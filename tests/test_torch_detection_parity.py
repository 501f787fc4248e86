"""The port's detection parity scripts (pocketflow_tpu_torch/experiments/
{detection_parity,frcnn_compression_parity,frcnn_synthetic_map,
frcnn_warmstart_resnet50}.py) against the JAX package's (experiments/ of the
same names).

* The band constants equal the JAX scripts' (baseline windows, every
  point's locked band in order, the two-sided floors, Faster R-CNN's hard
  regime), and the drills' flags and convergence bound equal the values in
  the JAX scripts' source.
* Each checker gives JAX's violations, message for message, on JAX's
  committed results and on planted regressions of them: a delta past its
  band, an "improvement" past the floor, a missing point, a baseline out of
  its window or missing, a quick run.
* The plan: with `create_learner` replaced by a recorder in both packages,
  each strip, in full and quick (and the SSD strip's --only subset), from
  registries set equal, asks for the same learners in the same order with
  the same value of every flag both registries define, and scores the same
  points, the UQ point through its quantization policy.
* The four scripts run end to end on the CPU at a tiny size through their
  `overrides` (SSD-VGG16 at 32x32, Faster R-CNN ResNet-18 and `small` at
  64x64, a few steps a learner, fp32, every score kept): every point's
  learner trains and is scored by the script's own code: the SSD baseline,
  WS and CPG points and every Faster R-CNN point (SSD's UQ and LASSO
  points are left out for time: the plan holds their flags, the uniform
  learner runs on SSD in tests/test_torch_detection_main.py and the LASSO
  learner on Faster R-CNN here); the warm start grafts
  the classifier into the detector's stem.  The nets barely train, so the
  bands are not held here; instead the tiny SSD baseline's mAP, as the
  strip scored it, equals the JAX package's evaluate_map on the same
  weights and eval set (non-zero: a decode or an IoU threshold that differs
  from JAX's moves it).
* The port's committed card results (pocketflow_tpu_torch/experiments/
  results/) carry the card, a commit and the run's seconds, and both
  packages' checkers give the verdict measured on the card.
"""

import json
import math
import os
import sys
import types

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, 'experiments'))

import detection_parity as jdp  # noqa: E402  (the JAX scripts)
import frcnn_compression_parity as jfc  # noqa: E402

from pocketflow_tpu.config import FLAGS as JFLAGS  # noqa: E402
from pocketflow_tpu_torch.config import FLAGS as TFLAGS  # noqa: E402
from pocketflow_tpu_torch.experiments import detection_parity as tdp  # noqa: E402
from pocketflow_tpu_torch.experiments import frcnn_compression_parity as tfc  # noqa: E402
from pocketflow_tpu_torch.experiments import frcnn_synthetic_map as tsm  # noqa: E402
from pocketflow_tpu_torch.experiments import frcnn_warmstart_resnet50 as tws  # noqa: E402
from torch_script_source import literal_flags  # noqa: E402

torch.set_num_threads(2)
JAX_RESULTS = os.path.join(ROOT, 'experiments', 'results')
PORT_RESULTS = tdp.sp.RESULTS_DIR
# the tiny size: every point a step or two, the prune passes at one batch,
# every score kept (so that a barely trained net's mAP is not 0)
TINY = dict(compute_dtype='float32', batch_size=2, batch_size_eval=4, nb_smpls_train=16,
            nb_smpls_eval=8, voc_image_size=32, nb_bboxs_max=6, nb_epochs_rat=0.003,
            summ_step=10 ** 6, cp_nb_batches=1, cp_nb_points_per_layer=2, cp_lasso_nb_iters=4,
            cpg_nb_iters_layer=2, ws_mask_update_step=2, uql_quant_epochs=1,
            ssd_score_threshold=0.0, frcnn_score_threshold=0.0)
# the SSD strip's tiny run: the baseline, WS and CPG (its LASSO point costs
# as much as two others there, and the Faster R-CNN strip's tiny run drives
# that learner; the UQ point's learner on SSD runs in
# tests/test_torch_detection_main.py, its policy-scored eval in the plan)
SSD_TINY_POINTS = {'baseline', 'ws', 'cpg'}
TINY_FRCNN = dict(TINY, voc_image_size=64, frcnn_nb_proposals=8, frcnn_nb_pre_nms=32,
                  frcnn_roi_batch=8, nb_epochs_rat=0.01)


def _load(directory, name):
    with open(os.path.join(directory, name)) as fin:
        return json.load(fin)


@pytest.fixture(autouse=True)
def _both_registries(monkeypatch):
    """Every flag of both packages registered, and restored after the test."""
    import pocketflow_tpu.learners as jlearners
    from pocketflow_tpu_torch.main import register_flags
    jlearners.register_all_flags()
    register_flags()
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    with JFLAGS.scope(**JFLAGS.as_dict()), TFLAGS.scope(**TFLAGS.as_dict()):
        yield


# ---------------------------------------------------------------------------
# constants and checkers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('port,jax_mod,names', [
    (tdp, jdp, ('BASELINE_BAND', 'LOCKED_MAX_DELTA', 'LOCKED_MIN_DELTA')),
    (tfc, jfc, ('BASELINE_BAND', 'LOCKED_MAX_DELTA', 'LOCKED_MIN_DELTA', 'HARD_REGIME')),
], ids=['detection_parity', 'frcnn_compression_parity'])
def test_band_constants_equal_jax(port, jax_mod, names):
    for name in names:
        assert getattr(port, name) == getattr(jax_mod, name), name
    assert list(port.LOCKED_MAX_DELTA) == list(jax_mod.LOCKED_MAX_DELTA)  # the same order


@pytest.mark.parametrize('script', ['frcnn_synthetic_map', 'frcnn_warmstart_resnet50'])
def test_drill_flags_equal_jax_source(tmp_path, script):
    """The drills' flags, call by call, and their mAP bound are the JAX
    scripts' values (paths aside: the port writes under a work directory;
    frcnn_synthetic_map's backbone is its CLI argument, resnet18 by
    default)."""
    paths = {'save_path', 'log_dir'}

    def strip(flags):
        return {k: v for k, v in flags.items() if k not in paths}
    want = [strip(flags) for flags in literal_flags(
        os.path.join(ROOT, 'experiments', script + '.py'))]
    if script == 'frcnn_synthetic_map':
        got, mod = [strip(tsm.drill_flags(str(tmp_path)))], tsm
    else:
        det = strip(tws.detector_flags(str(tmp_path)))
        got = [strip(tws.classifier_flags(str(tmp_path))),
               {'frcnn_backbone': det.pop('frcnn_backbone')}, det]
        mod = tws
    assert got == want
    with open(os.path.join(ROOT, 'experiments', script + '.py')) as fin:
        assert "res['mAP'] > %s" % mod.MIN_MAP in fin.read()


def _checker_cases():
    ssd = _load(JAX_RESULTS, 'detection_parity.json')
    fr = _load(JAX_RESULTS, 'frcnn_compression_parity.json')
    return {
        'ssd-committed': (ssd, 'ssd', False),
        'ssd-delta-past-band': (dict(ssd, **{'weight-sparse@50%_delta': 0.1765}), 'ssd', True),
        'ssd-improves-past-floor': (dict(ssd, **{'chn-pruned-gpu@40%_delta': -0.1}), 'ssd',
                                    True),
        'ssd-missing-point': ({k: v for k, v in ssd.items() if not k.startswith('channel@')},
                              'ssd', True),
        'ssd-broken-baseline': (dict(ssd, **{'full-prec_mAP': 0.05}), 'ssd', True),
        'ssd-no-baseline': ({k: v for k, v in ssd.items() if k != 'full-prec_mAP'}, 'ssd', True),
        'ssd-quick': ({'_quick': True, 'full-prec_mAP': 0.02, 'uniform@8bit_delta': -0.3},
                      'ssd', False),
        'ssd-quick-past-band': ({'_quick': True, 'full-prec_mAP': 0.5,
                                 'uniform@8bit_delta': 0.07}, 'ssd', True),
        'frcnn-committed': (fr, 'frcnn', False),
        'frcnn-delta-past-band': (dict(fr, **{'channel@60%preserve_delta': 0.3915}), 'frcnn',
                                  True),
        'frcnn-improves-past-floor': (dict(fr, **{'weight-sparse@50%_delta': -0.0901}),
                                      'frcnn', True),
        'frcnn-missing-point': ({k: v for k, v in fr.items() if not k.startswith('weight')},
                                'frcnn', True),
        'frcnn-saturated-baseline': (dict(fr, **{'full-prec_mAP': 1.0}), 'frcnn', True),
        'frcnn-dead-baseline': (dict(fr, **{'full-prec_mAP': 0.05}), 'frcnn', True),
        'frcnn-quick': (dict(fr, _quick=True, **{'full-prec_mAP': 0.0}), 'frcnn', False),
    }


CHECKER_CASES = _checker_cases()


@pytest.mark.parametrize('case', list(CHECKER_CASES))
def test_checker_matches_jax(case):
    results, kind, fails = CHECKER_CASES[case]
    jax_mod, port = (jdp, tdp) if kind == 'ssd' else (jfc, tfc)
    want = jax_mod.check_results(results)
    assert port.check_results(results) == want
    assert bool(want) == fails, want


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

class _Helper:
    """Records how a point is scored; computes nothing."""

    dataset_eval = 'eval set'

    def __init__(self, plan):
        self.plan = plan

    def forward_eval(self, model, variables, inputs, policy=None):  # JAX's signature
        self.plan[-1]['policy'] = policy

    def evaluate_map(self, model, *args, policy=None, **kwargs):
        self.plan[-1]['policy'] = policy
        return {'mAP': 0.5}


class _Learner:
    def __init__(self, plan, name):
        self.plan, self.name = plan, name
        self.model_helper, self.model = _Helper(plan), 'model'

    def train(self):
        return types.SimpleNamespace(model='model', step=0)

    def init_state(self):
        return self.train(), None, None

    def restore_baseline(self, state):
        self.plan[-1]['restored'] = True
        return state, True

    def _policy_fn(self):
        return lambda state: 'quant policy'


def _recorder(plan, registry):
    def create_learner(sm_writer, model_helper, learner_name=None, **kwargs):
        plan.append({'learner': learner_name, 'helper': type(model_helper).__module__,
                     'flags': registry.as_dict(), 'policy': None, 'restored': False})
        return _Learner(plan, learner_name)
    return create_learner


@pytest.mark.parametrize('strip,quick,only', [
    ('ssd', False, None), ('ssd', True, None), ('ssd', False, ('ws', 'uq')),
    ('frcnn', False, None), ('frcnn', True, None)])
def test_strip_plan_matches_jax(tmp_path, monkeypatch, strip, quick, only):
    import pocketflow_tpu.learners as jlearners
    import pocketflow_tpu.nets.detection.eval_loop as jeval
    import pocketflow_tpu_torch.learners as tlearners
    plans = {'jax': [], 'port': []}
    monkeypatch.setattr(jlearners, 'create_learner', _recorder(plans['jax'], JFLAGS))
    monkeypatch.setattr(tlearners, 'create_learner', _recorder(plans['port'], TFLAGS))

    def jax_eval(helper, model, state, dataset, forward_fn, nb_batches=None):
        forward_fn('variables', 'images')
        return {'mAP': 0.5}
    monkeypatch.setattr(jeval, 'run_detection_eval', jax_eval)
    common = set(JFLAGS.as_dict()) & set(TFLAGS.as_dict())
    jflags = JFLAGS.as_dict()
    TFLAGS.override(**{k: jflags[k] for k in common})  # both start equal
    workdir = str(tmp_path)
    if strip == 'ssd':
        jout = jdp.run_strip(workdir, quick=quick, only=set(only) if only else None)
        out = tdp.run_strip(workdir, quick=quick, only=set(only) if only else None, device='cpu')
    else:
        jout = jfc.run_strip(workdir, quick=quick)
        out = tfc.run_strip(workdir, quick=quick, device='cpu')
    jplan, tplan = plans['jax'], plans['port']
    assert len(tplan) == len(jplan) == {('ssd', False, None): 5, ('ssd', True, None): 3,
                                        ('ssd', False, ('ws', 'uq')): 3,
                                        ('frcnn', False, None): 4,
                                        ('frcnn', True, None): 3}[(strip, quick, only)]
    for j, t in zip(jplan, tplan):
        assert (t['learner'], t['policy'], t['restored']) == \
            (j['learner'], j['policy'], j['restored'])
        assert t['helper'].replace('pocketflow_tpu_torch', 'pocketflow_tpu') == j['helper']
        differ = {k: (j['flags'][k], t['flags'][k]) for k in common
                  if j['flags'][k] != t['flags'][k]}
        assert not differ, (j['learner'], differ)
    # the same points recorded, under the same keys
    keys = [k for k in jout if k.endswith('_mAP') or k.endswith('_delta')]
    assert keys and [k for k in out if k.endswith('_mAP') or k.endswith('_delta')] == keys
    if only:
        assert jplan[0]['restored'] and tplan[0]['restored']


# ---------------------------------------------------------------------------
# the scripts end to end, tiny, on the CPU
# ---------------------------------------------------------------------------

def _assert_points(out, locked, extra=()):
    base = out['full-prec_mAP']
    assert 0.0 <= base <= 1.0
    for key in locked:
        assert math.isfinite(out[key + '_mAP']) and 0.0 <= out[key + '_mAP'] <= 1.0
        assert out[key + '_delta'] == round(base - out[key + '_mAP'], 4)
    names = ['full-prec'] + list(locked) + list(extra)
    for record in ('_seconds', '_eval_seconds', '_steps'):
        assert list(out[record]) == names, record
    for parts in out['_eval_seconds'].values():
        assert set(parts) == {'forward', 'decode', 'nms', 'voc_eval'}
    assert all(steps > 0 for steps in out['_steps'].values())


@pytest.fixture(scope='module')
def ssd_run(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp('ssd'))
    with TFLAGS.scope(**TFLAGS.as_dict()):
        out = tdp.run_strip(workdir, quick=False, device='cpu', overrides=TINY,
                            only=SSD_TINY_POINTS)
    return out, workdir


def test_tiny_ssd_strip_runs(ssd_run):
    """The baseline and the WS and CPG points, each trained and scored; the
    stored results merge a subset re-measure."""
    out, workdir = ssd_run
    _assert_points(out, ['weight-sparse@50%', 'chn-pruned-gpu@40%'])
    assert out['_quick'] is False
    assert [v for v in tdp.check_results(out) if 'missing' in v] == [
        'uniform@8bit missing from results', 'channel@60%preserve missing from results']
    path = os.path.join(workdir, 'stored.json')
    with open(path, 'w') as fout:
        json.dump(out, fout)
    sub = {'_quick': False, 'full-prec_mAP': 0.9, 'uniform@8bit_mAP': 0.8,
           'uniform@8bit_delta': 0.1, '_seconds': {'uniform@8bit': 1.0}}
    merged = tdp.merge_stored(path, sub)
    assert merged['uniform@8bit_delta'] == 0.1
    assert merged['weight-sparse@50%_delta'] == out['weight-sparse@50%_delta']
    assert merged['_seconds'] == {**out['_seconds'], 'uniform@8bit': 1.0}


def test_tiny_ssd_baseline_map_equals_jax(ssd_run):
    """The strip's score of its tiny baseline is JAX's evaluate_map of the
    same weights over the same eval set, and it is not 0."""
    from pocketflow_tpu.nets.vgg_at_pascalvoc import ModelHelper as JHelper
    from pocketflow_tpu_torch.core import checkpoint as ckpt
    from pocketflow_tpu_torch.core.bridge import to_jax_numpy
    from pocketflow_tpu_torch.nets.vgg_at_pascalvoc import ModelHelper as THelper
    out, workdir = ssd_run
    flags = {**tdp.strip_flags(workdir, False), **TINY}
    with TFLAGS.scope(**flags), JFLAGS.scope(**flags):
        model = THelper().create_model()
        model.load_state_dict(ckpt.restore_latest(flags['save_path'], map_location='cpu')['model'])
        params, stats = to_jax_numpy(model)
        jhelper = JHelper()
        state = types.SimpleNamespace(params=params, batch_stats=stats)
        want = float(jhelper.evaluate_map(jhelper.create_model(), state,
                                          jhelper.dataset_eval)['mAP'])
    assert want > 0.0
    assert out['full-prec_mAP'] == pytest.approx(want, abs=1e-6)


def test_tiny_frcnn_strip_runs(tmp_path, monkeypatch):
    """Every point; then --rerun-channel re-measures the channel point
    against the same baseline checkpoint into the published results (here
    a copy under tmp_path)."""
    workdir = str(tmp_path / 'strip')
    out = tfc.run_strip(workdir, quick=False, device='cpu', overrides=TINY_FRCNN)
    _assert_points(out, tfc.LOCKED_MAX_DELTA, extra=('small-trunk',))
    assert 0.0 <= out['small-trunk_mAP'] <= 1.0 and out['baseline_train_s'] > 0
    assert not [v for v in tfc.check_results(out) if 'missing' in v]
    published = tmp_path / 'results'
    published.mkdir()
    monkeypatch.setattr(tdp.sp, 'RESULTS_DIR', str(published))
    monkeypatch.setattr(tfc, 'RESULTS', str(published / 'frcnn_compression_parity.json'))
    stale = dict(out, **{'channel@60%preserve_mAP': 0.0, 'channel@60%preserve_delta': 1.0})
    with open(tfc.RESULTS, 'w') as fout:
        json.dump(stale, fout)
    with pytest.raises(SystemExit):  # a tiny run is held to the full bands
        tfc.rerun_channel_point(workdir, 'card', device='cpu', overrides=TINY_FRCNN)
    with open(tfc.RESULTS) as fin:
        merged = json.load(fin)
    assert merged['_card'] == 'card'
    assert merged['channel@60%preserve_delta'] == round(
        merged['full-prec_mAP'] - merged['channel@60%preserve_mAP'], 4)
    assert merged['weight-sparse@50%_mAP'] == round(out['weight-sparse@50%_mAP'], 4)


def test_tiny_drills_run(tmp_path):
    small = dict(batch_size=2, batch_size_eval=4, nb_smpls_train=16, nb_smpls_eval=8,
                 frcnn_score_threshold=0.0)
    res = tsm.run(3, 'small', device='cpu', overrides=small, workdir=str(tmp_path / 'map'))
    assert res['steps'] == 3 and 0.0 <= res['mAP'] <= 1.0
    assert set(res['eval_seconds']) == {'forward', 'decode', 'nms', 'voc_eval'}
    res = tws.run(2, 2, device='cpu', workdir=str(tmp_path / 'ws'),
                  overrides=dict(small, ilsvrc_image_size=32))
    assert res['grafted'] and res['graft_max_abs'] > 0 and 0.0 <= res['mAP'] <= 1.0
    assert os.path.isdir(tmp_path / 'ws' / 'cls')


def test_drill_cli_holds_the_bound_and_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr('pocketflow_tpu_torch.core.cuda_timing.card_line', lambda: 'card')
    for mod in (tsm, tws):
        monkeypatch.setattr(mod, 'run', lambda *args, **kwargs: {'mAP': 0.3})
        with pytest.raises(SystemExit, match='failed to converge'):
            mod.main(['1', '1'])
        monkeypatch.setattr(mod, 'run', lambda *args, **kwargs: {'mAP': 0.31})
        assert mod.main(['1', '1']) == {'mAP': 0.31}
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for main in (tsm.main, tws.main, tdp.main, tfc.main):
        with pytest.raises(SystemExit, match='needs a CUDA device'):
            main([])


def test_probe_arguments_read_as_jax():
    assert tfc.parse_probe([]) == ('resnet18', {})
    assert tfc.parse_probe(['small', 'synthetic_det_noise=60', 'nb_epochs_rat=0.5']) == \
        ('small', {'synthetic_det_noise': 60, 'nb_epochs_rat': 0.5})
    assert tfc.parse_probe(['nb_epochs_rat=0.016']) == ('resnet18', {'nb_epochs_rat': 0.016})


# ---------------------------------------------------------------------------
# the card's results
# ---------------------------------------------------------------------------

PORT_FILES = {'detection_parity.json': (tdp, jdp), 'frcnn_compression_parity.json': (tfc, jfc)}
# the verdicts measured on the card (an empty list: every band held)
MEASURED_ON_THE_CARD = {'detection_parity.json': [], 'frcnn_compression_parity.json': []}


@pytest.mark.parametrize('name', list(PORT_FILES))
def test_committed_card_results_pass(name):
    port, jax_mod = PORT_FILES[name]
    data = _load(PORT_RESULTS, name)
    want = MEASURED_ON_THE_CARD[name]
    assert data['_quick'] is False
    assert 'H100' in data['_card'] and ' W' in data['_card']
    assert data['_commit']
    assert set(data['_seconds']) >= {'full-prec'} | set(port.LOCKED_MAX_DELTA)
    assert port.check_results(data) == jax_mod.check_results(data) == want
    path = os.path.join(PORT_RESULTS, name)
    if want:
        with pytest.raises(SystemExit):
            port.main(['--check-file', path])
    else:
        assert port.main(['--check-file', path]) == data


def test_points_side_by_side_record_as_in_turn(tmp_path, monkeypatch):
    """run_apart (--jobs): each point in a process of its own, here a
    stand-in module that writes a canned record, is recorded in the strip's
    order with its delta from the parent's baseline; a point whose process
    fails is left out, and the checker reports it missing."""
    (tmp_path / 'stand_in_point.py').write_text(
        'import json, sys\n'
        'args = sys.argv[1:]\n'
        "name, out = args[args.index('--point') + 1], args[args.index('--point-out') + 1]\n"
        "if name == 'channel':\n"
        '    sys.exit(3)\n'
        "key = {'ws': 'weight-sparse@50%', 'uq': 'uniform@8bit',\n"
        "       'cpg': 'chn-pruned-gpu@40%'}[name]\n"
        "json.dump({key + '_mAP': 0.9 - 0.01 * len(name), '_steps': {key: len(name)},\n"
        "           '_eval_seconds': {key: {'nms': 1.0}}}, open(out, 'w'))\n")
    monkeypatch.setenv('PYTHONPATH', os.pathsep.join([str(tmp_path), ROOT]))
    results = {'_quick': False}
    rec = tdp.MapRecorder(results)
    rec.baseline(0.9)
    tdp.run_apart('stand_in_point', rec, tdp.strip_points(str(tmp_path), False), str(tmp_path),
                  3, False)
    keys = ['weight-sparse@50%', 'uniform@8bit', 'chn-pruned-gpu@40%']
    assert [k for k in results if k.endswith('_delta')] == [k + '_delta' for k in keys]
    assert [results[k + '_delta'] for k in keys] == [0.02, 0.02, 0.03]
    assert results['_steps'] == dict(zip(keys, (2, 2, 3)))
    assert list(results['_seconds']) == ['full-prec'] + keys
    assert tdp.check_results(results) == ['channel@60%preserve missing from results']
