"""The port's accuracy-parity harness (pocketflow_tpu_torch/experiments/
{synthetic_parity,composed_cp_qat,composed_ws_qat}.py) against the JAX
package's (experiments/{synthetic_parity,composed_cp_qat,composed_ws_qat}.py).

* The band constants equal the JAX scripts' (the task's snr values, the
  baseline windows, every point's locked band, the two-sided floors, the
  composed scripts' stacked bands and fractions).
* Each checker gives JAX's violations, message for message, on JAX's
  committed results and on planted regressions of them: a delta past its
  band, a missing point, a saturated baseline, an "improvement" past the
  two-sided floor, a quick run, and the composed scripts' masks that regrew
  across QAT, too little pruning, too little shrink.
* The plan: with `create_learner` replaced by a recorder in both packages,
  run_sweep and run_sweep_mobilenet, in full and quick, from registries
  set equal, ask for the same points in the same order, under the same
  learner names, the same values of every flag both registries define
  (save paths included: both run in one work directory), and evaluate each
  with the same eval builder.
* The port's committed card results (pocketflow_tpu_torch/experiments/
  results/) carry the card's name and power limit and a commit, and both
  packages' checkers give their measured verdict: the ResNet-20 sweep and
  both composed pipelines pass; the MobileNet-v1 strip failed on the card
  and stays failed here (ROADMAP section 3).  The CLI's --check-file reads
  them; without a card the sweep's CLI exits (no CPU fallback).
"""

import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, 'experiments'))

import composed_cp_qat as jcp  # noqa: E402  (the JAX scripts)
import composed_ws_qat as jws  # noqa: E402
import synthetic_parity as jsp  # noqa: E402

from pocketflow_tpu.config import FLAGS as JFLAGS  # noqa: E402
from pocketflow_tpu_torch.config import FLAGS as TFLAGS  # noqa: E402
from pocketflow_tpu_torch.experiments import composed_cp_qat as tcp  # noqa: E402
from pocketflow_tpu_torch.experiments import composed_ws_qat as tws  # noqa: E402
from pocketflow_tpu_torch.experiments import synthetic_parity as tsp  # noqa: E402

JAX_RESULTS = os.path.join(ROOT, 'experiments', 'results')
PORT_RESULTS = tsp.RESULTS_DIR


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
    (tsp, jsp, ('HARD_TASK_SNR', 'BASELINE_BAND', 'LOCKED_MAX_DELTA', 'MOBILENET_SNR',
                'BASELINE_BAND_MOBILENET', 'LOCKED_MAX_DELTA_MOBILENET',
                'LOCKED_MIN_DELTA_FAMILY')),
    (tcp, jcp, ('LOCKED_MAX_STACKED_DELTA', 'LOCKED_MIN_STACKED_DELTA',
                'MIN_PRUNED_CHANNEL_FRAC', 'MAX_PACKED_PARAM_FRAC')),
    (tws, jws, ('LOCKED_MAX_STACKED_DELTA', 'LOCKED_MIN_STACKED_DELTA', 'MIN_SPARSITY_FRAC')),
], ids=['synthetic_parity', 'composed_cp_qat', 'composed_ws_qat'])
def test_band_constants_equal_jax(port, jax_mod, names):
    for name in names:
        assert getattr(port, name) == getattr(jax_mod, name), name
    if port is tsp:  # the same points, in the same order
        assert list(tsp.LOCKED_MAX_DELTA) == list(jsp.LOCKED_MAX_DELTA)
        assert list(tsp.LOCKED_MAX_DELTA_MOBILENET) == list(jsp.LOCKED_MAX_DELTA_MOBILENET)


def _sweep_cases():
    r20 = _load(JAX_RESULTS, 'parity_hard.json')
    mb = _load(JAX_RESULTS, 'parity_hard_mobilenet.json')
    cases = {
        'r20-committed': (r20, 'resnet20', False),
        'mb-committed': (mb, 'mobilenet_v1', False),
        'r20-delta-past-band': (dict(r20, **{'uniform@4bit_delta': 0.1122}), 'resnet20', True),
        'r20-missing-point': ({k: v for k, v in r20.items()
                               if not k.startswith('chn-pruned-rmt')}, 'resnet20', True),
        'r20-saturated-baseline': (dict(r20, **{'full-prec': 1.0}), 'resnet20', True),
        'r20-improves-past-floor': (dict(r20, **{'chn-pruned-gpu@50%_delta': -0.2}),
                                    'resnet20', True),
        'r20-no-baseline': ({k: v for k, v in r20.items() if k != 'full-prec'}, 'resnet20',
                            True),
        'r20-quick-missing-and-improving': (
            {'_quick': True, 'full-prec': 0.8, 'uniform@4bit_delta': -0.2}, 'resnet20', False),
        'r20-quick-past-band': ({'_quick': True, 'full-prec': 0.8, 'uniform@4bit_delta': 0.07},
                                'resnet20', True),
        'mb-delta-past-band': (dict(mb, **{'channel@50%+sched_delta': 0.2521}), 'mobilenet_v1',
                               True),
        'mb-improves-past-floor': (dict(mb, **{'chn-pruned-gpu@50%_delta': -0.25}),
                                   'mobilenet_v1', True),
        'mb-missing-point': ({k: v for k, v in mb.items()
                              if not k.startswith('weight-sparse@90%')}, 'mobilenet_v1', True),
        'mb-baseline-low': (dict(mb, **{'full-prec': 0.80}), 'mobilenet_v1', True),
    }
    return cases


SWEEP_CASES = _sweep_cases()


@pytest.mark.parametrize('case', list(SWEEP_CASES))
def test_sweep_checker_matches_jax(case):
    results, family, fails = SWEEP_CASES[case]
    want = jsp.check_results(results, family=family)
    assert tsp.check_results(results, family=family) == want
    assert bool(want) == fails, want


def _composed_cases():
    cp = _load(JAX_RESULTS, 'composed_cp_qat.json')
    ws = _load(JAX_RESULTS, 'composed_ws_qat.json')
    return {
        'cp-committed': (cp, 'cp', False),
        'cp-stacked-past-band': (dict(cp, **{'cp+qat@8bit_delta': 0.15}), 'cp', True),
        'cp-improves-past-floor': (dict(cp, **{'cp+qat@8bit_delta': -0.1}), 'cp', True),
        'cp-masks-regrew': (dict(cp, pruned_channel_frac_after_qat=0.4), 'cp', True),
        'cp-did-not-prune': (dict(cp, pruned_channel_frac=0.1,
                                  pruned_channel_frac_after_qat=0.1), 'cp', True),
        'cp-shrink-too-small': (dict(cp, packed_param_frac=0.9), 'cp', True),
        'cp-missing': ({k: v for k, v in cp.items() if not k.startswith('cp+qat')}, 'cp', True),
        'cp-quick': (dict(cp, _quick=True, **{'full-prec': 0.1, 'cp+qat@8bit_delta': 0.5}),
                     'cp', False),
        'ws-committed': (ws, 'ws', False),
        'ws-stacked-past-band': (dict(ws, **{'ws+qat@8bit_delta': 0.06}), 'ws', True),
        'ws-improves-past-floor': (dict(ws, **{'ws+qat@8bit_delta': -0.1}), 'ws', True),
        'ws-masks-regrew': (dict(ws, sparsity_frac_after_qat=0.45), 'ws', True),
        'ws-did-not-sparsify': (dict(ws, sparsity_frac=0.3, sparsity_frac_after_qat=0.3),
                                'ws', True),
        'ws-saturated-baseline': (dict(ws, **{'full-prec': 1.0}), 'ws', True),
        'ws-missing-fraction': ({k: v for k, v in ws.items() if k != 'sparsity_frac_after_qat'},
                                'ws', True),
    }


COMPOSED_CASES = _composed_cases()


@pytest.mark.parametrize('case', list(COMPOSED_CASES))
def test_composed_checkers_match_jax(case):
    results, kind, fails = COMPOSED_CASES[case]
    jax_mod, port = (jcp, tcp) if kind == 'cp' else (jws, tws)
    want = jax_mod.check_results(results)
    assert port.check_results(results) == want
    assert bool(want) == fails, want


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

class _Learner:
    """Records the eval builder a point is evaluated with; trains nothing."""

    def __init__(self, plan, name):
        self.plan, self.name = plan, name

    def train(self):
        return 'state'

    def __getattr__(self, attr):
        if attr.startswith('build_') and attr.endswith('eval_step'):
            return lambda: attr
        raise AttributeError(attr)

    def run_eval_loop(self, state, eval_step):
        self.plan[-1]['eval'] = eval_step
        return {'accuracy': 0.5, 'pr_msk': 0.5}


def _recorder(plan, registry):
    def create_learner(sm_writer, model_helper, learner_name=None, **kwargs):
        plan.append({'learner': learner_name, 'helper': type(model_helper).__module__,
                     'flags': registry.as_dict()})
        return _Learner(plan, learner_name)
    return create_learner


@pytest.mark.parametrize('family,quick', [('resnet20', False), ('resnet20', True),
                                          ('mobilenet_v1', False), ('mobilenet_v1', True)])
def test_sweep_plan_matches_jax(tmp_path, monkeypatch, family, quick):
    import pocketflow_tpu.learners as jlearners
    import pocketflow_tpu_torch.learners as tlearners
    plans = {'jax': [], 'port': []}
    monkeypatch.setattr(jlearners, 'create_learner', _recorder(plans['jax'], JFLAGS))
    monkeypatch.setattr(tlearners, 'create_learner', _recorder(plans['port'], TFLAGS))
    common = set(JFLAGS.as_dict()) & set(TFLAGS.as_dict())
    jflags = JFLAGS.as_dict()
    TFLAGS.override(**{k: jflags[k] for k in common})  # both start equal
    workdir = str(tmp_path)
    if family == 'mobilenet_v1':
        jsp.run_sweep_mobilenet(workdir, quick=quick)
        out = tsp.run_sweep_mobilenet(workdir, quick=quick, device='cpu')
    else:
        jsp.run_sweep(workdir, quick=quick)
        out = tsp.run_sweep(workdir, quick=quick, device='cpu')
    jplan, tplan = plans['jax'], plans['port']
    assert len(tplan) == len(jplan) == {('resnet20', False): 15, ('resnet20', True): 10,
                                        ('mobilenet_v1', False): 7,
                                        ('mobilenet_v1', True): 3}[(family, quick)]
    for j, t in zip(jplan, tplan):
        assert t['learner'] == j['learner']
        assert t['eval'] == j['eval']
        assert t['helper'].replace('pocketflow_tpu_torch', 'pocketflow_tpu') == j['helper']
        differ = {k: (j['flags'][k], t['flags'][k]) for k in common
                  if j['flags'][k] != t['flags'][k]}
        assert not differ, (j['learner'], differ)
    # and the same points recorded, in the same order
    assert [k for k in out if k.endswith('_delta')] == \
        [k + '_delta' for k in (tsp.LOCKED_MAX_DELTA if family == 'resnet20'
                                else tsp.LOCKED_MAX_DELTA_MOBILENET)
         if k + '_delta' in out]


# ---------------------------------------------------------------------------
# the card's results
# ---------------------------------------------------------------------------

PORT_FILES = {'parity_hard.json': ('sweep', 'resnet20'),
              'parity_hard_mobilenet.json': ('sweep', 'mobilenet_v1'),
              'composed_cp_qat.json': ('cp', None),
              'composed_ws_qat.json': ('ws', None)}
# The MobileNet-v1 strip failed on the card (ROADMAP section 3, open): its
# baseline memorized the train set (eval top-5 0.1562), and three points that
# regularize it beat it past the two-sided floor.  The result stays as
# measured, and failed, here.
FAILED_ON_THE_CARD = {'parity_hard_mobilenet.json': [
    'full-prec 0.1562 outside calibrated band [0.84, 0.95]',
    'weight-sparse@90% delta -0.4927 "improves" past the two-sided floor -0.10 — suspect a '
    'baseline/train-pipeline regression',
    'chn-pruned-gpu@50% delta -0.2329 "improves" past the two-sided floor -0.10 — suspect a '
    'baseline/train-pipeline regression',
    'channel@50%+sched delta -0.3335 "improves" past the two-sided floor -0.10 — suspect a '
    'baseline/train-pipeline regression']}


@pytest.mark.parametrize('name', list(PORT_FILES))
def test_committed_card_results_pass(name):
    """Each committed result is the port's checker's verdict: [] for the
    points that passed on the card, the measured violations for the strip
    that failed (its CLI exits 1 on it)."""
    data = _load(PORT_RESULTS, name)
    path = os.path.join(PORT_RESULTS, name)
    kind, family = PORT_FILES[name]
    want = FAILED_ON_THE_CARD.get(name, [])
    assert data['_quick'] is False
    assert 'H100' in data['_card'] and ' W' in data['_card']
    assert data['_commit']
    if kind == 'sweep':
        assert data.get('_family', 'resnet20') == family
        assert tsp.check_results(data, family=family) == want
        assert jsp.check_results(data, family=family) == want
        if want:
            with pytest.raises(SystemExit):
                tsp.main(['--check-file', path])
        else:
            assert tsp.main(['--check-file', path]) == data
    else:
        port = tcp if kind == 'cp' else tws
        assert port.check_results(data) == want == []
        assert port.main(['--check-file', path]) == data


def test_sweep_cli_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(SystemExit, match='needs a CUDA device'):
        tsp.main(['--quick'])
    with pytest.raises(SystemExit, match='needs a CUDA device'):
        tcp.main(['--quick'])


def test_committed_mobilenet_baseline_seeds():
    """The MobileNet-v1 strip's baseline alone at seeds 0-7 on the card
    (--baseline-seeds): the card and commit recorded, and its count in band
    the count of its accuracies inside the strip's baseline band.  The
    measured rate, 5 of 8 (seeds 0, 4 and 6 memorize), keeps ROADMAP
    section 3's fault open."""
    data = _load(PORT_RESULTS, 'parity_hard_mobilenet_seeds.json')
    assert 'H100' in data['_card'] and data['_commit']
    assert data['_family'] == 'mobilenet_v1'
    assert tuple(data['_band']) == jsp.BASELINE_BAND_MOBILENET
    assert list(data['seeds']) == [str(k) for k in range(8)] == list(data['_seconds'])
    band = jsp.BASELINE_BAND_MOBILENET
    assert data['in_band'] == sum(band[0] <= a <= band[1] for a in data['seeds'].values()) == 5
    assert data['of'] == 8
    # seed 0 is the strip's own run: the same baseline as the committed strip
    assert data['seeds']['0'] == _load(PORT_RESULTS, 'parity_hard_mobilenet.json')['full-prec']
