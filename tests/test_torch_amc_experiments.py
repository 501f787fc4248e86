"""The port's AMC experiments (pocketflow_tpu_torch/experiments/
{amc_vs_uniform,amc_mobilenet_onchip}.py) against the JAX package's
(experiments/ of the same names).

* The checker gives JAX's violations, message for message, on JAX's
  committed result and on planted regressions of it: RL losing past the
  noise band, preserved FLOPs off the ~50% operating point on either side,
  each key missing.
* The flags, call by call, equal the literal values of the JAX scripts'
  source (paths and the CLI's values aside); the RL arm runs on the
  MobileNet-v1 strip's own base flags (synthetic_parity.mobilenet_flags).
* Both scripts run end to end on the CPU at a tiny size through their
  `overrides` (MobileNet-v1 at depth 0.25 on 32x32 images): the baseline, a
  2-roll-out search, the top candidate's finetune and its val selection,
  the uniform arm; the drill's warm-up and search with its checkpoint.
* The port's committed card results carry the card, a commit and the
  run's seconds, and both checkers give the verdict measured on the card.
"""

import copy
import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, 'experiments'))

import amc_vs_uniform as javu  # noqa: E402  (the JAX script)

from pocketflow_tpu_torch.config import FLAGS as TFLAGS  # noqa: E402
from pocketflow_tpu_torch.experiments import amc_mobilenet_onchip as tdrill  # noqa: E402
from pocketflow_tpu_torch.experiments import amc_vs_uniform as tavu  # noqa: E402
from pocketflow_tpu_torch.experiments import synthetic_parity as tsp  # noqa: E402
from torch_script_source import literal_flags  # noqa: E402

torch.set_num_threads(2)
JAX_RESULTS = os.path.join(ROOT, 'experiments', 'results')
PORT_RESULTS = tsp.RESULTS_DIR
# MobileNet-v1 at a tiny size: depth 0.25 at 32x32, a step or two a learner,
# the prune passes at one batch; eval batches of 128 over the 2,048
# synthetic eval samples
TINY = dict(compute_dtype='float32', batch_size=8, batch_size_eval=128, nb_smpls_train=64,
            nb_smpls_eval=16, ilsvrc_image_size=32, mobilenet_depth_mult=0.25,
            nb_epochs_rat=0.001, summ_step=10 ** 6, cp_nb_batches=1, cp_nb_points_per_layer=2,
            cp_lasso_nb_iters=4)
PATHS = {'save_path', 'log_dir', 'cp_best_path', 'cp_channel_pruned_path'}


def _load(directory, name):
    with open(os.path.join(directory, name)) as fin:
        return json.load(fin)


@pytest.fixture(autouse=True)
def _port_flags(monkeypatch):
    """Every flag of the port registered, and restored after the test."""
    from pocketflow_tpu_torch.main import register_flags
    register_flags()
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    with TFLAGS.scope(**TFLAGS.as_dict()):
        yield


# ---------------------------------------------------------------------------
# the checker
# ---------------------------------------------------------------------------

def _checker_cases():
    healthy = _load(JAX_RESULTS, 'amc_vs_uniform.json')
    cases = {
        'committed': (healthy, False),
        'rl-lost-past-noise': (dict(healthy, rl_accuracy=healthy['uniform_accuracy'] - 0.1),
                               True),
        'rl-lost-within-noise': (dict(healthy, rl_accuracy=healthy['uniform_accuracy'] - 0.019),
                                 False),
        'flops-too-high': (dict(healthy, preserved_flops_frac=0.9), True),
        'flops-too-low': (dict(healthy, preserved_flops_frac=0.29), True),
        'flops-at-edges': (dict(healthy, preserved_flops_frac=0.55), False),
        'both-violations': (dict(healthy, rl_accuracy=0.5, preserved_flops_frac=0.6), True),
        'empty': ({}, True),
    }
    for key in ('rl_accuracy', 'uniform_accuracy', 'preserved_flops_frac'):
        cases['no-' + key] = ({k: v for k, v in healthy.items() if k != key}, True)
    return cases


CHECKER_CASES = _checker_cases()


@pytest.mark.parametrize('case', list(CHECKER_CASES))
def test_checker_matches_jax(case):
    results, fails = CHECKER_CASES[case]
    want = javu.check_results(copy.deepcopy(results))
    assert tavu.check_results(copy.deepcopy(results)) == want
    assert bool(want) == fails, want


def test_constants_equal_jax():
    assert tavu.NOISE == javu.NOISE
    with open(javu.__file__) as fin:
        src = fin.read()
    assert 'not 0.3 <= results[\'preserved_flops_frac\'] <= 0.55' in src
    for flag, default in (('rlouts', 60), ('rlouts_min', 15), ('topk', 3)):
        assert "'--%s', type=int, default=%d" % (flag, default) in src
    with open(os.path.join(ROOT, 'experiments', 'amc_mobilenet_onchip.py')) as fin:
        src = fin.read()
    assert "'--rlouts', type=int, default=12" in src
    assert "'--warm_steps', type=int, default=600" in src
    assert 'range(4)' in src and tdrill.NB_EVAL_BATCHES == 4


# ---------------------------------------------------------------------------
# the flags
# ---------------------------------------------------------------------------

def _strip(flags, also=()):
    return {k: v for k, v in flags.items() if k not in PATHS and k not in also}


def test_amc_flags_equal_jax_source(tmp_path):
    """The base flags (the strip's, at --rand_seed 0), the RL arm's and the
    uniform arm's are the JAX script's; the values it takes from its CLI
    and the search (the roll-outs, the budget's fraction, the epochs) are
    the port's arguments."""
    work = str(tmp_path)
    want = literal_flags(javu.__file__)
    base = dict(tsp.mobilenet_flags(work, 0.2), rand_seed=0)
    got = [_strip(base, ('nb_epochs_rat',)),
           _strip(tavu.search_flags(work, 60, 15), ('cp_nb_rlouts', 'cp_nb_rlouts_min')),
           _strip(tavu.uniform_flags(work, 0.44), ('cp_uniform_preserve_ratio',))]
    assert got == want
    assert tavu.search_flags(work, 7, 3)['cp_nb_rlouts'] == 7
    assert tavu.search_flags(work, 7, 3)['cp_nb_rlouts_min'] == 3
    assert tavu.uniform_flags(work, 0.44)['cp_uniform_preserve_ratio'] == 0.44


def test_drill_flags_equal_jax_source(tmp_path):
    want = literal_flags(os.path.join(ROOT, 'experiments', 'amc_mobilenet_onchip.py'))
    flags = tdrill.drill_flags(str(tmp_path), 12)
    assert [_strip(flags, ('cp_nb_rlouts', 'cp_nb_rlouts_min'))] == want
    assert flags['cp_nb_rlouts'] == 12 and flags['cp_nb_rlouts_min'] == 3
    assert tdrill.drill_flags(str(tmp_path), 2)['cp_nb_rlouts_min'] == 2


def test_result_names():
    assert tavu.result_tag(0) == 'amc_vs_uniform'
    assert tavu.result_tag(1) == 'amc_vs_uniform_seed1'


# ---------------------------------------------------------------------------
# tiny runs
# ---------------------------------------------------------------------------

def test_tiny_amc_vs_uniform_runs(tmp_path):
    out = tavu.run(str(tmp_path), quick=True, rlouts=2, rlouts_min=1, topk=1, device='cpu',
                   overrides=TINY)
    jax_keys = set(_load(JAX_RESULTS, 'amc_vs_uniform.json'))
    assert jax_keys - {'device'} <= set(out) and out['device'] == 'cpu'
    assert out['_quick'] is True and out['rand_seed'] == 0
    assert out['baseline_in_band'] == (0.84 <= out['baseline_accuracy'] <= 0.95)
    assert len(out['reward_trace']) == 2 and out['nb_rlouts'] == 2
    assert out['topk'] == 1 and len(out['candidates']) == 1
    assert out['rl_ratios'] == out['candidates'][0]['ratios']
    assert len(out['rl_ratios']) == 13  # MobileNet-v1's pointwise convs
    assert 0.0 < out['preserved_flops_frac'] <= 0.5 + 1e-6
    assert set(out['_seconds']) == {'baseline', 'search', 'candidates', 'uniform'}
    for key in ('baseline_accuracy', 'rl_accuracy', 'uniform_accuracy'):
        assert 0.0 <= out[key] <= 1.0
    assert isinstance(tavu.check_results(out), list)
    # each arm wrote its finetuned checkpoint
    for sub in ('rl/cand0', 'uni'):
        assert any(f.startswith('model.ckpt') for f in os.listdir(tmp_path / sub))


def test_tiny_drill_runs(tmp_path):
    res = tdrill.run(2, 2, device='cpu', overrides=dict(TINY, nb_smpls_val=16, nb_classes=8),
                     workdir=str(tmp_path))
    jax_keys = set(_load(JAX_RESULTS, 'amc_mobilenet_r3.json'))
    assert jax_keys <= set(res) and res['device'] == 'cpu'
    assert res['image_size'] == 32 and res['nb_prunable_convs'] == 13
    assert len(res['reward_trace']) == 2 and res['best_reward'] == max(res['reward_trace'])
    assert res['preserved_flops_frac'] <= 0.5 + 1e-6
    assert os.path.exists(tmp_path / 'ddpg_search.npz')


def test_clis_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for main in (tavu.main, tdrill.main):
        with pytest.raises(SystemExit, match='needs a CUDA device'):
            main([])
    path = os.path.join(JAX_RESULTS, 'amc_vs_uniform.json')
    assert tavu.main(['--check-file', path]) == _load(JAX_RESULTS, 'amc_vs_uniform.json')


# ---------------------------------------------------------------------------
# the card's results
# ---------------------------------------------------------------------------

def test_committed_drill_result():
    data = _load(PORT_RESULTS, 'amc_mobilenet_r3.json')
    assert set(_load(JAX_RESULTS, 'amc_mobilenet_r3.json')) <= set(data)
    assert 'H100' in data['_card'] and ' W' in data['_card'] and data['_commit']
    assert 'H100' in data['device'] and data['model'] == 'mobilenet_v1'
    assert (data['image_size'], data['nb_rlouts'], data['warm_steps']) == (224, 12, 600)
    assert data['nb_prunable_convs'] == 13 and len(data['best_ratios']) == 13
    assert len(data['reward_trace']) == 12 and data['best_reward'] == max(data['reward_trace'])
    assert data['preserved_flops_frac'] <= 0.5 + 1e-6


# the verdicts measured on the card (an empty list: the band held): seed 0's
# baseline memorizes as the strip's does (baseline_in_band False), seed 1's
# lands in the strip's band
AMC_MEASURED_ON_THE_CARD = {'amc_vs_uniform.json': (0, False, []),
                            'amc_vs_uniform_seed1.json': (1, True, [])}


@pytest.mark.parametrize('name', list(AMC_MEASURED_ON_THE_CARD))
def test_committed_amc_results_hold_their_verdict(name):
    seed, in_band, want = AMC_MEASURED_ON_THE_CARD[name]
    data = _load(PORT_RESULTS, name)
    assert data['_quick'] is False and data['rand_seed'] == seed
    assert tavu.result_tag(seed) + '.json' == name
    assert 'H100' in data['_card'] and ' W' in data['_card'] and data['_commit']
    assert set(data['_seconds']) == {'baseline', 'search', 'candidates', 'uniform'}
    assert set(_load(JAX_RESULTS, 'amc_vs_uniform.json')) <= set(data)
    band = tsp.BASELINE_BAND_MOBILENET
    assert data['baseline_in_band'] == in_band == (band[0] <= data['baseline_accuracy'] <= band[1])
    # a real search: enough roll-outs to exploit, and a reward trace that moved
    assert data['nb_rlouts'] >= 50 and len(data['reward_trace']) == data['nb_rlouts']
    assert max(data['reward_trace']) - min(data['reward_trace']) > 2 * tavu.NOISE
    assert data['topk'] == len(data['candidates']) == 3
    best = max(data['candidates'], key=lambda c: c['val_accuracy'])
    assert data['rl_ratios'] == best['ratios']
    assert tavu.check_results(data) == javu.check_results(data) == want
    assert tavu.main(['--check-file', os.path.join(PORT_RESULTS, name)]) == data
