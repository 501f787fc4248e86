"""The port's accuracy-parity scripts (pocketflow_tpu_torch/experiments/
{synthetic_parity,composed_cp_qat,composed_ws_qat,parity_calibrate}.py) run
end to end on the CPU at a tiny size: every point's learner trains and is
evaluated through the script's own code path (quick sweeps of ResNet and
MobileNet-v1, both composed pipelines with their masks carried through the
QAT finetune and the residual-aware shrink, one calibration point).

The size is cut through each script's `overrides` (ResNet-8 instead of
ResNet-20, 64 samples of 32x32 at batch 16, a step or two a learner, the
prune passes at one batch, fp32); the accuracies are those of nets that
barely trained, so the bands are not held here: the chip runs hold them
(tests/test_torch_parity_harness.py checks their committed results).
"""

import json
import math
import sys

import pytest
import torch

from pocketflow_tpu_torch.config import FLAGS as TFLAGS

torch.set_num_threads(2)
TINY = dict(compute_dtype='float32', batch_size=16, batch_size_eval=16, nb_smpls_train=64,
            nb_smpls_eval=32, nb_epochs_rat=0.01, summ_step=10 ** 6, resnet_size=8,
            ilsvrc_image_size=32, cpg_nb_iters_layer=2, cp_nb_batches=1,
            cp_nb_points_per_layer=2, cpr_nb_smpls=16, cpr_nb_crops_per_smpl=1,
            cpr_ista_nb_iters=2, cpr_lstsq_nb_iters=2, dcp_nb_iters_block=1,
            dcp_nb_iters_layer=1, ws_mask_update_step=2)


@pytest.fixture(autouse=True)
def _port_flags(monkeypatch):
    from pocketflow_tpu_torch.main import register_flags
    register_flags()
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    with TFLAGS.scope(**TFLAGS.as_dict()):
        yield


def _points(results):
    return [k[:-len('_delta')] for k in results if k.endswith('_delta')]


def _assert_recorded(results, keys):
    assert _points(results) == list(keys)
    base = results['full-prec']
    for key in keys:
        assert math.isfinite(results[key]) and 0.0 <= results[key] <= 1.0
        assert results[key + '_delta'] == round(base - results[key], 4)
    assert list(results['_seconds']) == ['full-prec'] + list(keys)


def test_quick_resnet_sweep_runs(tmp_path, monkeypatch):
    from pocketflow_tpu_torch.experiments import synthetic_parity as sp
    out = sp.run_sweep(str(tmp_path), quick=True, device='cpu', overrides=TINY)
    _assert_recorded(out, ['weight-sparse@75%', 'uniform@4bit', 'uniform-tf@8/8',
                           'non-uniform@4bit', 'chn-pruned-gpu@50%', 'channel@50%',
                           'channel@50%+sched', 'chn-pruned-rmt@50%', 'dis-chn-pruned@50%'])
    assert out['_quick'] is True
    # a quick run is held to the bands of the points it has, and nothing
    # is reported missing
    assert not [v for v in sp.check_results(out) if 'missing' in v]
    # a casual run writes under $PF_PARITY_OUT, never to the committed results
    monkeypatch.setenv('PF_PARITY_OUT', str(tmp_path / 'out'))
    path = sp.finish(dict(out), 'parity_hard', False, None)
    assert path == str(tmp_path / 'out' / 'parity_hard.json')
    with open(path) as fin:
        written = json.load(fin)
    assert written['_card'] is None and '_commit' in written
    assert written['uniform@4bit'] == round(out['uniform@4bit'], 4)


def test_quick_mobilenet_sweep_runs(tmp_path):
    from pocketflow_tpu_torch.experiments import synthetic_parity as sp
    out = sp.run_sweep_mobilenet(str(tmp_path), quick=True, device='cpu', overrides=TINY)
    _assert_recorded(out, ['weight-sparse@50%', 'uniform-tf@8/8'])
    assert out['_family'] == 'mobilenet_v1'


@pytest.mark.parametrize('script', ['composed_cp_qat', 'composed_ws_qat'])
def test_composed_pipeline_runs(tmp_path, script):
    import importlib
    mod = importlib.import_module('pocketflow_tpu_torch.experiments.' + script)
    out = mod.run(str(tmp_path), quick=True, device='cpu', overrides=TINY)
    if script == 'composed_cp_qat':
        _assert_recorded(out, ['channel@50%+sched', 'cp+qat@8bit'])
        # about half the input channels pruned, and still pruned after QAT
        assert 0.3 <= out['pruned_channel_frac'] == out['pruned_channel_frac_after_qat'] < 0.7
        assert 0.0 < out['packed_param_frac'] < 0.8
    else:
        _assert_recorded(out, ['weight-sparse@50%', 'ws+qat@8bit'])
        assert out['sparsity_frac'] == out['sparsity_frac_after_qat'] == 0.5
    assert mod.check_results(out) == []  # a quick run holds the mask-survival invariant


def test_calibration_point_runs():
    from pocketflow_tpu_torch.experiments import parity_calibrate
    acc = parity_calibrate.run_one(0.18, device='cpu', overrides=TINY)
    assert 0.0 <= acc <= 1.0
    assert TFLAGS.synthetic_snr == 0.18 and TFLAGS.synthetic_task == 'hard'


def test_baseline_seeds_run(tmp_path, monkeypatch):
    """--baseline-seeds: the baseline alone at each seed, its accuracy and
    how many land in the band, written where finish writes."""
    from pocketflow_tpu_torch.experiments import synthetic_parity as sp
    assert sp.parse_seeds('0-3') == [0, 1, 2, 3] and sp.parse_seeds('0,4') == [0, 4]
    monkeypatch.setenv('PF_PARITY_OUT', str(tmp_path))
    out = sp.baseline_seeds('resnet20', [0, 1], False, None, device='cpu', overrides=TINY)
    assert list(out['seeds']) == ['0', '1'] and out['of'] == 2
    assert all(0.0 <= acc <= 1.0 for acc in out['seeds'].values())
    assert out['in_band'] == sum(0.75 <= acc <= 0.88 for acc in out['seeds'].values())
    with open(tmp_path / 'parity_hard_seeds.json') as fin:
        assert json.load(fin)['seeds'] == out['seeds']
