"""The profiler hook and AutoML in the port, on the CPU.

* ``ProfilerHook`` through main.main on ConvNet @ FMNIST (6 steps): a
  Chrome trace in <log_dir>/profile whose step annotations are exactly the
  window [profiler_start_step, + profiler_nb_steps), cut at the loop's end;
  none without --enbl_profiler;
* ``automl/search.py`` against the JAX package's: GPSearch, TPESearch and
  RandomSearch over 8 trials of a fixed objective (the GP and TPE models
  past their warm-up), run_automl's history, ws_constraint and the LOG10
  spec: equal proposals and history;
* the AutoML CLI: 2 random trials of the weight-sparsification learner on
  ConvNet @ FMNIST complete and write their JSON.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from pocketflow_tpu.config import FLAGS as JFLAGS
from pocketflow_tpu_torch import main as port_main
from pocketflow_tpu_torch.config import FLAGS as TFLAGS

torch.set_num_threads(2)
port_main.register_flags()  # so that each test's scope restores every flag main() parses


AUTOML_FLAGS = ('automl_nb_trials', 'automl_algo', 'automl_space', 'automl_output')


@pytest.fixture(autouse=True)
def _port_flags(monkeypatch):
    """Restore the port's registry after each test, and drop the flags the
    AutoML CLI's main() registers in it (the JAX registry holds them only
    after its own CLI ran)."""
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    with TFLAGS.scope(**TFLAGS.as_dict()):
        yield
    for name in AUTOML_FLAGS:
        TFLAGS._specs.pop(name, None)
        TFLAGS._values.pop(name, None)


def _argv(tmp_path):
    return ['--model=convnet_at_fmnist', '--learner=full-prec', '--synthetic_data',
            '--batch_size=8', '--batch_size_eval=8', '--nb_smpls_train=48',
            '--nb_smpls_eval=16', '--compute_dtype=float32', '--summ_step=1',
            '--log_dir=%s' % (tmp_path / 'logs'),
            '--save_path=%s' % (tmp_path / 'models' / 'model.ckpt')]


@pytest.mark.parametrize('start,nb,traced', [(2, 3, [2, 3, 4]), (4, 5, [4, 5])])
def test_profiler_traces_exactly_its_window(tmp_path, start, nb, traced):
    from pocketflow_tpu_torch.tools.profile_step import trace_summary
    learner = port_main.main(_argv(tmp_path) + [
        '--nb_epochs_rat=0.0063', '--enbl_profiler',
        '--profiler_start_step=%d' % start, '--profiler_nb_steps=%d' % nb], device='cpu')
    assert learner.nb_iters_train == 6
    files = os.listdir(tmp_path / 'logs' / 'profile')
    assert files == ['trace_steps_%d-%d.json' % (start, traced[-1] + 1)]
    assert learner.profile_path == str(tmp_path / 'logs' / 'profile' / files[0])
    summary = trace_summary(learner.profile_path)
    assert summary['steps'] == traced and summary['window_ms'] > 0
    assert 'busy_ms' not in summary  # no card: host ops only


def test_trace_summary_reads_device_time(tmp_path):
    """Busy time, idle share and a program span's device time of a trace
    written as the hook's are on the card (kernels tied to their launches by
    correlation id): two steps over 0-100 us, kernels 10-30 and 20-50 (one
    launched inside 'pf.data.crop_resize') and a copy 90-120, past the last
    step."""
    from pocketflow_tpu_torch.tools.profile_step import trace_summary
    events = [
        {'ph': 'X', 'cat': 'user_annotation', 'name': 'train_step_3', 'ts': 0, 'dur': 40},
        {'ph': 'X', 'cat': 'user_annotation', 'name': 'train_step_4', 'ts': 40, 'dur': 60},
        {'ph': 'X', 'cat': 'user_annotation', 'name': 'pf.data.crop_resize', 'ts': 2,
         'dur': 5},
        {'ph': 'X', 'cat': 'cuda_runtime', 'name': 'cudaLaunchKernel', 'ts': 3, 'dur': 1,
         'args': {'correlation': 7}},
        {'ph': 'X', 'cat': 'cuda_runtime', 'name': 'cudaLaunchKernel', 'ts': 9, 'dur': 1,
         'args': {'correlation': 8}},
        {'ph': 'X', 'cat': 'kernel', 'name': 'gather', 'ts': 10, 'dur': 20,
         'args': {'correlation': 7}},
        {'ph': 'X', 'cat': 'kernel', 'name': 'conv', 'ts': 20, 'dur': 30,
         'args': {'correlation': 8}},
        {'ph': 'X', 'cat': 'gpu_memcpy', 'name': 'HtoD', 'ts': 90, 'dur': 30,
         'args': {'correlation': 9}}]
    path = tmp_path / 'trace.json'
    path.write_text(json.dumps({'traceEvents': events}))
    summary = trace_summary(str(path))
    assert summary['steps'] == [3, 4] and summary['device_events'] == 3
    assert summary['window_ms'] == 0.12 and summary['busy_ms'] == 0.07
    assert abs(summary['idle_share'] - 5 / 12) < 1e-12
    assert summary['spans'] == {'pf.data.crop_resize': {  # a step of the two
        'device_ms': 0.01, 'host_ms': 0.0025, 'count': 0.5, 'launches': 0.5}}


def test_no_trace_without_the_flag(tmp_path):
    learner = port_main.main(_argv(tmp_path) + ['--nb_epochs_rat=0.0063'],
                             device='cpu')
    assert not os.path.exists(tmp_path / 'logs' / 'profile')
    assert getattr(learner, 'profile_path', None) is None


def _objective(params):
    return -sum((value - 0.3 * (i + 1)) ** 2 for i, value in enumerate(params.values()))


def _specs(search):
    return [search.ParamSpec('lrn_rate_init', 'FLOAT', 0.0, 1.0),
            search.ParamSpec('momentum', 'FLOAT', 0.0, 1.0),
            search.ParamSpec('ws_mask_update_step', 'LOG10', 50, 2000),
            search.ParamSpec('nb_threads', 'INT', 1, 9)]


@pytest.mark.parametrize('algo', ['GPSearch', 'TPESearch', 'RandomSearch'])
def test_searchers_propose_as_jax(algo):
    from pocketflow_tpu.automl import search as jsearch
    from pocketflow_tpu_torch.automl import search as tsearch
    kwargs = {} if algo == 'RandomSearch' else {'nb_warmup': 3}
    searchers = [getattr(lib, algo)(_specs(lib), seed=7, **kwargs) for lib in (jsearch, tsearch)]
    for _ in range(8):
        want, got = (s.propose() for s in searchers)
        assert got == want and [type(v) for v in got.values()] == \
            [type(v) for v in want.values()]
        for searcher in searchers:
            searcher.update(got, _objective(got))
    if algo != 'RandomSearch':
        assert searchers[1].y == searchers[0].y and len(searchers[1].X) == 8


@pytest.mark.parametrize('algo', ['GP', 'TPE', 'random'])
def test_run_automl_history_as_jax(algo):
    import pocketflow_tpu  # noqa: F401  (registers the flags the trials scope)
    import pocketflow_tpu_torch.learners.weight_sparsification.learner  # noqa: F401
    from pocketflow_tpu.automl import search as jsearch
    from pocketflow_tpu_torch.automl import search as tsearch
    seen = []

    def objective(params):  # the trial runs under its proposal's flags
        seen.append(TFLAGS.ws_mask_update_step)
        return _objective(params)

    want = jsearch.run_automl(_objective, _specs(jsearch)[2:3] + _specs(jsearch)[:1],
                              nb_trials=8, algo=algo, seed=3)
    got = tsearch.run_automl(objective, _specs(tsearch)[2:3] + _specs(tsearch)[:1],
                             nb_trials=8, algo=algo, seed=3)
    assert got == want
    assert seen == [p['ws_mask_update_step'] for p, _ in got[2]]
    with pytest.raises(ValueError, match='unrecognized AutoML algo'):
        tsearch.run_automl(objective, _specs(tsearch), nb_trials=1, algo='anneal')


def test_ws_constraint_and_log10_spec_as_jax():
    from pocketflow_tpu.automl import search as jsearch
    from pocketflow_tpu_torch.automl import search as tsearch
    for beg, end in ((0.8, 0.2), (0.1, 0.9), (0.0, 0.0), (0.9, 1.0)):
        proposal = {'ws_iter_ratio_beg': beg, 'ws_iter_ratio_end': end, 'x': 1}
        fixed = tsearch.ws_constraint(proposal)
        assert fixed == jsearch.ws_constraint(proposal)
        assert fixed['ws_iter_ratio_beg'] <= fixed['ws_iter_ratio_end']
    assert tsearch.WS_SEARCH_SPACE == [tsearch.ParamSpec(**vars(s))
                                       for s in jsearch.WS_SEARCH_SPACE]
    spec, jspec = (lib.ParamSpec('ws_mask_update_step', 'LOG10', 50, 2000)
                   for lib in (tsearch, jsearch))
    rngs = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(20):
        value = spec.sample(rngs[0])
        assert value == jspec.sample(rngs[1]) and 50 <= value <= 2000
    for value in (50.0, 500.0, 2000.0):
        assert spec.to_unit(value) == jspec.to_unit(value)
        assert abs(spec.from_unit(spec.to_unit(value)) - value) < 1e-6 * value


def test_automl_cli_runs_two_random_trials(tmp_path):
    from pocketflow_tpu_torch.automl import cli
    out = tmp_path / 'automl.json'
    best, best_obj, history, seconds = cli.main(
        _argv(tmp_path)[:1] + _argv(tmp_path)[2:] + [
            '--learner=weight-sparse', '--automl_algo=random', '--automl_nb_trials=2',
            '--automl_output=%s' % out, '--nb_epochs_rat=0.0021',
            '--ws_save_path=%s' % (tmp_path / 'ws' / 'model.ckpt'),
            '--ws_prune_ratio_prtl=uniform', '--ws_prune_ratio=0.5'], device='cpu')
    with open(out) as fin:
        result = json.load(fin)
    assert len(result['history']) == 2 and len(seconds) == 2
    assert result['best_params'] == best and result['best_objective'] == best_obj
    assert set(best) == {'ws_prune_ratio_exp', 'ws_iter_ratio_beg', 'ws_iter_ratio_end',
                         'ws_mask_update_step'}
    assert 0.0 <= best_obj <= 1.0 and [o for _, o in history] == \
        [o for _, o in result['history']]
