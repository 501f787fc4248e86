"""The port's program spans (``core/profiling.py:span``) on the CPU.

* without a profiler ``span()`` is the shared no-op, formats nothing, and a
  uniform-tf step, a uniform step and an int8 serving forward of ConvNet @
  FMNIST, and ILSVRC-12's train augmentation, enter no ``record_function``;
* under ``torch.profiler`` (host ops) a step records each ``pf.train.*``
  phase once, one ``pf.quant.act`` a quantized activation site inside
  ``pf.train.forward`` and one ``pf.quant.act_backward`` a site inside
  ``pf.train.backward``; at 32-bit activations no ``pf.quant.act``;
* an int8 serving forward records one ``pf.int8.site <path>`` a site;
* ILSVRC-12's train augmentation of full-frame rows records one
  ``pf.data.crop_resize``, its eval augmentation none;
* a ``--enbl_profiler`` trace through main.main holds the five phases
  inside each ``train_step_<i>``, and ``trace_summary`` counts them;
* ``tools/profile_step.py:span_times`` on a hand-made trace with spans on
  two threads: device time by the launch's correlation id on any thread,
  the detail dropped, host time summed, launches without a device event
  left out.
"""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pocketflow_tpu_torch import main as port_main
from pocketflow_tpu_torch.config import FLAGS
from pocketflow_tpu_torch.core import profiling

torch.set_num_threads(2)
port_main.register_flags()

PHASES = ('pf.train.augment', 'pf.train.forward', 'pf.train.backward', 'pf.train.grad_sync',
          'pf.train.update')
SMALL = dict(batch_size=4, batch_size_eval=4, nb_smpls_train=16, nb_smpls_eval=8,
             synthetic_data=True, compute_dtype='float32', rand_seed=0)
# learner, its flags, and whether its activation sites quantize
STEPS = {
    'uniform-tf': ('uniform-tf', dict(uqtf_quant_delay=0), True),
    'uniform-act8': ('uniform', dict(uql_weight_bits=4, uql_activation_bits=8), True),
    'uniform-act32': ('uniform', dict(uql_weight_bits=4, uql_activation_bits=32), False),
}


@pytest.fixture(autouse=True)
def _port_flags():
    import pocketflow_tpu_torch.learners.uniform_quantization.learner  # noqa: F401
    import pocketflow_tpu_torch.learners.uniform_quantization_tf.learner  # noqa: F401
    with FLAGS.scope(**FLAGS.as_dict()):
        yield


def _step(kind):
    """run() -> one train step of `kind` (STEPS) on ConvNet @ FMNIST, and
    the number of its activation sites."""
    from pocketflow_tpu_torch.learners import create_learner
    from pocketflow_tpu_torch.nets.convnet_at_fmnist import ModelHelper
    learner_name, flags, _ = STEPS[kind]
    with FLAGS.scope(**SMALL, **flags):
        learner = create_learner(None, ModelHelper(), learner_name, device='cpu')
        state, tx, _ = learner.init_state_quant()
        if learner_name == 'uniform-tf':
            step = learner.build_qat_train_step(tx, freeze_bn=False)
        else:
            step = learner.build_quant_train_step(tx)
        batch = learner.put_batch(next(learner.dataset_train.build()))
    box = {'state': state}

    def run():
        with FLAGS.scope(**SMALL, **flags):  # a policy reads its flags at each step
            box['state'], _ = step(box['state'], batch, None)

    run()  # builds what the first step builds
    return run, learner.statistics['nb_activations']


def _int8_forward():
    """forward() -> an int8 serving forward of ConvNet @ FMNIST on the CPU,
    and its int8 sites' paths."""
    from pocketflow_tpu_torch.nets.convnet_at_fmnist import ModelHelper
    from pocketflow_tpu_torch.ops import int8_ops
    with FLAGS.scope(**SMALL):
        helper = ModelHelper()
        model = helper.create_model()
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.eval()
    images = torch.randn((4, 28, 28, 1), generator=torch.Generator().manual_seed(1))
    policy = int8_ops.Int8ServingPolicy(int8_ops.quantize_model_weights(model),
                                        int8_ops.calibrate(model, [images]))

    @torch.no_grad()
    def forward():
        helper.forward_eval(model, images, policy=policy)

    return forward, sorted(policy.act_scales)


def _crop(is_train=True):
    """augment() -> ILSVRC-12's augmentation of two full-frame rows (their
    [label, valid h, valid w] rows), resized to 224x224."""
    from pocketflow_tpu_torch.datasets.ilsvrc12 import Ilsvrc12Dataset
    with FLAGS.scope(batch_size=2, synthetic_data=True, ilsvrc_augment='inception'):
        dataset = Ilsvrc12Dataset(is_train=True)
    packed = {'image': torch.zeros((2, 48, 64, 3), dtype=torch.uint8),
              'label': torch.tensor([[7.0, 40.0, 30.0], [3.0, 48.0, 64.0]])}

    def augment():
        with FLAGS.scope(ilsvrc_augment='inception'):
            dataset.augment_xy(packed, torch.Generator().manual_seed(0), is_train)

    return augment


def _spans(fn):
    """{name: [(start_us, end_us)]} of the program spans recorded while fn() ran."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    out = {}
    for e in prof.events():
        if e.name.startswith(profiling.SPAN_PREFIX):
            out.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    return out


def _inside(inner, outer):
    return all(any(s <= a and b <= t for s, t in outer) for a, b in inner)


def test_span_is_the_shared_noop_without_a_profiler():
    class Unprintable:
        def __str__(self):
            raise AssertionError('the detail was formatted')

    first = profiling.span('train.forward')
    assert first is profiling.span('int8.site', Unprintable()) is profiling._OFF
    with first:
        pass


@pytest.mark.parametrize('kind', sorted(STEPS) + ['int8', 'crop'])
def test_no_record_function_without_a_profiler(monkeypatch, kind):
    run = {'int8': lambda: _int8_forward()[0], 'crop': _crop}.get(kind, lambda: _step(kind)[0])()

    def refuse(*args, **kwargs):
        raise AssertionError('record_function entered with no profiler: %r' % (args,))

    monkeypatch.setattr(torch.profiler, 'record_function', refuse)
    run()


@pytest.mark.parametrize('kind', sorted(STEPS))
def test_profiled_step_records_each_phase_and_site(kind):
    run, nb_sites = _step(kind)
    quantized = STEPS[kind][2]
    spans = _spans(run)
    assert {name: len(spans.get(name, ())) for name in PHASES} == dict.fromkeys(PHASES, 1)
    assert nb_sites > 0
    if not quantized:
        assert 'pf.quant.act' not in spans and 'pf.quant.act_backward' not in spans
        return
    assert len(spans['pf.quant.act']) == nb_sites
    assert len(spans['pf.quant.act_backward']) == nb_sites
    assert _inside(spans['pf.quant.act'], spans['pf.train.forward'])
    assert _inside(spans['pf.quant.act_backward'], spans['pf.train.backward'])
    order = [spans[name][0] for name in PHASES]
    assert all(a[1] <= b[0] for a, b in zip(order, order[1:]))  # siblings, in order


def test_int8_forward_records_one_span_a_site():
    forward, paths = _int8_forward()
    forward()  # prepares the sites
    spans = _spans(forward)
    sites = {name: len(v) for name, v in spans.items() if name.startswith('pf.int8.site ')}
    assert sites == {'pf.int8.site ' + path: 1 for path in paths} and len(paths) >= 3


@pytest.mark.parametrize('is_train', [True, False])
def test_ilsvrc12_crop_resize_records_its_span(is_train):
    spans = _spans(_crop(is_train))
    assert {name: len(v) for name, v in spans.items()} == (
        {'pf.data.crop_resize': 1} if is_train else {})


def test_enbl_profiler_trace_holds_the_phases_inside_each_step(tmp_path):
    from pocketflow_tpu_torch.tools.profile_step import trace_summary
    learner = port_main.main([
        '--model=convnet_at_fmnist', '--learner=full-prec', '--synthetic_data',
        '--batch_size=8', '--batch_size_eval=8', '--nb_smpls_train=48', '--nb_smpls_eval=16',
        '--compute_dtype=float32', '--summ_step=1', '--nb_epochs_rat=0.0063',
        '--log_dir=%s' % (tmp_path / 'logs'),
        '--save_path=%s' % (tmp_path / 'models' / 'model.ckpt'),
        '--enbl_profiler', '--profiler_start_step=2', '--profiler_nb_steps=2'], device='cpu')
    with open(learner.profile_path) as fin:
        events = [e for e in json.load(fin)['traceEvents'] if e.get('cat') == 'user_annotation']
    steps = [(e['ts'], e['ts'] + e['dur']) for e in events
             if e['name'].startswith(profiling.STEP_PREFIX)]
    assert len(steps) == 2
    for name in PHASES:
        spans = [(e['ts'], e['ts'] + e['dur']) for e in events if e['name'] == name]
        assert len(spans) == 2 and all(_inside([span], [step])
                                       for span, step in zip(sorted(spans), sorted(steps)))
    summary = trace_summary(learner.profile_path)
    assert {name: summary['spans'][name]['count'] for name in PHASES} == dict.fromkeys(PHASES, 1)
    assert all(summary['spans'][name]['host_ms'] > 0 for name in PHASES)


def test_span_times_on_two_threads():
    """Forward on thread 1 (0-50 us), backward on thread 1 (50-100) with
    its site's STE backward on thread 2 (60-70), two int8 sites; kernels
    tied to their launches by correlation id; a synchronize (id 9) with no
    device event is no launch."""
    from pocketflow_tpu_torch.tools.profile_step import span_times

    def annotation(name, ts, dur, tid):
        return {'ph': 'X', 'cat': 'user_annotation', 'name': name, 'ts': ts, 'dur': dur,
                'tid': tid}

    def launch(ts, corr, tid=1, cat='cuda_runtime'):
        return {'ph': 'X', 'cat': cat, 'name': 'cudaLaunchKernel', 'ts': ts, 'dur': 1,
                'tid': tid, 'args': {'correlation': corr}}

    def kernel(ts, dur, corr):
        return {'ph': 'X', 'cat': 'kernel', 'name': 'k%d' % corr, 'ts': ts, 'dur': dur,
                'args': {'correlation': corr}}

    events = [
        annotation('pf.train.forward', 0, 50, 1), annotation('pf.train.backward', 50, 50, 1),
        annotation('pf.quant.act_backward', 60, 10, 2),
        annotation('pf.int8.site conv1', 5, 10, 1), annotation('pf.int8.site conv2', 20, 10, 1),
        annotation('pfbench.step', 0, 100, 1), annotation('train_step_3', 0, 100, 1),
        launch(6, 1), launch(21, 2), launch(40, 3, cat='cuda_driver'), launch(55, 4),
        launch(62, 5, tid=2), launch(80, 9), launch(120, 6),
        kernel(10, 4, 1), kernel(30, 6, 2), kernel(45, 5, 3), kernel(70, 20, 4),
        kernel(90, 3, 5), kernel(130, 7, 6),
        {'ph': 'X', 'cat': 'gpu_memcpy', 'name': 'copy', 'ts': 100, 'dur': 2,
         'args': {'correlation': 5}}]
    got = span_times(events)
    assert got == {
        'pf.train.forward': {'device_ms': 0.015, 'host_ms': 0.05, 'count': 1, 'launches': 3},
        'pf.train.backward': {'device_ms': 0.025, 'host_ms': 0.05, 'count': 1, 'launches': 2},
        'pf.quant.act_backward': {'device_ms': 0.005, 'host_ms': 0.01, 'count': 1,
                                  'launches': 1},
        'pf.int8.site': {'device_ms': 0.01, 'host_ms': 0.02, 'count': 2, 'launches': 2}}
    assert span_times(events, 2)['pf.int8.site']['count'] == 1
