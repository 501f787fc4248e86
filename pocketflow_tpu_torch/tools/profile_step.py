"""Step time and device-time profile of the port's train step on one GPU.

    python -m pocketflow_tpu_torch.tools.profile_step [--variants qat,pruned-qat,...]
        [--out FILE]

Each variant is ResNet-50 at 224x224, bf16, batch 256, exact BN,
space-to-depth stem, synthetic ILSVRC-12 and random weights from seed 0 (the
settings of bench.py and chip_smoke.py), with the flags below on top:

    qat          UniformQuantLearner, 4-bit weights (the main path)
    full-prec    FullPrecLearner: no fake-quant
    ghost-bn-8   qat with --bn_stats_subsample=8
    channel      qat with --uql_use_buckets --uql_bucket_type=channel
    split        qat with --uql_use_buckets --uql_bucket_type=split
    act8         qat with --uql_activation_bits=8
    pruned-qat   qat composed with channel masks, as bench.py's pruned+QAT
                 step: half the input channels of every conv kernel with more
                 than 16 of them masked, masked gradients, and the masks
                 re-applied after each update

and ResNet-20 @ CIFAR-10 at batch 128, bf16, synthetic CIFAR-10 (the
chip smoke's runs A-C):

    r20-full-prec  FullPrecLearner
    r20-qat        UniformQuantLearner, 4-bit weights
    r20-qat-dst    r20-qat with distillation from a teacher of random weights
    r20-act8-dst   r20-qat-dst with --uql_activation_bits=8
    r20-ws         WeightSparseLearner's step, uniform ratio 0.5, no mask
                   refresh (masked gradients, the masks re-applied)
    r20-ws-refresh r20-ws with a mask refresh (masking.prune_update) every step

and MobileNet-v1 @ ILSVRC-12 at depth multiplier 1.0, 224x224, bf16, batch
256, synthetic data (the chip smoke's runs K and M):

    mbv1-full-prec   FullPrecLearner: no fake-quant (the uniform-tf step
                     before its quant delay does the same work)
    mbv1-uqtf        UniformQuantTFLearner's step, 8/8 bits, past the quant
                     delay: one grouped K2' launch pair for the 28 weights,
                     fake_quant_with_range on the 27 relu6 outputs, BN training
    mbv1-uqtf-frozen the same step with BN frozen (the eval-mode forward)
    mbv1-nuq         NonUniformQuantLearner's step: 4-bit codebooks on 26
                     weights, 8-bit activations (K1' with the select on each
                     of the 27 relu6 outputs), weights and codebooks trained

and the detectors at 300x300, bf16, the Pascal VOC spec's batch of 32,
synthetic VOC (the chip smoke's phase 24):

    ssd-full-prec    SSD-VGG16, FullPrecLearner
    ssd-qat          SSD-VGG16, UniformQuantLearner, 4-bit weights (one grouped
                     K1' launch pair for its 33 weights)
    ssd-act8         ssd-qat with --uql_activation_bits=8 (K1' with the select
                     on each of the 23 relu outputs)
    frcnn-full-prec  Faster R-CNN, ResNet-50 trunk, FullPrecLearner (300
                     proposals from 1,024 pre-NMS, 128 sampled ROIs an image),
                     at --lrn_rate_init=0.01: the default rate diverges from
                     random weights within a few steps

whose profiles also give, from NB_PROFILED more steps with the host's ops
recorded, the device time of kernels launched inside three named parts of
the step (`by_range_ms_per_step`, with their kernel launches): each helper's calc_loss ('matching and loss': anchor matching,
targets, mining and the loss's forward), Faster R-CNN's proposal layer
('proposal layer': top-k and nms_fixed) and its ROI-align ('roi-align',
forward; the backward runs outside the range),

and the DDPG agent of the RL searches (`ddpg`: one `train` update a step,
state 29 wide as ResNet-20's weight-sparsification search, batch 64, a full
buffer of 1,100 transitions).

For each variant: 3 warm-up steps, then 3 windows of 10 steps timed on the
host clock and ended by torch.cuda.synchronize(); then 5 steps under
torch.profiler (device activity only), reported per step: the device
window (first kernel start to last kernel end), the device busy time (the
union of kernel and copy intervals), the idle share of the window, kernel
launches, device time by layer (`kernel_category`), and the top kernels.
Last, the device time of one pass of each hand-written kernel and of its
plain version: the fake-quant kernels over the 52 quantized weights of one
step (4 bits; the grouped routes, per tensor and in channel and split
buckets, and the per-site routes they replaced: a per-site op and a select
on each weight), over one bf16 activation 256x256x56x56 and one
256x2048x7x7 (8 bits; K1' with and without the select, and the select after
the plain version); matmul_bf16 over the 8 ResNet-50 1x1 shapes of
mm_shape_sweep, beside cuBLAS's bf16 matmul; bn_relu_matmul_stats at
fused_mm_proto's shape, beside matmul_bf16 and cuBLAS on the same x and w.
Each is the profiler's kernel records of 10
passes, summed and divided by 10, in two repeats, and the last repeat
kernel by kernel.

With --depthwise, MobileNet-v1's 13 depthwise convs alone at batch 256
(bf16, channels-last): their device time forward and forward + backward
(CUDA events), and one pass's device time by kernel.

Prints one JSON object as its last line and writes it to --out if given.  A
variant named twice (to time two variants in turns, A B B A) is reported
as name#2 the second time.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from pocketflow_tpu_torch.core.cuda_timing import card_line

VARIANTS = {
    'qat': ('uniform', {}),
    'full-prec': ('full-prec', {}),
    'ghost-bn-8': ('uniform', {'bn_stats_subsample': 8}),
    'channel': ('uniform', {'uql_use_buckets': True, 'uql_bucket_type': 'channel'}),
    'split': ('uniform', {'uql_use_buckets': True, 'uql_bucket_type': 'split'}),
    'act8': ('uniform', {'uql_activation_bits': 8}),
    'pruned-qat': ('uniform', {}),
    'r20-full-prec': ('full-prec', {}),
    'r20-qat': ('uniform', {}),
    'r20-qat-dst': ('uniform', {}),
    'r20-act8-dst': ('uniform', {'uql_activation_bits': 8}),
    'r20-ws': ('weight-sparse', {'ws_mask_update_step': 10 ** 9}),
    'r20-ws-refresh': ('weight-sparse', {'ws_mask_update_step': 1, 'ws_iter_ratio_beg': 0.0,
                                         'ws_iter_ratio_end': 1.0}),
    'mbv1-full-prec': ('full-prec', {}),
    'mbv1-uqtf': ('uniform-tf', {'uqtf_quant_delay': 0}),
    'mbv1-uqtf-frozen': ('uniform-tf', {'uqtf_quant_delay': 0}),
    'mbv1-nuq': ('non-uniform', {'nuql_weight_bits': 4, 'nuql_init_style': 'kmeans',
                                 'nuql_activation_bits': 8, 'nuql_opt_mode': 'both'}),
    'ssd-full-prec': ('full-prec', {}),
    'ssd-qat': ('uniform', {}),
    'ssd-act8': ('uniform', {'uql_activation_bits': 8}),
    'frcnn-full-prec': ('full-prec', {'frcnn_backbone': 'resnet50', 'lrn_rate_init': 0.01}),
    'ddpg': (None, {}),
}
DET_BATCH = 32
# the parts of a detection step the profiler names (record_function ranges)
RANGES = ('matching and loss', 'proposal layer', 'roi-align')
DDPG_S_DIMS, DDPG_BUF_SIZE, DDPG_BATCH = 29, 1100, 64
R20_BATCH = 128
BATCH = 256
NB_WARMUP, NB_WINDOWS, NB_STEPS, NB_PROFILED = 3, 3, 10, 5
NB_BATCHES = 4

# (layer, substrings of the kernel name), first match wins
CATEGORIES = (
    ('fake-quant kernels', ('tensor_minmax', 'tensor_quantize', 'minmax_partials',
                            'group_quantize', 'column_group_partials', 'column_group_quantize')),
    ('batch norm', ('batch_norm',)),
    # cuDNN's depthwise kernels: conv2d_c1_k1_nhwc, dgrad2d_..., wgrad2d_...
    ('depthwise conv', ('depthwise', 'c1_k1_nhwc')),
    ('optimizer (foreach)', ('multi_tensor_apply', 'foreach')),
    ('conv/matmul (cuDNN, cuBLAS)', ('xmma', 'gemm', 'nvjet', 'cutlass', 'cudnn', 'conv2d',
                                     'implicit_convolve', 'sm90_', 'sm80_')),
    ('pooling', ('pool',)),
    ('copies/layout/pad', ('copy', 'Memcpy', 'Memset', 'nchwToNhwc', 'nhwcToNchw',
                           'transpose', 'pad', 'CatArray', 'cat_')),
    ('reductions/indexing', ('reduce_kernel', 'index', 'scatter', 'gather')),
    ('elementwise', ('elementwise',)),
)


def kernel_category(name: str) -> str:
    for category, keys in CATEGORIES:
        if any(key in name for key in keys):
            return category
    return 'other'


def device_events(prof):
    """(name, start_us, end_us) of every kernel, copy and memset on the card
    (not the ranges' annotations)."""
    out = []
    for event in prof.events():
        if event.device_type == torch.autograd.DeviceType.CUDA and event.name not in RANGES:
            out.append((event.name, event.time_range.start, event.time_range.end))
    return out


def range_times(prof, nb_steps: int) -> dict:
    """{range: {'ms_per_step', 'kernels_per_step'}}: the device time and the
    launches of the kernels each named range (RANGES) launched, its ops'
    included, from the profiler's CPU events."""
    def kernels(event):
        return len(event.kernels) + sum(kernels(child) for child in event.cpu_children)

    out = {}
    for event in prof.events():
        if event.device_type == torch.autograd.DeviceType.CPU and event.name in RANGES:
            entry = out.setdefault(event.name, {'ms_per_step': 0.0, 'kernels_per_step': 0.0})
            entry['ms_per_step'] += event.device_time_total / nb_steps / 1e3
            entry['kernels_per_step'] += kernels(event) / nb_steps
    return out


@contextlib.contextmanager
def detection_ranges():
    """Name the parts of a detection step for the profiler (RANGES), for the
    block: both helpers' calc_loss, faster_rcnn.propose and roi_align."""
    from pocketflow_tpu_torch.nets import faster_rcnn_at_pascalvoc, vgg_at_pascalvoc
    from pocketflow_tpu_torch.nets.detection import faster_rcnn
    from torch.profiler import record_function

    def named(label, fn):
        def wrapped(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)
        return wrapped

    patches = [(vgg_at_pascalvoc.ModelHelper, 'calc_loss', 'matching and loss'),
               (faster_rcnn_at_pascalvoc.ModelHelper, 'calc_loss', 'matching and loss'),
               (faster_rcnn, 'propose', 'proposal layer'),
               (faster_rcnn, 'roi_align', 'roi-align')]
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in patches]
    for owner, attr, label in patches:
        setattr(owner, attr, named(label, getattr(owner, attr)))
    try:
        yield
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def _busy_us(events) -> float:
    busy, end = 0.0, None
    for _, s, e in sorted(events, key=lambda t: t[1]):
        if end is None or s >= end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def summarize(events, nb_steps: int, nb_top: int = 12) -> dict:
    """Per-step device metrics of a profiled run of `nb_steps` steps."""
    if not events:
        raise RuntimeError('the profiler recorded no device activity')
    window = max(e for _, _, e in events) - min(s for _, s, _ in events)
    busy = _busy_us(events)
    by_category, by_kernel = {}, {}
    for name, s, e in events:
        category = kernel_category(name)
        by_category[category] = by_category.get(category, 0.0) + (e - s)
        by_kernel[name] = by_kernel.get(name, 0.0) + (e - s)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:nb_top]
    return {
        'window_ms_per_step': window / nb_steps / 1e3,
        'busy_ms_per_step': busy / nb_steps / 1e3,
        'idle_share': 1.0 - busy / window,
        'device_events_per_step': len(events) / nb_steps,
        'by_category_ms_per_step': {k: v / nb_steps / 1e3 for k, v in
                                    sorted(by_category.items(), key=lambda kv: -kv[1])},
        'top_kernels_ms_per_step': [(k[:120], v / nb_steps / 1e3, kernel_category(k))
                                    for k, v in top],
    }


def _profile(fn, nb_steps: int, ranges: bool = False):
    """The device events of `nb_steps` calls of fn(i) under the profiler, and
    with `ranges` (the host's ops recorded too, the detection ranges named)
    their ranges' times."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if ranges else [])
    with contextlib.ExitStack() as stack:
        if ranges:
            stack.enter_context(detection_ranges())
        prof = stack.enter_context(profile(activities=activities))
        for i in range(nb_steps):
            fn(i)
        torch.cuda.synchronize()
    return device_events(prof), (range_times(prof, nb_steps) if ranges else None)


def ddpg_step():
    """(train_step, batch size) of a DDPG agent on the card with a full buffer
    of random transitions (numpy, seed 0): one `train` update a step."""
    import numpy as np
    from pocketflow_tpu_torch.rl_agents.ddpg.agent import DdpgAgent
    rng = np.random.default_rng(0)
    agent = DdpgAgent(s_dims=DDPG_S_DIMS, a_dims=1, nb_rlouts=200, buf_size=DDPG_BUF_SIZE,
                      seed=0, device='cuda')
    agent.init()
    states = rng.uniform(size=(DDPG_BUF_SIZE + 1, DDPG_S_DIMS))
    agent.record(states[:-1], rng.uniform(size=(DDPG_BUF_SIZE, 1)),
                 rng.normal(size=DDPG_BUF_SIZE), np.zeros(DDPG_BUF_SIZE), states[1:])

    def train_step(state, batch, generator):
        del batch, generator
        actor_loss, critic_loss, _ = agent.train()
        return state, {'loss': torch.tensor(actor_loss + critic_loss)}

    return train_step, DDPG_BATCH


def profile_variant(name: str) -> dict:
    from pocketflow_tpu_torch.config import FLAGS
    from pocketflow_tpu_torch.learners import create_learner
    from pocketflow_tpu_torch.learners.weight_sparsification import masking
    from pocketflow_tpu_torch.nets import (
        faster_rcnn_at_pascalvoc, mobilenet_at_ilsvrc12, resnet_at_cifar10, resnet_at_ilsvrc12,
        vgg_at_pascalvoc)
    learner_name, flags = VARIANTS[name]
    if learner_name is None:  # the DDPG agent
        train_step, batch_size = ddpg_step()
        return time_and_profile(name, train_step, None, [None], batch_size)
    detection = name.startswith(('ssd-', 'frcnn-'))
    batch_size = R20_BATCH if name.startswith('r20-') else DET_BATCH if detection else BATCH
    with FLAGS.scope(batch_size=batch_size, batch_size_eval=batch_size,
                     nb_smpls_train=(4 if detection else 16) * batch_size, **flags):
        if name.startswith('ssd-'):
            helper = vgg_at_pascalvoc.ModelHelper()
        elif name.startswith('frcnn-'):
            helper = faster_rcnn_at_pascalvoc.ModelHelper()
        elif name.startswith('r20-'):
            helper = resnet_at_cifar10.ModelHelper(resnet_size=20)
        elif name.startswith('mbv1-'):
            helper = mobilenet_at_ilsvrc12.ModelHelper(version=1, depth_mult=1.0)
        else:
            helper = resnet_at_ilsvrc12.ModelHelper(resnet_size=50)
        learner = create_learner(None, helper, learner_name, device='cuda')
        if name.endswith('-dst'):
            from pocketflow_tpu_torch.learners.distillation_helper import DistillationHelper
            teacher = learner.create_model().state_dict()
            learner.helper_dst = DistillationHelper(helper, learner.device, teacher)
        if name == 'pruned-qat':
            from pocketflow_tpu_torch.learners.weight_sparsification.pruned_qat import (
                build_pruned_qat_step, channel_masks)
            state, tx, _ = learner.init_state_quant()
            state, train_step = build_pruned_qat_step(learner, tx, state,
                                                      channel_masks(state.model))
        elif learner_name in ('uniform', 'non-uniform'):
            state, tx, _ = learner.init_state_quant()
            train_step = learner.build_quant_train_step(tx)
        elif learner_name == 'uniform-tf':
            state, tx, _ = learner.init_state_quant()
            train_step = learner.build_qat_train_step(tx, freeze_bn=name.endswith('-frozen'))
        elif learner_name == 'weight-sparse':
            state, tx, _ = learner.init_state()
            params = dict(state.model.named_parameters())
            state, train_step = learner.build_sparse_train_step(
                tx, state, {n: 0.5 for n in masking.maskable_paths(params)})
        else:
            state, tx, _ = learner.init_state()
            train_step = learner.build_train_step(tx)
        iterator = learner.dataset_train.build()
        batches = [learner.put_batch(next(iterator)) for _ in range(NB_BATCHES)]
        del iterator
        return time_and_profile(name, train_step, state, batches, batch_size, learner.generator,
                                ranges=detection)


def time_and_profile(name, train_step, state, batches, batch_size, generator=lambda i: None,
                     ranges: bool = False):
    """Warm-up steps, NB_WINDOWS timed windows of NB_STEPS steps, then
    NB_PROFILED steps under the profiler (with `ranges`, the detection
    ranges named and timed); the variant's record."""
    def step(i):
        nonlocal state, metrics
        state, metrics = train_step(state, batches[i % len(batches)], generator(i))

    metrics = None
    for i in range(NB_WARMUP):
        step(i)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(NB_WINDOWS):
        start = time.perf_counter()
        for i in range(NB_STEPS):
            step(i)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - start) / NB_STEPS)
    loss = float(metrics['loss'])
    result = {
        'batch_size': batch_size,
        'ms_per_step': ms,
        'img_per_s': [batch_size * 1e3 / m for m in ms],
        'loss': loss,
        'peak_gib': torch.cuda.max_memory_allocated() / 2 ** 30,
    }
    result['profile'] = summarize(_profile(step, NB_PROFILED)[0], NB_PROFILED)
    if ranges:  # a window of its own: recording the host's ops slows the host
        result['profile']['by_range_ms_per_step'] = _profile(step, NB_PROFILED, True)[1]
    if not torch.isfinite(torch.tensor(loss)):
        raise RuntimeError('%s: loss %r' % (name, loss))
    return result


def profile_kernels(weight_shapes, repeats: int = 2, passes: int = 10) -> dict:
    """Device ms of one pass of each hand-written kernel and its plain version,
    averaged over `passes` passes in one profiled window (a window of one
    pass can come back with some of its records missing), `repeats` times;
    and the last repeat's ms by kernel name."""
    from pocketflow_tpu_torch.ops import fake_quant as fq
    gen = torch.Generator(device='cuda').manual_seed(0)
    bits4 = torch.tensor(4.0, device='cuda')
    bits8 = torch.tensor(8.0, device='cuda')
    weights = [torch.randn(s, generator=gen, device='cuda') * 0.05 for s in weight_shapes]
    columns = [w.reshape(-1, w.shape[-1]) for w in weights]  # channel buckets
    acts = {shape: torch.relu(torch.randn(shape, generator=gen, device='cuda',
                                          dtype=torch.bfloat16)).contiguous(
                                              memory_format=torch.channels_last)
            for shape in ((256, 256, 56, 56), (256, 2048, 7, 7))}
    k4, k8 = fq._levels(bits4), fq._levels(bits8)
    bits4_each = torch.full((len(weights),), 4.0, device='cuda')
    fns = {
        'per_tensor kernel, 52 weights': lambda: [fq.fake_quant_per_tensor(w, bits4)
                                                  for w in weights],
        'per_tensor plain, 52 weights': lambda: [fq._quantize_math_torch(w, k4, None)
                                                 for w in weights],
        'per_tensor_group kernel, 52 weights': lambda: fq.fake_quant_per_tensor_group(
            weights, bits4_each),
        'per-site route (per_tensor kernel + select), 52 weights': lambda: [
            torch.where(bits4 < 32, fq.fake_quant_per_tensor(w, bits4), w) for w in weights],
        'per_column plain, 52 weights as [-1, c_out]': lambda: [
            fq._quantize_math_torch(c, k4, 0) for c in columns],
        'per_column_group kernel, 52 weights, channel buckets': lambda: (
            fq.fake_quant_per_column_group(weights, bits4_each)),
        'per-site channel route (per-site op + select), 52 weights': lambda: [
            torch.where(bits4 < 32, fq.fake_quant_channel_bucket(w, bits4), w) for w in weights],
        'per_column_group kernel, 52 weights, split buckets (256)': lambda: (
            fq.fake_quant_per_column_group(weights, bits4_each, 256)),
        'per-site split route (per-site op + select), 52 weights': lambda: [
            torch.where(bits4 < 32, fq.fake_quant_split_bucket(w, bits4, 256), w)
            for w in weights],
    }
    for shape, act in acts.items():
        name = 'x'.join(map(str, shape))
        fns.update({
            'per_tensor kernel, bf16 act %s' % name: lambda act=act: (
                fq.fake_quant_per_tensor(act, bits8)),
            'per_tensor kernel + select, bf16 act %s' % name: lambda act=act: (
                fq.fake_quant_per_tensor(act, bits8, select=True)),
            'per_tensor plain + select, bf16 act %s' % name: lambda act=act: torch.where(
                bits8 < 32, fq._quantize_math_torch(act, k8, None).to(torch.bfloat16), act),
        })
    from pocketflow_tpu_torch.experiments import fused_mm_proto, mm_shape_sweep
    from pocketflow_tpu_torch.ops import matmul as mm
    products = [(torch.randn((m, k), generator=gen, device='cuda').to(torch.bfloat16),
                 (torch.randn((k, n), generator=gen, device='cuda') * 0.05).to(torch.bfloat16))
                for m, k, n in mm_shape_sweep.SHAPES]
    fused_in = fused_mm_proto.inputs(fused_mm_proto.M, fused_mm_proto.K, fused_mm_proto.N, 'cuda')
    fns.update({
        'matmul_bf16 kernel, 8 sweep shapes': lambda: [mm.matmul_bf16(x, w) for x, w in products],
        'matmul_bf16 plain, 8 sweep shapes': lambda: [mm._matmul_plain(x, w)
                                                      for x, w in products],
        'cuBLAS bf16 matmul, 8 sweep shapes': lambda: [torch.matmul(x, w) for x, w in products],
        'bn_relu_matmul_stats kernel, M=%d K=%d N=%d' % (
            fused_mm_proto.M, fused_mm_proto.K, fused_mm_proto.N): lambda: mm.bn_relu_matmul_stats(
                *fused_in),
        'bn_relu_matmul_stats plain, M=%d K=%d N=%d' % (
            fused_mm_proto.M, fused_mm_proto.K, fused_mm_proto.N):
            lambda: mm._bn_relu_matmul_stats_plain(*fused_in),
        'matmul_bf16 kernel, bn_relu_matmul_stats\'s x and w': lambda: mm.matmul_bf16(
            *fused_in[:2]),
        'cuBLAS bf16 matmul, bn_relu_matmul_stats\'s x and w': lambda: torch.matmul(
            *fused_in[:2]),
    })
    out, by_name = {}, {}
    for label, fn in fns.items():
        fn()  # build and warm
        torch.cuda.synchronize()
        out[label] = []
        for _ in range(repeats):
            events = _profile(lambda i: fn(), passes)[0]
            out[label].append(sum(e - s for _, s, e in events) / passes / 1e3)
        by_name[label] = {}  # the last repeat, kernel by kernel
        for name, s, e in events:
            name = name.replace('(anonymous namespace)::', '').split('(')[0][:60]
            by_name[label][name] = by_name[label].get(name, 0.0) + (e - s) / passes / 1e3
    return out, by_name


def depthwise_ms(nb_reps: int = 10) -> dict:
    """MobileNet-v1's 13 depthwise convs alone at depth multiplier 1.0,
    224x224, batch BATCH, bf16 channels-last inputs: the device ms of all of
    them forward, and forward + backward (input and kernel gradients), by
    CUDA events over nb_reps passes, and one pass's device ms by kernel name
    (the profiler's records)."""
    from pocketflow_tpu_torch.core.cuda_timing import time_ms
    from pocketflow_tpu_torch.nets.mobilenet_at_ilsvrc12 import ModelHelper
    from pocketflow_tpu_torch.nn.layers import PFDepthwiseConv
    model = ModelHelper(version=1, depth_mult=1.0).create_model()
    model.reset_parameters(torch.Generator().manual_seed(0))
    model = model.to('cuda').eval()
    shapes = {}

    def record(module, args):
        shapes[module] = tuple(args[0].shape)

    hooks = [m.register_forward_pre_hook(record) for m in model.modules()
             if isinstance(m, PFDepthwiseConv)]
    with torch.no_grad():
        model(torch.zeros((BATCH, 224, 224, 3), device='cuda'))
    for hook in hooks:
        hook.remove()
    layers = [(m, torch.randn(shape, device='cuda', dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last).requires_grad_(True)) for m, shape in shapes.items()]

    def forward():
        return [m.conv_fn(x, m.kernel.to(torch.bfloat16)) for m, x in layers]

    grads = [torch.randn_like(y) for y in forward()]
    wrt = [x for _, x in layers] + [m.kernel for m, _ in layers]

    def forward_backward(_=None):  # the gradients returned, not accumulated into .grad
        return torch.autograd.grad(forward(), wrt, grads)

    out = {'layers': len(layers), 'input_shapes': [list(s) for s in shapes.values()],
           'forward_ms': time_ms(forward, nb_reps),
           'forward_backward_ms': time_ms(forward_backward, nb_reps), 'by_kernel_ms': {}}
    for name, s, e in _profile(forward_backward, 1)[0]:
        name = name.replace('(anonymous namespace)::', '').split('(')[0][:100]
        out['by_kernel_ms'][name] = out['by_kernel_ms'].get(name, 0.0) + (e - s) / 1e3
    return out


def resnet50_weight_shapes():
    """The 52 quantized weight shapes of the QAT ResNet-50 step."""
    from pocketflow_tpu_torch.learners.uniform_quantization.learner import UniformQuantLearner
    from pocketflow_tpu_torch.nets.resnet_at_ilsvrc12 import ModelHelper
    return UniformQuantLearner(None, ModelHelper(resnet_size=50),
                               device='cuda').statistics['weight_shapes']


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--variants',
                        default='qat,full-prec,ghost-bn-8,channel,split,act8,pruned-qat')
    parser.add_argument('--out', default='')
    parser.add_argument('--skip_kernels', action='store_true',
                        help='profile the variants only, not the kernels one by one')
    parser.add_argument('--depthwise', action='store_true',
                        help="time MobileNet-v1's depthwise convs alone at batch 256")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('profile_step: needs a CUDA device')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from pocketflow_tpu_torch.config import FLAGS
    # register the flags set below
    import pocketflow_tpu_torch.learners.nonuniform_quantization.learner  # noqa: F401
    import pocketflow_tpu_torch.learners.uniform_quantization.learner  # noqa: F401
    import pocketflow_tpu_torch.learners.uniform_quantization_tf.learner  # noqa: F401
    import pocketflow_tpu_torch.learners.weight_sparsification.learner  # noqa: F401
    import pocketflow_tpu_torch.nets.mobilenet_at_ilsvrc12  # noqa: F401
    import pocketflow_tpu_torch.nets.resnet_at_cifar10  # noqa: F401
    import pocketflow_tpu_torch.nets.resnet_at_ilsvrc12  # noqa: F401
    import pocketflow_tpu_torch.nets.faster_rcnn_at_pascalvoc  # noqa: F401
    import pocketflow_tpu_torch.nets.vgg_at_pascalvoc  # noqa: F401
    FLAGS.override(synthetic_data=True, summ_step=10 ** 9, save_step=10 ** 9,
                   resnet_stem_s2d=True, rand_seed=0, batch_size=BATCH, batch_size_eval=BATCH,
                   nb_smpls_train=16 * BATCH, nb_smpls_eval=2 * BATCH, compute_dtype='bfloat16',
                   bn_stats_subsample=1, uql_weight_bits=4, uql_activation_bits=32)
    report = {'card': card_line(), 'torch': torch.__version__, 'cuda': torch.version.cuda,
              'batch_size': BATCH, 'variants': {}}
    print('card %s | torch %s cuda %s' % (report['card'], torch.__version__, torch.version.cuda),
          flush=True)
    for name in filter(None, args.variants.split(',')):
        result = profile_variant(name)
        runs = sum(key.split('#')[0] == name for key in report['variants'])
        report['variants'][name if not runs else '%s#%d' % (name, runs + 1)] = result
        brief = {k: v for k, v in result.items() if k != 'profile'}
        brief.update({k: result['profile'][k] for k in
                      ('window_ms_per_step', 'busy_ms_per_step', 'idle_share',
                       'device_events_per_step', 'by_category_ms_per_step',
                       'by_range_ms_per_step') if k in result['profile']})
        print('%s %s' % (name, json.dumps(brief)), flush=True)
        torch.cuda.empty_cache()
    if args.depthwise:
        report['depthwise'] = depthwise_ms()
        print('depthwise %s' % json.dumps(report['depthwise']), flush=True)
    if not args.skip_kernels:
        report.update(zip(('kernels_device_ms_per_pass', 'kernels_device_ms_by_name'),
                          profile_kernels(resnet50_weight_shapes())))
        for label, values in report['kernels_device_ms_per_pass'].items():
            print('device ms %-48s %s' % (label, ['%.4f' % v for v in values]), flush=True)
            print('    by kernel %s' % {name: round(ms, 4) for name, ms in
                                        report['kernels_device_ms_by_name'][label].items()})
    if args.out:
        with open(args.out, 'w') as fout:
            json.dump(report, fout, indent=1)
    print(json.dumps(report), flush=True)


if __name__ == '__main__':
    main(sys.argv[1:])
