"""Step time and device-time profile of the port's train step on one GPU.

    python -m pocketflow_tpu_torch.tools.profile_step [--variants qat,full-prec,...]
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

For each variant: 3 warm-up steps, then 3 windows of 10 steps timed on the
host clock and ended by torch.cuda.synchronize(); then 5 steps under
torch.profiler (device activity only), reported per step: the device
window (first kernel start to last kernel end), the device busy time (the
union of kernel and copy intervals), the idle share of the window, kernel
launches, device time by layer (`kernel_category`), and the top kernels.
Last, the device time of one pass of each fake-quant kernel and of its plain
version over the 52 quantized weights of one step (4 bits) and over one bf16
activation 256x256x56x56 (8 bits): the profiler's kernel records of 10
passes, summed and divided by 10, in two repeats.

Prints one JSON object as its last line and writes it to --out if given.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

VARIANTS = {
    'qat': ('uniform', {}),
    'full-prec': ('full-prec', {}),
    'ghost-bn-8': ('uniform', {'bn_stats_subsample': 8}),
    'channel': ('uniform', {'uql_use_buckets': True, 'uql_bucket_type': 'channel'}),
    'split': ('uniform', {'uql_use_buckets': True, 'uql_bucket_type': 'split'}),
    'act8': ('uniform', {'uql_activation_bits': 8}),
}
BATCH = 256
NB_WARMUP, NB_WINDOWS, NB_STEPS, NB_PROFILED = 3, 3, 10, 5
NB_BATCHES = 4

# (layer, substrings of the kernel name), first match wins
CATEGORIES = (
    ('fake-quant kernels', ('minmax_partials', 'quantize_tensor', 'column_partials',
                            'quantize_columns')),
    ('batch norm', ('batch_norm',)),
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


def _card() -> str:
    return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def _device_events(prof):
    """(name, start_us, end_us) of every kernel, copy and memset on the card."""
    out = []
    for event in prof.events():
        if event.device_type == torch.autograd.DeviceType.CUDA:
            out.append((event.name, event.time_range.start, event.time_range.end))
    return out


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


def _profile(fn, nb_steps: int):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(nb_steps):
            fn(i)
        torch.cuda.synchronize()
    return _device_events(prof)


def profile_variant(name: str) -> dict:
    from pocketflow_tpu_torch.config import FLAGS
    from pocketflow_tpu_torch.learners import create_learner
    from pocketflow_tpu_torch.nets.resnet_at_ilsvrc12 import ModelHelper
    learner_name, flags = VARIANTS[name]
    with FLAGS.scope(**flags):
        learner = create_learner(None, ModelHelper(resnet_size=50), learner_name, device='cuda')
        if learner_name == 'uniform':
            state, tx, _ = learner.init_state_quant()
            train_step = learner.build_quant_train_step(tx)
        else:
            state, tx, _ = learner.init_state()
            train_step = learner.build_train_step(tx)
        iterator = learner.dataset_train.build()
        batches = [learner.put_batch(next(iterator)) for _ in range(NB_BATCHES)]
        del iterator

        def step(i):
            nonlocal state, metrics
            state, metrics = train_step(state, batches[i % NB_BATCHES], learner.generator(i))

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
            'ms_per_step': ms,
            'img_per_s': [BATCH * 1e3 / m for m in ms],
            'loss': loss,
            'peak_gib': torch.cuda.max_memory_allocated() / 2 ** 30,
        }
        result['profile'] = summarize(_profile(step, NB_PROFILED), NB_PROFILED)
    if not torch.isfinite(torch.tensor(loss)):
        raise RuntimeError('%s: loss %r' % (name, loss))
    return result


def profile_kernels(weight_shapes, repeats: int = 2, passes: int = 10) -> dict:
    """Device ms of one pass of each fake-quant kernel and its plain version,
    averaged over `passes` passes in one profiled window (a window of one
    pass can come back with some of its records missing)."""
    from pocketflow_tpu_torch.ops import fake_quant as fq
    gen = torch.Generator(device='cuda').manual_seed(0)
    bits4 = torch.tensor(4.0, device='cuda')
    bits8 = torch.tensor(8.0, device='cuda')
    weights = [torch.randn(s, generator=gen, device='cuda') * 0.05 for s in weight_shapes]
    columns = [w.reshape(-1, w.shape[-1]) for w in weights]
    act = torch.relu(torch.randn((256, 256, 56, 56), generator=gen, device='cuda',
                                 dtype=torch.bfloat16)).contiguous(memory_format=torch.channels_last)
    k4, k8 = fq._levels(bits4), fq._levels(bits8)
    fns = {
        'per_tensor kernel, 52 weights': lambda: [fq.fake_quant_per_tensor(w, bits4)
                                                  for w in weights],
        'per_tensor plain, 52 weights': lambda: [fq._quantize_math_torch(w, k4, None)
                                                 for w in weights],
        'per_column kernel, 52 weights as [-1, c_out]': lambda: [
            fq.fake_quant_per_column(c, bits4) for c in columns],
        'per_column plain, 52 weights as [-1, c_out]': lambda: [
            fq._quantize_math_torch(c, k4, 0) for c in columns],
        'split buckets (256) kernel, 52 weights': lambda: [
            fq.fake_quant_split_bucket(w, bits4, 256) for w in weights],
        'per_tensor kernel, bf16 act 256x256x56x56': lambda: fq.fake_quant_per_tensor(act, bits8),
        'per_tensor plain, bf16 act 256x256x56x56': lambda: fq._quantize_math_torch(
            act, k8, None).to(torch.bfloat16),
    }
    out = {}
    for label, fn in fns.items():
        fn()  # build and warm
        torch.cuda.synchronize()
        out[label] = [sum(e - s for _, s, e in _profile(lambda i: fn(), passes)) / passes / 1e3
                      for _ in range(repeats)]
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--variants', default='qat,full-prec,ghost-bn-8,channel,split,act8')
    parser.add_argument('--out', default='')
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('profile_step: needs a CUDA device')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from pocketflow_tpu_torch.config import FLAGS
    # register the flags set below
    import pocketflow_tpu_torch.learners.uniform_quantization.learner  # noqa: F401
    import pocketflow_tpu_torch.nets.resnet_at_ilsvrc12  # noqa: F401
    FLAGS.override(synthetic_data=True, summ_step=10 ** 9, save_step=10 ** 9,
                   resnet_stem_s2d=True, rand_seed=0, batch_size=BATCH, batch_size_eval=BATCH,
                   nb_smpls_train=16 * BATCH, nb_smpls_eval=2 * BATCH, compute_dtype='bfloat16',
                   bn_stats_subsample=1, uql_weight_bits=4, uql_activation_bits=32)
    report = {'card': _card(), 'torch': torch.__version__, 'cuda': torch.version.cuda,
              'batch_size': BATCH, 'variants': {}}
    print('card %s | torch %s cuda %s' % (report['card'], torch.__version__, torch.version.cuda),
          flush=True)
    for name in filter(None, args.variants.split(',')):
        result = profile_variant(name)
        report['variants'][name] = result
        brief = {k: v for k, v in result.items() if k != 'profile'}
        brief.update({k: result['profile'][k] for k in
                      ('window_ms_per_step', 'busy_ms_per_step', 'idle_share',
                       'device_events_per_step', 'by_category_ms_per_step')})
        print('%s %s' % (name, json.dumps(brief)), flush=True)
        torch.cuda.empty_cache()
    from pocketflow_tpu_torch.nets.resnet_at_ilsvrc12 import ModelHelper
    from pocketflow_tpu_torch.learners.uniform_quantization.learner import UniformQuantLearner
    weight_shapes = UniformQuantLearner(None, ModelHelper(resnet_size=50),
                                        device='cuda').statistics['weight_shapes']
    report['kernels_device_ms_per_pass'] = profile_kernels(weight_shapes)
    for label, values in report['kernels_device_ms_per_pass'].items():
        print('device ms %-48s %s' % (label, ['%.4f' % v for v in values]), flush=True)
    if args.out:
        with open(args.out, 'w') as fout:
            json.dump(report, fout, indent=1)
    print(json.dumps(report), flush=True)


if __name__ == '__main__':
    main(sys.argv[1:])
