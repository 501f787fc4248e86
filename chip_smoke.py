"""Smoke run of the PyTorch port on one NVIDIA GPU: python3 chip_smoke.py

Builds the port's CUDA kernels from pocketflow_tpu_torch/csrc, holds each
against its plain PyTorch version on the card, drives the main path (the QAT
ResNet-50 train step of UniformQuantLearner at bench.py's settings: 224x224,
bf16, batch 256, exact BN, space-to-depth stem, synthetic ILSVRC-12, 4-bit
weights) and its other quantization routes, and checks that every quantized
weight and activation went through the kernels.  Any failed phase raises and
the script exits non-zero without its last line.  The last line is

    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": <n>}}

and the line before it lists each kernel with its launches, its largest
difference from the plain version, and both times.  `launches` counts one
run, which `run` names: for fake_quant_per_tensor the main path's 13 train
steps (the counters are reset just before them and read just after, before
the eval step), for fake_quant_per_column the 2 steps under channel buckets,
the route that launches it (the main path does not).  `launches_by_run`
gives every kernel's count in each run, each counted from its own reset.
"""

import json
import math
import subprocess
import sys
import time

import torch

SOURCE = 'pocketflow_tpu_torch/csrc/fake_quant.cu'
REPLACES = {
    'fake_quant_per_tensor': 'pocketflow_tpu/ops/fake_quant.py:84 (_fq_pallas_2d)',
    'fake_quant_per_column': 'pocketflow_tpu/ops/fake_quant.py:108 (_fq_pallas_cols_grid)',
}
BATCH = 256
N_WARMUP, N_TIMED = 3, 10
MAIN_RUN = 'main path: %d QAT train steps, per-tensor 4-bit weights' % (N_WARMUP + N_TIMED)
NB_WEIGHT_SITES, NB_ACT_SITES = 52, 49


def log(msg, *args):
    print(msg % args if args else msg, flush=True)


def check(cond, msg, *args):
    if not cond:
        raise RuntimeError('check failed: ' + (msg % args if args else msg))


def card_line():
    return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps=20):
    """Mean device time of fn() over `reps` back-to-back calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(got, want, alpha_over_k):
    """Max |got - want| and the number of differing elements.  Equal is the
    rule; a difference is allowed only as one quantization step at a
    rounding tie, in at most 1e-5 of the elements."""
    diff = (got.to(torch.float32) - want.to(torch.float32)).abs()
    n_diff = int((diff > 0).sum())
    max_err = float(diff.max())
    step = float(alpha_over_k.max()) if torch.is_tensor(alpha_over_k) else alpha_over_k
    check(n_diff <= max(1, got.numel() // 100000) and max_err <= step * 1.001 + 1e-6,
          'kernel differs from plain: %d elements, max %.3g', n_diff, max_err)
    return max_err, n_diff


def phase_kernels(fq, weight_shapes, device):
    """Phase 3: each kernel against the plain version, at main-path shapes."""
    results = {name: {'max_abs_err': 0.0} for name in REPLACES}
    gen = torch.Generator(device=device).manual_seed(0)
    distinct = sorted(set(weight_shapes))
    for bits_value in (2, 4, 8):
        bits = torch.tensor(float(bits_value), device=device)
        k = fq._levels(bits)
        for shape in distinct:
            w = torch.randn(shape, generator=gen, device=device) * 0.05
            # per tensor (K1')
            want = fq._quantize_math_torch(w, k, None)
            err, nd = compare(fq.fake_quant_per_tensor(w, bits), want,
                              (w.max() - w.min()) / k)
            results['fake_quant_per_tensor']['max_abs_err'] = max(
                results['fake_quant_per_tensor']['max_abs_err'], err)
            # channel buckets (K2' on reshape(-1, c_out))
            cols = w.reshape(-1, shape[-1])
            want = fq._quantize_math_torch(cols, k, 0)
            err_c, nd_c = compare(fq.fake_quant_per_column(cols, bits), want,
                                  (cols.amax(0) - cols.amin(0)) / k)
            # split buckets (K2' on [bucket_size, nb_buckets], bucket_size=256)
            got = fq.fake_quant_split_bucket(w, bits, 256)
            flat = w.reshape(-1)
            nb = -(-flat.numel() // 256)
            padded = torch.cat([flat, flat[-1:].expand(nb * 256 - flat.numel())])
            want = fq._quantize_math_torch(padded.reshape(256, nb), k, 0).reshape(-1)
            want = want[:flat.numel()].reshape(shape)
            err_s, nd_s = compare(got, want, (w.max() - w.min()) / k)
            results['fake_quant_per_column']['max_abs_err'] = max(
                results['fake_quant_per_column']['max_abs_err'], err_c, err_s)
            log('  bits=%d %-18s per-tensor max|d|=%.3g n_diff=%d | channel %.3g/%d | '
                'split %.3g/%d', bits_value, str(shape), err, nd, err_c, nd_c, err_s, nd_s)
    # one bf16 activation of the main path through K1'
    bits = torch.tensor(8.0, device=device)
    act = torch.randn((BATCH, 256, 56, 56), generator=gen, device=device, dtype=torch.bfloat16)
    act = torch.relu(act).contiguous(memory_format=torch.channels_last)
    k = fq._levels(bits)
    want = fq._quantize_math_torch(act, k, None).to(torch.bfloat16)
    got = fq.fake_quant_per_tensor(act, bits)
    check(got.is_contiguous(memory_format=torch.channels_last), 'K1 lost the activation layout')
    # bf16 output: a difference of one bf16 ulp counts as the allowed tie step
    err, nd = compare(got, want, float((act.max().float() - act.min().float()) / k))
    results['fake_quant_per_tensor']['max_abs_err'] = max(
        results['fake_quant_per_tensor']['max_abs_err'], err)
    log('  bf16 activation %s per-tensor max|d|=%.3g n_diff=%d', tuple(act.shape), err, nd)

    # times: one pass over the main path's 52 quantized weights at 4 bits
    bits = torch.tensor(4.0, device=device)
    k = fq._levels(bits)
    weights = [torch.randn(s, generator=gen, device=device) for s in weight_shapes]
    columns = [w.reshape(-1, w.shape[-1]) for w in weights]
    t = {
        'fake_quant_per_tensor': (
            time_ms(lambda: [fq.fake_quant_per_tensor(w, bits) for w in weights]),
            time_ms(lambda: [fq._quantize_math_torch(w, k, None) for w in weights])),
        'fake_quant_per_column': (
            time_ms(lambda: [fq.fake_quant_per_column(c, bits) for c in columns]),
            time_ms(lambda: [fq._quantize_math_torch(c, k, 0) for c in columns])),
    }
    for name, (ms, plain_ms) in t.items():
        results[name]['ms'], results[name]['plain_ms'] = ms, plain_ms
        log('  %s over the 52 weights of one step: kernel %.4f ms, plain %.4f ms',
            name, ms, plain_ms)
    act_ms = time_ms(lambda: fq.fake_quant_per_tensor(act, torch.tensor(8.0, device=device)), 10)
    act_plain = time_ms(lambda: fq._quantize_math_torch(act, k, None).to(torch.bfloat16), 10)
    log('  fake_quant_per_tensor on the bf16 activation %s: kernel %.4f ms, plain %.4f ms',
        tuple(act.shape), act_ms, act_plain)
    return results


def phase_reference(FLAGS, ModelHelper, UniformQuantLearner):
    """The QAT step on the card (kernels, fp32, no TF32) against the same
    step on the CPU (plain version) from the same seed, at a small size."""
    small = dict(ilsvrc_image_size=64, batch_size=4, batch_size_eval=4, nb_smpls_train=64,
                 nb_smpls_eval=8, compute_dtype='float32')
    with FLAGS.scope(**small):
        out = {}
        for device in ('cuda', 'cpu'):
            learner = UniformQuantLearner(None, ModelHelper(resnet_size=50), device=device)
            ds = learner.dataset_train
            ds.augment_xy = lambda batch, gen, is_train, ds=ds: type(ds).augment_xy(
                ds, batch, gen, False)
            state, tx, _ = learner.init_state_quant()
            images, labels = ds.synthesize_arrays(8)
            batch = learner.put_batch({'image': images[:4], 'label': labels[:4]})
            logits = learner.model_helper.forward_eval(
                state.model, ds.augment(batch['image'], None, False),
                policy=learner._policy_fn()(state))
            _, metrics = learner.build_quant_train_step(tx)(state, batch, None)
            out[device] = (logits.detach().cpu(), float(metrics['loss']))
    logit_err = float((out['cuda'][0] - out['cpu'][0]).abs().max())
    loss_gpu, loss_cpu = out['cuda'][1], out['cpu'][1]
    log('  eval logits card vs CPU: max|d| = %.3g (of %.3g); train loss card %.6f, CPU %.6f',
        logit_err, float(out['cpu'][0].abs().max()), loss_gpu, loss_cpu)
    check(logit_err <= 1e-3 + 1e-3 * float(out['cpu'][0].abs().max()), 'logits disagree')
    check(abs(loss_gpu - loss_cpu) <= 1e-3 * abs(loss_cpu), 'train loss disagrees')


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this smoke needs an NVIDIA GPU',
              file=sys.stderr)
        sys.exit(1)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device('cuda')

    from pocketflow_tpu_torch.config import FLAGS
    from pocketflow_tpu_torch.learners.uniform_quantization.learner import UniformQuantLearner
    from pocketflow_tpu_torch.nets.resnet_at_ilsvrc12 import ModelHelper
    from pocketflow_tpu_torch.ops import build
    from pocketflow_tpu_torch.ops import fake_quant as fq

    card = card_line()
    log('phase 1 device: %s | %s | torch %s cuda %s', card, torch.cuda.get_device_name(0),
        torch.__version__, torch.version.cuda)

    _, build_log, build_s = build.load('fake_quant.cu')
    log('phase 2 build: %s in %.1f s', SOURCE, build_s)
    for line in build_log.splitlines():
        if 'registers' in line or 'spill' in line or 'Compiling entry' in line:
            log('  ptxas: %s', line.strip())

    FLAGS.override(synthetic_data=True, summ_step=10 ** 9, save_step=10 ** 9,
                   resnet_stem_s2d=True, rand_seed=0)

    log('phase 3 reference: small QAT step, card vs CPU')
    phase_reference(FLAGS, ModelHelper, UniformQuantLearner)

    with FLAGS.scope(batch_size=BATCH, batch_size_eval=BATCH, nb_smpls_train=4096,
                     nb_smpls_eval=512, compute_dtype='bfloat16', bn_stats_subsample=1,
                     uql_weight_bits=4, uql_activation_bits=32):
        t0 = time.perf_counter()
        learner = UniformQuantLearner(None, ModelHelper(resnet_size=50), device=device)
        stats = learner.statistics
        check(stats['nb_matmuls'] == NB_WEIGHT_SITES and stats['nb_activations'] == NB_ACT_SITES,
              'sites %d/%d', stats['nb_matmuls'], stats['nb_activations'])

        log('phase 3 kernels vs plain at the %d quantized weight shapes of ResNet-50',
            len(set(stats['weight_shapes'])))
        kernels = phase_kernels(fq, stats['weight_shapes'], device)

        log('phase 4 main path: QAT ResNet-50 @224, bf16, batch %d, exact BN, s2d stem', BATCH)
        state, tx, _ = learner.init_state_quant()
        train_step = learner.build_quant_train_step(tx)
        eval_step = learner.build_quant_eval_step()
        iterator = learner.dataset_train.build()
        batches = [learner.put_batch(next(iterator)) for _ in range(4)]
        eval_batch = learner.put_batch(next(learner.dataset_eval.build()))
        torch.cuda.synchronize()
        log('  set-up (learner, data, init) %.1f s', time.perf_counter() - t0)
        torch.cuda.reset_peak_memory_stats()

        fq.reset_counters()  # the main path's launches are counted from here ...
        for i in range(N_WARMUP):
            state, metrics = train_step(state, batches[i % 4], learner.generator(i))
        torch.cuda.synchronize()
        start = time.perf_counter()
        for i in range(N_WARMUP, N_WARMUP + N_TIMED):
            state, metrics = train_step(state, batches[i % 4], learner.generator(i))
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - start
        runs = {MAIN_RUN: fq.counters()}  # ... to here
        loss = float(metrics['loss'])
        counts = runs[MAIN_RUN]
        check(math.isfinite(loss), 'loss %r', loss)
        check(state.step == N_WARMUP + N_TIMED, 'step %d', state.step)
        check(counts['fake_quant_per_tensor'] == NB_WEIGHT_SITES * state.step,
              'K1 launches %d for %d steps', counts['fake_quant_per_tensor'], state.step)
        check(counts['plain'] == 0 and counts['fake_quant_per_column'] == 0,
              'unexpected launches %s', counts)
        fq.reset_counters()
        ev = {k: float(v) for k, v in eval_step(state, eval_batch).items()}
        check(all(math.isfinite(v) for v in ev.values()), 'eval %s', ev)
        check(fq.counters() == {'fake_quant_per_tensor': NB_WEIGHT_SITES,
                                'fake_quant_per_column': 0, 'plain': 0},
              'eval step launches %s', fq.counters())
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        log('  step %d loss %.4f acc %.4f | eval %s', state.step, loss,
            float(metrics['accuracy']), ev)
        log('  %.2f img/s, %.2f ms/step over %d steps, peak memory %.2f GiB | %s',
            BATCH * N_TIMED / elapsed, 1e3 * elapsed / N_TIMED, N_TIMED, peak_gib, card)

        log('phase 5 other quantization routes, 2 steps each')
        channel = 'channel buckets (--uql_use_buckets --uql_bucket_type=channel): 2 QAT train steps'
        routes = [(channel, dict(uql_use_buckets=True, uql_bucket_type='channel'),
                   {'fake_quant_per_column': NB_WEIGHT_SITES}),
                  ('split buckets (--uql_use_buckets --uql_bucket_type=split): 2 QAT train steps',
                   dict(uql_use_buckets=True, uql_bucket_type='split'),
                   {'fake_quant_per_column': NB_WEIGHT_SITES}),
                  ('8-bit activations (--uql_activation_bits=8): 2 QAT train steps',
                   dict(uql_activation_bits=8),
                   {'fake_quant_per_tensor': NB_WEIGHT_SITES + NB_ACT_SITES})]
        for label, flags, per_step in routes:
            with FLAGS.scope(**flags):
                state = learner.set_bits(state, *learner.choose_bits())
                fq.reset_counters()
                for i in range(2):
                    state, metrics = train_step(state, batches[i], learner.generator(100 + i))
                runs[label] = fq.counters()
                loss = float(metrics['loss'])
            log('  %s: loss %.4f, launches %s', label, loss, runs[label])
            check(math.isfinite(loss), '%s loss %r', label, loss)
            want = {'fake_quant_per_tensor': 0, 'fake_quant_per_column': 0, 'plain': 0}
            want.update({name: 2 * n for name, n in per_step.items()})
            check(runs[label] == want, '%s: launches %s, expected %s', label, runs[label], want)

    # each kernel's launches in the run that drives it: the main path for K1',
    # the channel-bucket route for K2'
    own_run = {'fake_quant_per_tensor': MAIN_RUN, 'fake_quant_per_column': channel}
    line = {'kernels': [{'name': name, 'route': 'cuda', 'source': SOURCE,
                         'replaces': REPLACES[name], 'run': own_run[name],
                         'launches': runs[own_run[name]][name],
                         'launches_by_run': {label: c[name] for label, c in runs.items()},
                         'max_abs_err': kernels[name]['max_abs_err'],
                         'ms': kernels[name]['ms'], 'plain_ms': kernels[name]['plain_ms']}
                        for name in REPLACES]}
    for entry in line['kernels']:
        check(entry['launches'] > 0, '%s never launched in %s', entry['name'], entry['run'])
    log('%s', card_line())
    log('%s', json.dumps(line))
    log('%s', json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
