"""A serving cell: the eval forward under the program's int8 serving
policy, in a closed loop with one request in flight.

Set-up builds the net from the configuration's model helper, loads the
weights made from the seed, quantizes its weights and calibrates its
activation scales on ``calibration_batches`` normal batches
(``Int8ServingPolicy(quantize_model_weights(m), calibrate(m, ...))``),
stages ``distinct_requests`` batches of normal images in bf16 on the card
and serves ``warmup_requests`` (the first prepares every int8 site).  In
the window each request is dispatched as soon as the one before it has
ended on the card, and is timed from its dispatch to the synchronize after
it.  A sample of ``sampled_requests`` of the window's requests, drawn from
the seed (a reservoir over all of them), keeps its logits for the
reference.  With ``trace``, ``traced_requests`` more follow the window
under the profiler.

After the window the first of the sampled requests is served once more
through the same forward with every int8 site's input and output kept
(its logits have to equal the window's), and the reference compares each
site's output with its own, and with its site alone on the kept input.
The loop is closed with one request in flight: a traffic mix that asks
for another loop (``loop``, ``in_flight``) is refused.
"""

from __future__ import annotations

import importlib
import random
import statistics
import time
from typing import Dict, Optional

import torch

from pfbench import compare, flops, harness, tracing
from pfbench import weights as made
from pfbench.reference import serve as reference


UNSUPPORTED = ('loop', 'in_flight')  # keys of a load this driver does not offer


def build(cfg: Dict, traffic: Dict, seed: int, device: torch.device):
    """(forward(images) -> logits, weights on the host, {path: layer} of
    the int8 sites) of the cell, the program's flags in force."""
    from pocketflow_tpu_torch.nn.layers import PFConv, PFDense, PFDepthwiseConv
    from pocketflow_tpu_torch.ops import int8_ops
    helper = importlib.import_module('pocketflow_tpu_torch.nets.' + cfg['helper']).ModelHelper(
        **cfg['helper_args'])
    model = helper.create_model().to(device)
    weights = made.make_weights(cfg, seed, device)
    model.load_state_dict(weights, strict=True)
    host = {k: v.cpu() for k, v in weights.items()}
    del weights
    model.eval()
    calib = made.normal_images(cfg, int(traffic['batch']), int(traffic['calibration_batches']),
                               seed, made.CALIBRATION, device)
    policy = int8_ops.Int8ServingPolicy(int8_ops.quantize_model_weights(model),
                                        int8_ops.calibrate(model, calib),
                                        skip_depthwise=bool(traffic['skip_depthwise']))
    del calib
    sites = {m.path: m for m in model.modules()
             if isinstance(m, (PFConv, PFDense)) and m.path in policy.act_scales
             and not (policy.skip_depthwise and isinstance(m, PFDepthwiseConv))}

    @torch.no_grad()
    def forward(images):
        return helper.forward_eval(model, images, policy=policy)

    return forward, host, sites


def site_outputs(forward, sites: Dict, images: torch.Tensor):
    """(logits, {path: (input, output)}) of one forward with each int8
    site's input and output kept."""
    kept = {}

    def keep(module, args, out, path):
        kept[path] = (args[0].detach().clone(), out.detach().clone())

    hooks = [layer.register_forward_hook(
        lambda module, args, out, path=path: keep(module, args, out, path))
        for path, layer in sites.items()]
    try:
        logits = forward(images)
    finally:
        for hook in hooks:
            hook.remove()
    return logits, kept


def reference_gaps(cfg: Dict, weights: Dict, scales: Dict, levels: int, images: torch.Tensor,
                   kept: Optional[Dict] = None):
    """(reference logits, {path: site gap}, {path: local site gap}) of one
    request: each site of `kept` against the reference's site in the
    reference's forward, and against the reference's site alone on the
    kept input (each site freed once read)."""
    gaps, local = {}, {}

    def on_site(path, x, y):
        if kept is not None and path in kept:
            x_kept, y_kept = kept.pop(path)
            gaps[path] = compare.tensor_gap(y_kept, y)
            local[path] = compare.tensor_gap(
                y_kept, reference.site_forward(cfg, weights, scales, path, x_kept, levels))

    logits = reference.forward(cfg, weights, scales, images, levels, on_site=on_site)
    for path in list(kept or {}):
        gaps[path] = local[path] = float('inf')  # a site the reference never reached
        del kept[path]
    return logits, gaps, local


def site_gap(gaps: Dict[str, float]):
    if not gaps:
        return float('inf'), 'no int8 site'
    return compare.worst_leaf(gaps)


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between ranks."""
    ordered = sorted(values)
    at = (len(ordered) - 1) * q / 100.0
    lo = int(at)
    hi = min(lo + 1, len(ordered) - 1)
    return ordered[lo] + (ordered[hi] - ordered[lo]) * (at - lo)


def run(loaded: Dict, seed: int, seconds: float, trace: bool, device: str, start: float) -> Dict:
    cfg, traffic = loaded['cfg'], loaded['traffic']
    asked = [key for key in UNSUPPORTED if key in traffic]
    if asked:
        raise SystemExit('traffic %r sets %s: the serve driver runs a closed loop with one '
                         'request in flight and reads no such key'
                         % (loaded['cell']['traffic'], ', '.join(asked)))
    dev = torch.device(device)
    batch = int(traffic['batch'])
    modules = ['pocketflow_tpu_torch.nets.' + cfg['helper']] + traffic['flag_modules']
    with harness.program_flags(modules, cfg['flags'], traffic['flags'],
                               {'batch_size': batch, 'batch_size_eval': batch}):
        forward, host_weights, sites = build(cfg, traffic, seed, dev)
        requests = made.normal_images(cfg, batch, int(traffic['distinct_requests']), seed,
                                      made.REQUESTS, dev, torch.bfloat16)
        nb = len(requests)
        for i in range(int(traffic['warmup_requests'])):
            forward(requests[i % nb])
        harness.sync(dev)

        # the window: a closed loop, one request in flight
        sample = random.Random(seed)
        keep = int(traffic['sampled_requests'])
        kept, latencies, dispatch = [], [], []
        if dev.type == 'cuda':
            torch.cuda.reset_peak_memory_stats(dev)
        t_start = time.perf_counter()
        done = 0
        while True:
            t_call = time.perf_counter()
            if t_call - t_start >= seconds:
                break
            with tracing.span('stage'):
                images = requests[done % nb]
            with tracing.span('request'):
                logits = forward(images)
            t_back = time.perf_counter()
            with tracing.span('sync'):
                harness.sync(dev)
            t_done = time.perf_counter()
            dispatch.append(1e3 * (t_back - t_call))
            latencies.append(1e3 * (t_done - t_call))
            if len(kept) < keep:
                kept.append((done, logits))
            else:
                slot = sample.randrange(done + 1)
                if slot < keep:
                    kept[slot] = (done, logits)
            done += 1
        t_end = time.perf_counter()
        img_s = done * batch / (t_end - t_start)
        values = {'serve_img_s': img_s, 'serve_p95_ms': percentile(latencies, 95),
                  'setup_s': t_start - start}
        harness.note('%d requests in %.3f s: %.2f img/s, latency p50 %.3f p95 %.3f ms, '
                     'set-up %.2f s' % (done, t_end - t_start, img_s,
                                        statistics.median(latencies), values['serve_p95_ms'],
                                        t_start - start))

        traced_run = None
        if trace:
            def unit(j):
                with tracing.span('stage'):
                    images = requests[(done + j) % nb]
                with tracing.span('request'):
                    forward(images)
                with tracing.span('sync'):
                    harness.sync(dev)

            traced_run = harness.traced(loaded, unit, int(traffic['traced_requests']), {
                'kind': 'serve', 'batch': batch, 'img_s': img_s, 'dispatch_ms': dispatch,
                'forward_flops': flops.forward_flops(cfg),
                'int8_bound_ms': flops.int8_bound_ms(cfg, batch)})
        device_info = harness.device_info(dev, int(loaded['cell']['chips']))
        served = [(i, y.detach().float()) for i, y in kept]
        del kept, logits
        # the first sampled request once more, its sites' inputs and outputs kept
        checked = served[0][0] if served else None
        outputs = {}
        if served:
            again, outputs = site_outputs(forward, sites, requests[checked % nb])
            rerun_gap = compare.row_gap(again.float(), served[0][1])
            del again
        del forward, requests, sites
    harness.free(dev)

    # the reference serves the sampled requests again
    calib = made.normal_images(cfg, batch, int(traffic['calibration_batches']), seed,
                               made.CALIBRATION, dev)
    levels = int(traffic['levels'])
    scales = reference.calibrate(cfg, host_weights, calib, levels)
    del calib
    inputs = made.normal_images(cfg, batch, int(traffic['distinct_requests']), seed,
                                made.REQUESTS, dev, torch.bfloat16)
    gaps, site_gaps, local_gaps = [], {}, {}
    for i, y in served:
        want, found, near = reference_gaps(cfg, host_weights, scales, levels,
                                           inputs[i % len(inputs)],
                                           outputs if i == checked else None)
        site_gaps.update(found)
        local_gaps.update(near)
        gaps.append((compare.row_gap(y, want), 'request %d' % i))
    numbers = {'logit_gap': max(gaps) if gaps else (float('inf'), 'no request'),
               'site_gap': site_gap(site_gaps), 'site_gap.local': site_gap(local_gaps)}
    if served:
        numbers['rerun_gap'] = (rerun_gap, 'request %d' % checked)
    correct, checks = compare.judge(numbers, loaded['limits'])
    return harness.result(loaded, values, traced_run, device_info, correct, done, 0, numbers,
                          checks)
