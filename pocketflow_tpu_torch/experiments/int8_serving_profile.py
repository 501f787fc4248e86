"""Where the device time of an int8 serving forward goes, on one GPU, beside
the bf16 forward of the same net.

ResNet-50 and MobileNet-v1 as ``int8_serving_speed`` builds them (224x224,
batch 64, bf16, random weights from seed 0, activation scales calibrated on
2 normal batches, the depthwise sites skipped): each net is served in bf16
and through ``ops/int8_ops.Int8ServingPolicy``, NB_WARMUP forwards over the
benchmark's staged inputs (``tools/benchmark.py``), then NB_PROFILED more
under torch.profiler with the host's ops recorded and each PFConv / PFDense
call inside a named range.  A kernel belongs to the op that launched it
(the profiler's correlation id; the program's ``pf.`` spans, such as an
int8 site's ``pf.int8.site``, are not ops), and so to a part of the forward:

    int8 kernel        the int8 conv kernel (launched by the site itself)
    other site ops     anything else an int8 site launches (none: the
                       kernel adds the bias and casts)
    convs and dense    a site that ran in bf16 (cuDNN, cuBLAS)
    float layers       everything else: BN, ReLU, adds, pools, the mean,
                       and the depthwise convs the int8 forward skips

It reports, per forward: the device window (first kernel start to last
kernel end), the busy time (the union of kernels, copies and memsets) and the
idle share, from a profile of the card alone; the device ms and launches of
each part, the host-to-device copies and the cudaStreamSynchronize calls,
and the top kernels, from the profile with the host's ops.

    python -m pocketflow_tpu_torch.experiments.int8_serving_profile [--out FILE]

It runs on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch

from pocketflow_tpu_torch.experiments import require_cuda

TAG = 'int8_serving_profile'
BATCH, IMAGE_SIZE, NB_CLASSES = 64, 224, 1000
NB_WARMUP, NB_PROFILED, NB_CALIB = 5, 5, 2
SITE = 'int8_profile.site '  # outside the program spans' 'pf.'
PARTS = ('int8 kernel', 'other site ops', 'convs and dense', 'float layers')


def _site_ranges(model):
    """Name each PFConv / PFDense call of `model` for the profiler; returns
    the hooks' handles."""
    from torch.autograd.profiler import record_function
    from pocketflow_tpu_torch.nn.layers import PFConv, PFDense
    open_ranges = []

    def enter(module, args):
        rf = record_function(SITE + module.path)
        rf.__enter__()
        open_ranges.append(rf)

    def leave(module, args, out):
        open_ranges.pop().__exit__(None, None, None)

    handles = []
    for module in model.modules():
        if isinstance(module, (PFConv, PFDense)):
            handles.append(module.register_forward_pre_hook(enter))
            handles.append(module.register_forward_hook(leave))
    return handles


def _classify_site(launches, int8_forward: bool):
    """[(runtime event, name of the op it ran under at the site's top level,
    or None when the site launched it itself)] of one site call -> the part
    of each.  A site that launched nothing itself ran in float: a conv or
    dense of the bf16 forward, or a depthwise conv that the int8 forward
    skips."""
    if all(top is not None for _, top in launches):
        return ['float layers' if int8_forward else 'convs and dense'] * len(launches)
    return ['int8 kernel' if top is None else 'other site ops' for _, top in launches]


def trace_parts(events, nb_forwards: int, int8_forward: bool) -> dict:
    """The per-forward breakdown of a Chrome trace's events (see the module
    docstring)."""
    from pocketflow_tpu_torch.core.profiling import SPAN_PREFIX
    from pocketflow_tpu_torch.tools.profile_step import _busy_us
    host = sorted((e for e in events if e.get('cat') in ('cpu_op', 'user_annotation')
                   and 'dur' in e), key=lambda e: (e['ts'], -e['dur']))
    # the launches: the CUDA runtime API's, and the CUDA driver API's, through
    # which cuBLASLt launches its kernels
    runtime = sorted((e for e in events if e.get('cat') in ('cuda_runtime', 'cuda_driver')),
                     key=lambda e: e['ts'])
    device = [e for e in events if e.get('cat') in ('kernel', 'gpu_memcpy', 'gpu_memset')
              and 'dur' in e]
    if not device:
        raise RuntimeError('the profiler recorded no device activity')
    # each runtime call's enclosing site call and its op at the site's top
    # level: host events nest, so a stack of the open ones, pushed in start
    # order, holds the chain that encloses a runtime call
    sites = {}  # id of the site's annotation -> [(runtime event, top op name)]
    part_of = {}  # correlation -> part
    stack, i = [], 0
    for r in runtime:
        while i < len(host) and host[i]['ts'] <= r['ts']:
            while stack and stack[-1]['ts'] + stack[-1]['dur'] <= host[i]['ts']:
                stack.pop()
            stack.append(host[i])
            i += 1
        open_ = [e for e in stack if e['ts'] + e['dur'] >= r['ts']]
        at = next((k for k, e in enumerate(open_) if e['name'].startswith(SITE)), None)
        corr = r.get('args', {}).get('correlation')
        if at is None:
            part_of[corr] = 'float layers'
        else:
            top = next((e['name'] for e in open_[at + 1:]
                        if not e['name'].startswith(SPAN_PREFIX)), None)
            sites.setdefault(id(open_[at]), []).append((r, top))
    for launches in sites.values():
        for (r, _), part in zip(launches, _classify_site(launches, int8_forward)):
            part_of[r.get('args', {}).get('correlation')] = part
    ms = {part: 0.0 for part in PARTS}
    counts = {part: 0 for part in PARTS}
    by_kernel = {}
    for e in device:
        part = part_of.get(e.get('args', {}).get('correlation'), 'float layers')
        ms[part] += e['dur'] / 1e3 / nb_forwards
        counts[part] += 1
        by_kernel[e['name']] = by_kernel.get(e['name'], 0.0) + e['dur'] / 1e3 / nb_forwards
    lo = min(e['ts'] for e in device)
    hi = max(e['ts'] + e['dur'] for e in device)
    busy = _busy_us([(None, e['ts'], e['ts'] + e['dur']) for e in device])
    return {
        'window_ms': (hi - lo) / 1e3 / nb_forwards,
        'busy_ms': busy / 1e3 / nb_forwards,
        'idle_share': 1.0 - busy / (hi - lo),
        'device_ms_by_part': {k: v for k, v in ms.items() if counts[k]},
        'launches_by_part': {k: v / nb_forwards for k, v in counts.items() if v},
        'htod_copies': sum('HtoD' in e['name'] for e in device) / nb_forwards,
        'stream_syncs': sum(e['name'] == 'cudaStreamSynchronize' for e in runtime) / nb_forwards,
        'top_kernels_ms': [(k[:100], v) for k, v in
                           sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]],
    }


def _trace_events(prof) -> list:
    with tempfile.TemporaryDirectory(prefix='pf_int8_prof_') as tmp:
        path = os.path.join(tmp, 'trace.json')
        prof.export_chrome_trace(path)
        with open(path) as fin:
            return json.load(fin)['traceEvents']


def profile_forward(model, policy, inputs, nb_warmup: int = NB_WARMUP,
                    nb_profiled: int = NB_PROFILED) -> dict:
    """trace_parts of `nb_profiled` eval forwards of `model` under `policy`
    (None: the bf16 forward) after `nb_warmup`.  The window, busy time and
    idle share come from a first profile of the card alone; the parts from
    a second with the host's ops and the sites' ranges recorded, whose host
    overhead stretches the window (its own as 'annotated_window_ms')."""
    from torch.profiler import ProfilerActivity, profile
    from pocketflow_tpu_torch.nn.layers import compression

    def forward(i):
        with compression(policy):
            return model(inputs[i % len(inputs)])

    traces = []
    with torch.no_grad():
        for i in range(nb_warmup):
            forward(i)
        torch.cuda.synchronize()
        for activities in ([ProfilerActivity.CUDA],
                           [ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            handles = _site_ranges(model) if len(activities) == 2 else []
            try:
                with profile(activities=activities) as prof:
                    for i in range(nb_profiled):
                        forward(i)
                    torch.cuda.synchronize()
            finally:
                for handle in handles:
                    handle.remove()
            traces.append(_trace_events(prof))
    device_only = trace_parts(traces[0], nb_profiled, policy is not None)
    out = trace_parts(traces[1], nb_profiled, policy is not None)
    out['annotated_window_ms'] = out['window_ms']
    out.update({key: device_only[key] for key in ('window_ms', 'busy_ms', 'idle_share')})
    return out


def run(batch: int = BATCH, image_size: int = IMAGE_SIZE, nb_warmup: int = NB_WARMUP,
        nb_profiled: int = NB_PROFILED) -> dict:
    """Both nets, bf16 and int8 forwards profiled; returns {net: {'bf16':
    ..., 'int8': ...}}."""
    from pocketflow_tpu_torch.config import FLAGS
    from pocketflow_tpu_torch.experiments import int8_serving_speed as speed
    from pocketflow_tpu_torch.nets.mobilenet import MobileNetV1
    from pocketflow_tpu_torch.nets.resnet import ResNetImageNet
    from pocketflow_tpu_torch.ops import int8_ops
    from pocketflow_tpu_torch.tools import benchmark as bm
    dev = torch.device('cuda')
    shape = (batch, image_size, image_size, 3)
    out = {'device': torch.cuda.get_device_name(dev), 'batch': batch,
           'forwards': {'warm-up': nb_warmup, 'profiled': nb_profiled}}
    with FLAGS.scope(**speed.SERVE_FLAGS):
        for tag, model in (('resnet50', ResNetImageNet(resnet_size=50, nb_classes=NB_CLASSES,
                                                       dtype=torch.bfloat16)),
                           ('mobilenet_v1', MobileNetV1(nb_classes=NB_CLASSES,
                                                        dtype=torch.bfloat16))):
            start = time.perf_counter()
            model.reset_parameters(torch.Generator().manual_seed(0))
            model = model.to(dev).eval()
            calib = [x * 0.5 for x in bm._staged_inputs(shape, torch.float32, dev, seed=7,
                                                         nb=NB_CALIB)]
            policy = int8_ops.Int8ServingPolicy(int8_ops.quantize_model_weights(model),
                                                int8_ops.calibrate(model, calib))
            inputs = bm._staged_inputs(shape, torch.bfloat16, dev)
            out[tag] = {mode: profile_forward(model, pol, inputs, nb_warmup, nb_profiled)
                        for mode, pol in (('bf16', None), ('int8', policy))}
            out[tag]['_seconds'] = round(time.perf_counter() - start, 1)
            print(json.dumps({tag: out[tag]}), flush=True)
            del model, policy, inputs, calib
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--out', default='', help='write the results to this JSON file')
    args = parser.parse_args(argv)
    require_cuda(TAG)
    from pocketflow_tpu_torch.core.cuda_timing import card_line
    card = card_line()
    print('card: %s' % card, flush=True)
    results = run()
    results['_card'] = card
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as fout:
            json.dump(results, fout, indent=1)
    return results


if __name__ == '__main__':
    main()
