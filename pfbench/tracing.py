"""The benchmark's spans and the reduction of a profiler trace to device
times.

The arithmetic is frozen here from the port's
``pocketflow_tpu_torch/tools/profile_step.py`` so that a change to the
program cannot move it: ``busy_us`` (its ``_busy_us``: the union of device
intervals), ``CATEGORIES`` and ``kernel_category`` (device time by layer,
first match wins), and the range timing of ``trace_summary`` /
``detection_ranges`` (a kernel belongs to a named host range when the
runtime call that launched it, the same correlation id, lies inside one of
the range's annotations).

Spans are ``torch.profiler.record_function`` ranges named ``pfbench.*``,
opened by the benchmark around the calls into the program; they cost
nothing while no profiler runs.  ``capture`` runs a piece of work under the
profiler (host ops and the card), writes the Chrome trace under the
temporary directory, reads it back and deletes it.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from typing import Dict, Iterable, List, Optional, Tuple

import torch

SPAN_PREFIX = 'pfbench.'
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
LAUNCH_CATS = ('cuda_runtime', 'cuda_driver')

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


def busy_us(intervals: Iterable[Tuple[float, float]]) -> float:
    """The length of the union of (start, end) intervals."""
    busy, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s >= end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def merged(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def span(name: str):
    """A benchmark-side span, ``pfbench.<name>``."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


@contextlib.contextmanager
def patched(owner, attr: str, label: str):
    """Wrap ``owner.attr`` in a span named `label` for the block (the
    ``detection_ranges`` pattern)."""
    fn = getattr(owner, attr)

    def wrapped(*args, **kwargs):
        with span(label):
            return fn(*args, **kwargs)

    setattr(owner, attr, wrapped)
    try:
        yield
    finally:
        setattr(owner, attr, fn)


def capture(unit, units: int, warm: int = 0, patches=(), host: bool = True,
            count=None) -> Tuple[List[Dict], Optional[Dict]]:
    """The Chrome trace events of ``unit(j)`` for j in range(warm, warm +
    units), run under torch.profiler after `warm` units that it runs but
    drops (the profiler's own start): the card's activity, and with `host`
    the host's ops and the spans, with each (owner, attr, label) of
    `patches` wrapped in a span.  Recording the host's ops slows its
    dispatch, so the card's busy and idle time come from a profile without
    them.  The last unit ends in a synchronize.  With `count` (the
    program's counters), also their change over the recorded units."""
    from torch.profiler import ProfilerActivity, profile, schedule
    activities = ([ProfilerActivity.CUDA] if torch.cuda.is_available() else []) + (
        [ProfilerActivity.CPU] if host else [])
    counted = None
    with contextlib.ExitStack() as stack:
        for owner, attr, label in patches:
            stack.enter_context(patched(owner, attr, label))
        prof = stack.enter_context(profile(
            activities=activities,
            schedule=schedule(wait=0, warmup=warm, active=units, repeat=1)))
        for j in range(warm + units):
            if j == warm and count:
                before = count()
            unit(j)
            if j == warm + units - 1 and count:
                after = count()
                counted = {label: {k: after[label][k] - before[label].get(k, 0)
                                   for k in after[label]
                                   if after[label][k] - before[label].get(k, 0)}
                           for label in after}
            prof.step()
    fd, path = tempfile.mkstemp(prefix='pfbench_trace_', suffix='.json')
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fin:
            return json.load(fin)['traceEvents'], counted
    finally:
        os.remove(path)


def summarize(events: List[Dict], nb_top: int = 10) -> Dict:
    """What the metric readers take from one traced segment: its window,
    the device's busy time in it, device time by category and by kernel,
    the kernel records by name, and from a trace of the host too the
    device time launched inside each named span and the longest idle gaps,
    each labelled by the innermost benchmark span open when it began.  The
    window runs from the first benchmark span's start (the first device
    event's, without the host) to the end of the last device event or
    span."""
    spans = sorted((e for e in events if e.get('cat') == 'user_annotation' and 'dur' in e
                    and e.get('name', '').startswith(SPAN_PREFIX)), key=lambda e: e['ts'])
    device = [e for e in events if e.get('cat') in DEVICE_CATS and 'dur' in e]
    if not device:
        raise RuntimeError('the trace holds no device event')
    ends = [e['ts'] + e['dur'] for e in device + spans]
    lo = spans[0]['ts'] if spans else min(e['ts'] for e in device)
    hi = max(ends)
    inside = [(max(e['ts'], lo), e['ts'] + e['dur']) for e in device if e['ts'] + e['dur'] > lo]
    busy = merged(inside)
    by_category: Dict[str, float] = {}
    by_kernel: Dict[str, float] = {}
    records: Dict[str, int] = {}
    by_corr: Dict[int, float] = {}
    for e in device:
        by_category[kernel_category(e['name'])] = by_category.get(
            kernel_category(e['name']), 0.0) + e['dur']
        by_kernel[e['name']] = by_kernel.get(e['name'], 0.0) + e['dur']
        records[e['name']] = records.get(e['name'], 0) + 1
        corr = e.get('args', {}).get('correlation')
        by_corr[corr] = by_corr.get(corr, 0.0) + e['dur']
    launches = sorted((e for e in events if e.get('cat') in LAUNCH_CATS), key=lambda e: e['ts'])
    range_us: Dict[str, float] = {}
    for name in sorted({e['name'] for e in spans}):
        bounds = [(e['ts'], e['ts'] + e['dur']) for e in spans if e['name'] == name]
        range_us[name[len(SPAN_PREFIX):]] = sum(
            by_corr.get(e.get('args', {}).get('correlation'), 0.0) for e in launches
            if any(s <= e['ts'] <= t for s, t in bounds))
    gaps = []
    edges = [lo] + [t for s, t in busy]
    starts = [s for s, t in busy] + [hi]
    for gap_lo, gap_hi in zip(edges, starts):
        if gap_hi > gap_lo:
            gaps.append((gap_lo, (gap_hi - gap_lo) / 1e6))
    gaps = [(_innermost(spans, t), seconds)
            for t, seconds in sorted(gaps, key=lambda g: -g[1])[:nb_top]]
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:nb_top]
    return {
        'window_s': (hi - lo) / 1e6,
        'busy_s': busy_us(busy) / 1e6,
        'category_s': {k: v / 1e6 for k, v in by_category.items()},
        'kernel_s': {k: v / 1e6 for k, v in by_kernel.items()},
        'records': records,
        'range_s': {k: v / 1e6 for k, v in range_us.items()},
        'device_ops': [[k[:160], v / 1e6] for k, v in top],
        'idle_gaps': [[name, seconds] for name, seconds in gaps],
    }


def _innermost(spans: List[Dict], t: float) -> str:
    """The name of the shortest benchmark span open at host time t."""
    open_ = [e for e in spans if e['ts'] <= t <= e['ts'] + e['dur']]
    if not open_:
        return '(no benchmark span)'
    return min(open_, key=lambda e: e['dur'])['name']


def profile_units(unit, units: int, warm: int, patches=(), count=None) -> Dict:
    """Two traced segments of `units` units of work after `warm` each
    (``unit(j)`` runs one, the last of a segment ends in a synchronize):
    the card alone, for the device's times, busy time and window, with the
    program's counters (`count()`) over its recorded units in 'counters';
    then the card and the host, with the spans and `patches`, for the time
    launched inside each span and the labelled idle gaps (whose lengths
    carry the profiler's cost on the host)."""
    events, counted = capture(unit, units, warm, host=False, count=count)
    summary = summarize(events)
    summary['counters'] = counted or {}
    events, _ = capture(lambda j: unit(warm + units + j), units, warm, patches, host=True)
    host = summarize(events)
    summary.update(range_s=host['range_s'], idle_gaps=host['idle_gaps'])
    return summary


def kernel_seconds(summary: Dict, substring: str) -> Tuple[float, int]:
    """(device seconds, records) of the kernels whose name holds `substring`."""
    seconds = sum(v for k, v in summary['kernel_s'].items() if substring in k)
    count = sum(v for k, v in summary['records'].items() if substring in k)
    return seconds, count


def range_seconds(summary: Dict, name: str) -> Optional[float]:
    """Device seconds launched inside the span ``pfbench.<name>``, or None
    when the trace has no such span."""
    return summary['range_s'].get(name)
