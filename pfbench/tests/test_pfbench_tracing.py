"""The reduction of a trace to the per-layer metrics, on a trace made by
hand: busy time as the union of device intervals, categories, the time
launched inside a span, idle gaps labelled by the span open when each
began, and every reader of the traced cells."""

import json
import os

import pytest

from pfbench import harness, tracing


def kernel(name, ts, dur, corr):
    return {'cat': 'kernel', 'name': name, 'ts': ts, 'dur': dur, 'args': {'correlation': corr}}


def launch(ts, corr):
    return {'cat': 'cuda_runtime', 'name': 'cudaLaunchKernel', 'ts': ts, 'dur': 1,
            'args': {'correlation': corr}}


def span(name, ts, dur):
    return {'cat': 'user_annotation', 'name': 'pfbench.' + name, 'ts': ts, 'dur': dur}


EVENTS = [
    span('step', 0, 100), span('range_quant', 10, 10), span('sync', 100, 50),
    launch(5, 1), launch(12, 2), launch(30, 3),
    kernel('batch_norm_collect_statistics_kernel', 20, 30, 1),     # 20-50
    kernel('elementwise_kernel<round>', 40, 20, 2),                 # 40-60, overlaps
    kernel('void (anonymous namespace)::int8_conv_wgmma<128, 256>', 90, 40, 3),  # 90-130
]


def test_summary():
    s = tracing.summarize(EVENTS)
    assert s['window_s'] == pytest.approx(150e-6)                  # 0 .. the sync's end
    assert s['busy_s'] == pytest.approx(80e-6)                     # 20-60 and 90-130
    assert s['category_s']['batch norm'] == pytest.approx(30e-6)
    assert s['range_s']['range_quant'] == pytest.approx(20e-6)     # launch 2 only
    # idle 0-20 and 60-90 inside the step, 130-150 inside the sync
    assert sorted((name, round(sec * 1e6)) for name, sec in s['idle_gaps']) == [
        ('pfbench.step', 20), ('pfbench.step', 30), ('pfbench.sync', 20)]
    assert tracing.kernel_seconds(s, 'int8_conv_wgmma') == (pytest.approx(40e-6), 1)


@pytest.mark.parametrize('kind', ['train', 'serve'])
def test_every_reader_reads(root, kind):
    with open(os.path.join(root, 'BENCHMARK.json')) as fin:
        bench = json.load(fin)
    summary = tracing.summarize(EVENTS)
    run = {'kind': kind, 'batch': 256, 'units': 1, 'summary': summary, 'img_s': 1000.0,
           'dispatch_ms': [1.0, 2.0, 3.0], 'train_flops': 1e9, 'forward_flops': 1e9,
           'int8_bound_ms': 0.01, 'counters': {'int8': {'int8_conv': 1}}}
    for metric in bench['per_layer']:
        value = harness.reader(metric['name'])(run)
        if metric['name'].endswith('.' + ('serve' if kind == 'train' else 'train')):
            assert value is None
        if value is not None and metric['unit'] == '%':
            assert 0 < value <= 100
    assert harness.reader('int8_conv_roofline')({**run, 'kind': 'serve'}) == pytest.approx(25.0)
