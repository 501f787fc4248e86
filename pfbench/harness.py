"""What every driver shares: the benchmark's files found by name, the
program's flags, the window's clocks, the per-layer readers and the
result's line."""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import os
import sys
from typing import Dict, List, Optional

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'pocketflow_tpu')
TRACE_WARM = 2  # units the profiler runs before it records: its own start


def load_json(path: str) -> Dict:
    with open(path) as fin:
        return json.load(fin)


def load_cell(root: str, name: str, sizes: Optional[Dict] = None) -> Dict:
    """The cell `name` of ``BENCHMARK.json`` under `root`, with its
    configuration, traffic mix and limits; `sizes` ({'cfg.<key>' or
    'traffic.<key>': value}, a dict value merged into the key's) serves the
    tests' tiny sizes."""
    bench = load_json(os.path.join(root, 'BENCHMARK.json'))
    cells = {w['name']: w for w in bench['workloads']}
    if name not in cells:
        raise SystemExit('no workload %r in BENCHMARK.json (%s)' % (name, ', '.join(cells)))
    cell = cells[name]
    configs = {c['name']: c for c in bench['configs']}
    loaded = {
        'bench': bench,
        'cell': cell,
        'cfg': load_json(os.path.join(root, configs[cell['config']]['file'])),
        'traffic': load_json(os.path.join(HERE, 'traffic', cell['traffic'] + '.json')),
        'limits': load_json(os.path.join(HERE, 'limits', name + '.json')),
    }
    for key, value in (sizes or {}).items():
        part, field = key.split('.', 1)
        loaded[part][field] = ({**loaded[part][field], **value} if isinstance(value, dict)
                               else value)
    return loaded


@contextlib.contextmanager
def program_flags(modules: List[str], *groups: Dict):
    """The program's flags for the cell (its configuration's and its
    traffic's) in force for the block, once `modules` (those that define
    them) are imported."""
    for module in modules:
        importlib.import_module(module)
    from pocketflow_tpu_torch.config import FLAGS
    merged: Dict = {}
    for group in groups:
        merged.update(group)
    with FLAGS.scope(**merged):
        yield FLAGS


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name is JAX's, a JAX
    library's or the JAX package's (compared whole)."""
    return sorted({name for name in list(sys.modules)
                   if name.split('.')[0] in FORBIDDEN})


def counters(spec: Dict[str, str]) -> Dict[str, Dict]:
    """{label: module.counters()} of the program's counting modules."""
    return {label: dict(importlib.import_module(module).counters())
            for label, module in spec.items()}


def reader(name: str):
    """The reader of per-layer metric `name` (``metrics/<name>.py``)."""
    path = os.path.join(HERE, 'metrics', name + '.py')
    spec = importlib.util.spec_from_file_location('pfbench.metrics.' + name.replace('.', '_'),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_reports(metric: Dict, bench: Dict, cell_name: str) -> bool:
    """Whether the cell reports a metric: it lists the cell, or, without a
    list, the cell reports the end-to-end metric it moves."""
    if 'workloads' in metric:
        return cell_name in metric['workloads']
    moves = [m for m in bench['end_to_end'] if m['name'] == metric.get('moves')]
    return bool(moves) and ('workloads' not in moves[0] or cell_name in moves[0]['workloads'])


def per_layer_metrics(bench: Dict, cell_name: str, run: Dict) -> Dict:
    out = {}
    for metric in bench['per_layer']:
        if not cell_reports(metric, bench, cell_name):
            continue
        value = reader(metric['name'])(run)
        if value is None:
            note('%s: nothing to read' % metric['name'])
            continue
        out[metric['name']] = {'value': value, 'unit': metric['unit']}
    return out


def end_to_end_metrics(bench: Dict, cell_name: str, values: Dict[str, float]) -> Dict:
    out = {}
    for metric in bench['end_to_end']:
        if 'workloads' in metric and cell_name not in metric['workloads']:
            continue
        out[metric['name']] = {'value': values[metric['name']], 'unit': metric['unit']}
    return out


def sync(device: torch.device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def free(device: torch.device):
    """Return what the program held to the card (its state is deleted)."""
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()


def device_info(device: torch.device, chips: int) -> Dict:
    """The result's 'device': the card's name, the cards used and the
    allocator's peak on the fullest of them."""
    if device.type != 'cuda':
        return {'platform': 'cpu', 'kind': 'cpu', 'count': 1, 'memory_peak_bytes': 0}
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
    return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(device), 'count': chips,
            'memory_peak_bytes': int(peak)}


def traced(loaded: Dict, unit, units: int, run: Dict) -> Dict:
    """Profile `units` units of work (``unit(j)``, see
    ``tracing.profile_units``) with the traffic's spans and counters, and
    read the cell's per-layer metrics from them and from `run` (what the
    untraced window measured): {'metrics', 'breakdown', 'trace'}."""
    from pfbench import tracing
    traffic = loaded['traffic']
    patches = [(importlib.import_module(s['module']), s['attr'], s['name'])
               for s in traffic['spans']]
    summary = tracing.profile_units(unit, units, TRACE_WARM, patches,
                                    lambda: counters(traffic['counters']))
    note('traced %d units: launches %s' % (units, summary['counters']))
    run = {**run, 'units': units, 'summary': summary, 'counters': summary['counters']}
    return {'metrics': per_layer_metrics(loaded['bench'], loaded['cell']['name'], run),
            'breakdown': {'device_ops': summary['device_ops'],
                          'idle_gaps': summary['idle_gaps']},
            'trace': {'busy_s': summary['busy_s'], 'window_s': summary['window_s']}}


def result(loaded: Dict, values: Dict, traced_run: Optional[Dict], device: Dict,
           correct: bool, attempted: int, failed: int, numbers: Dict, checks: Dict) -> Dict:
    """The printed line: the end-to-end metrics, or with a traced run its
    per-layer metrics, busy and window seconds and breakdown; every number
    compared beside its limit last."""
    out = {'correct': bool(correct), 'attempted': attempted, 'failed': failed}
    if traced_run is None:
        out['metrics'] = end_to_end_metrics(loaded['bench'], loaded['cell']['name'], values)
        out['device'] = device
    else:
        out['metrics'] = traced_run['metrics']
        out['device'] = {**device, **traced_run['trace']}
        out['breakdown'] = traced_run['breakdown']
    out['numbers'] = {k: {'value': v, 'at': at} for k, (v, at) in numbers.items()}
    out['checks'] = checks
    return out


def note(text: str):
    print('pfbench: ' + text, file=sys.stderr, flush=True)


def report_checks(checks: Dict):
    """Each compared number beside its limit, as the last lines of stderr."""
    for name, c in checks.items():
        note('check %s = %r (limit %r) at %s' % (name, c['value'], c['limit'], c['at']))
