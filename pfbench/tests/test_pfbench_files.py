"""Every file the benchmark finds by name is there and loads."""

import json
import os
import re

import pytest

from pfbench import harness

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


def bench(root):
    with open(os.path.join(root, 'BENCHMARK.json')) as fin:
        return json.load(fin)


def test_every_cell_loads(root):
    spec = bench(root)
    for cell in spec['workloads']:
        loaded = harness.load_cell(root, cell['name'])
        assert loaded['cfg']['name'] == cell['config']
        assert loaded['traffic']['driver'] in ('train', 'serve')
        assert loaded['limits'], cell['name']
        assert os.path.exists(os.path.join(harness.HERE, 'drivers',
                                           loaded['traffic']['driver'] + '.py'))


def test_every_per_layer_metric_has_a_reader(root):
    for metric in bench(root)['per_layer']:
        assert callable(harness.reader(metric['name']))


def test_names_units_and_keys(root):
    spec = bench(root)
    assert set(spec) == {'command', 'paths', 'run_seconds', 'configs', 'workloads',
                         'end_to_end', 'per_layer'}
    names = [m['name'] for m in spec['end_to_end'] + spec['per_layer']]
    assert len(names) == len(set(names))
    for metric in spec['end_to_end'] + spec['per_layer']:
        assert NAME.match(metric['name']) and UNIT.match(metric['unit'])
        assert metric['better'] in ('lower', 'higher')
    for cell in spec['workloads']:
        assert NAME.match(cell['name']) and cell['chips'] in (1, 4)
        assert len(cell['why']) <= 200
    for cfg in spec['configs']:
        assert cfg['file'].startswith('pfbench/') and os.path.exists(
            os.path.join(root, cfg['file']))
    assert 'setup_s' in [m['name'] for m in spec['end_to_end']]


@pytest.mark.parametrize('name', ['resnet50', 'mobilenet_v1'])
def test_config_layers_named_once(root, name):
    with open(os.path.join(root, 'pfbench', 'configs', name + '.json')) as fin:
        cfg = json.load(fin)
    paths = [layer['p'] for layer in cfg['layers']]
    assert len(paths) == len(set(paths))
    assert cfg['reduced'] == []
