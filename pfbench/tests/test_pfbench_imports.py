"""No module of the benchmark imports JAX, a JAX library or the JAX
package (top-level names compared whole), and the references import
nothing of the port."""

import ast
import os

import pytest

from pfbench import harness

FORBIDDEN = {'jax', 'jaxlib', 'flax', 'optax', 'orbax', 'pocketflow_tpu'}


def modules(folder):
    for dirpath, _, files in os.walk(folder):
        for name in files:
            if name.endswith('.py'):
                yield os.path.join(dirpath, name)


def imported(path):
    with open(path) as fin:
        tree = ast.parse(fin.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split('.')[0]
        elif isinstance(node, ast.Call) and getattr(node.func, 'attr', '') == 'import_module':
            if node.args and isinstance(node.args[0], ast.Constant):
                yield node.args[0].value.split('.')[0]


@pytest.mark.parametrize('path', sorted(modules(harness.HERE)))
def test_no_jax(path):
    assert not FORBIDDEN & set(imported(path)), path


@pytest.mark.parametrize('path', sorted(modules(os.path.join(harness.HERE, 'reference'))))
def test_reference_imports_nothing_of_the_port(path):
    names = set(imported(path))
    assert 'pocketflow_tpu_torch' not in names, path
    with open(path) as fin:
        assert 'pocketflow_tpu_torch' not in fin.read(), path


def test_the_check_compares_whole_names():
    import sys
    sys.modules.setdefault('pocketflow_tpu_torch_probe', sys)
    try:
        assert 'pocketflow_tpu_torch_probe' not in harness.forbidden_modules()
    finally:
        del sys.modules['pocketflow_tpu_torch_probe']
