"""At a tiny size on the CPU, the plain references agree with the port:
its train steps at float32 (the configuration's bf16 moves the numbers by
its rounding) and its int8 serving forward at float32 (bit for bit, at
the logits and at every int8 site)."""

import pytest

from pfbench import run

from .conftest import sizes


@pytest.mark.parametrize('cell', ['resnet50.qat-w4.b256', 'mobilenet_v1.uqtf-w8a8.b256'])
def test_train_step(root, cell):
    numbers = run.run_cell(cell, 2 ** 31 + 17, 0.2, False, root=root, device='cpu',
                           sizes=sizes(cell, compute_dtype='float32'))['numbers']
    # the uniform-tf recipe's 8-bit activation grid turns float rounding
    # into whole quantization steps at a few elements; its bound is wider
    wide = 'uqtf' in cell
    assert numbers['loss_gap']['value'] < (2e-2 if wide else 1e-3)
    assert numbers['grad_gap.median_leaf']['value'] < (2e-2 if wide else 5e-3)
    assert numbers['grad_diff.last_kernel']['value'] < (0.2 if wide else 1e-3)


def test_int8_forward(root):
    cell = 'resnet50.int8-serve.b256'
    result = run.run_cell(cell, 2 ** 31 + 19, 0.2, False, root=root, device='cpu',
                          sizes=sizes(cell, compute_dtype='float32'))
    numbers = result['numbers']
    assert numbers['logit_gap']['value'] == 0.0
    assert numbers['site_gap']['value'] == 0.0  # each int8 site's output
    assert numbers['rerun_gap']['value'] == 0.0  # the served again equals the window's
    assert result['correct']
