"""Faster R-CNN's width_map (pocketflow_tpu_torch/nets/faster_rcnn_at_pascalvoc.py)
against the JAX package's, on the CPU in fp32 at 64x64.

The map halves the inner widths of every block of stages 1 and 2 (conv1,
and conv2 of a bottleneck), keyed by full module paths under 'backbone/'
as the JAX detector takes them.  For the ResNet-18 and ResNet-50 trunks:
the mapped detector's parameter and BN-statistic shapes equal JAX's path
for path; its eval forward on the JAX parameters carried across by
core/bridge.py (biases and BN variables moved off their init, the BN
statistics calibrated to the batch) is within JAX's (the RPN outputs, the
proposals with their validity exact, the ROI boxes and the heads): for
ResNet-18 within the detection tests' bound (rtol 1e-4, atol 1e-5 of the
largest value); for ResNet-50 within 1e-4 of each output's largest |value|
(its 13 blocks put the objectness logits at ~140; the dense ResNet-50
detector reads 2.1e-5 to 4.3e-5 of the largest against JAX, the mapped one
1.4e-5 to 3.5e-5, each output's fp32 sums in another order, while a
relative bound at the small logits would fail the dense detector as well);
``clone(width_map=...)`` of
the dense detector builds the same shapes; and a map without 'backbone/'
entries changes nothing.

The JAX detector does not apply such a map (a fault of the reference, not
carried over): its ``build_backbone`` strips the 'backbone/' prefix before
handing the map to the trunk (pocketflow_tpu/nets/faster_rcnn_at_pascalvoc.py:
117-122), but the trunk's ``_w`` resolves a layer by its full module path
(pocketflow_tpu/nets/resnet.py:29-32), which keeps 'backbone/', so no key
matches and the detector stays dense.  The port strips the prefix and
resolves the trunk's own paths, so the documented keys shrink it.  JAX's
detector is built with each key's prefix doubled, which its lookup does
match, to give it the same widths; the test also holds that the documented
keys leave JAX's detector dense.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pocketflow_tpu_torch.config import FLAGS as TFLAGS
from pocketflow_tpu_torch.core.bridge import load_jax_numpy
from test_torch_detection_nets import (
    FRCNN_FLAGS, _both, _calibrated, _close, _compare_outputs, _images_labels, _moved)

torch.set_num_threads(2)
STAGES = {18: (2, 2), 50: (3, 4)}  # blocks of stages 1 and 2


@pytest.fixture(autouse=True)
def _port_flags():
    with TFLAGS.scope(**TFLAGS.as_dict()):
        yield


def halving_map(size: int) -> dict:
    """Stages 1 and 2's inner widths halved (64 -> 32, 128 -> 64)."""
    out = {}
    for stage, nb_blocks in enumerate(STAGES[size], start=1):
        width = 64 * 2 ** (stage - 1)
        for block in range(nb_blocks):
            path = 'backbone/stage%d_block%d/' % (stage, block)
            out[path + 'conv1'] = width // 2
            if size == 50:
                out[path + 'conv2'] = width // 2
    return out


def _shapes_jax(tree, prefix=''):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_shapes_jax(value, prefix + key + '/'))
        else:
            out[prefix + key] = tuple(np.shape(value))
    return out


def _shapes_port(model):
    params = {n.replace('.', '/'): tuple(p.shape) for n, p in model.named_parameters()}
    stats = {n.replace('.', '/'): tuple(b.shape) for n, b in model.named_buffers()}
    return params, stats


@pytest.mark.parametrize('size', [18, 50])
def test_width_mapped_frcnn_matches_jax(size):
    from pocketflow_tpu.nets.faster_rcnn_at_pascalvoc import FasterRCNN as J
    from pocketflow_tpu_torch.nets.faster_rcnn_at_pascalvoc import FasterRCNN as P
    name, width_map = 'resnet%d' % size, halving_map(size)
    jscope, tscope = _both(**FRCNN_FLAGS)
    with jscope, tscope:
        x, _ = _images_labels(2)
        # the reference's fault: the documented keys leave its detector dense
        jax_dense = jax.eval_shape(
            lambda v: J(nb_classes=21, backbone_name=name, dtype=jnp.float32,
                        width_map=width_map).init(jax.random.PRNGKey(0), v, labels=None,
                                                  train=False), jnp.asarray(x))
        assert jax_dense['params']['backbone']['stage1_block0']['conv1']['kernel'].shape[-1] == 64
        jm = J(nb_classes=21, backbone_name=name, dtype=jnp.float32,
               width_map={'backbone/' + k: v for k, v in width_map.items()})
        variables = _moved(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), labels=None,
                                   train=False))
        tm = P(nb_classes=21, backbone_name=name, dtype=torch.float32, width_map=width_map)
        params, stats = _shapes_port(tm)
        assert params == _shapes_jax(variables['params'])
        assert stats == _shapes_jax(variables['batch_stats'])
        # the map did shrink the trunk: stage 1's first block is 32 wide inside
        assert params['backbone/stage1_block0/conv1/kernel'][-1] == 32
        assert tm.backbone.out_features == ((512, 1024) if size == 50 else (128, 256))

        dense = P(nb_classes=21, backbone_name=name, dtype=torch.float32)
        assert _shapes_port(dense.clone(width_map=width_map)) == (params, stats)
        assert _shapes_port(P(nb_classes=21, backbone_name=name, dtype=torch.float32,
                              width_map={'stage1_block0/conv1': 8})) == _shapes_port(dense)

        load_jax_numpy(tm, variables['params'], variables['batch_stats'])
        variables = _calibrated(tm, x)
        want = jax.device_get(jm.apply(variables, jnp.asarray(x), labels=None, train=False))
        with torch.no_grad():
            got = tm.eval()(torch.from_numpy(x))
    keys = ('anchors', 'obj_logits', 'rpn_deltas', 'proposals', 'proposal_valid',
            'roi_boxes', 'cls_logits', 'box_deltas')
    if size == 18:
        _compare_outputs(got, want, keys)
        return
    np.testing.assert_array_equal(got['proposal_valid'].numpy(),
                                  np.asarray(want['proposal_valid']))
    for key in keys:
        if key != 'proposal_valid':
            _close(got[key].numpy(), want[key], key, rtol=0.0, atol=1e-4)
