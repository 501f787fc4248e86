"""Serving-side loader: any export artifact -> a runnable module
(counterpart of pocketflow_tpu/tools/serving.py).

The artifact is the packed .npz + manifest of tools/export_cli (the JAX
package's format, so artifacts of either package serve here):

* 'plain'               - parameters and BN statistics as they are;
* 'quant'               - int codes + per-bucket scales, dequantized
                          (tools/export.unpack_quantized);
* 'chn-pruned'          - input-side-shrunk kernels scattered back to their
                          dense shapes (zeros in the pruned input channels),
                          so the unmodified net serves them exactly;
* 'chn-pruned-residual' - the physically smaller net: the zoo net is built
                          again with the manifest's width_map and serves the
                          shrunk parameters directly.

    from pocketflow_tpu_torch.tools.serving import load_serving_model
    net = load_serving_model('export/model.npz', helper.create_model().cuda())
    logits = net(images)

    python -m pocketflow_tpu_torch.tools.serving --artifact=./export/model.npz \\
        --export_model=resnet_at_cifar10 [--serve_batch=64]
"""

from __future__ import annotations

import copy
import importlib
import json
import sys
from typing import Any, Dict

import numpy as np
import torch

from pocketflow_tpu_torch.core.bridge import load_jax_numpy
from pocketflow_tpu_torch.core.metrics import get_logger
from pocketflow_tpu_torch.tools import export as export_lib
from pocketflow_tpu_torch.tools import shrink_graph as sg

log = get_logger()


def _load_manifest(artifact_path: str) -> Dict[str, Any]:
    path = artifact_path if artifact_path.endswith('.npz') else artifact_path + '.npz'
    with open(path + '.manifest.json') as fin:
        return json.load(fin)


def load_serving_model(artifact_path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a packed export artifact into a new eval-mode module on `model`'s
    device.  `model` is the dense zoo net the checkpoint was exported from
    (``helper.create_model()``); it is not modified.  A residual-shrunk
    artifact is served by ``model.clone(width_map=...)``, the others by a
    copy of `model`.  Raises on a parameter the artifact lacks or a shape it
    disagrees on."""
    packed = export_lib.unpack_quantized(export_lib.load_packed(artifact_path))
    manifest = _load_manifest(artifact_path)
    device = next(model.parameters()).device

    if manifest.get('components'):
        if not hasattr(model, 'clone'):
            raise ValueError('%s takes no width_map, so it cannot serve a residual-shrunk '
                             'artifact' % type(model).__name__)
        serving = model.clone(width_map=sg.width_map_from_packed(packed, manifest=manifest))
        log.info('serving the width-mapped shrunk model')
    else:
        # consumer-side channel pruning: scatter input channels back to dense
        # (zeros where pruned) so the unmodified net reproduces the outputs
        for pstr, info in manifest.items():
            if not (isinstance(info, dict) and 'kept_in_channels' in info):
                continue
            kernel = np.asarray(packed[pstr])
            dense_shape = list(kernel.shape)
            dense_shape[2] = int(info['orig_in_channels'])
            dense = np.zeros(dense_shape, kernel.dtype)
            dense[:, :, np.asarray(info['kept_in_channels'], np.int64), :] = kernel
            packed[pstr] = dense
        serving = copy.deepcopy(model)
    variables = sg.variables_from_packed(packed)
    load_jax_numpy(serving, variables['params'], variables['batch_stats'])
    return serving.to(device).eval()


def main(argv=None, device='cuda'):
    """CLI: load an artifact on `device`, run a forward self-check, report
    latency.  Returns {'logits': [2, classes] numpy, 'latency_ms',
    'throughput_per_sec', 'device'}."""
    from pocketflow_tpu_torch.config import FLAGS
    from pocketflow_tpu_torch.learners.abstract_learner import resolve_device
    from pocketflow_tpu_torch.main import MODELS
    from pocketflow_tpu_torch.tools.benchmark import calc_inference_time

    device = resolve_device(device)
    for module_name in MODELS.values():  # the helpers' flags
        importlib.import_module(module_name)
    FLAGS.DEFINE_string('artifact', './export/model.npz', 'packed artifact')
    FLAGS.DEFINE_string('export_model', 'convnet_at_fmnist', 'model helper name')
    FLAGS.DEFINE_integer('serve_batch', 64, 'benchmark batch size')
    FLAGS.parse_args(argv)

    helper = importlib.import_module(MODELS[FLAGS.export_model]).ModelHelper()
    model = load_serving_model(FLAGS.artifact, helper.create_model().to(device))
    ds = helper.build_dataset_eval()
    sample = ds.augment(torch.from_numpy(ds.synthesize_arrays(2)[0][:2]).to(device), None, False)
    with torch.no_grad():
        logits = model(sample).to(torch.float32).cpu().numpy()
    log.info('forward OK: logits %s %s', logits.shape, logits.dtype)
    shape = (FLAGS.serve_batch,) + tuple(sample.shape[1:])
    return {'logits': logits, **calc_inference_time(model, shape)}


if __name__ == '__main__':
    main(sys.argv[1:])
