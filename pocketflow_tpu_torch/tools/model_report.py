"""Model audit report: per-layer params/FLOPs + compression summary
(counterpart of pocketflow_tpu/tools/model_report.py).

Given a model helper (and optionally a compressed checkpoint), lists each
kernel's shape, parameter count, conv FLOPs, nonzero fraction and surviving
input channels: the audit of a compressed artifact before deployment.

    python -m pocketflow_tpu_torch.tools.model_report --report_model=resnet_at_cifar10 \\
        [--report_ckpt=./models_cpg/model.ckpt]
"""

from __future__ import annotations

import importlib
import sys
from typing import Any, Dict, List

import numpy as np
import torch


def build_report(model: torch.nn.Module, sample_images: torch.Tensor) -> Dict[str, Any]:
    """The report of `model`'s parameters; FLOPs of the convs from one
    forward of `sample_images` (``conv_layer_specs``)."""
    from pocketflow_tpu_torch.core.bridge import to_jax_numpy
    from pocketflow_tpu_torch.learners.channel_pruning.channel_pruner import conv_layer_specs
    from pocketflow_tpu_torch.tools.shrink_graph import tree_leaves

    specs = {s['path']: s for s in conv_layer_specs(model, sample_images)}
    rows: List[Dict[str, Any]] = []
    total_params, total_nnz, total_flops = 0, 0, 0.0
    for pstr, arr in tree_leaves(to_jax_numpy(model)[0]):
        if not pstr.endswith('/kernel'):
            continue
        module = pstr[:-len('/kernel')]
        nnz = int(np.count_nonzero(arr))
        row = {'layer': module, 'shape': list(arr.shape),
               'params': int(arr.size), 'nnz_frac': nnz / max(arr.size, 1)}
        if arr.ndim == 4:
            norms = np.abs(arr).sum(axis=(0, 1, 3))
            row['in_channels_kept'] = int(np.count_nonzero(norms))
            row['in_channels'] = int(arr.shape[2])
        spec = specs.get(module)
        if spec is not None:
            row['flops'] = spec['flops']
            total_flops += spec['flops']
        rows.append(row)
        total_params += arr.size
        total_nnz += nnz
    return {
        'layers': rows,
        'total_params': int(total_params),
        'overall_sparsity': 1.0 - total_nnz / max(total_params, 1),
        'total_conv_flops': total_flops,
    }


def format_report(report: Dict[str, Any]) -> str:
    lines = ['%-28s %-20s %10s %8s %12s %s' % (
        'layer', 'shape', 'params', 'nnz%', 'flops', 'in-chns')]
    for row in report['layers']:
        lines.append('%-28s %-20s %10d %7.1f%% %12s %s' % (
            row['layer'], 'x'.join(map(str, row['shape'])), row['params'],
            row['nnz_frac'] * 100.0,
            ('%.3g' % row['flops']) if 'flops' in row else '-',
            ('%d/%d' % (row['in_channels_kept'], row['in_channels']))
            if 'in_channels' in row else '-'))
    lines.append('total params: %d | overall sparsity: %.2f%% | conv FLOPs: %.4g'
                 % (report['total_params'], report['overall_sparsity'] * 100.0,
                    report['total_conv_flops']))
    return '\n'.join(lines)


def main(argv=None, device='cuda'):
    """CLI: print the report of a zoo net (random weights from seed 0, or the
    newest checkpoint under --report_ckpt) on `device`; returns it."""
    from pocketflow_tpu_torch.config import FLAGS
    from pocketflow_tpu_torch.core import checkpoint as ckpt_lib
    from pocketflow_tpu_torch.learners.abstract_learner import resolve_device
    from pocketflow_tpu_torch.main import MODELS

    device = resolve_device(device)
    for module_name in MODELS.values():  # the helpers' flags
        importlib.import_module(module_name)
    FLAGS.DEFINE_string('report_model', 'convnet_at_fmnist',
                        'model helper: ' + ' | '.join(sorted(MODELS)))
    FLAGS.DEFINE_string('report_ckpt', None, 'checkpoint to audit (optional)')
    FLAGS.parse_args(argv)

    helper = importlib.import_module(MODELS[FLAGS.report_model]).ModelHelper()
    model = helper.create_model()
    model.reset_parameters(torch.Generator().manual_seed(0))
    if FLAGS.report_ckpt:
        payload = ckpt_lib.restore_latest(FLAGS.report_ckpt, map_location='cpu')
        if payload is None:
            raise FileNotFoundError('no checkpoint next to ' + FLAGS.report_ckpt)
        model.load_state_dict(payload['model'])
    model = model.to(device)
    ds = helper.build_dataset_train()
    sample = ds.augment(torch.from_numpy(ds.synthesize_arrays(2)[0][:2]).to(device), None, False)
    report = build_report(model, sample)
    print(format_report(report))
    return report


if __name__ == '__main__':
    main(sys.argv[1:])
