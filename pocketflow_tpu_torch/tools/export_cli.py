"""Export CLI: checkpoint -> deployment artifact (counterpart of
pocketflow_tpu/tools/export_cli.py).

    python -m pocketflow_tpu_torch.tools.export_cli --export_model=resnet_at_cifar10 \\
        --ckpt_path=./models_cpg/model.ckpt --export_mode=chn-pruned-residual \\
        --output_path=./export/model

Modes: 'plain' (packed fp32), 'chn-pruned' (all-zero input channels cut
from the kernels, their indices in the manifest), 'chn-pruned-residual'
(producer-side shrink across skip connections and depthwise convs, checked
exact by scattering back to dense, with a FLOPs audit) and 'quant' (int
codes + scales at --uql_weight_bits).  Every run writes the packed .npz +
manifest and the eval forward as ``<output>.pt2`` (torch.export), then
reloads the artifact through the serving loader and compares its logits
with the live model's.  The TFLite and SavedModel artifacts
(--tflite_mode, --export_saved_model) need TensorFlow and are not ported
(ROADMAP item 23).
"""

from __future__ import annotations

import copy
import importlib
import sys

import numpy as np
import torch


def main(argv=None, device='cuda'):
    """Export the newest checkpoint under --ckpt_path on `device`; returns
    the artifact's .npz path."""
    from pocketflow_tpu_torch.config import FLAGS
    from pocketflow_tpu_torch.core import checkpoint as ckpt_lib
    from pocketflow_tpu_torch.core.bridge import load_jax_numpy, to_jax_numpy
    from pocketflow_tpu_torch.core.metrics import get_logger
    from pocketflow_tpu_torch.learners.abstract_learner import resolve_device
    from pocketflow_tpu_torch.learners.uniform_quantization import utils as uq
    from pocketflow_tpu_torch.main import MODELS
    from pocketflow_tpu_torch.tools import export as export_lib
    from pocketflow_tpu_torch.tools import serving as serving_lib
    from pocketflow_tpu_torch.tools import shrink_graph as sg
    from pocketflow_tpu_torch.tools.model_report import build_report

    device = resolve_device(device)
    for module_name in MODELS.values():  # the helpers' flags
        importlib.import_module(module_name)
    FLAGS.DEFINE_string('ckpt_path', './models/model.ckpt', 'checkpoint to export')
    FLAGS.DEFINE_string('export_mode', 'plain',
                        "export mode: 'plain' | 'chn-pruned' | "
                        "'chn-pruned-residual' (producer-side shrink across "
                        "skip connections) | 'quant'")
    FLAGS.DEFINE_string('output_path', './export/model', 'output artifact path')
    FLAGS.DEFINE_string('export_model', 'convnet_at_fmnist', 'model helper name')
    FLAGS.DEFINE_string('tflite_mode', 'none',
                        "also write a .tflite artifact: 'none' (the only mode "
                        "ported; the others need TensorFlow, ROADMAP item 23)")
    FLAGS.DEFINE_boolean('export_saved_model', False,
                         'also write a TF SavedModel (not ported: ROADMAP item 23)')
    FLAGS.DEFINE_boolean('tflite_latency', False,
                         'measure TFLite interpreter latency (needs --tflite_mode)')
    FLAGS.parse_args(argv)
    log = get_logger()
    if FLAGS.tflite_mode != 'none' or FLAGS.export_saved_model:
        raise NotImplementedError(
            '--tflite_mode=%s / --export_saved_model need TensorFlow and are not ported yet '
            "(ROADMAP 'Modules to port', item 23)" % FLAGS.tflite_mode)
    if FLAGS.tflite_latency:
        log.warning('--tflite_latency ignored: no TFLite artifact was exported')
    if FLAGS.export_mode not in ('plain', 'chn-pruned', 'chn-pruned-residual', 'quant'):
        raise ValueError('unknown --export_mode %r' % FLAGS.export_mode)

    helper = importlib.import_module(MODELS[FLAGS.export_model]).ModelHelper()
    model = helper.create_model()
    payload = ckpt_lib.restore_latest(FLAGS.ckpt_path, map_location='cpu')
    if payload is None:
        raise FileNotFoundError('no checkpoint next to ' + FLAGS.ckpt_path)
    model.load_state_dict(payload['model'])
    model = model.to(device).eval()
    ds = helper.build_dataset_train()
    sample = ds.synthesize_arrays(2)[0] if FLAGS.synthetic_data else next(ds.build())['image']
    sample = ds.augment(torch.from_numpy(np.asarray(sample[:2])).to(device), None, False)
    params, batch_stats = to_jax_numpy(model)

    if FLAGS.export_mode == 'chn-pruned-residual':
        # residual-aware physical shrink across skip connections and
        # depthwise convs, through the captured conv graph
        graph = sg.capture_conv_graph(model, tuple(sample.shape))
        packed, manifest = sg.shrink_residual_aware(params, batch_stats, graph)
        # exactness: scattered back to dense, the logits must be equal
        dense_p, dense_s = sg.expand_to_dense(packed, manifest, params, batch_stats)
        dense = load_jax_numpy(copy.deepcopy(model), dense_p, dense_s)
        delta = export_lib.numeric_self_check(model, dense, sample)
        if delta != 0.0:
            raise AssertionError('residual shrink changed the model (max delta %.3e)' % delta)
        # FLOPs audit: conv FLOPs scale with the kernel's element count at
        # fixed spatial sizes, so the shrunk/original size ratio is exact
        report = build_report(model, sample)
        flops_before = flops_after = 0.0
        for row in report['layers']:
            fl = row.get('flops')
            if fl is None and len(row['shape']) == 2:
                # dense kernels: per-sample FLOPs 2 * in * out
                fl = 2.0 * float(np.prod(row['shape']))
            if fl is None:
                continue
            new = packed.get(row['layer'] + '/kernel')
            old_size = int(np.prod(row['shape']))
            flops_before += fl
            flops_after += fl * (new.size / old_size if new is not None else 1.0)
        manifest['flops_audit'] = {
            'flops_before': flops_before, 'flops_after': flops_after,
            'covers': 'conv + dense kernels',
            'reduction': 1.0 - (flops_after / flops_before if flops_before else 1.0)}
        log.info('residual shrink FLOPs audit: %.3e -> %.3e (-%.1f%%)', flops_before,
                 flops_after, 100.0 * manifest['flops_audit']['reduction'])
    elif FLAGS.export_mode == 'chn-pruned':
        packed, manifest = export_lib.shrink_channel_pruned(params)
    elif FLAGS.export_mode == 'quant':
        stats = uq.discover_quant_sites(model, sample)
        packed = export_lib.pack_quantized(
            params, stats['weight_paths'], [FLAGS.uql_weight_bits] * stats['nb_matmuls'],
            bucket_type=FLAGS.uql_bucket_type if FLAGS.uql_use_buckets else None,
            bucket_size=FLAGS.uql_bucket_size)
        manifest = {'weight_bits': FLAGS.uql_weight_bits}
        log.info('quant export: %d tensors int-packed',
                 sum(1 for v in packed.values() if isinstance(v, dict)))
    else:
        packed, manifest = dict(sg.tree_leaves(params)), {}

    if FLAGS.export_mode != 'chn-pruned-residual':
        # the artifact serves on its own: BN running statistics ride along
        # under 'batch_stats/' (the residual shrink's packed tree has them)
        for pstr, leaf in sg.tree_leaves(batch_stats):
            packed['batch_stats/' + pstr] = leaf

    out = export_lib.save_packed(packed, manifest, FLAGS.output_path + '.npz')
    export_lib.export_program(model, sample, FLAGS.output_path + '.pt2')
    # the real self-check: the artifact reloaded through the serving loader
    # against the live model (for 'quant' the delta is the quantization
    # error, reported, not gated)
    delta = export_lib.numeric_self_check(
        model, serving_lib.load_serving_model(out, model), sample)
    if FLAGS.export_mode in ('plain', 'chn-pruned') and delta > 1e-3:
        raise AssertionError('export artifact diverged from the live model (max delta %.3e)'
                             % delta)
    log.info('export written to %s', out)
    return out


if __name__ == '__main__':
    main(sys.argv[1:])
