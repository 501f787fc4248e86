"""Entry point of the PyTorch port (counterpart of the repository's main.py).

Selects the model helper by ``--model`` (or a positional name), applies the
model's dataset entries of ``--path_conf``, and runs the learner chosen by
``--learner`` on one CUDA device, or data-parallel on one device a process
when launched with torchrun (``core/mesh.py``).

Usage:
    python -m pocketflow_tpu_torch.main --model=resnet_at_cifar10 --learner=uniform \\
        --data_dir_local=/data/cifar10 [--exec_mode=train|eval] [flags...]
    torchrun --nproc_per_node=N -m pocketflow_tpu_torch.main ... --enbl_multi_gpu
"""

import importlib
import sys

MODELS = {
    'convnet_at_fmnist': 'pocketflow_tpu_torch.nets.convnet_at_fmnist',
    'faster_rcnn_at_pascalvoc': 'pocketflow_tpu_torch.nets.faster_rcnn_at_pascalvoc',
    'lenet_at_cifar10': 'pocketflow_tpu_torch.nets.lenet_at_cifar10',
    'mobilenet_at_ilsvrc12': 'pocketflow_tpu_torch.nets.mobilenet_at_ilsvrc12',
    'resnet_at_cifar10': 'pocketflow_tpu_torch.nets.resnet_at_cifar10',
    'resnet_at_ilsvrc12': 'pocketflow_tpu_torch.nets.resnet_at_ilsvrc12',
    'vgg_at_pascalvoc': 'pocketflow_tpu_torch.nets.vgg_at_pascalvoc',
}


def register_flags():
    """Register the flags of every learner and model, and --model."""
    from pocketflow_tpu_torch.config import FLAGS
    import pocketflow_tpu_torch.learners.channel_pruning.learner  # noqa: F401
    import pocketflow_tpu_torch.learners.channel_pruning_gpu.learner  # noqa: F401
    import pocketflow_tpu_torch.learners.channel_pruning_rmt.learner  # noqa: F401
    import pocketflow_tpu_torch.learners.discr_channel_pruning.learner  # noqa: F401
    import pocketflow_tpu_torch.learners.nonuniform_quantization.learner  # noqa: F401
    import pocketflow_tpu_torch.learners.uniform_quantization.learner  # noqa: F401
    import pocketflow_tpu_torch.learners.uniform_quantization_tf.learner  # noqa: F401
    import pocketflow_tpu_torch.learners.weight_sparsification.learner  # noqa: F401
    for module in MODELS.values():
        importlib.import_module(module)
    FLAGS.DEFINE_string('model', 'convnet_at_fmnist',
                        'model helper: ' + ' | '.join(sorted(MODELS)))


def main(argv=None, device='cuda'):
    """Run the learner on `device`; returns the learner.  Under torchrun's
    environment the process joins its group first (a group the caller made
    is kept; one made here is destroyed at the end), and a CUDA `device`
    without an index becomes ``cuda:LOCAL_RANK``."""
    import torch.distributed as dist
    from pocketflow_tpu_torch.config import FLAGS
    from pocketflow_tpu_torch.core import mesh
    from pocketflow_tpu_torch.core.metrics import SummaryWriter, get_logger
    from pocketflow_tpu_torch.learners import create_learner
    from pocketflow_tpu_torch.utils.path_args import apply_path_conf
    register_flags()  # before parsing
    leftovers = FLAGS.parse_args(argv)
    model_name = FLAGS.model
    for arg in leftovers:  # allow a bare positional model name
        if arg in MODELS:
            model_name = arg
        elif arg.startswith('-'):
            raise SystemExit('unrecognized flag %r (see --help)' % arg)
    if model_name not in MODELS:
        raise SystemExit('unknown model %r' % model_name)
    apply_path_conf(model_name)
    owns_group = not (dist.is_available() and dist.is_initialized())
    owns_group = mesh.distributed_init(device) and owns_group

    log = get_logger()
    log.info('model = %s | learner = %s | exec_mode = %s',
             model_name, FLAGS.learner, FLAGS.exec_mode)
    module = importlib.import_module(MODELS[model_name])
    # summaries from rank 0 only
    sm_writer = SummaryWriter(FLAGS.log_dir) if mesh.is_primary_worker() else None
    try:
        learner = create_learner(sm_writer, module.ModelHelper(), device=device)
        if FLAGS.exec_mode == 'train':
            learner.train()
        elif FLAGS.exec_mode == 'eval':
            learner.evaluate()
        else:
            raise ValueError('unrecognized execution mode: ' + FLAGS.exec_mode)
    finally:
        if sm_writer is not None:
            sm_writer.close()
        if owns_group:
            dist.destroy_process_group()
    return learner


if __name__ == '__main__':
    main(sys.argv[1:])
