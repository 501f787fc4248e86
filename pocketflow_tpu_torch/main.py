"""Entry point of the PyTorch port (counterpart of the repository's main.py).

Selects the model helper by ``--model`` (or a positional name) and runs the
learner chosen by ``--learner`` on one CUDA device.

Usage:
    python -m pocketflow_tpu_torch.main --model=resnet_at_ilsvrc12 --learner=uniform \\
        --synthetic_data --nb_epochs_rat=0.001 [--exec_mode=train|eval] [flags...]
"""

import importlib
import sys

MODELS = {
    'resnet_at_ilsvrc12': 'pocketflow_tpu_torch.nets.resnet_at_ilsvrc12',
}

# model helpers of the JAX package that wait for a later slice
NOT_PORTED = ('convnet_at_fmnist', 'lenet_at_cifar10', 'resnet_at_cifar10',
              'mobilenet_at_ilsvrc12', 'vgg_at_pascalvoc', 'faster_rcnn_at_pascalvoc')


def main(argv=None, device='cuda'):
    from pocketflow_tpu_torch.config import FLAGS
    from pocketflow_tpu_torch.core.metrics import SummaryWriter, get_logger
    from pocketflow_tpu_torch.learners import create_learner
    # register the flags of every ported module before parsing
    import pocketflow_tpu_torch.learners.uniform_quantization.learner  # noqa: F401
    for module in MODELS.values():
        importlib.import_module(module)

    FLAGS.DEFINE_string('model', 'convnet_at_fmnist',
                        'model helper: ' + ' | '.join(sorted(MODELS)))
    leftovers = FLAGS.parse_args(argv)
    model_name = FLAGS.model
    for arg in leftovers:  # allow a bare positional model name
        if arg in MODELS or arg in NOT_PORTED:
            model_name = arg
        elif arg.startswith('-'):
            raise SystemExit('unrecognized flag %r (see --help)' % arg)
    if model_name in NOT_PORTED:
        raise NotImplementedError(
            "model %r is not ported yet (ROADMAP 'Modules to port', items 12 and 19-24)"
            % model_name)
    if model_name not in MODELS:
        raise SystemExit('unknown model %r' % model_name)

    log = get_logger()
    log.info('model = %s | learner = %s | exec_mode = %s',
             model_name, FLAGS.learner, FLAGS.exec_mode)
    module = importlib.import_module(MODELS[model_name])
    sm_writer = SummaryWriter(FLAGS.log_dir)
    try:
        learner = create_learner(sm_writer, module.ModelHelper(), device=device)
        if FLAGS.exec_mode == 'train':
            learner.train()
        elif FLAGS.exec_mode == 'eval':
            learner.evaluate()
        else:
            raise ValueError('unrecognized execution mode: ' + FLAGS.exec_mode)
    finally:
        sm_writer.close()


if __name__ == '__main__':
    main(sys.argv[1:])
