"""Entry script for mobilenet_at_ilsvrc12 (counterpart of pocketflow_tpu/nets/mobilenet_at_ilsvrc12_run.py):
the port's dispatcher with the model chosen.

    python -m pocketflow_tpu_torch.nets.mobilenet_at_ilsvrc12_run [--learner=... flags]
"""

import sys


def main(argv=None, device='cuda'):
    from pocketflow_tpu_torch import main as dispatcher
    argv = sys.argv[1:] if argv is None else list(argv)
    return dispatcher.main(['--model=mobilenet_at_ilsvrc12'] + argv, device=device)


if __name__ == '__main__':
    main()
