"""Entry script for convnet_at_fmnist (counterpart of pocketflow_tpu/nets/convnet_at_fmnist_run.py):
the port's dispatcher with the model chosen.

    python -m pocketflow_tpu_torch.nets.convnet_at_fmnist_run [--learner=... flags]
"""

import sys


def main(argv=None, device='cuda'):
    from pocketflow_tpu_torch import main as dispatcher
    argv = sys.argv[1:] if argv is None else list(argv)
    return dispatcher.main(['--model=convnet_at_fmnist'] + argv, device=device)


if __name__ == '__main__':
    main()
