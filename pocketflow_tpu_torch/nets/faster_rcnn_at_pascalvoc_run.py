"""Entry script for faster_rcnn_at_pascalvoc (counterpart of pocketflow_tpu/nets/faster_rcnn_at_pascalvoc_run.py):
the port's dispatcher with the model chosen.

    python -m pocketflow_tpu_torch.nets.faster_rcnn_at_pascalvoc_run [--learner=... flags]
"""

import sys


def main(argv=None, device='cuda'):
    from pocketflow_tpu_torch import main as dispatcher
    argv = sys.argv[1:] if argv is None else list(argv)
    return dispatcher.main(['--model=faster_rcnn_at_pascalvoc'] + argv, device=device)


if __name__ == '__main__':
    main()
