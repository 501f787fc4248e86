import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the driver's workers share the machine's cores
torch.set_num_threads(max(1, min(4, (os.cpu_count() or 2) // 4)))

# a tiny size the CPU holds: 64x64 images, 8 a batch, few staged inputs
TINY = {'cfg.image_size': 64, 'cfg.flags': {'ilsvrc_image_size': 64}, 'traffic.batch': 8,
        'traffic.distinct_batches': 4, 'traffic.distinct_requests': 2,
        'traffic.warmup_requests': 1, 'traffic.warmup_steps': 4}
# 128x128 and 16 a batch: uniform-tf's 8-bit activation grid turns float
# rounding into whole steps at some elements, so at 64x64 and 8 a batch
# even the float32 program leaves its full-size limits, here it keeps
# them; and the float8 control's rounding of the first BN's sums, which
# grows with the positions summed, here passes the worst leaf's limit
SMALL = {**TINY, 'cfg.image_size': 128, 'cfg.flags': {'ilsvrc_image_size': 128},
         'traffic.batch': 16}


def sizes(cell, small=False, **flags):
    """The tiny sizes of `cell` (`small`: the larger of the two), with
    program flags on top."""
    base = SMALL if small or 'uqtf' in cell else TINY
    return {**base, 'cfg.flags': {**base['cfg.flags'], **flags}}


@pytest.fixture
def root():
    return ROOT


@pytest.fixture
def cuda():
    """Skips a test that needs the card where there is none (decided here,
    never while the module is imported)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
