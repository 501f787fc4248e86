"""Device selection helpers (counterpart of pocketflow_tpu/utils/devices.py).

``list_devices`` and ``pick_devices`` choose among the CUDA devices of this
host, and ``rank_device`` gives a data-parallel rank its own: ``cuda:LOCAL_RANK``,
one process per GPU as torchrun launches them.  The JAX package's
``honor_jax_platforms`` has no counterpart: keeping a program on the CPU is
the port's explicit ``device`` argument (``main.main(argv, device='cpu')``).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from pocketflow_tpu_torch.core import mesh


def list_devices() -> List[torch.device]:
    """The CUDA devices of this host, in order."""
    if not torch.cuda.is_available():
        return []
    return [torch.device('cuda', i) for i in range(torch.cuda.device_count())]


def pick_devices(nb_devices: Optional[int] = None) -> List[torch.device]:
    """The first `nb_devices` CUDA devices (all when None)."""
    devices = list_devices()
    if nb_devices is None:
        return devices
    if nb_devices > len(devices):
        raise RuntimeError('requested %d devices but only %d are available'
                           % (nb_devices, len(devices)))
    return devices[:nb_devices]


def rank_device() -> torch.device:
    """This rank's CUDA device, ``cuda:LOCAL_RANK``; raises where the host
    has no such device."""
    index = mesh.local_rank()
    devices = list_devices()
    if index >= len(devices):
        raise RuntimeError('rank %d (LOCAL_RANK %d) wants cuda:%d but this host has %d CUDA '
                           'devices' % (mesh.worker_rank(), index, index, len(devices)))
    return devices[index]
