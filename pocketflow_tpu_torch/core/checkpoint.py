"""The port's own checkpoints: ``torch.save`` of a train state under
``<save_path>-<step>.pt``, with a JSON index naming the newest one.

A minimal counterpart of pocketflow_tpu/core/checkpoint.py (msgpack/orbax,
multi-process); that format is not read here — JAX parameters come across
through ``core/bridge.py``.  Files hold tensors and plain containers only and
are loaded with ``weights_only=True``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

INDEX = 'checkpoint.json'


def _index_path(save_dir: str) -> str:
    return os.path.join(save_dir, INDEX)


def save(save_path: str, payload: Dict[str, Any], step: int) -> str:
    """Write `payload` to ``<save_path>-<step>.pt`` (atomically) and index it."""
    save_dir = os.path.dirname(save_path) or '.'
    os.makedirs(save_dir, exist_ok=True)
    path = '%s-%d.pt' % (save_path, step)
    torch.save(payload, path + '.tmp')
    os.replace(path + '.tmp', path)
    tmp_index = _index_path(save_dir) + '.tmp'
    with open(tmp_index, 'w') as fout:
        json.dump({'latest': os.path.basename(path), 'step': step}, fout)
    os.replace(tmp_index, _index_path(save_dir))
    return path


def latest_checkpoint(save_dir: str) -> Optional[str]:
    """Path of the newest checkpoint in `save_dir`, or None."""
    idx = _index_path(save_dir)
    if not os.path.exists(idx):
        return None
    with open(idx) as fin:
        meta = json.load(fin)
    path = os.path.join(save_dir, meta['latest'])
    return path if os.path.exists(path) else None


def restore_latest(save_path: str, map_location=None) -> Optional[Dict[str, Any]]:
    """The newest payload saved under `save_path`'s directory, or None."""
    path = latest_checkpoint(os.path.dirname(save_path) or '.')
    if path is None:
        return None
    return torch.load(path, map_location=map_location, weights_only=True)
