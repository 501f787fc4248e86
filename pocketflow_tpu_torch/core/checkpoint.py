"""The port's own checkpoints: ``torch.save`` of a train state under
``<save_path>-<step>.pt``, with a JSON index naming the newest one.

A minimal counterpart of pocketflow_tpu/core/checkpoint.py (msgpack/orbax,
multi-process); that format is not read here — JAX parameters come across
through ``core/bridge.py``.  ``restore_intersecting`` grafts the parameters
of a checkpoint into a model by name and shape (a detector's backbone from a
classification checkpoint).  Files hold tensors and plain containers only and
are loaded with ``weights_only=True``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

from pocketflow_tpu_torch.core import mesh

INDEX = 'checkpoint.json'


def _index_path(save_dir: str) -> str:
    return os.path.join(save_dir, INDEX)


def save(save_path: str, payload: Dict[str, Any], step: int) -> str:
    """Write `payload` to ``<save_path>-<step>.pt`` (atomically) and index it;
    under data parallelism only rank 0 writes, and every rank returns the
    path (the caller's barrier makes the file visible to all)."""
    path = '%s-%d.pt' % (save_path, step)
    if not mesh.is_primary_worker():
        return path
    save_dir = os.path.dirname(save_path) or '.'
    os.makedirs(save_dir, exist_ok=True)
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


def restore_intersecting(save_path: str, model: torch.nn.Module,
                         prefix_map: Optional[Dict[str, str]] = None) -> int:
    """Copy into `model`, in place, every parameter of the newest checkpoint
    under `save_path`'s directory whose path and shape match one of its
    parameters; the rest keep their values.  Paths are Flax-style
    ('stage1_block0/conv1/kernel'); `prefix_map` rewrites a source prefix
    first (the first that matches; {'': 'backbone/'} puts a classification
    trunk under 'backbone/').  Parameters only, as the JAX package grafts
    its 'params' tree.  Returns the number of tensors copied (0 without a
    checkpoint)."""
    payload = restore_latest(save_path, map_location='cpu')
    if payload is None:
        return 0
    src = {}
    for key, value in payload['model'].items():
        key = key.replace('.', '/')
        for old, new in (prefix_map or {}).items():
            if key.startswith(old):
                key = new + key[len(old):]
                break
        src[key] = value
    count = 0
    with torch.no_grad():
        for name, param in model.named_parameters():
            cand = src.get(name.replace('.', '/'))
            if cand is not None and tuple(cand.shape) == tuple(param.shape):
                param.copy_(cand)
                count += 1
    return count
