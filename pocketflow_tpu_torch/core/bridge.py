"""Carry the JAX package's parameters into the port's modules.

The two frameworks cannot draw the same random initial weights, so every
parity test starts both packages from one set of parameters: the JAX
learner's ``jax.device_get(state.params)`` and ``state.batch_stats`` (nested
dicts of numpy arrays) go through ``from_jax_numpy`` into the port.

The port names its parameters after the Flax paths, so the mapping is a
rename from 'a/b/c' to 'a.b.c' with the layouts kept: conv kernels stay HWIO
(the policy quantizes them in that layout), dense kernels [in, out], BN
``scale``/``bias`` parameters and ``mean``/``var`` running statistics.  Any
other leaf raises, and ``load_jax_numpy`` raises on any port parameter or
buffer left unset.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

# leaf names the bridge maps: (collection, leaf) -> where it lands in the port
_PARAM_LEAVES = ('kernel', 'bias', 'scale')
_STAT_LEAVES = ('mean', 'var')


def _flatten(tree: Mapping[str, Any], prefix: str = '') -> Dict[str, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        path = '%s/%s' % (prefix, key) if prefix else str(key)
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def from_jax_numpy(params: Mapping[str, Any], batch_stats: Mapping[str, Any]
                   ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Map Flax params and batch_stats to (parameters, buffers) keyed by the
    port's state-dict names.  Raises KeyError on a leaf it does not map."""
    state_dict, buffers = {}, {}
    for path, value in _flatten(params).items():
        parts = path.split('/')
        leaf = parts[-1]
        is_bn = len(parts) >= 2 and parts[-2] == 'bn'
        if leaf not in _PARAM_LEAVES or (leaf == 'scale' and not is_bn):
            raise KeyError('bridge: unmapped parameter %r' % path)
        state_dict['.'.join(parts)] = torch.from_numpy(np.array(value, np.float32))
    for path, value in _flatten(batch_stats).items():
        parts = path.split('/')
        if parts[-1] not in _STAT_LEAVES or len(parts) < 2 or parts[-2] != 'bn':
            raise KeyError('bridge: unmapped batch statistic %r' % path)
        buffers['.'.join(parts)] = torch.from_numpy(np.array(value, np.float32))
    return state_dict, buffers


def load_jax_numpy(model: torch.nn.Module, params: Mapping[str, Any],
                   batch_stats: Mapping[str, Any]) -> torch.nn.Module:
    """Copy JAX params and batch_stats into `model` in place.  Raises on an
    unmapped key, a shape mismatch, or a port parameter/buffer left unset."""
    state_dict, buffers = from_jax_numpy(params, batch_stats)
    values = {**state_dict, **buffers}
    target = model.state_dict()
    missing = sorted(set(target) - set(values))
    unexpected = sorted(set(values) - set(target))
    if missing or unexpected:
        raise KeyError('bridge: port entries left unset %s; JAX entries with no '
                       'port counterpart %s' % (missing, unexpected))
    for name, value in values.items():
        if tuple(target[name].shape) != tuple(value.shape):
            raise ValueError('bridge: %s has shape %s in JAX and %s in the port'
                             % (name, tuple(value.shape), tuple(target[name].shape)))
    model.load_state_dict(values, strict=True)
    return model
