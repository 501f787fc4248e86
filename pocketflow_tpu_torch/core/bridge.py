"""Carry the JAX package's parameters into the port's modules.

The two frameworks cannot draw the same random initial weights, so every
parity test starts both packages from one set of parameters: the JAX
learner's ``jax.device_get(state.params)`` and ``state.batch_stats`` (nested
dicts of numpy arrays) go through ``from_jax_numpy`` into the port.

The port names its parameters after the Flax paths, so the mapping is a
rename from 'a/b/c' to 'a.b.c' with the layouts kept: conv kernels stay HWIO
(the policy quantizes them in that layout), dense kernels [in, out], BN
``scale``/``bias`` parameters and ``mean``/``var`` running statistics, and
SSD's ``l2norm_conv4_3/scale``.  The detectors map the same way (SSD-VGG's
``vgg/...`` trunk and heads, Faster R-CNN's ``backbone/...``,
``lateral0/1``, the RPN convs and the fc heads).  Any
other leaf raises, and ``load_jax_numpy`` raises on any port parameter or
buffer left unset.

Under tensor parallelism each rank keeps its shard of a sharded kernel
(``load_jax_numpy`` slices the JAX array), and ``to_jax_numpy`` gathers the
full arrays over the model group (every model rank calls it).

``to_jax_numpy`` is the way back: a port model's parameters and running
statistics as the Flax ``params`` and ``batch_stats`` trees (nested dicts of
float32 numpy arrays, keys sorted), on which the export tools work, so that
an artifact the port writes has the keys of one the JAX package writes.

A learner's ``state.extra`` goes through ``extra_from_jax`` (the uniform-tf
ranges, the activation bits, the non-uniform codebooks).

The DDPG agent's networks take the same route: ``ddpg_params_from_jax``
carries the Flax actor and critic params (``blocks/dense_i``, ``blocks/ln_i``,
``dense_in``, ``ln_in``, ``head``) into the port's `Actor` and `Critic`, whose
layers keep those names and Flax's [in, out] kernels, and
``ddpg_adam_from_jax`` carries optax's Adam state (the step count and the
first and second moments, by parameter name) into a ``torch.optim.Adam``.
The agent's ``restore_search`` reads a search checkpoint the JAX package
wrote through these two (its 'state' entry holds the Flax bytes of the
agent).

The discrimination-aware learner's auxiliary heads (``gamma``, ``beta``,
``fc/kernel`` [in, out], ``fc/bias`` a head site) go through
``aux_heads_from_jax``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from pocketflow_tpu_torch.core import mesh

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


def _scaled(parts) -> bool:
    """Whether a 'scale' leaf at `parts` is one the port holds: a BN's
    (under 'bn') or SSD's L2Norm's ('l2norm_conv4_3/scale')."""
    return len(parts) >= 2 and (parts[-2] == 'bn' or parts[-2].startswith('l2norm'))


def from_jax_numpy(params: Mapping[str, Any], batch_stats: Mapping[str, Any]
                   ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Map Flax params and batch_stats to (parameters, buffers) keyed by the
    port's state-dict names.  Raises KeyError on a leaf it does not map."""
    state_dict, buffers = {}, {}
    for path, value in _flatten(params).items():
        parts = path.split('/')
        leaf = parts[-1]
        if leaf not in _PARAM_LEAVES or (leaf == 'scale' and not _scaled(parts)):
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
    return _load_checked(model, {**state_dict, **buffers})


def _nest(tree: Dict[str, Any], parts, value):
    for part in parts[:-1]:
        tree = tree.setdefault(part, {})
    tree[parts[-1]] = value


def _sorted_tree(tree: Dict[str, Any]) -> Dict[str, Any]:
    return {key: _sorted_tree(value) if isinstance(value, dict) else value
            for key, value in sorted(tree.items())}


def to_jax_numpy(model: torch.nn.Module) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(params, batch_stats) of `model` as Flax trees of float32 numpy arrays:
    'stage1_block0.bn1.bn.scale' goes to params/stage1_block0/bn1/bn/scale,
    the buffer 'stage1_block0.bn1.bn.mean' to batch_stats/stage1_block0/bn1/bn/mean.
    Raises KeyError on an entry ``from_jax_numpy`` would not map back."""
    params: Dict[str, Any] = {}
    batch_stats: Dict[str, Any] = {}
    for name, value in model.named_parameters():
        parts = name.split('.')
        if parts[-1] not in _PARAM_LEAVES or (parts[-1] == 'scale' and not _scaled(parts)):
            raise KeyError('bridge: unmapped port parameter %r' % name)
        if isinstance(value, mesh.ModelShard):  # the full kernel of the model ranks' shards
            value = mesh.gather_tensor(value, mesh.shard(-1))
        _nest(params, parts, value.detach().to('cpu', torch.float32).numpy().copy())
    for name, value in model.named_buffers():
        parts = name.split('.')
        if parts[-1] not in _STAT_LEAVES or parts[-2:-1] != ['bn']:
            raise KeyError('bridge: unmapped port buffer %r' % name)
        _nest(batch_stats, parts, value.detach().to('cpu', torch.float32).numpy().copy())
    return _sorted_tree(params), _sorted_tree(batch_stats)


def _load_checked(model: torch.nn.Module, values: Dict[str, torch.Tensor]) -> torch.nn.Module:
    """load_state_dict(values, strict=True) after naming every entry left
    unset, every entry with no counterpart and every shape mismatch; a
    ModelShard of a tensor-parallel model takes its slice of the full
    array."""
    from pocketflow_tpu_torch.nn import layers
    target = model.state_dict(keep_vars=True)
    missing = sorted(set(target) - set(values))
    unexpected = sorted(set(values) - set(target))
    if missing or unexpected:
        raise KeyError('bridge: port entries left unset %s; JAX entries with no '
                       'port counterpart %s' % (missing, unexpected))
    for name, value in values.items():
        if layers.full_shape(name, target[name]) != tuple(value.shape):
            raise ValueError('bridge: %s has shape %s in JAX and %s in the port'
                             % (name, tuple(value.shape), layers.full_shape(name, target[name])))
    layers.load_full_state_dict(model, values)
    return model


def extra_from_jax(extra: Mapping[str, Any], device='cpu') -> Dict[str, Any]:
    """Map a JAX learner's ``state.extra`` (numpy) to the port's: the
    uniform-tf learner's activation ranges ``act_min``/``act_max``, the
    activation bits ``a_bits``, and the non-uniform learner's ``codebooks``
    (path -> [k, nb_buckets], each a leaf that requires grad).  Raises
    KeyError on an entry it does not map."""
    out = {}
    for key, value in extra.items():
        if key in ('act_min', 'act_max', 'a_bits'):
            out[key] = torch.tensor(np.array(value, np.float32), device=device)
        elif key == 'codebooks':
            out[key] = {path: torch.tensor(np.array(c, np.float32), device=device,
                                           requires_grad=True) for path, c in value.items()}
        else:
            raise KeyError('bridge: unmapped extra entry %r' % key)
    return out


def ddpg_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Map the params of a Flax DDPG actor or critic to the port's
    state-dict names.  Raises KeyError on a leaf it does not map."""
    state_dict = {}
    for path, value in _flatten(params).items():
        parts = path.split('/')
        layer, leaf = (parts[-2] if len(parts) >= 2 else ''), parts[-1]
        dense = (layer.startswith('dense_') or layer == 'head') and leaf in ('kernel', 'bias')
        norm = layer.startswith('ln_') and leaf in ('scale', 'bias')
        if not (dense or norm):
            raise KeyError('bridge: unmapped DDPG parameter %r' % path)
        state_dict['.'.join(parts)] = torch.from_numpy(np.array(value, np.float32))
    return state_dict


def ddpg_params_from_jax(actor: torch.nn.Module, critic: torch.nn.Module,
                         actor_params: Mapping[str, Any], critic_params: Mapping[str, Any]):
    """Copy the JAX agent's actor and critic params into the port's modules
    in place.  Raises on an unmapped leaf, a shape mismatch, or a port
    parameter left unset."""
    for module, params in ((actor, actor_params), (critic, critic_params)):
        _load_checked(module, ddpg_state_dict_from_jax(params))
    return actor, critic


def ddpg_adam_from_jax(optimizer: torch.optim.Optimizer, module: torch.nn.Module,
                       adam_state: Mapping[str, Any]):
    """Load optax's ``ScaleByAdamState`` of `module`'s parameters ({'count',
    'mu', 'nu'}, the moments as Flax trees) into `module`'s Adam optimizer,
    in place: each parameter's step is the count, its ``exp_avg`` and
    ``exp_avg_sq`` the moments at its name.  Raises KeyError on a moment
    without a parameter or a parameter without its moments, ValueError on a
    shape mismatch."""
    count = float(np.asarray(adam_state['count']))
    moments = {key: ddpg_state_dict_from_jax(adam_state[key]) for key in ('mu', 'nu')}
    named = list(module.named_parameters())
    names = {name for name, _ in named}
    for key, values in moments.items():
        if set(values) != names:
            raise KeyError('bridge: Adam %s entries %s, the module\'s parameters %s'
                           % (key, sorted(values), sorted(names)))
    state = {}
    for idx, (name, param) in enumerate(named):
        mu, nu = moments['mu'][name], moments['nu'][name]
        if tuple(mu.shape) != tuple(param.shape) or tuple(nu.shape) != tuple(param.shape):
            raise ValueError('bridge: Adam moments of %s have shape %s in JAX and %s in the '
                             'port' % (name, tuple(mu.shape), tuple(param.shape)))
        state[idx] = {'step': torch.tensor(count, dtype=torch.float32),
                      'exp_avg': mu.to(param.device), 'exp_avg_sq': nu.to(param.device)}
    optimizer.load_state_dict({'state': state,
                               'param_groups': optimizer.state_dict()['param_groups']})
    return optimizer


def aux_heads_from_jax(heads: Mapping[str, torch.nn.Module], params: Mapping[str, Any]):
    """Copy the JAX auxiliary heads' params ({site: {'gamma', 'beta', 'fc':
    {'kernel', 'bias'}}}) into the port's heads (site -> AuxHead) in place.
    Raises on a missing or extra site, an unmapped leaf, a shape mismatch,
    or a parameter left unset."""
    if set(heads) != set(params):
        raise KeyError('bridge: head sites %s in the port, %s in JAX'
                       % (sorted(heads), sorted(params)))
    for site, head in heads.items():
        state_dict = {}
        for path, value in _flatten(params[site]).items():
            if path not in ('gamma', 'beta', 'fc/kernel', 'fc/bias'):
                raise KeyError('bridge: unmapped head parameter %r of %s' % (path, site))
            state_dict[path.replace('/', '.')] = torch.from_numpy(np.array(value, np.float32))
        _load_checked(head, state_dict)
    return heads
