"""Masks and the dynamic pruning-ratio schedule for weight sparsification
(counterpart of pocketflow_tpu/learners/weight_sparsification/masking.py).

Parameters are dicts keyed by the port's parameter names
(``model.named_parameters()``: 'stage1_block0.conv1.kernel', the Flax path
with dots), and masks and backups dicts with the same keys.  Maskable are the
'kernel' leaves of conv and dense layers, except those under a depthwise
module (a parent named 'dw*').  A non-maskable entry carries a 0-d
placeholder, as in the JAX package.

The functions return new tensors, as the JAX package's do; ``mask_gradients_``
and ``apply_masks_`` multiply in place instead (the train step's gradient
hook and post-update re-zero, which need no second copy of the parameters).
Dict order is the JAX package's tree order (keys sorted at every level).

Under tensor parallelism a kernel held as a ``mesh.ModelShard`` keeps its
shard's mask and backup; its percentile threshold is the full kernel's (the
backup gathered over the model group at a refresh, which is rare), its
shape in ``maskable_shapes`` the full one, and ``calc_prune_ratio`` counts
its zeros over the model group.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence, Tuple, Union

import numpy as np
import torch

from pocketflow_tpu_torch.config import FLAGS
from pocketflow_tpu_torch.core import mesh
from pocketflow_tpu_torch.nn import layers

FLAGS.DEFINE_float('ws_prune_ratio_exp', 3.0, "WS: pruning ratio's exponent term")
FLAGS.DEFINE_float('ws_iter_ratio_beg', 0.1, 'WS: iteration ratio (at starting time)')
FLAGS.DEFINE_float('ws_iter_ratio_end', 0.5, 'WS: iteration ratio (at ending time)')

Path = Union[str, Sequence[str]]
Tensors = Mapping[str, torch.Tensor]


def path_str(path: Path) -> str:
    """The parameter name of a path: 'conv1.kernel' for ('conv1', 'kernel')."""
    return path if isinstance(path, str) else '.'.join(str(p) for p in path)


def _parts(path: Path) -> List[str]:
    return path.split('.') if isinstance(path, str) else [str(p) for p in path]


def is_maskable_path(path: Path) -> bool:
    """Kernel leaves of conv/dense layers; a kernel under a depthwise module
    ('dw*') is not maskable."""
    parts = _parts(path)
    if parts[-1] != 'kernel':
        return False
    return not (len(parts) >= 2 and parts[-2].startswith('dw'))


def _tree_order(params: Tensors) -> List[str]:
    return sorted(params, key=_parts)


def maskable_paths(params: Tensors) -> List[str]:
    """Names of the maskable parameters, in the JAX package's tree order."""
    return [name for name in _tree_order(params) if is_maskable_path(name)]


def maskable_shapes(params: Tensors) -> List[Tuple[int, ...]]:
    """The maskable parameters' shapes (a ModelShard's full kernel's)."""
    return [layers.full_shape(name, params[name]) for name in maskable_paths(params)]


def _mask_of(param: torch.Tensor, weights: torch.Tensor, prune_ratio) -> torch.Tensor:
    """percentile_mask(weights, prune_ratio); where `param` is a ModelShard,
    the threshold is its full kernel's: `weights` (its shard's) gathered,
    masked, and cut back to the shard."""
    if not isinstance(param, mesh.ModelShard):
        return percentile_mask(weights, prune_ratio)
    full = percentile_mask(mesh.all_gather_model(weights.contiguous(), -1), prune_ratio)
    return mesh.shard_tensor(full, mesh.shard(-1))


def build_mask_state(params: Tensors) -> Dict[str, Dict[str, torch.Tensor]]:
    """All-ones masks and fp32 weight backups; 0-d placeholders elsewhere."""
    masks, bkups = {}, {}
    for name in _tree_order(params):
        p = params[name]
        if is_maskable_path(name):
            masks[name] = torch.ones(p.shape, dtype=torch.float32, device=p.device)
            bkups[name] = p.detach().to(torch.float32).clone()
        else:
            masks[name] = torch.ones((), dtype=torch.float32, device=p.device)
            bkups[name] = torch.zeros((), dtype=torch.float32, device=p.device)
    return {'masks': masks, 'bkups': bkups}


def dynamic_prune_ratio(step, nb_iters_train: int, prune_ratio_fnl) -> torch.Tensor:
    """Zhu & Gupta's schedule: pr(t) = pr_fnl * (1 - (1 - base)^ws_prune_ratio_exp),
    base = the progress between ws_iter_ratio_beg and ws_iter_ratio_end,
    clamped to [0, 1]."""
    idx_beg = int(nb_iters_train * FLAGS.ws_iter_ratio_beg)
    idx_end = int(nb_iters_train * FLAGS.ws_iter_ratio_end)
    denom = max(1, idx_end - idx_beg)
    base = (torch.as_tensor(step).to(torch.float32) - idx_beg) / denom
    base = torch.clamp(base, 0.0, 1.0)
    return prune_ratio_fnl * (1.0 - torch.pow(1.0 - base, FLAGS.ws_prune_ratio_exp))


# above this size, find the percentile threshold by bisection (compare and
# count passes) instead of torch.quantile's full sort
_BISECT_MIN_SIZE = 1 << 16


def percentile_threshold_bisect(mag: torch.Tensor, prune_ratio, nb_iters: int = 26) -> torch.Tensor:
    """Threshold t such that the fraction of |w| <= t approximates
    prune_ratio, by bisection on [0, max(mag)]: each iteration is one
    compare-and-count pass over the tensor."""
    flat = mag.reshape(-1).to(torch.float32)
    n = flat.shape[0]
    target = torch.clamp(torch.as_tensor(prune_ratio, dtype=torch.float32,
                                         device=flat.device), 0.0, 1.0) * n
    lo = torch.zeros((), dtype=torch.float32, device=flat.device)
    hi = flat.max()
    for _ in range(nb_iters):
        mid = (lo + hi) * 0.5
        below = (flat <= mid).sum().to(torch.float32) < target
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid)
    return (lo + hi) * 0.5


def percentile_mask(weights: torch.Tensor, prune_ratio) -> torch.Tensor:
    """mask = |w| > percentile(|w|, prune_ratio * 100), in fp32.  A ratio
    <= 0 keeps everything (the quantile at 0 is min |w|, which the formula
    would prune)."""
    mag = weights.detach().to(torch.float32).abs()
    ratio = torch.as_tensor(prune_ratio, dtype=torch.float32, device=mag.device)
    if mag.numel() >= _BISECT_MIN_SIZE:
        thres = percentile_threshold_bisect(mag, ratio)
    else:
        thres = torch.quantile(mag.reshape(-1), torch.clamp(ratio, 0.0, 1.0))
    mask = (mag > thres).to(torch.float32)
    return torch.where(ratio <= 0.0, torch.ones_like(mask), mask)


def prune_update(params: Tensors, extra: Mapping[str, Tensors], step, nb_iters_train: int,
                 ratios_fnl: Mapping[str, float]):
    """One prune step: refresh the backups of the weights the mask keeps,
    recompute the masks at the dynamic ratio, zero the pruned weights.
    Returns (new params, {'masks', 'bkups'})."""
    masks, bkups = extra['masks'], extra['bkups']
    new_params, new_masks, new_bkups = {}, {}, {}
    for name in _tree_order(params):
        p, m, b = params[name], masks[name], bkups[name]
        if not is_maskable_path(name):
            new_params[name], new_masks[name], new_bkups[name] = p, m, b
            continue
        ratio = dynamic_prune_ratio(step, nb_iters_train, float(ratios_fnl[name]))
        b = torch.where(m > 0.5, p.detach().to(torch.float32), b)
        m = _mask_of(p, b, ratio)
        new_params[name], new_masks[name], new_bkups[name] = (b * m).to(p.dtype), m, b
    return new_params, {'masks': new_masks, 'bkups': new_bkups}


def mask_gradients(grads: Tensors, masks: Tensors) -> Dict[str, torch.Tensor]:
    """grad * mask on the maskable entries."""
    return {name: grads[name] * masks[name].to(grads[name].dtype) if is_maskable_path(name)
            else grads[name] for name in _tree_order(grads)}


def apply_masks(params: Tensors, masks: Tensors) -> Dict[str, torch.Tensor]:
    """params * mask on the maskable entries (the prune without a refresh)."""
    return {name: (params[name].to(torch.float32) * masks[name]).to(params[name].dtype)
            if is_maskable_path(name) else params[name] for name in _tree_order(params)}


@torch.no_grad()
def mask_gradients_(grads: Tensors, masks: Tensors):
    """``mask_gradients`` in place, in one foreach call (entries whose
    gradient is None are skipped)."""
    names = [name for name, g in grads.items() if g is not None and is_maskable_path(name)]
    if names:
        torch._foreach_mul_([grads[n] for n in names],
                            [masks[n].to(grads[n].dtype) for n in names])


@torch.no_grad()
def apply_masks_(params: Tensors, masks: Tensors):
    """``apply_masks`` in place, in one foreach call: the same product for
    fp32 parameters, and for masks of zeros and ones in any dtype."""
    names = [name for name in params if is_maskable_path(name)]
    if names:
        torch._foreach_mul_([params[n] for n in names],
                            [masks[n].to(params[n].dtype) for n in names])


def masked_update_hooks(model: torch.nn.Module):
    """(grad_transform_fn, post_update_fn) for a train step that keeps
    ``state.extra['masks']``: the maskable parameters' gradients masked in
    place after the backward, and the masks re-applied after each update.
    The step updates `model`'s parameters in place, so they are looked up
    once, here."""
    params = dict(model.named_parameters())
    maskable = {name: params[name] for name in maskable_paths(params)}

    def grad_transform(state):
        mask_gradients_({n: p.grad for n, p in maskable.items()}, state.extra['masks'])

    def post_update(state):
        apply_masks_(maskable, state.extra['masks'])
        return state

    return grad_transform, post_update


def masks_from_ratios(params: Tensors, ratios: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Masks at explicit per-layer ratios (the ratio optimizer's roll-outs)."""
    out = {}
    for name in _tree_order(params):
        p = params[name]
        if is_maskable_path(name):
            out[name] = _mask_of(p, p, torch.as_tensor(ratios[name], dtype=torch.float32))
        else:
            out[name] = torch.ones((), dtype=torch.float32, device=p.device)
    return out


def calc_prune_ratio(params: Tensors, maskable_only: bool = False) -> torch.Tensor:
    """The overall fraction of zero weights (a ModelShard's nonzeros summed
    over the model group: the full kernel's)."""
    nnz, shard_nnz, tot = 0.0, [], 0
    for name in _tree_order(params):
        if maskable_only and not is_maskable_path(name):
            continue
        count = (params[name] != 0).sum().to(torch.float32)
        if isinstance(params[name], mesh.ModelShard):
            shard_nnz.append(count)
        else:
            nnz = nnz + count
        tot += int(np.prod(layers.full_shape(name, params[name])))
    if shard_nnz:
        nnz = nnz + mesh.all_reduce_sum_model_(torch.stack(shard_nnz).sum().reshape(1))[0]
    return 1.0 - torch.as_tensor(nnz, dtype=torch.float32) / max(tot, 1)
