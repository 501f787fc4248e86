"""bench.py's composed pruned+QAT step: the QAT train step of a
UniformQuantLearner with fixed channel masks on its conv kernels, built from
the learner's ``build_train_step`` hooks (no learner API of its own)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from pocketflow_tpu_torch.learners.weight_sparsification import masking


def channel_masks(model: torch.nn.Module, seed: int = 0) -> Dict[str, torch.Tensor]:
    """bench.py's masks of the composed step, keyed by parameter name: for
    every 4-D (HWIO) kernel with more than 16 input channels, a random half
    of them (rounded up) kept, as a [1, 1, c, 1] fp32 mask; a 0-d one for
    every other parameter.  The masks are drawn in the JAX package's tree
    order, so a seed gives bench.py's masks."""
    rng = np.random.default_rng(seed)
    params = dict(model.named_parameters())
    masks = {}
    for name in sorted(params, key=lambda n: n.split('.')):
        p = params[name]
        if p.dim() == 4 and p.shape[2] > 16:
            c = p.shape[2]
            alive = np.zeros(c, np.float32)
            alive[rng.permutation(c)[:(c + 1) // 2]] = 1.0
            masks[name] = torch.from_numpy(alive.reshape(1, 1, -1, 1)).to(p.device)
        else:
            masks[name] = torch.ones((), device=p.device)
    return masks


def build_pruned_qat_step(learner, tx, state, masks: Dict[str, torch.Tensor]):
    """bench.py's composed pruned+QAT step from the learner's hooks: the QAT
    policy, the gradients of the maskable kernels masked in place, and the
    masks re-applied to the parameters after each update
    (``masking.masked_update_hooks``).  The masks go into
    ``state.extra['masks']``.  Returns (state, train_step)."""
    state = learner.set_extra(state, {**state.extra, 'masks': masks})
    grad_transform, post_update = masking.masked_update_hooks(state.model)
    return state, learner.build_train_step(tx, policy_fn=learner._policy_fn(),
                                           grad_transform_fn=grad_transform,
                                           post_update_fn=post_update)
