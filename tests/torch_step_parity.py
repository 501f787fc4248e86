"""One train step of a port learner against the JAX learner's, from one
bridged JAX state, for tests/test_torch_uniform_tf.py and
tests/test_torch_nonuniform.py.

Each side's step is a function of (snapshot, images, labels) returning the
state after it as one flat dict of numpy arrays: the parameters and BN
statistics under their Flax paths ('block01/dw/kernel',
'block01/bn_dw/bn/mean') and the learner's extra under 'extra/...'
('extra/act_min', 'extra/codebooks/conv1').  The JAX step also runs three
times more: with the images and with the starting parameters perturbed by
1e-7 relative, and with the batch in reverse order.  Each tensor is held to
the bound of tests/torch_slice_parity.py: ||port - jax|| <= ||ATOL +
RTOL*|jax||| + NOISE_FACTOR * the largest ||rerun - jax||.
"""

import jax
import numpy as np

from torch_slice_parity import PERTURBATION, _flat, _tolerance


def flat_state(params, batch_stats, extra):
    """The flat dict of a state: parameters, BN statistics, 'extra/...'."""
    out = {**_flat(params), **_flat(batch_stats)}
    out.update({'extra/' + k: v for k, v in _flat(extra).items()})
    return out


def perturbed(tree, rng):
    """Every leaf scaled by 1 + PERTURBATION * N(0, 1), in fp32."""
    return jax.tree_util.tree_map(
        lambda a: (a * (1 + PERTURBATION * rng.standard_normal(a.shape))).astype(np.float32),
        tree)


def jax_runs(jax_step, snapshot, images, labels, seed=0):
    """(the JAX step's state, [its three reruns' states]); jax_step(snapshot,
    images, labels) -> flat state."""
    rng = np.random.default_rng(seed)
    want = jax_step(snapshot, images, labels)
    noise = PERTURBATION * rng.standard_normal(images.shape)
    reruns = [jax_step(snapshot, (images * (1 + noise)).astype(np.float32), labels),
              jax_step({**snapshot, 'params': perturbed(snapshot['params'], rng)}, images,
                       labels),
              jax_step(snapshot, images[::-1].copy(), labels[::-1].copy())]
    return want, reruns


def out_of_bound(want, reruns, got):
    """The tensors of `got` outside the bound: [(key, error, bound)]."""
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    bad = []
    for key, value in want.items():
        floor = max(float(np.linalg.norm(np.asarray(r[key]) - value)) for r in reruns)
        err = float(np.linalg.norm(np.asarray(got[key], np.float32) - value))
        bound = _tolerance(value, floor)
        if not err <= bound:
            bad.append((key, err, bound))
    return bad


def moved_past_bound(start, want, reruns):
    """The share of tensors that the JAX step moves by more than their bound
    (so that a wrong update of them would show)."""
    keys = [k for k in want if k in start]
    moved = 0
    for key in keys:
        floor = max(float(np.linalg.norm(np.asarray(r[key]) - want[key])) for r in reruns)
        if float(np.linalg.norm(want[key] - start[key])) > _tolerance(want[key], floor):
            moved += 1
    return moved / len(keys)
