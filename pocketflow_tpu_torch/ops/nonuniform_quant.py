"""Non-uniform (learned codebook) quantization with STE and exact codebook
gradients (counterpart of pocketflow_tpu/ops/nonuniform_quant.py).

    x_norm = (x - min) / (max - min + 1e-10)        (per tensor / per bucket column)
    assign = argmin_j |x_norm - c_j|                (k = 2^bits clusters, first on ties)
    q      = alpha * c[assign] + beta

``nonuniform_quant_2d`` is a ``torch.autograd.Function``: d q / d x = 1 (the
straight-through estimator), and d q / d c is the exact gather gradient,
cluster j of column b summing alpha * the cotangents of the positions
assigned to it (``index_add_``; on the card these sums are atomic and their
order varies).  Plain PyTorch on every device: the reference leaves these ops
to XLA and has no kernel for them.

Bucketing: 'split' reshapes the flattened tensor to [bucket_size, nb_buckets]
(padding with the last element), 'channel' to [-1, c_out]; scaling and
codebooks are then per bucket column.  Codebook initialization: 'uniform'
(linspace), 'quantile' (percentiles of the normalized weights) or 'kmeans'
(Lloyd refinement from the uniform start).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

EPS = 1e-10

# bound the [rows, k, b] argmin intermediate (fp32 elements): with k = 256
# codebooks on multi-million-element kernels the unchunked tensor would
# need GBs (1 GB at 8 bits for a 1M-weight kernel)
_ASSIGN_CHUNK_ELEMS = 4 * 1024 * 1024


def _normalize(x2d: torch.Tensor, per_column: bool):
    """(x_norm in fp32, alpha, beta), alpha and beta detached: per column
    ([1, b]) or per tensor (0-d)."""
    x32 = x2d.to(torch.float32)
    if per_column:
        w_max, w_min = x32.amax(0, keepdim=True), x32.amin(0, keepdim=True)
    else:
        w_max, w_min = x32.max(), x32.min()
    alpha = (w_max - w_min + EPS).detach()
    beta = w_min.detach()
    return (x32 - beta) / alpha, alpha, beta


def _assign_and_gather(x_norm: torch.Tensor, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_norm [n, b], c [k, b] -> (q [n, b], assign [n, b] int64), the rows
    in chunks that keep the [rows, k, b] distances under _ASSIGN_CHUNK_ELEMS
    (rows are independent: clusters are per column)."""
    n, b = x_norm.shape
    k = c.shape[0]
    rows = n if n * k * b <= _ASSIGN_CHUNK_ELEMS else max(1, min(n, _ASSIGN_CHUNK_ELEMS // (k * b)))
    assign = torch.cat([(x_norm[i:i + rows, None, :] - c[None]).abs().argmin(1)
                        for i in range(0, n, rows)])
    return torch.gather(c, 0, assign), assign


class _NonUniformQuant2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, c, per_column):
        x_norm, alpha, beta = _normalize(x2d, per_column)
        q, assign = _assign_and_gather(x_norm, c.detach())
        ctx.save_for_backward(assign, alpha)
        ctx.c_shape = tuple(c.shape)
        return (alpha * q + beta).to(x2d.dtype)

    @staticmethod
    def backward(ctx, g):
        assign, alpha = ctx.saved_tensors
        k, b = ctx.c_shape
        galpha = g.to(torch.float32) * alpha
        # dc[j, col] sums g * alpha over the rows assigned to j in that column
        seg = assign * b + torch.arange(b, device=assign.device)
        dc = torch.zeros(k * b, dtype=torch.float32, device=g.device)
        dc.index_add_(0, seg.reshape(-1), galpha.reshape(-1))
        return g, dc.reshape(k, b), None


def nonuniform_quant_2d(x2d: torch.Tensor, c: torch.Tensor, per_column: bool) -> torch.Tensor:
    """Codebook-quantize a 2-D tensor; c is [k, nb_buckets] (or [k, 1])."""
    return _NonUniformQuant2d.apply(x2d, c, per_column)


# ---------------------------------------------------------------------------
# shape plumbing: tensor <-> 2-D bucket layout
# ---------------------------------------------------------------------------

def to_buckets(x: torch.Tensor, bucket_type: Optional[str],
               bucket_size: int) -> Tuple[torch.Tensor, int, bool]:
    """Reshape to [rows, nb_buckets]; returns (x2d, padded, per_column)."""
    if bucket_type is None:
        return x.reshape(-1, 1), 0, False
    if bucket_type == 'channel':
        return x.reshape(-1, x.shape[-1]), 0, True
    if bucket_type == 'split':
        flat = x.reshape(-1)
        n = flat.shape[0]
        nb_buckets = -(-n // bucket_size)
        pad = nb_buckets * bucket_size - n
        if pad:
            flat = torch.cat([flat, flat[-1:].expand(pad)])
        return flat.reshape(bucket_size, nb_buckets), pad, True
    raise ValueError('unrecognized bucket type: %r' % (bucket_type,))


def from_buckets(q2d: torch.Tensor, shape, pad: int) -> torch.Tensor:
    flat = q2d.reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def nonuniform_quant(x: torch.Tensor, c: torch.Tensor, bucket_type: Optional[str],
                     bucket_size: int) -> torch.Tensor:
    """Quantize any-shape x against codebook c ([k, nb_buckets])."""
    x2d, pad, per_column = to_buckets(x, bucket_type, bucket_size)
    return from_buckets(nonuniform_quant_2d(x2d, c, per_column), x.shape, pad)


# ---------------------------------------------------------------------------
# codebook initialization
# ---------------------------------------------------------------------------

@torch.no_grad()
def lloyd_refine(x_norm: torch.Tensor, c: torch.Tensor, nb_iters: int = 25) -> torch.Tensor:
    """K-means (Lloyd) refinement of per-column codebooks, x_norm [n, b], c
    [k, b]: each step assigns every element to its nearest cluster (in row
    chunks) and moves each cluster with members to their mean."""
    k, b = c.shape
    cols = torch.arange(b, device=x_norm.device)
    ones = torch.ones(x_norm.numel(), dtype=torch.float32, device=x_norm.device)
    for _ in range(nb_iters):
        _, assign = _assign_and_gather(x_norm, c)
        seg = (assign * b + cols).reshape(-1)
        sums = torch.zeros(k * b, dtype=torch.float32, device=x_norm.device)
        sums.index_add_(0, seg, x_norm.reshape(-1))
        counts = torch.zeros(k * b, dtype=torch.float32, device=x_norm.device)
        counts.index_add_(0, seg, ones)
        sums, counts = sums.reshape(k, b), counts.reshape(k, b)
        c = torch.where(counts > 0, sums / counts.clamp_min(1.0), c)
    return c


def _unit_levels(k: int, device) -> torch.Tensor:
    """k levels from 0 to 1 as the reference's jnp.linspace(0, 1, k) lays
    them: i times the fp32 reciprocal of k - 1 (XLA's form of the division),
    the last one exactly 1."""
    levels = torch.arange(k, dtype=torch.float32, device=device) * (
        torch.tensor(1.0) / torch.tensor(float(max(1, k - 1))))
    levels[-1] = 1.0
    return levels


@torch.no_grad()
def init_codebook(x: torch.Tensor, bits: int, init_style: str, bucket_type: Optional[str],
                  bucket_size: int) -> torch.Tensor:
    """[k, nb_buckets] initial clusters from the normalized weights, fp32:
    'uniform' (linspace on [0, 1]), 'quantile' (the (i + 1) / (k + 1)
    percentiles, linear interpolation), 'kmeans' (Lloyd from the uniform
    start)."""
    k = int(2 ** bits)
    x2d, _, per_column = to_buckets(x, bucket_type, bucket_size)
    x_norm, _, _ = _normalize(x2d, per_column)
    nb_buckets = x2d.shape[1]
    uniform = _unit_levels(k, x.device)[:, None].expand(k, nb_buckets)
    if init_style == 'uniform':
        return uniform.contiguous()
    if init_style == 'kmeans':
        return lloyd_refine(x_norm, uniform.contiguous())
    if init_style == 'quantile':
        qs = torch.tensor([(i + 1) * 1.0 / (k + 1) for i in range(k)], dtype=torch.float32,
                          device=x.device)
        # torch.quantile takes at most 2^24 elements; the largest weight of
        # the zoo (ResNet-50's 3x3x512x512) has 2.4 M
        if per_column:
            return torch.quantile(x_norm, qs, dim=0).contiguous()
        return torch.quantile(x_norm.reshape(-1), qs)[:, None].expand(k, nb_buckets).contiguous()
    raise ValueError('unrecognized init style: %r' % (init_style,))
