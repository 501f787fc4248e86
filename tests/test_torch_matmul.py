"""Parity of the port's matmul ops (pocketflow_tpu_torch/ops/matmul.py) and
its matmul experiments with the JAX package's experiments: the Pallas
kernels K3 (experiments/fused_mm_proto.py, `fused_kernel` under
`pallas_fused`), K4 (experiments/conv1x1_ab.py `make_pallas`) and K5
(experiments/mm_shape_sweep.py `make_pallas`), each built by the script's own
code with its BlockSpecs and tile rule and run in interpret mode.  On the
CPU the port runs its plain PyTorch versions; the CUDA kernels are compared
with them on the card in tests/test_torch_cuda.py.  Inputs are made with
numpy from a seed and rounded to bf16 once, on the JAX side.

Tolerances, with their measured reasons (this CPU, JAX 0.9.0, torch 2.13):
* bf16 products (K4, K5): XLA's CPU dot and torch's CPU fp32 matmul sum the
  fp32 products in different orders (torch's equals a sequential sum over k
  here), so an element may round to the neighbouring bf16 value: one bf16
  ulp, or, where the sum cancels, up to 2^-20 of the sum of the products'
  magnitudes, in at most 1e-3 of the elements (measured: 18 of 524,288 and
  13 of 98,304).  On inputs whose sums are exact in fp32 the two are
  bit-equal.
* K3 with an exact prologue (scale 2, shift 0): y bit-equal; s within 1e-5
  of each column's sum of |y|, ss within 1e-5 relative.
* K3 at the script's scale 1.1 and shift 0.1: XLA on the CPU fuses the
  prologue into the dot and rounds z differently in 873 of 131,072
  elements, so y is held within one bf16 ulp plus 2e-3 of max|y| (measured:
  9.9e-4 before the bf16 rounding), s within 2e-4 of the largest column sum
  of |y| (measured 6.9e-5) and ss within 3e-4 relative (measured 1.35e-4).
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from pocketflow_tpu_torch.experiments import conv1x1_ab as tconv
from pocketflow_tpu_torch.experiments import fused_mm_proto as tfused
from pocketflow_tpu_torch.experiments import mm_shape_sweep as tsweep
from pocketflow_tpu_torch.ops import matmul as tmm

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                'experiments'))
import conv1x1_ab as jconv  # noqa: E402
import fused_mm_proto as jfused  # noqa: E402
import mm_shape_sweep as jsweep  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture
def interpret(monkeypatch):
    """Every pl.pallas_call of the JAX scripts runs in interpret mode."""
    monkeypatch.setattr(pl, 'pallas_call', functools.partial(pl.pallas_call, interpret=True))


def _bf16(a):
    """(jax bf16 array, torch bf16 tensor) of one numpy array, rounded once."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


def _f32(a):
    return np.asarray(a.float() if torch.is_tensor(a) else jnp.asarray(a).astype(jnp.float32),
                      np.float32)


def _bf16_ulp(v):
    _, exponent = np.frexp(np.abs(v).astype(np.float32))
    return np.ldexp(np.float32(1.0), exponent - 8).astype(np.float32)


def _assert_bf16_product_close(got, want, abs_terms, max_share=1e-3):
    """The first bound of the module docstring; abs_terms = |a| @ |b|."""
    diff = np.abs(got - want)
    bound = np.maximum(_bf16_ulp(got), _bf16_ulp(want)) + abs_terms * 2.0 ** -20
    assert (diff <= bound).all(), float((diff - bound).max())
    assert (diff > 0).sum() <= max(1, max_share * diff.size), int((diff > 0).sum())


def _matmul_inputs(seed, m, k, n, exact=False):
    rng = np.random.default_rng(seed)
    if exact:  # small integers times powers of two: every fp32 sum is exact
        x = rng.integers(-8, 9, (m, k)) * 2.0 ** -3
        w = rng.integers(-8, 9, (k, n)) * 2.0 ** -6
    else:
        x = rng.standard_normal((m, k))
        w = rng.standard_normal((k, n)) * 0.05
    return _bf16(x.astype(np.float32)), _bf16(w.astype(np.float32))


# ---------------------------------------------------------------------------
# K5: mm_shape_sweep's tiled matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('m,k,n', [(2048, 64, 256), (1536, 256, 64), (3072, 128, 128)])
@pytest.mark.parametrize('exact', [True, False])
def test_matmul_matches_k5_body(interpret, m, k, n, exact):
    (jx, tx), (jw, tw) = _matmul_inputs(m + k + n, m, k, n, exact)
    want = _f32(jsweep.make_pallas(m, k, n)(jx, jw))
    got = tmm.matmul_bf16(tx, tw)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    got = _f32(got)
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        _assert_bf16_product_close(got, want, np.abs(_f32(tx)) @ np.abs(_f32(tw)))


# ---------------------------------------------------------------------------
# K4: conv1x1_ab's chains (conv, dot and the tiled matmul, k_iters = 2)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('exact', [True, False])
def test_conv1x1_arms_match_the_jax_chains(interpret, exact):
    spatial, c, k_iters = (2, 8, 8), 64, 2
    shape = spatial + (c,)
    rng = np.random.default_rng(7)
    if exact:
        x = (rng.integers(-4, 5, shape) * 2.0 ** -2).astype(np.float32)
        w = (rng.integers(-2, 3, (c, c)) * 2.0 ** -4).astype(np.float32)
    else:
        x = rng.standard_normal(shape).astype(np.float32)
        w = (rng.standard_normal((c, c)) * 0.1).astype(np.float32)
    (jx, tx), (jw, tw) = _bf16(x), _bf16(w)
    tx = tx.permute(0, 3, 1, 2)  # NHWC memory, NCHW axes: the port's activation
    assert tx.is_contiguous(memory_format=torch.channels_last)
    pallas_step, _ = jconv.make_pallas(shape, c, jw, k_iters, 512)
    want = {'conv': _f32(jconv.make_conv(shape, c, jw.reshape(1, 1, c, c), k_iters)(jx)),
            'dot': _f32(jconv.make_dot(shape, c, jw, k_iters)(jx)),
            'kernel': _f32(pallas_step(jx))}
    tmm.reset_counters()
    arms = tconv.make_arms(spatial, c, tw, k_iters)
    assert set(arms) == set(tconv.ARMS)
    # the bound of one product, at the second one's inputs (the JAX chain
    # after one step), and one more ulp for the first product's rounding
    mid = _f32(jconv.make_dot(shape, c, jw, 1)(jx)).reshape(-1, c)
    abs_terms = (np.abs(mid) @ np.abs(w)).reshape(shape)
    for name, step in arms.items():
        out = step(tx)
        assert out.dtype == torch.bfloat16 and out.shape == tx.shape
        got = _f32(out.permute(0, 2, 3, 1))
        if exact:
            np.testing.assert_array_equal(got, want[name])
        else:
            _assert_bf16_product_close(got, want[name], abs_terms + np.abs(want[name]) * 2 ** -8)
    assert tmm.counters() == {'matmul_bf16': 0, 'bn_relu_matmul_stats': 0, 'plain': k_iters}


def test_conv1x1_k_iters_follow_the_jax_script():
    for spatial, c in tconv.SHAPES:
        n, h, wd = spatial
        assert tconv.k_iters_for(spatial, c) == max(4, int(6e9 / (2.0 * n * h * wd * c * 2)))
    assert [(s, c) for s, c in tconv.SHAPES] == [(s, c) for s, c in jconv.SHAPES]
    assert tconv.k_iters_for(*tconv.SHAPES[0]) == 7
    assert tsweep.SHAPES == jsweep.SHAPES


# ---------------------------------------------------------------------------
# K3: fused_mm_proto's fused_kernel
# ---------------------------------------------------------------------------

def _pallas_fused(monkeypatch, m, k, n, tile_m):
    """The script's pallas_fused at (m, k, n) with TILE_M = tile_m: its
    BlockSpecs read the module's M, K, N, TILE_M."""
    for name, value in (('M', m), ('K', k), ('N', n), ('TILE_M', tile_m)):
        monkeypatch.setattr(jfused, name, value)
    return jax.jit(jfused.pallas_fused.__wrapped__)


@pytest.mark.parametrize('scale,shift', [(2.0, 0.0), (1.1, 0.1)])
def test_bn_relu_matmul_stats_matches_fused_kernel(interpret, monkeypatch, scale, shift):
    m, k, n = 2048, 64, 32  # 2 grid steps of TILE_M = 1024
    (jx, tx), (jw, tw) = _matmul_inputs(3, m, k, n)
    jscale = jnp.full((1, k), scale, jnp.float32)
    jshift = jnp.full((1, k), shift, jnp.float32)
    jy, js, jss = _pallas_fused(monkeypatch, m, k, n, 1024)(jx, jw, jscale, jshift)
    ty, ts, tss = tmm.bn_relu_matmul_stats(tx, tw, torch.from_numpy(np.array(jscale)),
                                           torch.from_numpy(np.array(jshift)))
    assert ty.dtype == torch.bfloat16 and ty.shape == (m, n)
    assert ts.shape == tss.shape == (n,) and ts.dtype == torch.float32
    jy, ty = _f32(jy), _f32(ty)
    col_abs = np.abs(jy.astype(np.float64)).sum(0)
    s_err = np.abs(ts.numpy() - np.asarray(js)) / col_abs
    ss_err = np.abs(tss.numpy() - np.asarray(jss)) / np.asarray(jss)
    if shift == 0.0:
        np.testing.assert_array_equal(ty, jy)
        assert s_err.max() <= 1e-5 and ss_err.max() <= 1e-5, (s_err.max(), ss_err.max())
    else:
        bound = np.maximum(_bf16_ulp(ty), _bf16_ulp(jy)) + 2e-3 * np.abs(jy).max()
        assert (np.abs(ty - jy) <= bound).all()
        assert np.abs(ts.numpy() - np.asarray(js)).max() <= 2e-4 * col_abs.max()
        assert ss_err.max() <= 3e-4, ss_err.max()


@pytest.mark.parametrize('m', [1000, 1, 129])
def test_ragged_m_statistics_match_numpy(m):
    """Any M: the sums run over the M rows of z = relu(x * scale + shift),
    and a missing row is not a zero row of x (relu(0 * scale + shift) =
    shift would add to s)."""
    k, n = 64, 32
    rng = np.random.default_rng(11)
    (jx, tx), (jw, tw) = _matmul_inputs(m, m, k, n)
    scale = (1 + 0.1 * rng.random(k)).astype(np.float32)
    shift = (0.1 * rng.random(k)).astype(np.float32)
    y, s, ss = tmm.bn_relu_matmul_stats(tx, tw, torch.from_numpy(scale).reshape(1, k),
                                        torch.from_numpy(shift))
    z = np.maximum(_f32(tx) * scale + shift, 0).astype(np.float32)
    z = np.asarray(jnp.asarray(z).astype(jnp.bfloat16).astype(jnp.float32), np.float64)
    y64 = z @ _f32(tw).astype(np.float64)
    np.testing.assert_allclose(s.numpy(), y64.sum(0), rtol=0, atol=1e-5 * np.abs(y64).sum(0).max())
    np.testing.assert_allclose(ss.numpy(), np.square(y64).sum(0), rtol=1e-5)
    want = _f32(jnp.asarray(y64.astype(np.float32), jnp.bfloat16))
    _assert_bf16_product_close(_f32(y), want, np.abs(z) @ np.abs(_f32(tw)))
    padded = np.concatenate([z, np.maximum(shift, 0)[None].astype(np.float64)])
    assert not np.allclose((padded @ _f32(tw)).sum(0), s.numpy(), rtol=1e-3)


# ---------------------------------------------------------------------------
# wrappers and experiments
# ---------------------------------------------------------------------------

def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros((16, 64), dtype=torch.bfloat16)
    w = torch.zeros((64, 32), dtype=torch.bfloat16)
    scale = torch.ones(64)
    bad_products = [(x.float(), w), (x, w.float()), (x.t(), w[:16].contiguous()),
                    (x[:, :60].contiguous(), w[:60]), (x, w[:, :30].contiguous()),
                    (x, w[:32]), (x[:0], w), (x.reshape(4, 4, 64), w)]
    for a, b in bad_products:
        with pytest.raises(ValueError):
            tmm.matmul_bf16(a, b)
        with pytest.raises(ValueError):
            tmm.bn_relu_matmul_stats(a, b, scale, scale)
    for bad in (scale.double(), scale[:32], torch.ones(2, 64)[:, 0], torch.ones(65)):
        with pytest.raises(ValueError):
            tmm.bn_relu_matmul_stats(x, w, bad, scale)
        with pytest.raises(ValueError):
            tmm.bn_relu_matmul_stats(x, w, scale, bad)
    meta = torch.empty((16, 64), dtype=torch.bfloat16, device='meta')
    with pytest.raises(ValueError, match='no kernel for device'):
        tmm.matmul_bf16(meta, torch.empty((64, 32), dtype=torch.bfloat16, device='meta'))


def test_cpu_tensors_take_the_plain_versions():
    tmm.reset_counters()
    (_, tx), (_, tw) = _matmul_inputs(0, 8, 16, 8)
    tmm.matmul_bf16(tx, tw)
    tmm.bn_relu_matmul_stats(tx, tw, torch.ones(16), torch.zeros(16))
    assert tmm.counters() == {'matmul_bf16': 0, 'bn_relu_matmul_stats': 0, 'plain': 2}


def test_fused_arms_agree_on_the_cpu():
    """The A/B's two arms at a small shape: the same y but for bf16 rounding
    of the library chain's sums' input (it sums the bf16 y)."""
    x, w, scale, shift = tfused.inputs(512, 64, 32, torch.device('cpu'))
    ya, sa, ssa = tfused.library_chain(x, w, scale, shift)
    yb, sb, ssb = tmm.bn_relu_matmul_stats(x, w, scale, shift)
    assert ya.dtype == yb.dtype == torch.bfloat16
    assert float((sa - sb).abs().max() / sa.abs().max()) <= tfused.MAX_SUMS_REL_ERR
    assert float(((ssa - ssb).abs() / ssa).max()) <= tfused.MAX_SUMS_REL_ERR


@pytest.mark.parametrize('module', [tfused, tconv, tsweep])
def test_experiments_need_a_card(module):
    if torch.cuda.is_available():
        pytest.skip('a card is present: the entry point would run')
    with pytest.raises(SystemExit, match='CUDA'):
        module.main(['--reps', '1'])


def test_experiments_check_results():
    assert tfused.check_results({})
    healthy = {'chain_ms': 2.0, 'fused_ms': 1.0, 'sums_rel_err': 1e-6}
    assert tfused.check_results(healthy) == []
    assert tfused.check_results({**healthy, 'fused_ms': float('nan')})
    assert tfused.check_results({**healthy, 'sums_rel_err': 0.1})

    assert tconv.check_results({})
    rows = {'M%d_C%d' % (n * h * w, c): {'conv': 900.0, 'dot': 950.0, 'kernel': 700.0}
            for (n, h, w), c in tconv.SHAPES}
    assert tconv.check_results({'card': 'x', **rows}) == []
    key = next(iter(rows))
    assert tconv.check_results({**rows, key: {'conv': 900.0, 'dot': 950.0}})
    assert tconv.check_results({**rows, key: {**rows[key], 'kernel': 0.0}})
    assert tconv.default_out().endswith(os.path.join('pocketflow_tpu_torch', 'conv1x1_ab.json'))
    assert 'experiments' not in tconv.default_out().split(os.sep)

    assert tsweep.check_results({})
    rows = {'M%d_K%d_N%d' % s: {'torch_ms': 1.0, 'kernel_ms': 1.5} for s in tsweep.SHAPES}
    assert tsweep.check_results(rows) == []
    key = next(iter(rows))
    assert tsweep.check_results({**rows, key: {'torch_ms': 1.0, 'kernel_ms': float('inf')}})
