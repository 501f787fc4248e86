"""Channel pruner: LASSO channel selection + least-squares reconstruction
(counterpart of pocketflow_tpu/learners/channel_pruning/channel_pruner.py,
He et al. ICCV'17).

* Feature-map sampling: for each batch, X (the conv's input windows at
  ``cp_nb_points_per_layer`` random output positions an image) comes from the
  CURRENT, partly pruned net and Y (its output there, bias subtracted) from
  the ORIGINAL net, so each layer regresses back toward the unpruned model.
  The windows are gathered directly from the padded input: the padding is
  the conv's own ('SAME' through ``same_pad``'s split, the odd row and
  column at the end, or 'VALID').  Each forward stops at the layer it
  samples; a conv called more than once in a forward (Faster R-CNN's RPN
  convs, shared by two levels) is sampled at its last call, input and
  output alike, as the JAX package's capture keeps the last.  Positions
  come from an explicit ``torch.Generator``, or are given (the JAX package
  draws them with ``jax.random``, which torch cannot reproduce).
* Channel selection: ISTA on min 1/2||y - P b||^2 + alpha ||b||_1 with the
  JAX package's binary search over alpha to hit the channel count (and its
  multiple-of-4 'quadruple' option).  P (sampled rows x c_out, c_in) is
  built on the device, and the ISTA runs on its Gram form: G = P^T P and
  P^T y are formed once per layer, the gradient is G b - P^T y and the
  Lipschitz bound v^T G v after 8 power iterations.  In exact arithmetic
  this is the JAX package's iteration; only the rounding differs.
* Reconstruction: ridge-regularized normal equations in float64
  (lam = 1e-4 * the Gram's mean diagonal) on the surviving channels, with
  the original weights kept on them if the solve is not finite.

fp32 matmuls inside the solvers run at full precision (no TF32), whatever the
caller set.  Everything runs on the learner's device; only c_in-long vectors
(the LASSO's coefficients, channel scores) come to the host, where numpy
ranks them as the JAX package does.  Pruning is "fake": pruned input
channels become zeros of the kernel and [1, 1, c_in, 1] masks.
"""

from __future__ import annotations

import collections
import contextlib
import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pocketflow_tpu_torch.config import FLAGS
from pocketflow_tpu_torch.core.metrics import get_logger
from pocketflow_tpu_torch.learners.capture import CapturePolicy
from pocketflow_tpu_torch.nn.layers import PFConv, _same_pads, compression

FLAGS.DEFINE_integer('cp_nb_points_per_layer', 10,
                     'CP: sampled positions per image per layer')
FLAGS.DEFINE_integer('cp_nb_batches', 30, 'CP: batches sampled for reconstruction')
FLAGS.DEFINE_boolean('cp_quadruple', False,
                     'CP: force surviving channel counts to multiples of 4')
FLAGS.DEFINE_integer('cp_lasso_nb_iters', 300,
                     'CP: ISTA iterations per LASSO solve (tests/smoke runs '
                     'can lower this)')
FLAGS.DEFINE_boolean('cp_lasso', True,
                     'CP: use LASSO selection + reconstruction; if False, '
                     'prune by kernel weight magnitude (reference '
                     'channel_pruner.py:33-36,619-630)')


class _StopForward(Exception):
    """Ends a forward once the sampled layer has been seen."""


class InputCapturePolicy(CapturePolicy):
    """Also records each conv/dense layer's input (the windows of the
    regression).  With `only`, records that layer alone; with `stop`
    ('input' or 'output'), ends the forward once it has that layer's input
    or output (run the forward through `run_until`)."""

    def __init__(self, only: Optional[str] = None, stop: Optional[str] = None):
        super().__init__()
        self.only = only
        self.stop = stop
        self.inputs: List[Tuple[str, torch.Tensor]] = []

    def reset_trace(self):
        super().reset_trace()
        self.inputs = []

    def process_input(self, path, x):
        if self.only is None or path == self.only:
            self.inputs.append((path, x))
            if self.stop == 'input':
                raise _StopForward()
        return x

    def process_act(self, path, act):
        if path.startswith('act/') or self.only is None or path == self.only:
            act = super().process_act(path, act)
            if self.stop == 'output' and path == self.only:
                raise _StopForward()
        return act


@torch.no_grad()
def run_until(model: torch.nn.Module, images: torch.Tensor, policy: CapturePolicy):
    """An eval-mode forward of `model` without gradients under `policy`,
    ended early if the policy stops it; returns the policy."""
    model.eval()
    with compression(policy):
        try:
            model(images)
        except _StopForward:
            pass
    return policy


def conv_modules(model: torch.nn.Module) -> Dict[str, PFConv]:
    """The model's convs (depthwise ones included) by Flax path."""
    return {m.path: m for m in model.modules() if isinstance(m, PFConv)}


@torch.no_grad()
def conv_layer_specs(model: torch.nn.Module, sample_images: torch.Tensor) -> List[dict]:
    """Per-conv specs from one forward of `sample_images` (NHWC), in call
    order: path, kernel shape (HWIO), strides, padding, input and output
    shapes in the JAX package's NHWC order, FLOPs, and 'nb_calls', how often
    the forward calls the conv.  Strides and padding are the conv's own;
    depthwise convs are left out (their input channels are not prunable this
    way).  A conv called twice has two specs, each with the last call's input
    shape and its own call's output shape, as the JAX package's."""
    recorder = run_until(model, sample_images, InputCapturePolicy())
    convs = conv_modules(model)
    ins = dict(recorder.inputs)
    nb_calls = collections.Counter(path for path, _ in recorder.inputs)
    specs = []
    for path, out in recorder.captured:
        conv = convs.get(path)
        if conv is None:
            continue  # a dense layer
        x = ins[path]
        h, w, c_in, c_out = conv.kernel.shape
        if c_in == 1 and x.shape[1] != 1:
            continue  # depthwise conv
        in_shape = (x.shape[0], x.shape[2], x.shape[3], x.shape[1])
        out_shape = (out.shape[0], out.shape[2], out.shape[3], out.shape[1])
        flops = 2.0 * out_shape[1] * out_shape[2] * h * w * c_in * c_out
        specs.append({
            'path': path, 'kernel_shape': (h, w, c_in, c_out),
            'strides': tuple(conv.strides), 'padding': conv.padding,
            'in_shape': in_shape, 'out_shape': out_shape, 'flops': float(flops),
            'nb_calls': nb_calls[path],
        })
    return specs


# ---------------------------------------------------------------------------
# the LASSO (Gram-form ISTA) and the channel count search
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def full_precision():
    """fp32 matmuls and convolutions without TF32 inside, the caller's
    settings restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def lasso_problem(P: torch.Tensor, y: torch.Tensor):
    """(G, P^T y, step) of min 1/2||y - P b||^2 + alpha ||b||_1, formed once
    for every alpha: G = P^T P, and the ISTA step 1 / (v^T G v + 1e-6) with
    v from 8 power iterations on G starting at the normalized ones."""
    with full_precision():
        P32, y32 = P.to(torch.float32), y.to(torch.float32)
        G = P32.T @ P32
        Pty = P32.T @ y32
        v = torch.ones(G.shape[0], dtype=torch.float32, device=G.device)
        v = v / torch.linalg.vector_norm(v)
        for _ in range(8):
            v = G @ v
            v = v / (torch.linalg.vector_norm(v) + 1e-12)
        lip = v @ (G @ v) + 1e-6
        step = float(1.0 / lip)
    return G, Pty, step


def make_lasso_solver(nb_iters: Optional[int] = None):
    """solve(problem, alpha) -> beta: `nb_iters` ISTA iterations from zero on
    a `lasso_problem`, each b <- softshrink(b - step (G b - P^T y),
    step * alpha), three launches."""
    if nb_iters is None:
        nb_iters = int(FLAGS.cp_lasso_nb_iters)

    def solve(problem, alpha: float) -> torch.Tensor:
        G, Pty, step = problem
        thr = float(np.float32(step) * np.float32(alpha))
        with full_precision():
            beta = torch.zeros_like(Pty)
            for _ in range(nb_iters):
                grad = torch.addmv(Pty, G, beta, beta=-1.0)
                beta = F.softshrink(torch.add(beta, grad, alpha=-step), thr)
        return beta
    return solve


def lasso_inputs(X: torch.Tensor, Y: torch.Tensor, W2: torch.Tensor):
    """(P [p * c_out, c_in], y [p * c_out]) of the channel-selection LASSO on
    p = min(400, max(1, n // 20)) sampled rows drawn with numpy's
    default_rng(rand_seed) (reference :467-470): P[:, c] = vec(X_c * W2_c)
    over (rows, c_out), W2 the HWIO fp32 kernel."""
    h, w, c_in, c_out = W2.shape
    nb = X.shape[0]
    rng = np.random.default_rng(FLAGS.rand_seed)
    picks = torch.from_numpy(rng.integers(0, nb, min(400, max(1, nb // 20)))).to(X.device)
    Xs, Ys = X[picks], Y[picks]
    W2c = W2.permute(2, 0, 1, 3).reshape(c_in, h * w, c_out)
    Xc = Xs.reshape(Xs.shape[0], c_in, h * w)
    with full_precision():
        contrib = torch.einsum('pck,cko->pco', Xc, W2c)     # [p, c_in, c_out]
    return contrib.transpose(1, 2).reshape(-1, c_in), Ys.reshape(-1)


def select_channels(P: torch.Tensor, y: torch.Tensor, c_new: int, solver,
                    alpha_init: float = 1e-4, tolerance: float = 0.02) -> torch.Tensor:
    """Binary-search alpha until ~c_new nonzero channels survive (reference
    compute_pruned_kernel :497-568, incl. 'quadruple'); returns a bool
    tensor [c_in] on P's device."""
    log = get_logger()
    c_in = P.shape[1]
    if c_new >= c_in:
        return torch.ones(c_in, dtype=torch.bool, device=P.device)
    problem = lasso_problem(P, y)

    def nnz(alpha):
        beta = solver(problem, alpha).cpu().numpy()
        idxs = np.abs(beta) > 1e-12
        return idxs, int(idxs.sum())

    left, right = 0.0, alpha_init
    lbound = c_new - tolerance * c_in / 2
    rbound = c_new + tolerance * c_in / 2
    # grow right until it over-prunes
    for _ in range(60):
        _, count = nnz(right)
        if count < c_new:
            break
        right *= 2
    alpha = (left + right) / 2
    idxs, count = nnz(alpha)
    for _ in range(60):
        if FLAGS.cp_quadruple and count % 4 == 0 and abs(count - c_new) <= 2:
            break
        if lbound <= count <= rbound:
            if not FLAGS.cp_quadruple or count % 4 == 0:
                break
            if count % 4 <= 2:
                rbound, lbound = count - 1, lbound - 2
            else:
                lbound, rbound = count + 1, rbound + 2
        elif abs(left - right) <= right * 0.1:
            lbound = max(1, lbound - 1)
            rbound = min(c_in, rbound + 1)
            left, right = left / 1.2, right * 1.2
        elif count > rbound:
            left = left + (alpha - left) / 2
        else:
            right = right - (right - alpha) / 2
        if alpha < 1e-10:
            break
        alpha = (left + right) / 2
        idxs, count = nnz(alpha)
    log.info('lasso: kept %d/%d channels (target %d, alpha %.3e)', count, c_in, c_new, alpha)
    if count == 0:
        # degenerate (P^T y ~ 0, e.g. a collapsed upstream layer): the LASSO
        # cannot rank channels, so fall back to magnitude selection at the
        # REQUESTED count; keeping a single channel would over-prune far
        # past the target and break the FLOPs budget accounting
        order = np.argsort(-P.abs().sum(0).cpu().numpy())
        idxs = np.zeros(c_in, bool)
        idxs[order[:max(1, c_new)]] = True
    return torch.from_numpy(idxs).to(P.device)


# ---------------------------------------------------------------------------
# the pruner
# ---------------------------------------------------------------------------

def _sync(device: torch.device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


class ChannelPruner:
    """Samples feature maps, selects channels, reconstructs kernels.
    `timings` accumulates the seconds spent sampling ('sample'), in the
    LASSO ('lasso') and in the reconstruction ('ridge'), each part ended by a
    synchronize."""

    def __init__(self, dataset, specs: List[dict]):
        self.dataset = dataset
        self.specs = specs
        self.log = get_logger()
        self.solver = make_lasso_solver()
        self.timings: Dict[str, float] = collections.defaultdict(float)

    @torch.no_grad()
    def sample(self, spec: dict, orig: torch.nn.Module, cur: torch.nn.Module,
               batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
               positions: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """(X [B * nb_pts, c_in, h, w], Y [B * nb_pts, c_out]) of one device
        batch, both fp32: X from `cur`'s input to the layer, Y from `orig`'s
        output minus its bias, at output positions (yi, xi) drawn from
        `generator` (yi first) or given as `positions`."""
        path = spec['path']
        h, w, c_in, c_out = spec['kernel_shape']
        strides = spec['strides']
        nb_pts = FLAGS.cp_nb_points_per_layer
        images = self.dataset.augment_images(batch, None, False)
        once = spec.get('nb_calls', 1) == 1  # else the whole forward, for its last call
        x = run_until(cur, images, InputCapturePolicy(
            only=path, stop='input' if once else None)).inputs[-1][1]
        y_full = run_until(orig, images, InputCapturePolicy(
            only=path, stop='output' if once else None)).captured[-1][1]
        bias = conv_modules(orig)[path].bias
        if bias is not None:
            y_full = y_full - bias.to(y_full.dtype)[:, None, None]
        if spec.get('padding', 'SAME') == 'SAME':
            (top, bottom), (left, right) = (_same_pads(x.shape[2], h, strides[0]),
                                            _same_pads(x.shape[3], w, strides[1]))
        else:
            top = bottom = left = right = 0
        xp = F.pad(x.to(torch.float32), (left, right, top, bottom))
        B = x.shape[0]
        Hp = (x.shape[2] + top + bottom - h) // strides[0] + 1
        Wp = (x.shape[3] + left + right - w) // strides[1] + 1
        bi = torch.arange(B, device=x.device).repeat_interleave(nb_pts)
        if positions is None:
            yi = torch.randint(0, Hp, (B * nb_pts,), generator=generator, device=x.device)
            xi = torch.randint(0, Wp, (B * nb_pts,), generator=generator, device=x.device)
        else:
            yi, xi = (p.to(x.device) for p in positions)
        rows = yi[:, None] * strides[0] + torch.arange(h, device=x.device)   # [P, h]
        cols = xi[:, None] * strides[1] + torch.arange(w, device=x.device)   # [P, w]
        X = xp[bi[:, None, None], :, rows[:, :, None], cols[:, None, :]]   # [P, h, w, c_in]
        X = X.permute(0, 3, 1, 2).contiguous()                               # [P, c_in, h, w]
        Y = y_full[bi, :, yi, xi].to(torch.float32)                         # [P, c_out]
        return X, Y

    def collect(self, spec: dict, orig: torch.nn.Module, cur: torch.nn.Module, batches,
                generator: Optional[torch.Generator] = None, positions=None):
        """X and Y of cp_nb_batches device batches from `batches`,
        concatenated on the device.  ``orig`` is the ORIGINAL unpruned net
        (the reconstruction targets), ``cur`` the current partly pruned one
        (the layer inputs).  `positions`, if given, is one (yi, xi) pair a
        batch."""
        start = time.perf_counter()
        Xs, Ys = [], []
        for i in range(FLAGS.cp_nb_batches):
            X, Y = self.sample(spec, orig, cur, next(batches), generator,
                               None if positions is None else positions[i])
            Xs.append(X)
            Ys.append(Y)
        X, Y = torch.cat(Xs), torch.cat(Ys)
        _sync(X.device)
        self.timings['sample'] += time.perf_counter() - start
        return X, Y

    @torch.no_grad()
    def prune_layer(self, spec: dict, kernel: torch.Tensor, X: torch.Tensor, Y: torch.Tensor,
                    preserve_ratio: float) -> Tuple[torch.Tensor, torch.Tensor]:
        """Select input channels and reconstruct the kernel; returns
        (new_kernel HWIO in the kernel's dtype, channel mask bool [c_in])."""
        h, w, c_in, c_out = spec['kernel_shape']
        c_new = max(1, int(math.ceil(preserve_ratio * c_in)))
        if c_new >= c_in:
            return kernel, torch.ones(c_in, dtype=torch.bool, device=kernel.device)

        W2 = kernel.detach().to(torch.float32)                # [h, w, c_in, c_out]
        start = time.perf_counter()
        with full_precision():
            if FLAGS.cp_lasso:
                P, y = lasso_inputs(X, Y, W2)
                idxs = select_channels(P, y, c_new, self.solver)
                del P
            else:
                # magnitude mode (reference :619-630): keep the c_new input
                # channels with the largest total |W2| mass, then reconstruct
                order = np.argsort(-W2.abs().sum((0, 1, 3)).cpu().numpy())
                keep = np.zeros(c_in, bool)
                keep[order[:c_new]] = True
                idxs = torch.from_numpy(keep).to(W2.device)
            lasso_end = time.perf_counter()
            self.timings['lasso'] += lasso_end - start

            # ridge-regularized least squares on the surviving channels
            # (:442-454): with few sampled rows the plain system is
            # underdetermined and its min-norm solution generalizes badly;
            # lam scales with the Gram's mean diagonal
            Xsel = X[:, idxs].reshape(X.shape[0], -1).to(torch.float64)
            gram = Xsel.T @ Xsel
            lam = 1e-4 * max(float(torch.trace(gram)) / max(gram.shape[0], 1), 1e-12)
            eye = torch.eye(gram.shape[0], dtype=torch.float64, device=gram.device)
            W2new, info = torch.linalg.solve_ex(gram + lam * eye, Xsel.T @ Y.to(torch.float64))
            finite = int(info) == 0 and bool(torch.isfinite(W2new).all())
        self.timings['ridge'] += time.perf_counter() - lasso_end
        if not finite:
            # last resort: the original weights on the surviving channels
            # (selection without reconstruction)
            self.log.warning('layer %s: reconstruction produced non-finite weights; keeping '
                             'original kernel values on surviving channels', spec['path'])
            return (W2 * idxs[None, None, :, None]).to(kernel.dtype), idxs
        W2new = W2new.reshape(int(idxs.sum()), h, w, c_out)
        new_kernel = torch.zeros_like(W2)
        new_kernel[:, :, idxs, :] = W2new.permute(1, 2, 0, 3).to(torch.float32)
        return new_kernel.to(kernel.dtype), idxs
