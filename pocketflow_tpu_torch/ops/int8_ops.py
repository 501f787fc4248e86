"""Int8 serving: symmetric post-training quantization and int8 contractions
(counterpart of pocketflow_tpu/ops/int8_ops.py).

    xq = clip(round(x / sx), -127, 127)  int8,  wq = round(w / sw_c)  int8 (per out-channel)
    y  = float(contract(xq, wq -> int32)) * (sx * sw_c)

Weights quantize offline (symmetric per output channel, 127 levels);
activation scales come from a calibration pass that records each layer's
input absmax over a few batches.  `Int8ServingPolicy` plugs these into the
model through the layers' ``run_contraction`` hook: the same module serves
fp32, bf16 or int8.

The contraction is exact on both devices, so the int32 accumulators on the
card equal the CPU's (and JAX's) bit for bit:

* a product is ``torch._int_mm`` (cuBLASLt's int8 GEMM on the card).  On
  the card it takes M > 16 and K a multiple of 8; on an H100 cuBLASLt
  refuses (CUBLAS_STATUS_NOT_SUPPORTED) a row-major B at most shapes, and an
  N of 8 mod 16 from 40 up at K = 16, 32, 64 or 96 (probed over every N up
  to 1024).  ``int8_matmul`` pads with zero rows and columns to M > 16, K a
  multiple of 8 and N of 16 (zeros add nothing to an int32 sum), hands B
  over as the transpose of an [N, K] tensor, and slices the result back, on
  both devices, so the CPU tests cover the same path;
* a spatial conv is an im2col of the int8 codes: ``Tensor.unfold`` views the
  padded codes as windows (a view works for any dtype, where ``F.unfold``
  and cuDNN take no int8), one int8 copy lays them out as rows in the
  kernel's H, W, C order, and ``int8_matmul`` contracts them.  A 1x1
  stride-1 conv is a reshape only.  'SAME' padding goes in after the
  quantization, as code 0, with the asymmetric split of ``same_pad``;
* a depthwise conv (only when the policy does not skip it) sums its taps in
  float32, exact: every partial sum is an integer below 2^24.

Op order follows the reference: x / sx is a division by a tensor on x's
device (PyTorch's CUDA division by a CPU scalar multiplies by the
reciprocal, which moves .5 boundaries), round is half to even, and the
output scale is sx * sw_c, multiplied first.

On the card a site is one kernel (``int8_conv``, ``csrc/int8_conv.cu``; its
header says why it exists, what bounds it and how it is built), one launch
in two phases: it quantizes the layer's bf16 or fp32 NHWC input once an
element into int8 codes with the channels padded to ``Cp`` (C rounded up to
16, code 0 past C; the stems' window rows laid out as channels,
``wide_taps``; a strided 1x1 conv's read pixels only, ``subsampled``), then
contracts the codes' im2col rows on the int8 tensor cores against the
weights packed once per device with the same channel padding
(``pack_weights``: K-major [Npad, Kp], K = kh * kw * Cp),
adds the layer's bias in fp32 where it has one (its own bias add) and
writes the layer's dtype.  Each site takes a tile plan chosen on the host
once for its shape (``tile_plan``: the tile's rows and columns and a split
of K for sites with fewer tiles than the card has SMs).  Its plain version,
``int8_conv_plain``, is the formula above step by step (quantize,
``int8_conv2d`` or ``int8_matmul``, rescale, bias, cast); the two give the
same bits.  The kernel's layout steps have plain versions too, for the
tests: the padded codes (``padded_codes_plain``), their im2col rows
(``padded_rows_plain``), the split-K partial sums and their sum
(``split_k_partials_plain``, ``split_k_sum_plain``), composed by
``int8_conv_layout_plain``.  ``Int8ServingPolicy`` prepares each site once
per device (``Int8Site``: the activation scale as a device tensor, the fp32
product x_scale * w_scale, the bias, the packed codes, the plan and its
counters), so that a forward makes no host-to-device copy and no stream
sync.  Dispatch is by device: a CPU tensor takes the plain version, a CUDA
tensor launches the kernel, anything else raises.  The depthwise int8 route
(only when the policy does not skip it) stays the layer's plain contraction
on every device.  The module-level counters count kernel launches, plain
calls on the CPU, the plain contractions on CUDA tensors and the depthwise
route's calls.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Iterable, Optional, Tuple

import torch
import torch.nn.functional as F

from pocketflow_tpu_torch.core.profiling import span
from pocketflow_tpu_torch.nn.layers import (
    CompressionPolicy, PFConv, PFDense, _same_pads, compression, same_pad)

_LEVELS = 127.0
_CHANNEL_CHUNK = 16  # codes a 16-byte copy: a site's channels are padded to a multiple of it
_K_STAGE = 128  # k (bytes of codes) of a kernel stage: split-K splits whole stages
_TILE_ROWS = (128, 64)  # the tile's rows: two consumer warpgroups, or one
_PLAN_SMS = 132  # the H100's SMs: the plans fill them (any card runs any plan)
_MAX_SPLITS = 16

# launches of the int8 conv kernel; calls of the plain version on CPU
# tensors; calls of the plain contractions (int8_conv2d, int8_matmul) on CUDA
# tensors; calls of the depthwise int8 route
kernel_launches = 0
plain_calls = 0
plain_cuda_calls = 0
depthwise_calls = 0


def reset_counters():
    global kernel_launches, plain_calls, plain_cuda_calls, depthwise_calls
    kernel_launches = plain_calls = plain_cuda_calls = depthwise_calls = 0


def counters() -> dict:
    return {'int8_conv': kernel_launches, 'int8_plain_cuda': plain_cuda_calls,
            'int8_depthwise': depthwise_calls, 'plain': plain_calls}


def quantize_weights_symmetric(kernel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8: (codes int8, scale [c_out] float32)."""
    k32 = kernel.detach().to(torch.float32)
    absmax = k32.reshape(-1, k32.shape[-1]).abs().amax(dim=0)
    scale = torch.clamp_min(absmax, 1e-8) / torch.tensor(_LEVELS, device=absmax.device)
    codes = torch.clamp(torch.round(k32 / scale), -127, 127).to(torch.int8)
    return codes, scale


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] int8 @ b [K, N] int8 -> [M, N] int32 accumulators, padded to
    what ``torch._int_mm`` takes on the card (M > 16, K a multiple of 8, N
    of 16, B column-major)."""
    global plain_cuda_calls
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError('int8_matmul takes int8 operands, got %s and %s' % (a.dtype, b.dtype))
    plain_cuda_calls += a.is_cuda
    m, k = a.shape
    n = b.shape[1]
    k_pad, n_pad, m_pad = -k % 8, -n % 16, max(17 - m, 0)
    if k_pad or m_pad:
        a = F.pad(a, (0, k_pad, 0, m_pad))
    if k_pad or n_pad:
        b = F.pad(b, (0, n_pad, 0, k_pad))
    acc = torch._int_mm(a.contiguous(), b.t().contiguous().t())
    return acc[:m, :n] if (m_pad or n_pad) else acc


def int8_conv2d(xq: torch.Tensor, codes: torch.Tensor, strides=(1, 1), padding: str = 'SAME',
                groups: int = 1) -> torch.Tensor:
    """Exact int32 convolution of NCHW int8 codes `xq` with HWIO int8 `codes`
    (the layer's strides and padding); returns NCHW int32 (a channels-last
    view).  ``groups`` is 1 or, for a depthwise kernel (I == 1), the input's
    channel count."""
    global depthwise_calls
    kh, kw, cin, cout = codes.shape
    sh, sw = strides
    if padding == 'SAME':
        xq = same_pad(xq, (kh, kw), strides)
    elif padding != 'VALID':
        raise ValueError('unknown padding %r' % (padding,))
    n, c, h, w = xq.shape
    ho, wo = (h - kh) // sh + 1, (w - kw) // sw + 1
    if groups != 1:
        if cin != 1 or groups != c or cout % c:
            raise ValueError('int8_conv2d: groups=%d with a %s kernel on %d channels'
                             % (groups, tuple(codes.shape), c))
        depthwise_calls += 1
        return _depthwise(xq, codes, strides, ho, wo)
    if (kh, kw, sh, sw) == (1, 1, 1, 1):
        rows = xq.permute(0, 2, 3, 1).reshape(-1, c)
    else:
        windows = xq.unfold(2, kh, sh).unfold(3, kw, sw)  # [N, C, Ho, Wo, kh, kw], a view
        rows = windows.permute(0, 2, 3, 4, 5, 1).reshape(n * ho * wo, kh * kw * c)
    acc = int8_matmul(rows, codes.reshape(kh * kw * cin, cout))
    return acc.reshape(n, ho, wo, cout).permute(0, 3, 1, 2)


def _depthwise(xq, codes, strides, ho, wo):
    """Depthwise int8 conv, the taps summed in float32 (exact below 2^24)."""
    kh, kw, _, cout = codes.shape
    sh, sw = strides
    mult = cout // xq.shape[1]
    acc = None
    for i in range(kh):
        for j in range(kw):
            tap = xq[:, :, i:i + sh * (ho - 1) + 1:sh, j:j + sw * (wo - 1) + 1:sw].to(torch.float32)
            if mult > 1:
                tap = tap.repeat_interleave(mult, dim=1)
            term = tap * codes[i, j, 0].to(torch.float32)[:, None, None]
            acc = term if acc is None else acc + term
    return acc.to(torch.int32)


def _contract(x: torch.Tensor, x_scale: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
              contract_fn, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quantize x by the 0-d device tensor x_scale, contract, rescale the
    int32 sums by `scale` (x_scale * w_scale) to float32 and add the fp32
    `bias`, as the layer adds it."""
    xq = torch.clamp(torch.round(x.to(torch.float32) / x_scale), -127, 127).to(torch.int8)
    acc = contract_fn(xq, codes, torch.int32)
    if acc.dim() == 4:  # NCHW: the scale and the bias run along the channel axis
        scale = scale[:, None, None]
        bias = None if bias is None else bias[:, None, None]
    y = acc.to(torch.float32) * scale
    return y if bias is None else y + bias


def int8_contract(x: torch.Tensor, codes: torch.Tensor, w_scale: torch.Tensor, x_scale,
                  contract_fn) -> torch.Tensor:
    """Quantize x, contract in int8 -> int32, rescale to float32.
    `contract_fn(xq, codes, torch.int32)` is the layer's conv or dense."""
    x_scale = torch.as_tensor(x_scale, dtype=torch.float32, device=x.device)
    return _contract(x, x_scale, codes, x_scale * w_scale, contract_fn)


def padded_channels(c: int) -> int:
    """A site's input channels in the kernel's codes: c rounded up to 16, so
    that a 16-byte chunk of codes never straddles two taps."""
    return -(-c // _CHANNEL_CHUNK) * _CHANNEL_CHUNK


def tile_n(cout: int) -> int:
    """The kernel's column tile (csrc/int8_conv.cu: BN) for `cout` output
    channels: the least of 64, 128, 256 that covers them up to 256."""
    return 64 if cout <= 64 else 128 if cout <= 128 else 256


def _padded_cout(cout: int) -> int:
    """`cout` rounded up to the column tile (tile_n), the rows of the packed
    codes and the length of the scale."""
    tile = tile_n(cout)
    return -(-cout // tile) * tile


def wide_taps(kshape) -> bool:
    """Whether the kernel lays a site out wide: a conv on so few input
    channels (the stems) that one window row's kw taps, kw * C codes, fit in
    32.  Its codes then hold at (n, h, wo) the codes of x[n, h, wo * sw - pad
    + j, c] at channel j * C + c (padded_channels of kw * C), and the
    product runs kh x 1 taps over them: kh 32-byte chunks a row, not kh * kw
    chunks of 16 bytes mostly of padding."""
    return len(kshape) == 4 and kshape[1] > 1 and kshape[1] * kshape[2] <= 2 * _CHANNEL_CHUNK


def subsampled(kshape, strides) -> bool:
    """Whether the kernel codes only the pixels a site reads: a 1x1 conv at
    a stride (no padding), whose codes are [N, Ho, Wo, Cp], x's pixels (n, ho
    sh, wo sw), and whose product is a 1x1 conv at stride 1 over them."""
    return len(kshape) == 4 and tuple(kshape[:2]) == (1, 1) and tuple(strides) != (1, 1)


def _codes_kshape(kshape):
    """The kernel shape that the product sees: HWIO, [1, 1, in, out] for a
    dense layer, [kh, 1, kw * C, out] for a wide site."""
    if len(kshape) == 2:
        return (1, 1) + tuple(kshape)
    kh, kw, cin, cout = kshape
    return (kh, 1, kw * cin, cout) if wide_taps(kshape) else tuple(kshape)


def _packed_k(kshape) -> int:
    """Kp of the packed codes of an HWIO or [in, out] kernel: kh * kw * Cp
    (wide: kh * padded_channels(kw * C)) rounded up to a kernel stage (128),
    so that every stage runs whole."""
    kh, kw, cin, _ = _codes_kshape(kshape)
    k = kh * kw * padded_channels(cin)
    return -(-k // _K_STAGE) * _K_STAGE


def pack_weights(codes: torch.Tensor) -> torch.Tensor:
    """HWIO (conv) or [in, out] (dense) int8 codes -> the kernel's K-major
    [Npad, Kp] codes: row n holds output channel n's kh * kw * Cp codes in
    the HWIO flattening order with the input channels padded to Cp
    (padded_channels, zero past the inputs in each tap), zero past K (Kp a
    multiple of 128, the kernel's stage) and past the output channels (Npad
    a multiple of the column tile).  A wide site (wide_taps) packs its kernel
    as [kh, 1, kw * C, out], the order of its codes' channels."""
    kh, kw, cin, cout = _codes_kshape(tuple(codes.shape))
    hwio = codes.reshape(kh, kw, cin, cout)
    cp = padded_channels(cin)
    taps = torch.zeros((cout, kh, kw, cp), dtype=torch.int8, device=codes.device)
    taps[..., :cin] = hwio.permute(3, 0, 1, 2)
    packed = torch.zeros((_padded_cout(cout), _packed_k(codes.shape)), dtype=torch.int8,
                         device=codes.device)
    packed[:cout, :kh * kw * cp] = taps.reshape(cout, -1)
    return packed


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """How the kernel cuts one site: bm x bn output tiles (bm 128 or 64,
    bn = tile_n(Cout)) and K split into `splits` runs of whole 128-deep
    stages, whose int32 partial sums the last of a tile's units adds."""
    bm: int
    bn: int
    splits: int


def tile_plan(m: int, cout: int, kp: int) -> TilePlan:
    """The tile plan of a site with m output rows, cout channels and packed
    depth kp, a pure function of the shapes.  It minimizes a block's work
    in cycles times the waves of units over the H100's 132 SMs (one block
    an SM): a 128-deep stage costs the larger of its int8 products
    (bm bn / 32 cycles at 8,192 operations a cycle) and its copies (2 (bm +
    bn): 64 bytes a cycle), a unit adds its fill and epilogue (600 + bm bn /
    32) and, split, its partials' write and read (bm bn / 8).  Ties keep the
    larger tile and the fewer splits.  Sites with many tiles get bm = 128 and
    no split; the dense layers at M = 64 get bm = 64 and a split of K."""
    bn = tile_n(cout)
    nk = -(-kp // _K_STAGE)
    n_tiles = -(-cout // bn)
    best, best_cost = None, None
    for bm in _TILE_ROWS:
        tiles = -(-m // bm) * n_tiles
        stage = max(bm * bn / 32, 2 * (bm + bn))
        for splits in range(1, min(nk, _MAX_SPLITS) + 1):
            waves = -(-tiles * splits // _PLAN_SMS)
            unit = -(-nk // splits) * stage + 600 + bm * bn / 32 + (splits > 1) * bm * bn / 8
            cost = waves * unit
            if best_cost is None or cost < best_cost:
                best, best_cost = TilePlan(bm, bn, splits), cost
    return best


def split_k_bounds(kp: int, splits: int):
    """The k ranges [k0, k1) of the kernel's splits: split s takes stages
    [s nk / splits, (s + 1) nk / splits) of the nk = kp / 128 (uneven where
    splits does not divide nk)."""
    nk = kp // _K_STAGE
    return [(s * nk // splits * _K_STAGE, (s + 1) * nk // splits * _K_STAGE)
            for s in range(splits)]


@dataclasses.dataclass
class Int8Site:
    """One int8 site's contraction on one device, prepared once: the codes
    (HWIO or [in, out]), the activation scale (a 0-d fp32 tensor), the fp32
    output scale x_scale * w_scale and the layer's bias in fp32 (or None),
    both padded with zeros to the column tile, the packed codes (on CUDA),
    the conv's strides and padding, the output dtype, the kernel's launch
    for each input layout it has served (checked and laid out once), and
    the kernel's tile plan for each row count it has served ({M: (TilePlan,
    counters)}: on CUDA the plan's counters [2 + tiles], made zero: the
    grid barrier's
    arrivals, which each launch leaves zero, its generation, which each
    launch advances, and a count a tile, which each launch leaves zero; a
    site's launches run one after another on one stream)."""
    codes: torch.Tensor
    x_scale: torch.Tensor
    scale: torch.Tensor
    packed: Optional[torch.Tensor] = None
    strides: Tuple[int, int] = (1, 1)
    padding: str = 'SAME'
    out_dtype: torch.dtype = torch.float32
    bias: Optional[torch.Tensor] = None
    plans: Dict[int, Tuple[TilePlan, Optional[torch.Tensor]]] = dataclasses.field(
        default_factory=dict)
    launches: Dict[tuple, '_Launch'] = dataclasses.field(default_factory=dict)

    @property
    def dense(self) -> bool:
        return self.codes.dim() == 2


def make_site(codes: torch.Tensor, w_scale: torch.Tensor, x_scale, device, strides=(1, 1),
              padding: str = 'SAME', out_dtype: torch.dtype = torch.float32,
              bias: Optional[torch.Tensor] = None, x_shape=None) -> Int8Site:
    """An Int8Site on `device`; the codes are packed for the kernel on CUDA,
    and the tile plan of an input of `x_shape` (NCHW or [M, K]) is chosen."""
    device = torch.device(device)
    codes = codes.to(device)
    x_scale = torch.as_tensor(x_scale, dtype=torch.float32, device=device)
    cout = codes.shape[-1]
    scale = torch.zeros(_padded_cout(cout), dtype=torch.float32, device=device)
    scale[:cout] = x_scale * w_scale.to(device)  # multiplied first, as int8_contract does
    if bias is not None:
        padded = torch.zeros_like(scale)
        padded[:cout] = bias.detach().to(device, torch.float32)
        bias = padded
    site = Int8Site(codes, x_scale, scale,
                    pack_weights(codes) if device.type == 'cuda' else None,
                    tuple(strides), padding, out_dtype, bias)
    if x_shape is not None:
        site_plan(site, _site_rows(site, x_shape))
    return site


def _site_rows(site: Int8Site, x_shape) -> int:
    """M, the output positions of a site on an input of x_shape."""
    if site.dense:
        return x_shape[0]
    n, _, h, w = x_shape
    ho, wo, _, _ = _conv_geometry(h, w, *site.codes.shape[:2], site.strides, site.padding)
    return n * ho * wo


def site_plan(site: Int8Site, m: int) -> Tuple[TilePlan, Optional[torch.Tensor]]:
    """The site's tile plan for m output rows and, on CUDA, its counters:
    chosen and allocated at the first call for m, kept in the site."""
    if m not in site.plans:
        cout = site.codes.shape[-1]
        plan = tile_plan(m, cout, _packed_k(site.codes.shape))
        counters = None
        if site.scale.is_cuda:
            tiles = -(-m // plan.bm) * (_padded_cout(cout) // plan.bn)
            counters = torch.zeros(2 + tiles, dtype=torch.int32, device=site.scale.device)
        site.plans[m] = (plan, counters)
    return site.plans[m]


def _conv_geometry(h: int, w: int, kh: int, kw: int, strides, padding: str):
    """(ho, wo, pad_top, pad_left) of a conv as int8_conv2d pads it."""
    if padding == 'SAME':
        (top, bottom), (left, right) = _same_pads(h, kh, strides[0]), _same_pads(w, kw, strides[1])
    elif padding == 'VALID':
        top = bottom = left = right = 0
    else:
        raise ValueError('unknown padding %r' % (padding,))
    ho = (h + top + bottom - kh) // strides[0] + 1
    wo = (w + left + right - kw) // strides[1] + 1
    return ho, wo, top, left


def _contract_plain(x: torch.Tensor, site: Int8Site, contract_fn=None) -> torch.Tensor:
    """int8_contract with the site's device scales, then its bias and the
    cast to its output dtype; the contraction is the layer's `contract_fn`,
    or int8_matmul / int8_conv2d."""
    if contract_fn is None:
        if site.dense:
            contract_fn = lambda xq, codes, _: int8_matmul(xq, codes)  # noqa: E731
        else:
            contract_fn = lambda xq, codes, _: int8_conv2d(  # noqa: E731
                xq, codes, site.strides, site.padding)
    cout = site.codes.shape[-1]
    return _contract(x, site.x_scale, site.codes, site.scale[:cout], contract_fn,
                     None if site.bias is None else site.bias[:cout]).to(site.out_dtype)


def int8_conv_plain(x: torch.Tensor, site: Int8Site) -> torch.Tensor:
    """The plain version of int8_conv: the same function, op by op."""
    global plain_calls
    plain_calls += x.device.type == 'cpu'
    return _contract_plain(x, site)


def padded_codes_plain(x: torch.Tensor, site: Int8Site) -> torch.Tensor:
    """The kernel's first phase: x's codes clamp(round(x / x_scale), -127,
    127) as the plain version computes them, NHWC [N, H, W, Cp] (a dense
    input: [M, Cp]), code 0 past the C channels.  A wide site (wide_taps):
    [N, H, Wo, Cp], at (n, h, wo) channel j * C + c the code of x[n, h, wo *
    sw - pad_left + j, c] (0 on the padding), 0 past kw * C.  A subsampled
    site: [N, Ho, Wo, Cp], the codes of x's pixels (n, ho sh, wo sw)."""
    xq = torch.clamp(torch.round(x.to(torch.float32) / site.x_scale), -127, 127).to(torch.int8)
    if not site.dense:
        xq = xq.permute(0, 2, 3, 1)
    if subsampled(tuple(site.codes.shape), site.strides):
        xq = xq[:, ::site.strides[0], ::site.strides[1]]
    if wide_taps(tuple(site.codes.shape)):
        kh, kw = site.codes.shape[:2]
        n, h, w, c = xq.shape
        _, wo, _, left = _conv_geometry(h, w, kh, kw, site.strides, site.padding)
        right = max((wo - 1) * site.strides[1] + kw - w - left, 0)
        padded = torch.zeros((n, h, w + left + right, c), dtype=torch.int8, device=x.device)
        padded[:, :, left:left + w] = xq
        windows = padded.unfold(2, kw, site.strides[1])[:, :, :wo]  # [N, H, Wo, C, kw]
        xq = windows.permute(0, 1, 2, 4, 3).reshape(n, h, wo, kw * c)
    c = xq.shape[-1]
    codes = torch.zeros(xq.shape[:-1] + (padded_channels(c),), dtype=torch.int8,
                        device=x.device)
    codes[..., :c] = xq
    return codes


def padded_rows_plain(codes: torch.Tensor, site: Int8Site) -> torch.Tensor:
    """The im2col rows [M, Kp] that the kernel's producer gathers from the
    padded codes: k = (i kw + j) Cp + c, code 0 where the window falls on
    the padding and past K = kh kw Cp."""
    if site.dense:
        rows = codes
    else:
        kh, kw = site.codes.shape[:2]
        sh, sw = site.strides
        n, h, w, cp = codes.shape
        ho, wo, top, left = _conv_geometry(h, w, kh, kw, site.strides, site.padding)
        if wide_taps(tuple(site.codes.shape)):  # kh x 1 taps over the wide codes
            kw, sw, wo, left = 1, 1, w, 0
        if subsampled(tuple(site.codes.shape), site.strides):  # 1x1, stride 1
            sh = sw = 1
            ho, wo, top, left = h, w, 0, 0
        bottom = max((ho - 1) * sh + kh - h - top, 0)
        right = max((wo - 1) * sw + kw - w - left, 0)
        padded = torch.zeros((n, h + top + bottom, w + left + right, cp), dtype=torch.int8,
                             device=codes.device)
        padded[:, top:top + h, left:left + w] = codes
        windows = padded.unfold(1, kh, sh).unfold(2, kw, sw)[:, :ho, :wo]  # [N, Ho, Wo, Cp, kh, kw]
        rows = windows.permute(0, 1, 2, 4, 5, 3).reshape(n * ho * wo, kh * kw * cp)
    out = torch.zeros((rows.shape[0], _packed_k(site.codes.shape)), dtype=torch.int8,
                      device=codes.device)
    out[:, :rows.shape[1]] = rows
    return out


def split_k_partials_plain(rows: torch.Tensor, packed: torch.Tensor, cout: int,
                           splits: int) -> torch.Tensor:
    """The int32 partial sums [splits, M, cout] of rows [M, Kp] against the
    packed codes [Npad, Kp], one a split of split_k_bounds."""
    return torch.stack([int8_matmul(rows[:, k0:k1].contiguous(), packed[:cout, k0:k1].t())
                        for k0, k1 in split_k_bounds(rows.shape[1], splits)])


def split_k_sum_plain(partials: torch.Tensor) -> torch.Tensor:
    """The int32 sum of the splits' partial sums (exact in any order)."""
    return partials.sum(0, dtype=torch.int32)


def int8_conv_layout_plain(x: torch.Tensor, site: Int8Site, packed: Optional[torch.Tensor] = None,
                           plan: Optional[TilePlan] = None) -> torch.Tensor:
    """int8_conv through the kernel's layout, step by step: the padded codes,
    their rows against the padded packed codes (``pack_weights``, or
    `packed`) in the plan's splits of K, the partials summed, then the
    rescale, bias and cast of int8_conv_plain.  It gives int8_conv_plain's
    bits; the tests hold it to that."""
    packed = pack_weights(site.codes) if packed is None else packed
    rows = padded_rows_plain(padded_codes_plain(x, site), site)
    cout = site.codes.shape[-1]
    plan = tile_plan(rows.shape[0], cout, packed.shape[1]) if plan is None else plan
    acc = split_k_sum_plain(split_k_partials_plain(rows, packed, cout, plan.splits))
    y = acc.to(torch.float32) * site.scale[:cout]
    if site.bias is not None:
        y = y + site.bias[:cout]
    y = y.to(site.out_dtype)
    if site.dense:
        return y
    n, _, h, w = x.shape
    ho, wo, _, _ = _conv_geometry(h, w, *site.codes.shape[:2], site.strides, site.padding)
    return y.reshape(n, ho, wo, cout).permute(0, 3, 1, 2)


def _check_conv(x: torch.Tensor, site: Int8Site):
    """(batch, H, W, C, Ho, Wo, pad_top, pad_left) of a site the kernel takes;
    ValueError otherwise."""
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError('int8_conv: no kernel for device %s' % x.device)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError('int8_conv takes bf16 or fp32 inputs, got %s' % x.dtype)
    if site.out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError('int8_conv writes bf16 or fp32, not %s' % site.out_dtype)
    for name, t in (('codes', site.codes), ('scale', site.scale), ('x_scale', site.x_scale),
                    ('bias', site.bias)):
        if t is not None and t.device != x.device:
            raise ValueError('int8_conv: x on %s, the site\'s %s on %s' % (x.device, name, t.device))
    if site.dense:
        k, cout = site.codes.shape
        if x.dim() != 2 or x.shape[1] != k or not x.is_contiguous():
            raise ValueError('int8_conv: a dense site takes a contiguous [M, %d] input, got %s %s'
                             % (k, tuple(x.shape), tuple(x.stride())))
        return x.shape[0], 1, 1, k, 1, 1, 0, 0
    kh, kw, cin, cout = site.codes.shape
    if x.dim() != 4 or x.shape[1] != cin \
            or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError('int8_conv: a conv site takes a channels-last [N, %d, H, W] input, got '
                         '%s %s' % (cin, tuple(x.shape), tuple(x.stride())))
    n, c, h, w = x.shape
    ho, wo, top, left = _conv_geometry(h, w, kh, kw, site.strides, site.padding)
    if ho < 1 or wo < 1:
        raise ValueError('int8_conv: a %dx%d window does not fit a %dx%d input' % (kh, kw, h, w))
    return n, h, w, c, ho, wo, top, left


def _library() -> ctypes.CDLL:
    from pocketflow_tpu_torch.ops import build
    lib, _, _ = build.load('int8_conv.cu')
    if not getattr(lib, '_pf_bound', False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.pf_int8_conv.argtypes = [ptr] * 10 + [i32, ptr]
        lib.pf_int8_conv.restype = i32
        lib._pf_bound = True
    return lib


@dataclasses.dataclass
class _Launch:
    """The kernel's launch of a site for one input layout, worked out once:
    the tile plan, the output's NHWC shape, the workspace's bytes (the
    codes, then the split-K partials), the plan's counters, whether x's
    channels allow 16-byte loads, and the entry point's geometry
    (csrc/int8_conv.cu: pf_int8_conv), a ctypes int array."""
    plan: TilePlan
    y_shape: Tuple[int, ...]
    codes_bytes: int
    partial_bytes: int
    counters: torch.Tensor
    vec: bool
    geometry: ctypes.Array


def _prepare_launch(x: torch.Tensor, site: Int8Site, aligned: bool) -> _Launch:
    n, h, w, c, ho, wo, top, left = _check_conv(x, site)
    if site.packed is None or site.packed.device != x.device:
        raise ValueError('int8_conv: the site has no packed codes on %s' % x.device)
    kh, kw = (1, 1) if site.dense else site.codes.shape[:2]
    cout = site.codes.shape[-1]
    m = n * ho * wo
    plan, counters = site_plan(site, m)
    wide = wide_taps(tuple(site.codes.shape))
    sub = subsampled(tuple(site.codes.shape), site.strides)
    npad, kp = site.packed.shape
    cp = padded_channels(kw * c if wide else c)
    units = -(-m // plan.bm) * (npad // plan.bn) * plan.splits
    geometry = (x.dtype == torch.float32, site.out_dtype == torch.float32, n, h, w, c, cp, ho, wo,
                cout, npad, kp, kh, kw, site.strides[0], site.strides[1], top, left, wide,
                plan.bm, plan.bn, plan.splits)
    return _Launch(plan, (n, cout) if site.dense else (n, ho, wo, cout),
                   n * (ho if sub else h) * (wo if wide or sub else w) * cp,
                   units * plan.bm * plan.bn * 4 if plan.splits > 1 else 0, counters,
                   aligned and c % 8 == 0 and not wide, (ctypes.c_int * len(geometry))(*geometry))


def launch_plan(x: torch.Tensor, site: Int8Site) -> TilePlan:
    """The tile plan of the kernel's launch for x (a CUDA tensor)."""
    return _launch(x, site).plan


def _launch(x: torch.Tensor, site: Int8Site) -> _Launch:
    key = (x.shape, x.stride(), x.dtype, x.device, x.data_ptr() % 16 == 0)
    launch = site.launches.get(key)
    if launch is None:
        launch = site.launches[key] = _prepare_launch(x, site, key[-1])
    return launch


def int8_conv(x: torch.Tensor, site: Int8Site) -> torch.Tensor:
    """The int8 contraction of one site: y = out_dtype(float(conv or dense of
    clamp(round(x / x_scale), -127, 127) with the codes, int32 sums) *
    x_scale * w_scale (+ bias)).  x is a channels-last NCHW (conv) or contiguous [M,
    K] (dense) bf16 or fp32 tensor; y is channels-last NCHW or [M, N].  The
    kernel on CUDA (one launch, with a workspace for the padded codes and,
    where the plan splits K, the partial sums; an input layout is checked
    and laid out at its first call), the plain version on the CPU."""
    global kernel_launches
    if x.device.type != 'cuda':
        _check_conv(x, site)
        return int8_conv_plain(x, site)
    launch = _launch(x, site)
    y = torch.empty(launch.y_shape, dtype=site.out_dtype, device=x.device)
    workspace = torch.empty(launch.codes_bytes + launch.partial_bytes, dtype=torch.uint8,
                            device=x.device)
    x_ptr, ws_ptr = x.data_ptr(), workspace.data_ptr()
    err = _library().pf_int8_conv(
        x_ptr, site.packed.data_ptr(), site.scale.data_ptr(), site.x_scale.data_ptr(),
        None if site.bias is None else site.bias.data_ptr(), y.data_ptr(), ws_ptr,
        ws_ptr + launch.codes_bytes if launch.partial_bytes else None,
        launch.counters.data_ptr(), launch.geometry, launch.vec,
        # the raw handle of the current stream (torch.cuda.current_stream
        # builds a Stream object: several microseconds a call)
        torch._C._cuda_getCurrentRawStream(x.get_device()))
    if err != 0:
        raise RuntimeError('int8_conv: CUDA error %d at launch' % err)
    kernel_launches += 1
    return y if site.dense else y.permute(0, 3, 1, 2)


class CalibrationPolicy(CompressionPolicy):
    """Records each layer's input absmax (post-training calibration)."""

    def __init__(self):
        self.absmax: Dict[str, torch.Tensor] = {}

    def reset_trace(self):
        super().reset_trace()
        self.absmax = {}

    def process_input(self, path, x):
        m = x.detach().to(torch.float32).abs().amax()
        self.absmax[path] = torch.maximum(self.absmax[path], m) if path in self.absmax else m
        return x


def calibrate(model: torch.nn.Module, batches_images: Iterable[torch.Tensor]) -> Dict[str, float]:
    """Eval forwards of a few batches; per-layer input scales absmax / 127
    (host floats, the max over the batches)."""
    policy = CalibrationPolicy()
    was_training = model.training
    model.eval()
    absmax: Dict[str, float] = {}
    with torch.no_grad():
        for images in batches_images:
            with compression(policy):
                model(images)
            for path, m in policy.absmax.items():
                absmax[path] = max(absmax.get(path, 0.0), float(m))
    model.train(was_training)
    return {path: max(m, 1e-8) / _LEVELS for path, m in absmax.items()}


class Int8ServingPolicy(CompressionPolicy):
    """Runs every quantized conv/dense in int8.

    ``weight_q[path] = (codes, w_scale)``; ``act_scales[path]`` from
    calibrate().  Layers without both fall through to the float path.

    ``skip_depthwise`` (default True): a depthwise conv stays on the float
    path, since int8 buys it nothing and its quantize/dequantize pair is
    pure overhead.  A depthwise site is recognized by its kernel: HWIO with
    I == 1 and O a multiple of the input's channel count (x.shape[1], the
    channel axis of NCHW activations).  C > 1 keeps a dense conv on one
    input channel (a grayscale stem) in int8.

    Each site is prepared once per device at its first use (``Int8Site``)
    from the layer that the hook passes: its strides and padding, its dtype,
    which the site writes, and its bias, which the site adds.  A site is
    ``int8_conv`` (one kernel launch on CUDA, the plain version on the CPU);
    a depthwise one is the plain formula through the layer's ``contract_fn``
    on any device.  A bare contraction (no layer: stride 1, 'SAME', fp32, no
    bias) takes that route too, on the CPU only.
    """

    def __init__(self, weight_q, act_scales: Dict[str, float], skip_depthwise: bool = True):
        self.weight_q = weight_q
        self.act_scales = act_scales
        self.skip_depthwise = skip_depthwise
        self.sites: Dict[tuple, Int8Site] = {}

    def site(self, path, x, layer=None) -> Int8Site:
        """The prepared site of `path` on x's device."""
        key = (path, x.device)
        if key not in self.sites:
            codes, w_scale = self.weight_q[path]
            spec = {}
            if layer is not None:
                spec = dict(out_dtype=layer.dtype, bias=layer.bias)
                if isinstance(layer, PFConv):
                    spec.update(strides=layer.strides, padding=layer.padding)
            self.sites[key] = make_site(codes, w_scale, self.act_scales[path], x.device,
                                        x_shape=tuple(x.shape), **spec)
        return self.sites[key]

    def run_contraction(self, path, x, kernel, contract_fn, layer=None):
        global plain_calls
        entry = self.weight_q.get(path)
        if entry is None or path not in self.act_scales:
            return None
        depthwise = (kernel.dim() == 4 and kernel.shape[-2] == 1 and kernel.shape[-1] > 1
                     and x.shape[1] > 1 and kernel.shape[-1] % x.shape[1] == 0)
        if depthwise and self.skip_depthwise:
            return None
        with span('int8.site', path):
            site = self.site(path, x, layer)
            if layer is not None and not depthwise:
                return int8_conv(x, site)
            if x.device.type != 'cpu' and not depthwise:
                raise ValueError('Int8ServingPolicy: %s on %s: the kernel needs the layer' %
                                 (path, x.device))
            plain_calls += x.device.type == 'cpu'
            return _contract_plain(x, site, contract_fn)


class _SiteRecorder(CompressionPolicy):
    def __init__(self):
        self.sites = []

    def process_weight(self, path, kernel):
        self.sites.append(path)
        return kernel


def verify_quant_coverage(model: torch.nn.Module, sample_images: torch.Tensor, weight_q,
                          act_scales) -> Dict[str, list]:
    """Every conv/dense of an eval forward of `sample_images` must have int8
    weights and an activation scale.  Returns {'unquantized_weights': [...],
    'uncalibrated': [...]}, both empty when the deployment is all int8."""
    recorder = _SiteRecorder()
    was_training = model.training
    model.eval()
    with torch.no_grad(), compression(recorder):
        model(sample_images)
    model.train(was_training)
    return {'unquantized_weights': [p for p in recorder.sites if p not in weight_q],
            'uncalibrated': [p for p in recorder.sites if p not in act_scales]}


def quantize_model_weights(model: torch.nn.Module, skip_paths=()) -> Dict[str, tuple]:
    """{module path: (codes, w_scale)} for every conv/dense kernel of `model`
    outside skip_paths, on the kernel's device."""
    return {m.path: quantize_weights_symmetric(m.kernel) for m in model.modules()
            if isinstance(m, (PFConv, PFDense)) and m.path not in skip_paths}
