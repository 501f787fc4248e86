// The int8 serving contraction of one conv or dense site for Hopper (sm_90a).
//
//   y[m, n] = out(float(sum_k xq[m, k] * w[n, k]) * scale[n] (+ bias[n]))
//   xq      = clamp(rint(x / x_scale), -127, 127)        (int8)
//
// x is the layer's input, NHWC (a channels-last NCHW tensor, or [M, C] for a
// dense layer) in bf16 or fp32; xq[m, k] is the im2col row of output position
// m over the input's codes with their channels padded to Cp (C rounded up to
// 16, code 0 past C): k = (i * kw + j) * Cp + c in the order of the HWIO
// kernel, code 0 where the window falls on the padding.  w is the packed
// [Npad, Kp] int8 codes (K-major: row n holds output channel n's kh * kw * Cp
// codes, zero past C in each tap, past K = kh * kw * Cp up to Kp, a multiple
// of 128, and past Cout),
// scale[n] = x_scale * w_scale[n] in fp32 (zero past Cout), x_scale one fp32
// value on the device, bias (optional) [Npad] fp32 (zero past Cout), y
// [M, Cout] (NHWC) in bf16 or fp32.
//
// It replaces no Pallas kernel.  The JAX package's int8 serving
// (pocketflow_tpu/ops/int8_ops.py:37, int8_contract) is XLA's native int8
// convolution with preferred_element_type=int32, into which XLA fuses the
// quantize before and the rescale and cast after; this kernel does the
// whole site in one launch.  Its plain version, ops/int8_ops.py:
// int8_conv_plain, is that formula step by step, and the two give the same
// bits: the codes are those of the IEEE division (PyTorch divides by a
// tensor so; quantize8() below gets them from a multiply and, where that
// could round otherwise, __fdiv_rn), rint rounds half to even as
// torch.round, the int32 sums are exact in any order (|sum| < 127^2 K <
// 2^31), and the rescale is one __fmul_rn of __int2float_rn(acc) by the
// precomputed scale, then one __fadd_rn of the layer's bias where it has one
// (its fp32 bias add), rounded once to the output type (__float2bfloat16_rn).
//
// What bounds a site on the card.  It reads its input once in its dtype and
// writes its output once, and does 2 * M * Cout * kh * kw * C int8
// operations, against the H100's 3.35 TB/s and 1,979 TOP/s int8: most sites
// of ResNet-50 and MobileNet-v1 at batch 64 are bound by bytes, the dense
// layers and the last stage's convs by neither (few output tiles for 132
// SMs: latency).  The quantize costs ALU work that neither bound counts:
// done inside the product's main loop, as this kernel first did, it ran
// once for each element of the im2col rows (nine times a pixel for a 3x3
// conv) and once more for each column tile, and took several times the int8
// products.  The design:
//
//   * Two phases in one cooperative launch.  Phase 1 quantizes the input
//     once an element into a workspace of codes [N, H, W, Cp] (the wrapper
//     allocates it; the kernel allocates nothing): every thread of the grid
//     on groups of 8 codes, 8 groups' loads in flight a thread (16-byte loads
//     where C % 8 == 0, element loads elsewhere), an 8-byte store of codes a
//     group.  Its arithmetic avoids the conversion instructions, which run
//     at a quarter of the ALUs' rate (quantize8()), and the rare values
//     that need the division go on a per-warp list in shared memory that the
//     warp redoes after its loop (no atomic, no branch in the loop; a group
//     past a full list is redone at once).  A
//     grid-wide barrier follows (a self-resetting arrival count and
//     generation in the site's counters; the cooperative launch makes every
//     block resident, or refuses the launch, so the barrier cannot hang).
//     No site keeps the quantize inside its product: one path for every
//     site; the codes are half the bytes of a bf16 input, and a 1x1 site
//     reads them back mostly from the 50 MB L2.
//   * Three layouts of the codes, so that phase 2 copies whole 16-byte
//     chunks of one tap: the channels padded to 16 (code 0 past C; the
//     packed weights the same, zero there); the stems' wide layout (a conv
//     on so few channels that a window row's kw * C codes fit in 32: the
//     codes' pixel (n, h, wo) holds that row's codes, and phase 2 runs kh x
//     1 taps, kh 32-byte chunks a row instead of kh * kw chunks mostly of
//     padding); a strided 1x1 conv's subsampled layout (only the pixels it
//     reads, and phase 2 at stride 1).
//   * Phase 2 is a warp-specialized implicit GEMM over the codes into a ring
//     of stages (128 k a stage, 128-byte swizzle: 16-byte chunk c of row r
//     at c ^ (r % 8)), a full and an empty mbarrier a stage.  One thread of
//     the producer warpgroup loads B's BN x 128 panel with TMA and, where
//     phase 2 is a 1x1 product at stride 1 (A's rows are the codes' rows),
//     A's BM x 128 box too (zeros past M and past Cp).  Otherwise the
//     producer's threads gather A with cp.async, each one 16-byte chunk of
//     one tap for BM / 16 rows (the rows' window origins worked out once a
//     row tile, one row a thread, through shared memory), the window's
//     padding and rows past M as cp.async's zero fill, and signal a stage's
//     full barrier kLag stages later, once its copies have landed
//     (cp.async.wait_group) and after a proxy fence that makes them visible
//     to the tensor cores.  Past K the stage's A is left as it is: B is zero
//     there (Kp is a multiple of 128, so every stage runs its four steps).
//   * One or two consumer warpgroups (BM = 64 or 128) run wgmma
//     m64nBNk32 s32.s8.s8 on a stage and wait with wgmma.wait_group 1, so a
//     stage's products run while the next stage is waited for, and free the
//     stage through its empty barrier; the producer hands registers to the
//     consumers (setmaxnreg) where there are two.
//   * A tile plan a site, chosen on the host (ops/int8_ops.py:tile_plan):
//     BM, BN = 64, 128 or 256 (by Cout: the packed codes are padded to it)
//     and a split of K.  The grid is persistent (as many blocks as fit on
//     the SMs, each walking its units: split fastest, then the column tile,
//     then the row tile), so the producer loads the next unit's stages
//     while the consumers write a unit out.  With a split, each unit writes
//     its int32 partial sums in the accumulators' own layout to a workspace,
//     counts itself in its tile's counter, and the last unit of a tile to
//     arrive adds the others' partials (exact in any order), resets the
//     counter for the next call and writes the tile.
//   * The epilogue: a bf16 output with Cout % 8 == 0 goes through a
//     warpgroup's staging tile in shared memory (64 x 64 panels in TMA's
//     swizzle, no bank conflict) and leaves by TMA stores, which run on
//     while the next unit's products start; other outputs go straight to
//     y, two columns at a time where Cout is even.
//   * The dynamic shared memory size and the grid are set up at a variant's
//     first launch on a device, so that a launch makes no other call of the
//     runtime than its tensor maps' encoding.  A wait of about ten seconds
//     traps, so that a fault of the pipeline is a launch error, not a hung
//     card.
//
// Plain C interface for ctypes; the entry point returns the launch's error
// (or cudaErrorInvalidValue for arguments out of range).

#include <cuda.h>  // CUtensorMap and its enums (types only; nothing is linked from it)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kBK = 128;              // k a stage: one 128-byte row of codes
constexpr int kChunk = 16;            // codes a 16-byte chunk; Cp is a multiple of it
constexpr int kGroup = 8;             // phase 1: codes a thread makes at a time
constexpr int kGroupsInFlight = 8;    // phase 1: groups a thread loads before it quantizes them
constexpr int kNearCap = 2047;        // phase 1: groups a warp lists to redo with divisions
constexpr int kMaxWarps = 16;
constexpr int kProducerThreads = 128;
constexpr int kProducerRegs = 56;     // setmaxnreg with two consumer warpgroups:
constexpr int kConsumerRegs = 224;    // 128 x 56 + 256 x 224 = 384 x 168
constexpr int kLag = 2;               // stages of copies in flight beyond the signalled one
constexpr int kSmemAlign = 1024;      // a 128-byte swizzle repeats every 8 rows of 128 bytes
constexpr int kMaxSmem = 232448;      // dynamic shared memory of one block
constexpr long long kWaitTrapCycles = 1LL << 34;  // ~10 s at the H100's clocks

template <int BM, int BN> struct Tile {
  static constexpr int kConsumers = BM / 64;  // warpgroups of 64 rows
  static constexpr int kThreads = 128 * kConsumers + kProducerThreads;
  static constexpr int kABytes = BM * kBK;
  static constexpr int kBBytes = BN * kBK;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kStageCols = BN < 128 ? BN : 128;  // bf16 columns a staging pass
  static constexpr int kStagingBytes = kConsumers * 64 * kStageCols * 2;
  static constexpr int kRowsOffset = 256;  // after the mbarriers and the last-unit flag
  static constexpr int kMiscBytes = kRowsOffset + 8 * BM;  // and the row tile's window origins
  static constexpr int kFit = (kMaxSmem - kStagingBytes - kMiscBytes - kSmemAlign) / kStageBytes;
  static constexpr int kStages = kFit < 8 ? kFit : 8;
  static constexpr int kStagingOffset = kStages * kStageBytes;
  static constexpr int kBarOffset = kStagingOffset + kStagingBytes;
  static constexpr int kSmemBytes = kBarOffset + kMiscBytes + kSmemAlign;
  static_assert(kStages >= kLag + 2, "the ring: the producer's lag and a stage being read");
  static_assert(kStages * kStageBytes >= 4 * kMaxWarps * (1 + kNearCap), "phase 1's lists");
  static_assert(kSmemBytes <= kMaxSmem, "shared memory of one block");
  static_assert(16 * kStages + 4 <= kRowsOffset, "the mbarriers and the flag");
};

struct alignas(64) Params {
  CUtensorMap y_map;  // y as [M, Cout] bf16 in 64 x 64 boxes, 128-byte swizzle (tma_y)
  CUtensorMap b_map;  // w as [Npad, Kp] int8 in BN x 128 boxes, 128-byte swizzle
  CUtensorMap a_map;  // the codes as [pixels, Cp] int8 in BM x 128 boxes (tma_a)
  const void* x;
  const int8_t* w;
  const float* scale;
  const float* x_scale;
  const float* bias;  // or nullptr
  void* y;
  int8_t* codes;       // [pixels, Cp], phase 1's output
  int* partials;       // [units, BM * BN] int32 partial sums (splits > 1)
  unsigned* counters;  // [2 + tiles]: the grid barrier's count and generation, a count a tile
  // phase 2's geometry: the codes' grid [N, H, W, Cp], the taps kh x kw at
  // strides sh, sw; C the input's channels
  int pixels, H, W, C, Cp, Ho, Wo, M, Cout, Kp, K, kw, sh, sw, pad_top, pad_left, splits;
  // wide: the codes' pixel (n, h, wo) holds the kw taps of one window row,
  // code j C + c from x[n, h, wo xsw - xpl + j, c] (x's width xW), and phase
  // 2 runs kh x 1 taps over them; sub (a 1x1 conv at a stride): the codes'
  // pixel (n, ho, wo) is x's pixel (n, ho xsh, wo xsw) (x's height xH), and
  // phase 2 runs a 1x1 conv at stride 1 over them
  int wide, sub, xH, xW, xkw, xsh, xsw, xpl;
  int x_fp32, y_fp32, vec;
  int tma_y;  // a bf16 y with Cout % 8 == 0: the epilogue stores with TMA
  int tma_a;  // a 1x1 product at stride 1: A's rows are the codes' rows, loaded with TMA
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A wgmma shared-memory descriptor, 128-byte swizzle, K-major: start
// address, leading byte offset (unused by the swizzled layouts) and the
// stride between 8-row groups, all in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>(1) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// The box of a 2-D tensor map at (c0 inner, c1 outer) into shared memory;
// its bytes complete the transaction count of the mbarrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`; a wait
// of more than about ten seconds traps.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - start > kWaitTrapCycles) __trap();
  } while (!done);
}

// The 64 x 64 box of y at (column c0, row c1) from a swizzled staging panel.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1)
               : "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Every block of the (cooperative, so all resident) grid reaches this
// before any goes on: bar[0] counts the arrivals and is reset by the last,
// which then advances the generation bar[1] that the others wait on.  The
// fences order each block's earlier global stores before its arrival, and
// the generation's read before its later loads.
__device__ __forceinline__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned generation = ld_acquire(bar + 1);
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      const long long start = clock64();
      while (ld_acquire(bar + 1) == generation)
        if (clock64() - start > kWaitTrapCycles) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

#define PF_ACC8(i)                                                                          \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), "+r"(d[i + 5]), \
      "+r"(d[i + 6]), "+r"(d[i + 7])
#define PF_ACC32(i) PF_ACC8(i), PF_ACC8(i + 8), PF_ACC8(i + 16), PF_ACC8(i + 24)
#define PF_D32                                                                    \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "        \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define PF_D64                                                                    \
  PF_D32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, " \
         "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "    \
         "%60, %61, %62, %63"
#define PF_D128                                                                       \
  PF_D64 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, "    \
         "%78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, " \
         "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, "     \
         "%106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "    \
         "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"

// d (+)= a @ b for one m64nNk32 step of int8 codes, a and b K-major in
// shared memory, int32 accumulators d[0..N/2) in the layout of the f32 ones;
// scale_d = 0 starts a new sum (a unit's first step), so that no other
// instruction writes the accumulators between the products.
template <int N> struct WgmmaS8;

template <> struct WgmmaS8<64> {
  __device__ __forceinline__ static void mma(int (&d)[32], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {" PF_D32 "}, %32, %33, p;\n}\n"
        : PF_ACC32(0)
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <> struct WgmmaS8<128> {
  __device__ __forceinline__ static void mma(int (&d)[64], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {" PF_D64 "}, %64, %65, p;\n}\n"
        : PF_ACC32(0), PF_ACC32(32)
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <> struct WgmmaS8<256> {
  __device__ __forceinline__ static void mma(int (&d)[128], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {" PF_D128 "}, %128, %129, p;\n}\n"
        : PF_ACC32(0), PF_ACC32(32), PF_ACC32(64), PF_ACC32(96)
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

#undef PF_ACC8
#undef PF_ACC32
#undef PF_D32
#undef PF_D64
#undef PF_D128

template <int R>
__device__ __forceinline__ void fence_registers(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// 16 bytes from src, or zeros (src_bytes = 0: nothing is read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// The raw bits of a group of 8 values: 8 bf16 in 4 words, or 8 fp32.
template <typename T> struct Group;
template <> struct Group<__nv_bfloat16> {
  static constexpr int kWords = 4;
  __device__ __forceinline__ static void load8(const __nv_bfloat16* p, uint32_t (&w)[kWords]) {
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = b.x;
    w[1] = b.y;
    w[2] = b.z;
    w[3] = b.w;
  }
  __device__ __forceinline__ static void put(uint32_t (&w)[kWords], int e, const __nv_bfloat16* p) {
    const uint32_t bits = *reinterpret_cast<const unsigned short*>(p);
    w[e >> 1] |= (e & 1) ? bits << 16 : bits;
  }
  __device__ __forceinline__ static float value(const uint32_t (&w)[kWords], int e) {
    return __uint_as_float((e & 1) ? (w[e >> 1] & 0xFFFF0000u) : (w[e >> 1] << 16));
  }
};
template <> struct Group<float> {
  static constexpr int kWords = 8;
  __device__ __forceinline__ static void load8(const float* p, uint32_t (&w)[kWords]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 b = __ldg(reinterpret_cast<const uint4*>(p) + h);
      w[4 * h] = b.x;
      w[4 * h + 1] = b.y;
      w[4 * h + 2] = b.z;
      w[4 * h + 3] = b.w;
    }
  }
  __device__ __forceinline__ static void put(uint32_t (&w)[kWords], int e, const float* p) {
    w[e] = *reinterpret_cast<const uint32_t*>(p);
  }
  __device__ __forceinline__ static float value(const uint32_t (&w)[kWords], int e) {
    return __uint_as_float(w[e]);
  }
};

// The raw bits of group v's values (the codes' pixel v / gq, channels 8 (v
// % gq) + e), zero where the code is 0: one 16-byte load of bf16 where vec
// (C % 8 == 0, x 16-byte aligned, not wide), element loads elsewhere.
template <typename T>
__device__ __forceinline__ void load_group(const Params& p, int v, int gq,
                                           uint32_t (&w)[Group<T>::kWords]) {
  using G = Group<T>;
#pragma unroll
  for (int i = 0; i < G::kWords; ++i) w[i] = 0u;
  const T* x = static_cast<const T*>(p.x);
  if (p.vec && p.Cp == p.C && !p.sub) {  // no padding: group v is x's values 8 v on
    G::load8(x + static_cast<int64_t>(v) * kGroup, w);
    return;
  }
  int pix = v / gq;
  const int c0 = (v - pix * gq) * kGroup;
  if (p.sub) {  // the codes' pixel (n, ho, wo) is x's pixel (n, ho xsh, wo xsw)
    const int nh = pix / p.W, wo = pix - nh * p.W;
    const int n = nh / p.H, ho = nh - n * p.H;
    pix = (n * p.xH + ho * p.xsh) * p.xW + wo * p.xsw;
  }
  if (p.vec) {
    if (c0 < p.C) G::load8(x + static_cast<int64_t>(pix) * p.C + c0, w);
    return;
  }
  if (!p.wide) {
    const T* src = x + static_cast<int64_t>(pix) * p.C + c0;
#pragma unroll
    for (int e = 0; e < kGroup; ++e)
      if (c0 + e < p.C) G::put(w, e, src + e);
    return;
  }
  // wide: the window row's kw C values are contiguous in x's image row,
  // from column w0 on; those of columns outside it are the padding
  const int nh = pix / p.W, wo = pix - nh * p.W;
  const int first = (wo * p.xsw - p.xpl) * p.C + c0;  // in the image row's W C values
  const T* row = x + static_cast<int64_t>(nh) * p.xW * p.C;
#pragma unroll
  for (int e = 0; e < kGroup; ++e)
    if (c0 + e < p.xkw * p.C && first + e >= 0 && first + e < p.xW * p.C)
      G::put(w, e, row + first + e);
}

// The codes clamp(rint(v / s), -127, 127) of a group's 8 values, as the
// IEEE division rounds them, low byte first, from r = 1 / s rounded.  t = v *
// r is within 3 units of 2^-24 of v / s relative to it (one rounding in r,
// one in the product), and the rounded quotient within one unit: below |t|
// = 128 the two lie within 2^-14 / 2.67 of each other.  So where t lies
// farther than 2^-14 from every half-integer, both round to the same
// integer, and where |t| >= 127 both clamp to +-127.  The rest (bf16
// activations repeat their values: about one in 3,000 of a normal batch)
// have to be divided: quantize8() says whether the group holds any, and
// exact8() computes the group again with those divided.  The common path
// uses no conversion instruction (a quarter of the ALUs' rate on this card):
// t clamped to [-127, 127] (as good as clamping after the rounding) plus
// 1.5 * 2^23 rounds to an integer, half to even, whose low byte is the code,
// and |t - its rounding| < kNearHalf clears the group; an element costs a
// multiply, a clamp, three adds and a max, and a byte permute for two.
constexpr float kNearHalf = 0.5f - 1.0f / 16384.0f;
constexpr float kRoundMagic = 12582912.0f;  // 1.5 * 2^23

__device__ __forceinline__ bool near_half(float t) {
  return fabsf(t - rintf(t)) >= kNearHalf && fabsf(t) < 127.0f;
}

__device__ __forceinline__ int code_int(float t) {
  return __float2int_rn(fminf(fmaxf(t, -127.0f), 127.0f));
}

// the low bytes of eight words (codes), low byte first
__device__ __forceinline__ uint2 pack8(const int (&c)[kGroup]) {
  return make_uint2(
      __byte_perm(__byte_perm(c[0], c[1], 0x0040), __byte_perm(c[2], c[3], 0x0040), 0x5410),
      __byte_perm(__byte_perm(c[4], c[5], 0x0040), __byte_perm(c[6], c[7], 0x0040), 0x5410));
}

template <typename T>
__device__ __forceinline__ bool quantize8(const uint32_t (&w)[Group<T>::kWords], float r,
                                          uint2& out) {
  int c[kGroup];
  float worst = 0.0f;
#pragma unroll
  for (int e = 0; e < kGroup; ++e) {
    const float t = fminf(fmaxf(__fmul_rn(Group<T>::value(w, e), r), -127.0f), 127.0f);
    const float rounded = __fadd_rn(t, kRoundMagic);
    worst = fmaxf(worst, fabsf(__fadd_rn(t, -__fadd_rn(rounded, -kRoundMagic))));
    c[e] = __float_as_int(rounded);  // its low byte is the code
  }
  out = pack8(c);
  return worst >= kNearHalf;
}

template <typename T>
__device__ __forceinline__ uint2 exact8(const Params& p, int v, int gq, float s, float r) {
  uint32_t w[Group<T>::kWords];
  load_group<T>(p, v, gq, w);
  int c[kGroup];
#pragma unroll
  for (int e = 0; e < kGroup; ++e) {
    const float x = Group<T>::value(w, e);
    const float t = __fmul_rn(x, r);
    c[e] = code_int(near_half(t) ? __fdiv_rn(x, s) : t);
  }
  return pack8(c);
}

// Phase 1: the codes of the whole input, [pixels, Cp], every thread of the
// grid on groups v, v + stride, ... (a warp's loads and stores contiguous),
// kGroupsInFlight groups' loads in flight a thread.  A group with a value
// near a half-integer goes on its warp's list in shared memory (`near`: a
// count a warp, then the lists; the warp's count kept in registers, the
// same in every lane, so that no atomic is needed), and the warp redoes
// its listed groups with exact8() after its loop; a group past a full list
// is redone at once.
template <typename T>
__device__ __forceinline__ void quantize_input(const Params& p, float s, float r, int* near) {
  constexpr int kWords = Group<T>::kWords;
  const int gq = p.Cp / kGroup;
  const int groups = p.pixels * gq;
  const int stride = static_cast<int>(gridDim.x * blockDim.x);
  const int first = static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* list = near + kMaxWarps + warp * kNearCap;
  uint2* codes = reinterpret_cast<uint2*>(p.codes);
  int listed = 0;
  for (int v0 = first; v0 < groups; v0 += kGroupsInFlight * stride) {
    uint32_t w[kGroupsInFlight][kWords];
#pragma unroll
    for (int q = 0; q < kGroupsInFlight; ++q)
      if (v0 + q * stride < groups) load_group<T>(p, v0 + q * stride, gq, w[q]);
    uint32_t flagged = 0u;  // no branch in the loop: the groups' work interleaves
#pragma unroll
    for (int q = 0; q < kGroupsInFlight; ++q) {
      const int v = v0 + q * stride;
      if (v >= groups) continue;
      uint2 c;
      flagged |= static_cast<uint32_t>(quantize8<T>(w[q], r, c)) << q;
      codes[v] = c;
    }
    // the lanes still in the loop append their flagged groups in lane order
    const unsigned active = __activemask();
#pragma unroll
    for (int q = 0; q < kGroupsInFlight; ++q) {
      const unsigned ballot = __ballot_sync(active, flagged >> q & 1u);
      if (flagged >> q & 1u) {
        const int slot = listed + __popc(ballot & ((1u << lane) - 1u));
        const int v = v0 + q * stride;
        if (slot < kNearCap)
          list[slot] = v;
        else
          codes[v] = exact8<T>(p, v, gq, s, r);
      }
      listed += __popc(ballot);
    }
  }
  // lane 0 took part in every pass of its warp (it has the lowest v0)
  if (lane == 0) near[warp] = min(listed, kNearCap);
  __syncwarp();
  for (int i = lane; i < near[warp]; i += 32) {
    const int v = list[i];
    codes[v] = exact8<T>(p, v, gq, s, r);
  }
}

// An accumulator rescaled as the plain route does: float(acc) * scale, then
// + bias in fp32 where the layer has one, and nothing where it has none (a
// product that underflows to -0.0 stays -0.0).
__device__ __forceinline__ float rescale(int acc, float scale, float bias, const float* has_bias) {
  const float v = __fmul_rn(__int2float_rn(acc), scale);
  return has_bias ? __fadd_rn(v, bias) : v;
}

template <int BM, int BN>
__global__ void __launch_bounds__(Tile<BM, BN>::kThreads, 1)
int8_conv_wgmma(const __grid_constant__ Params p) {
  using Tl = Tile<BM, BN>;
  constexpr int S = Tl::kStages;
  constexpr int kConsumerThreads = 128 * Tl::kConsumers;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + kSmemAlign - 1) & ~static_cast<uint32_t>(kSmemAlign - 1);
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full_bar = base + Tl::kBarOffset;  // stage s: full_bar + 8 s
  const uint32_t empty_bar = full_bar + 8 * S;
  volatile int* last_flag = reinterpret_cast<volatile int*>(smem + Tl::kBarOffset + 16 * S);

  // phase 1: the input's codes; the barriers set up meanwhile
  {
    const float s = *p.x_scale;
    const float r = __frcp_rn(s);
    // the near-half list in the stages' memory, which phase 2 fills later
    int* near = reinterpret_cast<int*>(smem);
    if (p.x_fp32)
      quantize_input<float>(p, s, r, near);
    else
      quantize_input<__nv_bfloat16>(p, s, r, near);
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      // the TMA thread's expected bytes, and the A copies' lagged signals
      mbar_init(full_bar + 8 * i, p.tma_a ? 1 : 1 + kProducerThreads);
      mbar_init(empty_bar + 8 * i, kConsumerThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  grid_sync(p.counters);

  // phase 2: unit u = (tile, split), tile = row tile * n_tiles + column
  // tile; split s takes k-blocks [s nk / splits, (s + 1) nk / splits)
  const int n_tiles = (p.Cout + BN - 1) / BN;
  const int units = ((p.M + BM - 1) / BM) * n_tiles * p.splits;
  const int nk = (p.Kp + kBK - 1) / kBK;
  const int block = static_cast<int>(blockIdx.x), grid = static_cast<int>(gridDim.x);

  if (threadIdx.x >= kConsumerThreads) {
    // the producer warpgroup: thread 0 loads B's panel (and, tma_a, A's
    // rows) of each stage with TMA; otherwise thread t copies 16-byte chunk
    // t % 8 of rows t / 8 + 16 q of A
    if constexpr (Tl::kConsumers == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    const int t = threadIdx.x - kConsumerThreads;
    if (p.tma_a) {
      if (t != 0) return;
      int g = 0;
      for (int u = block; u < units; u += grid) {
        const int tile = u / p.splits, split = u - tile * p.splits;
        const int mt = tile / n_tiles, n0 = (tile - mt * n_tiles) * BN;
        for (int kb = split * nk / p.splits; kb < (split + 1) * nk / p.splits; ++kb, ++g) {
          const int slot = g % S;
          mbar_wait(empty_bar + 8 * slot, ((g / S) & 1) ^ 1);
          const uint32_t a = base + slot * Tl::kStageBytes, bar = full_bar + 8 * slot;
          mbar_expect_tx(bar, Tl::kStageBytes);  // rows past M, k past Cp: zeros
          tma_load(a, &p.a_map, bar, kb * kBK, mt * BM);
          tma_load(a + Tl::kABytes, &p.b_map, bar, kb * kBK, n0);
        }
      }
      return;
    }
    const int chunk = t & 7, r0 = t >> 3;
    const int swizzle = (chunk ^ (r0 & 7)) << 4;  // rows r0 + 16 q all have r % 8 = r0 % 8
    // row r0 + 16 q of the current row tile: the pixel offset of its window
    // origin, (n H + h0) W + w0, and (h0, w0) as two 16-bit halves (h0 far
    // below 0 past M, so every tap falls outside); thread t works out row t
    // of a new row tile into shared memory, and each thread reads its rows
    int2* rows = reinterpret_cast<int2*>(smem + Tl::kBarOffset + Tl::kRowsOffset);
    int origin[BM / 16], hw[BM / 16];
    int rows_tile = -1;
    int g = 0;
    for (int u = block; u < units; u += grid) {
      const int tile = u / p.splits, split = u - tile * p.splits;
      const int mt = tile / n_tiles, n0 = (tile - mt * n_tiles) * BN;
      const int kb0 = split * nk / p.splits, kb1 = (split + 1) * nk / p.splits;
      if (mt != rows_tile) {
        rows_tile = mt;
        named_barrier(4, kProducerThreads);  // every thread has read the last tile's rows
        const int m = mt * BM + t;
        if (t < BM) {
          if (m < p.M) {
            const int hwo = p.Ho * p.Wo;
            const int img = m / hwo, rem = m - img * hwo;
            const int ho = rem / p.Wo, wo = rem - ho * p.Wo;
            const int h0 = ho * p.sh - p.pad_top, w0 = wo * p.sw - p.pad_left;
            rows[t] = make_int2((img * p.H + h0) * p.W + w0,
                                static_cast<int>((static_cast<unsigned>(h0) << 16) | (w0 & 0xFFFF)));
          } else {
            rows[t] = make_int2(0, static_cast<int>(0x80000000u));
          }
        }
        named_barrier(4, kProducerThreads);
#pragma unroll
        for (int q = 0; q < BM / 16; ++q) {
          const int2 row = rows[r0 + 16 * q];
          origin[q] = row.x;
          hw[q] = row.y;
        }
      }
      for (int kb = kb0; kb < kb1; ++kb, ++g) {
        const int slot = g % S;
        mbar_wait(empty_bar + 8 * slot, ((g / S) & 1) ^ 1);
        const uint32_t a = base + slot * Tl::kStageBytes;
        const uint32_t b = a + Tl::kABytes;
        if (t == 0) {  // B's panel, with the stage's expected bytes
          mbar_expect_tx(full_bar + 8 * slot, Tl::kBBytes);
          tma_load(b, &p.b_map, full_bar + 8 * slot, kb * kBK, n0);
        }
        const int k0 = kb * kBK + chunk * kChunk;
        if (k0 < p.K) {
          const int tap = k0 / p.Cp;
          const int c0 = k0 - tap * p.Cp;
          const int i = tap / p.kw, j = tap - i * p.kw;
#pragma unroll
          for (int q = 0; q < BM / 16; ++q) {
            const int h = (hw[q] >> 16) + i;
            const int w = static_cast<int>(static_cast<int16_t>(hw[q] & 0xFFFF)) + j;
            const bool in = static_cast<unsigned>(h) < static_cast<unsigned>(p.H) &&
                            static_cast<unsigned>(w) < static_cast<unsigned>(p.W);
            const int8_t* src =
                in ? p.codes + static_cast<int64_t>(origin[q] + i * p.W + j) * p.Cp + c0 : p.codes;
            cp_async16(a + (r0 + 16 * q) * kBK + swizzle, src, in ? 16 : 0);
          }
        }  // past K, B's codes are zero: whatever A's stage holds there adds nothing
        asm volatile("cp.async.commit_group;" ::: "memory");
        if (g >= kLag) {
          // stage g - kLag's copies have landed: visible to the tensor cores
          asm volatile("cp.async.wait_group %0;" ::"n"(kLag) : "memory");
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          mbar_arrive(full_bar + 8 * ((g - kLag) % S));
        }
      }
    }
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    for (int h = g - kLag > 0 ? g - kLag : 0; h < g; ++h) mbar_arrive(full_bar + 8 * (h % S));
    return;
  }

  // the consumer warpgroups: wg owns rows [64 wg, 64 wg + 64) of each tile
  if constexpr (Tl::kConsumers == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int wg = threadIdx.x >> 7;
  const int t = threadIdx.x & 127, lane = t & 31, warp = t >> 5;
  unsigned char* staging = smem + Tl::kStagingOffset + wg * 64 * Tl::kStageCols * 2;
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;  // each unit's first product overwrites it

  // the epilogue of a unit: acc[4 j + 2 h + c] is row 16 warp + lane / 4 +
  // 8 h, column 8 j + 2 (lane % 4) + c of the warpgroup's 64 x BN tile
  auto epilogue = [&](int m0, int n0) {
    const int row0 = warp * 16 + (lane >> 2);
    if (p.tma_y) {
      // through the staging tile, kStageCols columns a pass in 64 x 64
      // panels of 128-byte rows, 16-byte chunk c of row r at chunk c ^ (r %
      // 8) (TMA's 128-byte swizzle; no bank conflict for the pairs written
      // from the accumulators), then one TMA store a panel (rows past M and
      // columns past Cout clipped), which runs on while the next unit's
      // products start
      constexpr int kCols = Tl::kStageCols;
#pragma unroll
      for (int pass = 0; pass < BN / kCols; ++pass) {
        // the last stores have read the staging tile
        if (t == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
        named_barrier(2 + wg, 128);
#pragma unroll
        for (int j = 0; j < kCols / 8; ++j) {
          const int jj = pass * (kCols / 8) + j;
          const int col = n0 + 8 * jj + 2 * (lane & 3);
          const float s0 = p.scale[col], s1 = p.scale[col + 1];  // scale is Npad long
          const float b0 = p.bias ? p.bias[col] : 0.0f, b1 = p.bias ? p.bias[col + 1] : 0.0f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = row0 + 8 * h;
            *reinterpret_cast<__nv_bfloat162*>(staging + (j >> 3) * 8192 + r * 128 +
                                               (((j & 7) ^ (r & 7)) << 4) + 4 * (lane & 3)) =
                __floats2bfloat162_rn(rescale(acc[4 * jj + 2 * h], s0, b0, p.bias),
                                      rescale(acc[4 * jj + 2 * h + 1], s1, b1, p.bias));
          }
        }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // visible to the TMA unit
        named_barrier(2 + wg, 128);
        if (t == 0) {
#pragma unroll
          for (int panel = 0; panel < kCols / 64; ++panel)
            tma_store(&p.y_map, smem_addr(staging) + panel * 8192, n0 + pass * kCols + 64 * panel,
                      m0);
          asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        }
      }
      return;
    }
    const bool pairs = (p.Cout & 1) == 0;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane & 3);
      if (col >= p.Cout) continue;
      const float s0 = p.scale[col], s1 = p.scale[col + 1];
      const float b0 = p.bias ? p.bias[col] : 0.0f, b1 = p.bias ? p.bias[col + 1] : 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + row0 + 8 * h;
        if (m >= p.M) continue;
        const int64_t at = static_cast<int64_t>(m) * p.Cout + col;
        const float v0 = rescale(acc[4 * j + 2 * h], s0, b0, p.bias);
        const float v1 = rescale(acc[4 * j + 2 * h + 1], s1, b1, p.bias);
        const bool second = col + 1 < p.Cout;
        if (p.y_fp32) {
          float* y = static_cast<float*>(p.y) + at;
          if (pairs) {
            *reinterpret_cast<float2*>(y) = make_float2(v0, v1);
          } else {
            y[0] = v0;
            if (second) y[1] = v1;
          }
        } else {
          __nv_bfloat16* y = static_cast<__nv_bfloat16*>(p.y) + at;
          if (pairs) {
            *reinterpret_cast<__nv_bfloat162*>(y) = __floats2bfloat162_rn(v0, v1);
          } else {
            y[0] = __float2bfloat16_rn(v0);
            if (second) y[1] = __float2bfloat16_rn(v1);
          }
        }
      }
    }
  };

  int g = 0;
  for (int u = block; u < units; u += grid) {
    const int tile = u / p.splits, split = u - tile * p.splits;
    const int mt = tile / n_tiles, n0 = (tile - mt * n_tiles) * BN;
    const int kb0 = split * nk / p.splits, kb1 = (split + 1) * nk / p.splits;
    int prev = -1;
    for (int kb = kb0; kb < kb1; ++kb, ++g) {
      const int slot = g % S;
      mbar_wait(full_bar + 8 * slot, (g / S) & 1);
      const uint32_t a = base + slot * Tl::kStageBytes + wg * 64 * kBK;
      const uint32_t b = base + slot * Tl::kStageBytes + Tl::kABytes;
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk)
        WgmmaS8<BN>::mma(acc, smem_desc(a + kk * 32), smem_desc(b + kk * 32), kk > 0 || kb > kb0);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      if (prev >= 0) {  // the previous stage's products are done: release it
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
        fence_registers(acc);
        if (lane == 0) mbar_arrive(empty_bar + 8 * prev);
      }
      prev = slot;
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_registers(acc);
    if (lane == 0) mbar_arrive(empty_bar + 8 * prev);

    if (p.splits > 1) {
      // this unit's partial sums, thread t's acc[i] at [i][t] of its
      // warpgroup's slice (coalesced, and read back in the same layout)
      const int64_t slice = static_cast<int64_t>(BN / 2) * 128;
      int* mine = p.partials + (static_cast<int64_t>(u) * Tl::kConsumers + wg) * slice + t;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) mine[i * 128] = acc[i];
      __threadfence();
      named_barrier(1, kConsumerThreads);
      if (threadIdx.x == 0) {
        const bool last = atomicAdd(p.counters + 2 + tile, 1u) == static_cast<unsigned>(p.splits - 1);
        if (last) p.counters[2 + tile] = 0;  // every split has arrived: ready for the next call
        *last_flag = last;
      }
      named_barrier(1, kConsumerThreads);
      if (!*last_flag) continue;
      __threadfence();
      for (int other = 0; other < p.splits; ++other) {
        if (other == split) continue;
        const int* theirs = mine + static_cast<int64_t>(other - split) * Tl::kConsumers * slice;
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] += __ldcg(theirs + i * 128);
      }
    }
    epilogue(mt * BM + wg * 64, n0);
  }
  // the block's shared memory stays until its last stores have read it
  if (t == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

constexpr int kMaxDevices = 64;

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major [rows, inner] matrix of 1-byte (int8) or 2-byte (bf16)
// elements in boxes of box_rows x box_inner, 128-byte swizzle; loads past
// the edges fill zeros, stores past them are clipped.
bool tensor_map(CUtensorMap* map, const void* ptr, int elem_bytes, uint64_t inner, uint64_t rows,
                uint32_t box_inner, uint32_t box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {inner, rows};
  const cuuint64_t strides[1] = {inner * elem_bytes};
  const cuuint32_t box[2] = {box_inner, box_rows};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                2, const_cast<void*>(ptr), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int BM, int BN>
int launch(const Params& p, int units, cudaStream_t stream) {
  using Tl = Tile<BM, BN>;
  auto kernel = int8_conv_wgmma<BM, BN>;
  // persistent: as many blocks as fit on the SMs at once (this variant's
  // slots on the device, found at its first launch there); a cooperative
  // launch, so that all of them are resident for phase 1's barrier
  static int slots[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (slots[device] == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Tl::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (Tl::kConsumers == 2) {
      // setmaxnreg shares out the block's registers: the kernel must start
      // with at least what the producer and the consumers then hold
      cudaFuncAttributes attr;
      err = cudaFuncGetAttributes(&attr, kernel);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (attr.numRegs * Tl::kThreads < kProducerRegs * 128 + kConsumerRegs * 256)
        return static_cast<int>(cudaErrorInvalidDeviceFunction);
    }
    int per_sm = 0, sms = 0, cooperative = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, Tl::kThreads,
                                                        Tl::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&cooperative, cudaDevAttrCooperativeLaunch, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (!cooperative || per_sm < 1) return static_cast<int>(cudaErrorNotSupported);
    slots[device] = sms * per_sm;
  }
  const int grid = units < slots[device] ? units : slots[device];
  Params args = p;
  void* argv[] = {&args};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                    dim3(Tl::kThreads), argv, Tl::kSmemBytes, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: [batch, H, W, C] (NHWC) bf16 (x_fp32 = 1: fp32); w: [Npad, Kp] int8
// with K = kh * kw * Cp, Cp = C rounded up to 16 (wide: K = kh * Cp, Cp =
// kw * C rounded up to 16), Kp = K rounded up to 128 and Npad = Cout rounded
// up to bn; scale: [Npad] fp32; x_scale: one fp32; bias: [Npad] fp32 or
// null; y: [batch, Ho, Wo, Cout] bf16 (y_fp32 = 1: fp32).  codes: the
// codes' bytes (batch * H * W * Cp, wide: batch * H * Wo * Cp), 16-byte
// aligned; partials: ceil(M / bm) * (Npad / bn) * splits * bm * bn int32
// (splits > 1; else null); counters: 2 + ceil(M / bm) * (Npad / bn) uint32,
// zero before a site's first call (each call leaves its counts so).
// geometry: {x_fp32, y_fp32, batch, H, W, C, Cp, Ho, Wo, Cout, Npad, Kp, kh,
// kw, sh, sw, pad_top, pad_left, wide, bm, bn, splits}, the tile plan bm 64
// or 128, bn 64, 128 or 256, splits of K in [1, Kp / 128].  vec: C % 8 ==
// 0, x 16-byte aligned and not wide (phase 1 loads 8 channels at a time).
// A dense layer is batch = M, H = W = Ho = Wo = kh = kw = 1, C its inputs.
int pf_int8_conv(const void* x, const int8_t* w, const float* scale, const float* x_scale,
                 const float* bias, void* y, int8_t* codes, int* partials, unsigned* counters,
                 const int* geometry, int vec, void* stream) {
  const int x_fp32 = geometry[0], y_fp32 = geometry[1], batch = geometry[2], H = geometry[3],
            W = geometry[4], C = geometry[5], Cp = geometry[6], Ho = geometry[7],
            Wo = geometry[8], Cout = geometry[9], Npad = geometry[10], Kp = geometry[11],
            kh = geometry[12], kw = geometry[13], sh = geometry[14], sw = geometry[15],
            pad_top = geometry[16], pad_left = geometry[17], wide = geometry[18],
            bm = geometry[19], bn = geometry[20], splits = geometry[21];
  // phase 2's grid and taps: in the wide layout a window row's taps are
  // channels of the codes; a strided 1x1 conv (sub) runs at stride 1 over
  // the pixels it reads
  const int sub = kh == 1 && kw == 1 && (sh > 1 || sw > 1);
  const int H2 = sub ? Ho : H, W2 = wide || sub ? Wo : W, kw2 = wide ? 1 : kw;
  const int sh2 = sub ? 1 : sh, sw2 = wide || sub ? 1 : sw, pl2 = wide ? 0 : pad_left;
  const int64_t channels = static_cast<int64_t>(wide ? kw : 1) * C;
  const int64_t M = static_cast<int64_t>(batch) * Ho * Wo;
  const int64_t pixels = static_cast<int64_t>(batch) * H2 * W2;
  const int64_t K = static_cast<int64_t>(kh) * kw2 * Cp;
  const bool plan_ok = (bm == 64 || bm == 128) && (bn == 64 || bn == 128 || bn == 256);
  if (!plan_ok || M < 1 || M > INT32_MAX / 2 || pixels * Cp > INT32_MAX / 2 || Cp % kChunk ||
      Cp < channels || Cp - channels >= kChunk || C < 1 || K > INT32_MAX / 2 || Kp % kBK ||
      Kp < K || Kp - K >= kBK || Cout < 1 || Npad % bn || Npad < Cout || sh < 1 || sw < 1 ||
      kw < 1 || H > 16384 || W > 16384 || pad_top > 16384 || pad_left > 16384 ||
      (vec && (C % 8 || wide)) || (sub && (pad_top || pad_left)) || splits < 1 ||
      splits > Kp / kBK ||
      (splits > 1 && partials == nullptr) || codes == nullptr || counters == nullptr ||
      reinterpret_cast<uintptr_t>(codes) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t units = ((M + bm - 1) / bm) * ((Cout + bn - 1) / bn) * splits;
  if (units > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  memset(&p, 0, sizeof(p));
  p.x = x;
  p.w = w;
  p.scale = scale;
  p.x_scale = x_scale;
  p.bias = bias;
  p.y = y;
  p.codes = codes;
  p.partials = partials;
  p.counters = counters;
  p.pixels = static_cast<int>(pixels);
  p.H = H2;
  p.W = W2;
  p.C = C;
  p.Cp = Cp;
  p.Ho = Ho;
  p.Wo = Wo;
  p.M = static_cast<int>(M);
  p.Cout = Cout;
  p.Kp = Kp;
  p.K = static_cast<int>(K);
  p.kw = kw2;
  p.sh = sh2;
  p.sw = sw2;
  p.pad_top = pad_top;
  p.pad_left = pl2;
  p.splits = splits;
  p.wide = wide;
  p.sub = sub;
  p.xH = H;
  p.xsh = sh;
  p.xW = W;
  p.xkw = kw;
  p.xsw = sw;
  p.xpl = pad_left;
  p.x_fp32 = x_fp32;
  p.y_fp32 = y_fp32;
  p.vec = vec;
  p.tma_y = !y_fp32 && Cout % 8 == 0;
  // A's rows are the codes' rows where phase 2 is a 1x1 product at stride 1
  p.tma_a = kh == 1 && kw2 == 1 && sh2 == 1 && sw2 == 1 && pad_top == 0 && pl2 == 0;
  if ((p.tma_y && (reinterpret_cast<uintptr_t>(y) % 16 ||
                   !tensor_map(&p.y_map, y, 2, Cout, M, 64, 64))) ||
      reinterpret_cast<uintptr_t>(w) % 16 || !tensor_map(&p.b_map, w, 1, Kp, Npad, kBK, bn) ||
      (p.tma_a && !tensor_map(&p.a_map, codes, 1, Cp, pixels, kBK, bm)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int u = static_cast<int>(units);
  if (bm == 128) {
    return bn == 64 ? launch<128, 64>(p, u, st) : bn == 128 ? launch<128, 128>(p, u, st)
                                                            : launch<128, 256>(p, u, st);
  }
  return bn == 64 ? launch<64, 64>(p, u, st) : bn == 128 ? launch<64, 128>(p, u, st)
                                                         : launch<64, 256>(p, u, st);
}

}  // extern "C"
