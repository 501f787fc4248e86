// The int8 serving contraction of one conv or dense site for Hopper (sm_90a).
//
//   y[m, n] = out(float(sum_k xq[m, k] * w[n, k]) * scale[n] (+ bias[n]))
//   xq      = clamp(rint(x / x_scale), -127, 127)        (int8, in registers)
//
// x is the layer's input, NHWC (a channels-last NCHW tensor, or [M, K] for a
// dense layer) in bf16 or fp32; xq[m, k] is the im2col row of output position
// m, with k = (i * kw + j) * C + c in the order of the HWIO kernel, code 0
// where the window falls on the padding.  w is the packed [Npad, Kp] int8
// codes (K-major: row n holds output channel n's kh * kw * C codes, zero past
// K and past Cout), scale[n] = x_scale * w_scale[n] in fp32 (zero past Cout),
// x_scale one fp32 value on the device, bias (optional) [Npad] fp32 (zero
// past Cout), y [M, Cout] (NHWC) in bf16 or fp32.
//
// It replaces no Pallas kernel.  The JAX package's int8 serving
// (pocketflow_tpu/ops/int8_ops.py:37, int8_contract) is XLA's native int8
// convolution with preferred_element_type=int32, into which XLA fuses the
// quantize before and the rescale and cast after.  The port ran the same
// formula as separate eager passes around cuBLASLt's int8 GEMM (an fp32
// quantize in five passes, an int8 im2col copy, the GEMM, an fp32 rescale and
// a cast), which made int8 serving three times slower than bf16 on an H100;
// this kernel does the whole site in one launch.  Its plain version,
// ops/int8_ops.py:int8_conv_plain, is that formula; the two give the same bits:
// the codes are those of the IEEE division (PyTorch divides by a tensor so;
// quantize_rows() below gets them from a multiply and, where that could
// round otherwise, __fdiv_rn), rint rounds half to even as torch.round, the
// int32 sums are exact, and the rescale is one __fmul_rn of
// __int2float_rn(acc) by the precomputed scale, then one __fadd_rn of the
// layer's bias where it has one (its fp32 bias add), rounded once to the
// output type (__float2bfloat16_rn).
//
// What bounds it on the card.  A site moves its input in its dtype (read
// once), the codes and its output (written once); it does 2 * M * Cout * K
// int8 operations, against the H100's 1,979 TOP/s int8 and 3.35 TB/s: most
// sites of ResNet-50 and MobileNet-v1 at batch 64 are bound by bytes.  Inside
// the kernel the quantize is the cost that neither bound counts: it runs on
// the ALUs, once for each element of the im2col rows (nine times a pixel for
// a 3x3 conv) and once more for each column tile of the output.  A stage's
// quantize (8,192 elements at a 64 x 128 tile) takes several times its int8
// products, so the kernel is built around keeping the ALUs busy on it: the
// copies run ahead asynchronously, three blocks share an SM so that one
// quantizes while the others wait on their products or write their output,
// and an element costs a multiply by 1/x_scale, a rounding and two compares,
// not a division (quantize_rows(), below).
//
// Design:
//   * 64 x BN output tiles, BN = 64 (Cout <= 64) or 128, the column tile
//     fastest, so that the tiles of one row tile run side by side and x is
//     read from memory about once; a persistent grid of blocks of one
//     warpgroup (128 threads), as many as fit on the SMs at once (three an
//     SM for bf16 inputs), walks them, a block's tiles' k-blocks one
//     pipeline, so that the next tile's first copies run during a tile's
//     last products and its epilogue;
//   * the implicit GEMM's A tile is 64 rows x 128 k a stage (a thread
//     computes its rows' window origins once a tile).  Where C % 8 == 0 and
//     x is 16-byte aligned, a thread owns 8 consecutive k (one tap's 8
//     channels, 16 bytes of bf16) of 8 rows, and cp.async copies them into
//     one of two raw stages in shared memory, a stage ahead; positions on
//     the padding, rows past M and k past K are copied as zeros (cp.async's
//     zero fill), which quantize to code 0.  Elsewhere (the stems' 3
//     channels, odd shrunk widths) the quantize reads its 8 elements one by
//     one from x;
//   * every thread quantizes its chunks of a stage into int8 A (128-byte
//     rows, 128-byte swizzle: 16-byte chunk c of row r at c ^ (r % 8)), one
//     stage, while the next stage's copies run;
//   * B (the BN x 128 panel of w) is copied with cp.async into one of two
//     stages in the same layout;
//   * wgmma m64nBNk32 s32.s8.s8 with A and B K-major from shared memory,
//     int32 accumulators in registers, waited for before the next stage's
//     quantize rewrites A (the products are a small share of the time); the
//     last stage issues only the 32-deep steps below Kp;
//   * the epilogue converts and scales the accumulators and adds the bias;
//     a bf16 output with
//     Cout % 8 == 0 goes through shared memory (the raw stage just read)
//     and leaves in whole 16-byte chunks a row, other outputs go straight
//     to y (rows < M, columns < Cout), two columns at a time where Cout is
//     even;
//   * the dynamic shared memory size and the grid (the blocks that fit on
//     the SMs at once) are set up at a variant's first launch on a device,
//     so that a launch makes no other call of the runtime.
//
// Plain C interface for ctypes; the entry point returns cudaGetLastError()
// (or cudaErrorInvalidValue for arguments out of range).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;        // output rows a tile: one warpgroup's wgmma
constexpr int kBK = 128;       // k a stage: one 128-byte row of codes
constexpr int kThreads = 128;
constexpr int kChunks = kBK / 8;                           // 8-k chunks of a row
constexpr int kRowsAThread = kBM * kChunks / kThreads;     // 8
constexpr int kRowStep = kThreads / kChunks;               // 8
constexpr int kSmemAlign = 1024;  // a 128-byte swizzle repeats every 8 rows of 128 bytes

template <int BN, typename T, bool kVec> struct Tile {
  static constexpr int kRawStages = 2;  // the input, a stage ahead
  static constexpr int kBStages = 2;
  static constexpr int kABytes = kBM * kBK;                           // int8 codes, one stage
  static constexpr int kBBytes = BN * kBK;
  static constexpr int kRawBytes = kVec ? kBM * kBK * sizeof(T) : 0;  // the input, raw
  static constexpr int kBOffset = kABytes;
  static constexpr int kRawOffset = kBOffset + kBStages * kBBytes;
  static constexpr int kSmemBytes = kRawOffset + kRawStages * kRawBytes + kSmemAlign;
  static_assert(kSmemBytes <= 232448, "shared memory of one block");
};

struct Params {
  const void* x;
  const int8_t* w;
  const float* scale;
  const float* x_scale;
  const float* bias;  // or nullptr
  void* y;
  int M, H, W, C, Ho, Wo, Cout, Kp, K, kw, sh, sw, pad_top, pad_left;
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

// d (+)= a @ b for one m64nNk32 step of int8 codes, a and b K-major in
// shared memory, int32 accumulators d[0..N/2) in the layout of the f32 ones;
// scale_d = 0 starts a new sum (a tile's first step), so that no other
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

#undef PF_ACC8
#undef PF_ACC32
#undef PF_D32
#undef PF_D64

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

// The value of element e of a chunk's raw bits: 8 bf16 in 4 words, or 8 fp32.
template <typename T> struct Raw;
template <> struct Raw<__nv_bfloat16> {
  static constexpr int kWords = 4;
  __device__ __forceinline__ static float load(const void* p) {
    return __uint_as_float(static_cast<uint32_t>(*static_cast<const unsigned short*>(p)) << 16);
  }
  __device__ __forceinline__ static float value(const uint32_t (&r)[kWords], int e) {
    const uint32_t word = r[e >> 1];
    return __uint_as_float((e & 1) ? (word & 0xFFFF0000u) : (word << 16));
  }
  __device__ __forceinline__ static void put(uint32_t (&r)[kWords], int e, const void* p) {
    const uint32_t bits = *static_cast<const unsigned short*>(p);
    r[e >> 1] |= (e & 1) ? bits << 16 : bits;
  }
};
template <> struct Raw<float> {
  static constexpr int kWords = 8;
  __device__ __forceinline__ static float load(const void* p) {
    return *static_cast<const float*>(p);
  }
  __device__ __forceinline__ static float value(const uint32_t (&r)[kWords], int e) {
    return __uint_as_float(r[e]);
  }
  __device__ __forceinline__ static void put(uint32_t (&r)[kWords], int e, const void* p) {
    r[e] = *static_cast<const uint32_t*>(p);
  }
};

// The code of a quotient t: clamp(rint(t), -127, 127) as a byte (the clamp
// before the rounding gives the same integer as after it).
__device__ __forceinline__ uint32_t code_of(float t) {
  return static_cast<uint32_t>(__float2int_rn(fminf(fmaxf(t, -127.0f), 127.0f))) & 0xFFu;
}

// The codes clamp(rint(v / s), -127, 127) of a thread's 8 x 8 values, as the
// IEEE division rounds them, 8 to a uint2 (low byte first), from r = 1 / s
// rounded.  t = v * r is within 3 units of 2^-24 of v / s relative to it (one
// rounding in r, one in the product), and the rounded quotient within one
// unit: below |t| = 128 the two lie within 2^-14 / 2.67 of each other.  So
// where t lies farther than 2^-14 from every half-integer, both round to the
// same integer, and where |t| >= 127 both clamp to +-127.  The rest (bf16
// activations repeat their values: about one in 3,000 of a normal batch, in
// about half of a warp's stages) come back as bit 8 q + e of the mask, for
// the caller to redo with the division.  The common path is a multiply, a
// rounding and two compares an element, all 64 independent.
constexpr float kNearHalf = 0.5f - 1.0f / 16384.0f;

__device__ __forceinline__ uint64_t quantize_rows(const float (&v)[kRowsAThread][8], float r,
                                                  uint2 (&out)[kRowsAThread]) {
  uint64_t near_half = 0;
#pragma unroll
  for (int q = 0; q < kRowsAThread; ++q) {
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float t = __fmul_rn(v[q][e], r);
      if (fabsf(t - rintf(t)) >= kNearHalf && fabsf(t) < 127.0f)
        near_half |= static_cast<uint64_t>(1) << (8 * q + e);
      w[e >> 2] |= code_of(t) << (8 * (e & 3));
    }
    out[q] = make_uint2(w[0], w[1]);
  }
  return near_half;
}

// An accumulator rescaled as the plain route does: float(acc) * scale, then
// + bias in fp32 where the layer has one, and nothing where it has none (a
// product that underflows to -0.0 stays -0.0).
__device__ __forceinline__ float rescale(int acc, float scale, float bias, const float* has_bias) {
  const float v = __fmul_rn(__int2float_rn(acc), scale);
  return has_bias ? __fadd_rn(v, bias) : v;
}

template <typename OutT> struct Out;
template <> struct Out<__nv_bfloat16> {
  __device__ __forceinline__ static void one(void* y, int64_t at, float v) {
    static_cast<__nv_bfloat16*>(y)[at] = __float2bfloat16_rn(v);
  }
  __device__ __forceinline__ static void two(void* y, int64_t at, float v0, float v1) {
    reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(y) + at)[0] =
        __floats2bfloat162_rn(v0, v1);
  }
};
template <> struct Out<float> {
  __device__ __forceinline__ static void one(void* y, int64_t at, float v) {
    static_cast<float*>(y)[at] = v;
  }
  __device__ __forceinline__ static void two(void* y, int64_t at, float v0, float v1) {
    reinterpret_cast<float2*>(static_cast<float*>(y) + at)[0] = make_float2(v0, v1);
  }
};

template <int BN, typename T, bool kVec, typename OutT>
__global__ void __launch_bounds__(kThreads, 3)
int8_conv_wgmma(const Params p) {
  using Tl = Tile<BN, T, kVec>;
  using R = Raw<T>;
  constexpr int S = Tl::kRawStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + kSmemAlign - 1) & ~static_cast<uint32_t>(kSmemAlign - 1);
  unsigned char* smem = smem_raw + (base - raw);

  const int tid = threadIdx.x;
  const int n_tiles = (p.Cout + BN - 1) / BN;
  const int tiles = ((p.M + kBM - 1) / kBM) * n_tiles;
  const int nk = (p.Kp + kBK - 1) / kBK;
  // this block's tiles are blockIdx.x + i * gridDim.x; stage g is tile i's
  // k-block g % nk, i = g / nk, one pipeline over all of them
  const int block = static_cast<int>(blockIdx.x), grid = static_cast<int>(gridDim.x);
  const int my_tiles = block < tiles ? (tiles - 1 - block) / grid + 1 : 0;
  const int stages = my_tiles * nk;
  const T* __restrict__ x = static_cast<const T*>(p.x);
  const float s = *p.x_scale;
  const float r = __frcp_rn(s);

  // this thread's chunk of 8 k and its rows r0 + 16 q
  const int chunk = tid % kChunks;
  const int r0 = tid / kChunks;

  auto tile_of = [&](int g) { return block + (g / nk) * grid; };

  // the image offset (n * H), window origin (h0, w0) and validity of this
  // thread's rows of the tile last looked up
  int rows_tile = -1;
  int4 rows[kRowsAThread];
  auto rows_of = [&](int tile) {
    if (tile == rows_tile) return;
    rows_tile = tile;
    const int hw = p.Ho * p.Wo;
#pragma unroll
    for (int q = 0; q < kRowsAThread; ++q) {
      const int m = (tile / n_tiles) * kBM + r0 + kRowStep * q;
      const int mm = m < p.M ? m : 0;
      const int img = mm / hw, rem = mm - img * hw;
      const int ho = rem / p.Wo, wo = rem - ho * p.Wo;
      rows[q] = make_int4(img * p.H, ho * p.sh - p.pad_top, wo * p.sw - p.pad_left, m < p.M);
    }
  };

  // the copies of stage g: the raw input chunks (kVec) and B's panel
  // (16-byte chunks below Kp: the wgmma steps past Kp are not issued)
  auto issue = [&](int g) {
    const int tile = tile_of(g), kb = g % nk;
    if constexpr (kVec) {
      rows_of(tile);
      const int k0 = kb * kBK + chunk * 8;
      const int tap = k0 / p.C;
      const int c0 = k0 - tap * p.C;
      const int i0 = tap / p.kw, j0 = tap - i0 * p.kw;
      const uint32_t dst = base + Tl::kRawOffset + (g % S) * Tl::kRawBytes +
                           chunk * 8 * static_cast<int>(sizeof(T));
#pragma unroll
      for (int q = 0; q < kRowsAThread; ++q) {
        const int h = rows[q].y + i0, w = rows[q].z + j0;
        const bool in = rows[q].w && k0 < p.K && h >= 0 && h < p.H && w >= 0 && w < p.W;
        const T* src = in ? x + ((static_cast<int64_t>(rows[q].x + h) * p.W + w) * p.C + c0) : x;
#pragma unroll
        for (int v = 0; v < static_cast<int>(sizeof(T)) / 2; ++v)
          cp_async16(dst + (r0 + kRowStep * q) * kBK * static_cast<int>(sizeof(T)) + 16 * v,
                     src + v * (16 / static_cast<int>(sizeof(T))), in ? 16 : 0);
      }
    }
    const int n0 = (tile % n_tiles) * BN;
    const uint32_t b = base + Tl::kBOffset + (g % Tl::kBStages) * Tl::kBBytes;
    for (int u = tid; u < BN * (kBK / 16); u += kThreads) {
      const int n = u / (kBK / 16), c = u % (kBK / 16);
      const int kbyte = kb * kBK + c * 16;
      if (kbyte < p.Kp)
        cp_async16(b + n * kBK + ((c ^ (n & 7)) << 4),
                   p.w + static_cast<int64_t>(n0 + n) * p.Kp + kbyte);
    }
  };

  // quantize stage g into A's stage g % 2: 8 codes (8 bytes) a chunk, at
  // half `chunk % 2` of 16-byte chunk (chunk / 2) ^ (row % 8) of the row
  // quantize stage g into A: 8 codes (8 bytes) a chunk, at half `chunk % 2`
  // of 16-byte chunk (chunk / 2) ^ (row % 8) of the row
  auto quantize_stage = [&](int g) {
    unsigned char* a = smem;
    const unsigned char* in = smem + Tl::kRawOffset + (g % S) * Tl::kRawBytes;
    const int k0 = (g % nk) * kBK + chunk * 8;
    int c0 = 0, i0 = 0, j0 = 0;
    if constexpr (!kVec) {
      rows_of(tile_of(g));
      const int tap = k0 / p.C;
      c0 = k0 - tap * p.C;
      i0 = tap / p.kw;
      j0 = tap - i0 * p.kw;
    }
    float v[kRowsAThread][8];
#pragma unroll
    for (int q = 0; q < kRowsAThread; ++q) {
      const int row_index = r0 + kRowStep * q;
      uint32_t bits[R::kWords];
      if constexpr (kVec) {
        // the chunk's raw bits, as the copy left them
#pragma unroll
        for (int u = 0; u < R::kWords / 4; ++u) {
          const uint4 b4 = *reinterpret_cast<const uint4*>(
              in + row_index * kBK * static_cast<int>(sizeof(T)) +
              chunk * 8 * static_cast<int>(sizeof(T)) + 16 * u);
          bits[4 * u] = b4.x;
          bits[4 * u + 1] = b4.y;
          bits[4 * u + 2] = b4.z;
          bits[4 * u + 3] = b4.w;
        }
      } else {
        // element by element from x (C % 8 != 0 or x not 16-byte aligned)
#pragma unroll
        for (int u = 0; u < R::kWords; ++u) bits[u] = 0u;
        if (rows[q].w) {
          int c = c0, i = i0, j = j0;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int h = rows[q].y + i, w = rows[q].z + j;
            if (k0 + e < p.K && h >= 0 && h < p.H && w >= 0 && w < p.W)
              R::put(bits, e, x + ((static_cast<int64_t>(rows[q].x + h) * p.W + w) * p.C + c));
            if (++c == p.C) {
              c = 0;
              if (++j == p.kw) {
                j = 0;
                ++i;
              }
            }
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) v[q][e] = R::value(bits, e);
    }
    uint2 codes[kRowsAThread];
    uint64_t near_half = quantize_rows(v, r, codes);
    // the values near a half-integer, read again and divided (the 64 floats
    // are dead by now: only their positions are kept)
    while (near_half != 0) {
      const int i = __ffsll(static_cast<long long>(near_half)) - 1;
      near_half &= near_half - 1;
      const int q = i >> 3, e = i & 7;
      float value;
      if constexpr (kVec) {
        value = R::load(in + (r0 + kRowStep * q) * kBK * static_cast<int>(sizeof(T)) +
                        (chunk * 8 + e) * static_cast<int>(sizeof(T)));
      } else {
        // element e of the chunk: k0 + e, from (i0, j0, c0) on; it lies
        // inside the input (a padded position is 0, never near a half)
        int c = c0 + e, ii = i0, jj = j0;
        while (c >= p.C) {
          c -= p.C;
          if (++jj == p.kw) {
            jj = 0;
            ++ii;
          }
        }
        int4 row = rows[0];
#pragma unroll
        for (int u = 1; u < kRowsAThread; ++u)
          if (u == q) row = rows[u];
        value = R::load(x + ((static_cast<int64_t>(row.x + row.y + ii) * p.W + row.z + jj) * p.C + c));
      }
      const uint32_t shift = 8 * (e & 3), code = code_of(__fdiv_rn(value, s)) << shift;
#pragma unroll
      for (int u = 0; u < kRowsAThread; ++u) {
        if (u != q) continue;
        if (e & 4)
          codes[u].y = (codes[u].y & ~(0xFFu << shift)) | code;
        else
          codes[u].x = (codes[u].x & ~(0xFFu << shift)) | code;
      }
    }
#pragma unroll
    for (int q = 0; q < kRowsAThread; ++q) {
      const int row_index = r0 + kRowStep * q;
      *reinterpret_cast<uint2*>(a + row_index * kBK +
                                ((((chunk >> 1) ^ (row_index & 7)) << 4) | ((chunk & 1) << 3))) =
          codes[q];
    }
  };

  const int lane = tid & 31;
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;  // each tile's first product overwrites it

  // the epilogue of a tile: acc[4 j + 2 h + c] is row 16 warp + lane / 4 +
  // 8 h, column 8 j + 2 (lane % 4) + c.  A bf16 tile with Cout % 8 == 0
  // goes through shared memory (the raw stage `staging`, which stage g's
  // quantize has read and stage g + 2's copies have not begun to fill):
  // 16-byte chunk c of row r at chunk c ^ (r % 8), so that both the pairs
  // written from the accumulators and the chunks read back meet no bank
  // conflict, and each row leaves as whole 16-byte stores.  Otherwise the
  // pairs go straight to y.
  auto epilogue = [&](int tile, int staging) {
    const int n0 = (tile % n_tiles) * BN;
    const int m0 = (tile / n_tiles) * kBM;
    const int row0 = (tid >> 5) * 16 + (lane >> 2);
    constexpr bool kStaged = kVec && sizeof(T) == 2 && sizeof(OutT) == 2 &&
                             kBM * BN * 2 <= Tl::kRawBytes;
    if (kStaged && (p.Cout & 7) == 0) {
      unsigned char* tile_smem = smem + Tl::kRawOffset + staging * Tl::kRawBytes;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * (lane & 3);
        const float s0 = p.scale[col], s1 = p.scale[col + 1];  // scale is Npad long
        const float b0 = p.bias ? p.bias[col] : 0.0f, b1 = p.bias ? p.bias[col + 1] : 0.0f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + 8 * h;
          const __nv_bfloat162 pair =
              __floats2bfloat162_rn(rescale(acc[4 * j + 2 * h], s0, b0, p.bias),
                                    rescale(acc[4 * j + 2 * h + 1], s1, b1, p.bias));
          *reinterpret_cast<__nv_bfloat162*>(tile_smem + r * BN * 2 + ((j ^ (r & 7)) << 4) +
                                             4 * (lane & 3)) = pair;
        }
      }
      asm volatile("bar.sync 1, %0;" ::"n"(kThreads) : "memory");
      for (int u = tid; u < kBM * (BN / 8); u += kThreads) {
        const int r = u / (BN / 8), c = u % (BN / 8);
        if (m0 + r < p.M && n0 + 8 * c < p.Cout)
          *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p.y) +
                                    static_cast<int64_t>(m0 + r) * p.Cout + n0 + 8 * c) =
              *reinterpret_cast<const uint4*>(tile_smem + r * BN * 2 + ((c ^ (r & 7)) << 4));
      }
      return;
    }
    const bool pairs = (p.Cout & 1) == 0;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane & 3);
      if (col >= p.Cout) continue;
      const float s0 = p.scale[col], s1 = p.scale[col + 1];  // scale is Npad long
      const float b0 = p.bias ? p.bias[col] : 0.0f, b1 = p.bias ? p.bias[col + 1] : 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + row0 + 8 * h;
        if (m >= p.M) continue;
        const int64_t at = static_cast<int64_t>(m) * p.Cout + col;
        const float v0 = rescale(acc[4 * j + 2 * h], s0, b0, p.bias);
        const float v1 = rescale(acc[4 * j + 2 * h + 1], s1, b1, p.bias);
        if (pairs) {
          Out<OutT>::two(p.y, at, v0, v1);
        } else {
          Out<OutT>::one(p.y, at, v0);
          if (col + 1 < p.Cout) Out<OutT>::one(p.y, at + 1, v1);
        }
      }
    }
  };

  // stage 0's copies before the loop, one cp.async group a stage
  if (stages > 0) issue(0);
  asm volatile("cp.async.commit_group;" ::: "memory");
  for (int g = 0; g < stages; ++g) {
    const int kb = g % nk;
    // stage g - 1's products are done (A and its B stage are free again),
    // and this thread's copies of stage g have landed; past the barrier
    // every thread's have
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_registers(acc);
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();
    if (g + 1 < stages) issue(g + 1);  // into stage g - 1's raw and B stages
    asm volatile("cp.async.commit_group;" ::: "memory");
    quantize_stage(g);  // while stage g + 1's copies run
    // this stage's codes and B's copies, visible to the tensor cores' proxy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    const uint32_t a = base;
    const uint32_t b = base + Tl::kBOffset + (g % Tl::kBStages) * Tl::kBBytes;
    const int steps = min(kBK / 32, (p.Kp - kb * kBK) / 32);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk)
      if (kk < steps)
        WgmmaS8<BN>::mma(acc, smem_desc(a + kk * 32), smem_desc(b + kk * 32), kb > 0 || kk > 0);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    if (kb == nk - 1) {  // the tile's last stage: write it out, while the
                         // next tile's first stage is being copied
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_registers(acc);
      epilogue(tile_of(g), g % S);
    }
  }
}

constexpr int kMaxDevices = 64;

template <int BN, typename T, bool kVec, typename OutT>
int launch(const Params& p, cudaStream_t stream) {
  const int smem = Tile<BN, T, kVec>::kSmemBytes;
  const int64_t tiles = static_cast<int64_t>((p.M + kBM - 1) / kBM) * ((p.Cout + BN - 1) / BN);
  if (tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  // persistent: as many blocks as fit on the SMs at once (this variant's
  // slots on the device, found at its first launch there), each walking
  // its tiles
  static int slots[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (slots[device] == 0) {
    err = cudaFuncSetAttribute(int8_conv_wgmma<BN, T, kVec, OutT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, int8_conv_wgmma<BN, T, kVec, OutT>, kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    slots[device] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int grid = static_cast<int>(tiles < slots[device] ? tiles : slots[device]);
  int8_conv_wgmma<BN, T, kVec, OutT><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int BN, typename T>
int launch_t(const Params& p, bool vec, bool y_fp32, cudaStream_t stream) {
  if (vec) {
    return y_fp32 ? launch<BN, T, true, float>(p, stream)
                  : launch<BN, T, true, __nv_bfloat16>(p, stream);
  }
  return y_fp32 ? launch<BN, T, false, float>(p, stream)
                : launch<BN, T, false, __nv_bfloat16>(p, stream);
}

// The column tile of a site with `cout` output channels: the packed codes
// and the scale are padded to a multiple of it (ops/int8_ops.py:_padded_cout).
int tile_n(int cout) { return cout <= 64 ? 64 : 128; }

}  // namespace

extern "C" {

// x: [batch, H, W, C] (NHWC) bf16 (x_fp32 = 0) or fp32; w: [Npad, Kp] int8
// with Npad = Cout rounded up to tile_n(Cout) and Kp = K rounded up to 32,
// K = kh * kw * C; scale: [Npad] fp32; x_scale: one fp32; bias: [Npad] fp32
// or null; y: [batch, Ho, Wo, Cout] bf16 (y_fp32 = 0) or fp32.  vec: C % 8
// == 0 and x 16-byte aligned (one load an 8-channel chunk).  A dense layer
// is batch = M, H = W = Ho = Wo = kh = kw = 1, C = K.
int pf_int8_conv(const void* x, int x_fp32, const int8_t* w, const float* scale,
                 const float* x_scale, const float* bias, void* y, int y_fp32, int batch, int H,
                 int W, int C, int Ho, int Wo, int Cout, int Npad, int Kp, int kh, int kw, int sh,
                 int sw, int pad_top, int pad_left, int vec, void* stream) {
  const int64_t M = static_cast<int64_t>(batch) * Ho * Wo;
  const int64_t K = static_cast<int64_t>(kh) * kw * C;
  const int bn = tile_n(Cout);
  if (M < 1 || M > INT32_MAX / 2 || K < 1 || Kp % 32 || Kp < K || Kp - K >= 32 || Cout < 1 ||
      Npad % bn || Npad < Cout || sh < 1 || sw < 1 || kw < 1 ||
      static_cast<int64_t>(batch) * H > INT32_MAX / 2 || (vec && C % 8))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{x, w, scale, x_scale, bias, y, static_cast<int>(M), H, W, C, Ho, Wo, Cout, Kp,
           static_cast<int>(K), kw, sh, sw, pad_top, pad_left};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bn == 64) {
    return x_fp32 ? launch_t<64, float>(p, vec, y_fp32, st)
                  : launch_t<64, __nv_bfloat16>(p, vec, y_fp32, st);
  }
  return x_fp32 ? launch_t<128, float>(p, vec, y_fp32, st)
                : launch_t<128, __nv_bfloat16>(p, vec, y_fp32, st);
}

}  // extern "C"
