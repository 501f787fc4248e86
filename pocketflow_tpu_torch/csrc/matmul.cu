// Bf16 matrix product kernels for Hopper (sm_90a).
//
//   pf_matmul_bf16:          y = bf16(x @ w)                  (fp32 accumulate)
//   pf_bn_relu_matmul_stats: z = bf16(relu(f32(x) * scale + shift))
//                            y32 = z @ w (fp32),  y = bf16(y32)
//                            s = sum over rows of y32,  ss = sum over rows of y32^2
//
// x is row-major [M, K] bf16, w row-major [K, N] bf16, y row-major [M, N]
// bf16; scale and shift are [K] fp32, s and ss [N] fp32.
//
// pf_matmul_bf16 replaces the tiled Pallas matmul of
// experiments/conv1x1_ab.py:make_pallas and experiments/mm_shape_sweep.py:
// make_pallas (the same body: jnp.dot(..., preferred_element_type=f32)
// .astype(bf16)).  pf_bn_relu_matmul_stats replaces
// experiments/fused_mm_proto.py:pallas_fused (body fused_kernel): the 1x1-conv
// matmul with a BN scale/shift + ReLU prologue and a per-column sum/sum^2
// epilogue taken from the fp32 accumulator, as the TPU kernel takes them.
//
// What bounds them on the card.  A product of [M, K] and [K, N] does
// 2*M*K*N flops on (M*K + K*N + M*N)*2 bytes, so about K*N / (K + N) flops a
// byte: 51 at K=256, N=64, 205 at K=512, N=2048, against the H100's ~295 bf16
// flops a byte.  Six of the eight ResNet-50 1x1 shapes are bound by bytes
// (reading x once and writing y once at the memory's rate is the whole game
// there), the two stage-4 shapes by the tensor cores.  The fused kernel's
// shape (M=802,816, K=256, N=64) is one of the six: its prologue and sums add
// a few instructions an element and no bytes.  The TPU kernels streamed
// (TILE_M, K) blocks of x through VMEM against the whole of w.
//
// Both run on one kernel body, matmul_wgmma<BN, kStats> (the usual Hopper
// GEMM):
//   * TMA loads: one producer warp copies 128x64 tiles of x and 64x64 panels
//     of w into a ring of shared-memory stages (128-byte swizzle), each stage
//     with an mbarrier for its arrival (transaction bytes) and one for its
//     release.  Boxes past M or K fill zeros, so a ragged M or K needs no
//     masked loads; the descriptors are encoded on the host
//     (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, no -lcuda) and
//     passed as __grid_constant__ parameters.  Waits trap after ~10 s, so a
//     pipeline fault is a launch error, not a hung card.
//   * wgmma: two consumer warpgroups each own 64 rows of a 128-row tile and
//     run m64nBNk16 (bf16 in, fp32 accumulators in registers) on the stage;
//     w stays row-major [K, N], which is the MN-major ("transposed") B
//     operand wgmma reads from the swizzled panels, so no transpose pass.
//     The producer warpgroup gives its registers to the consumers
//     (setmaxnreg).
//   * A persistent grid, at most one block per SM, walking the output tiles
//     with the column tile fastest, so that the tiles of one row tile run at
//     the same time on neighbouring SMs and x is read from memory once while
//     w stays in the 50 MB L2.  The epilogue rounds the accumulators with
//     __float2bfloat16_rn into a swizzled tile in shared memory (no bank
//     conflicts) and stores it with TMA (rows past M and columns past N are
//     clipped), while the producer already loads the next tile's stages.
//
// The plain product (kStats false) takes A from shared memory too, and keeps
// one wgmma group in flight while the previous stage is released.  Tile by
// N: BN = 64, 128 or 256, the least that covers N up to 256, so at N <= 256
// one tile spans all of y's columns; wider N takes 128x256 tiles (128x128
// where those leave a last wave mostly idle).
//
// The fused product (kStats true) adds two things to the same body.
//   * The prologue in registers (the register-A form of wgmma).  z has to
//     sit between the shared-memory tile and the tensor cores.  Rewriting
//     the landed tile in shared memory would cost a store, a proxy fence and
//     a barrier of both warpgroups each stage; instead each warp loads its
//     16 rows of the stage with ldmatrix (conflict-free on the 128-byte
//     swizzle), applies z = bf16(relu(x * scale + shift)) to the fragments
//     with __fmul_rn and __fadd_rn (never an FMA, so z equals the plain
//     version's separate multiply and add), repacks them with
//     __floats2bfloat162_rn and issues wgmma with A from registers and w
//     from shared memory.  The fragment registers are rewritten each stage,
//     so a stage's products are waited for before the next stage's
//     ldmatrix; the other warpgroup keeps the tensor cores busy meanwhile.
//     scale and shift travel with the stage: a second warp of the producer
//     warpgroup writes the stage's 64 values of each into its shared memory
//     (zero past K; 512 bytes from L2 beside the stage's 24 KB or more of x
//     and w) and arrives on the stage's barrier with the TMA's bytes, laid
//     out so that a thread reads the four values of a 16-deep step in one
//     16-byte load.  So K is bounded by nothing but the int type, as in the
//     plain product.  Past K, x and w are zero (TMA fill) and z =
//     relu(0 * 0 + 0) = 0.  Past M, x is zero but z = relu(shift) is not,
//     so those rows' accumulators are not zero: the TMA store clips them and
//     the sums skip them.
//   * The statistics from the accumulators, before the bf16 rounding, in a
//     fixed order: each thread adds its two rows of a column (rows < M only),
//     then three warp shuffles halve the values a lane holds while summing
//     over the warp's 16 rows (fp32, as the TPU kernel sums a tile); each
//     lane adds its tile sums into double accumulators of its own, tile by
//     tile; at the end the block sums its 8 warps' in shared memory, in
//     order, into one row of partials.  Every tile a block walks has the same
//     column tile (the grid is a multiple of the column tiles), so a block's
//     accumulators cover BN columns.  A second, small launch sums each
//     column's partials over the blocks in double, a warp a column, in a
//     fixed order.  No float atomics: two runs give the same bits.  BN = 64
//     (N <= 64) or 128: at 256 the accumulators, the fragments and the
//     statistics would not fit the consumers' registers.
//
// Plain C interface for ctypes; every entry point returns cudaGetLastError()
// (or cudaErrorInvalidValue when a TMA descriptor cannot be made or an input
// is out of range).

#include <cuda.h>  // CUtensorMap and its enums (types only; nothing is linked from it)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMmBM = 128;        // rows of y a tile: two consumer warpgroups of 64
constexpr int kMmBK = 64;         // k a stage: one 128-byte swizzled row of bf16
constexpr int kPanel = 64;        // columns of one 128-byte swizzled panel
constexpr int kPanelRowBytes = 128;
constexpr int kMmThreads = 384;   // warpgroups 0 and 1 consume, 2 produces
constexpr int kConsumerThreads = 256;
constexpr int kConsumerWarps = 8;
constexpr int kSmemAlign = 1024;  // a 128-byte swizzle repeats every 8 rows of 128 bytes
constexpr int kMaxSmem = 232448;  // dynamic shared memory of one block
constexpr int kBnThreads = 32;    // kStats: the producer warp that writes scale and shift
constexpr long long kWaitTrapCycles = 1LL << 34;  // ~10 s at the H100's clocks

template <int BN, bool kStats> struct MmTile {
  static constexpr int kStages = BN == 256 ? 3 : BN == 128 ? 5 : 8;
  static constexpr int kABytes = kMmBM * kMmBK * 2;            // 16 KB of x
  static constexpr int kBBytes = kMmBK * BN * 2;               // BN/64 panels of w
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kCBytes = kMmBM * BN * 2;               // the bf16 y tile
  static constexpr int kWgCBytes = kCBytes / 2;                // a warpgroup's 64 rows
  static constexpr int kBarOffset = kStages * kStageBytes + kCBytes;
  static constexpr int kBnOffset = kBarOffset + 2 * kStages * 8;  // kStats: scale, shift a stage
  static constexpr int kBnFloats = 2 * kMmBK;
  static constexpr int kSmemBytes = kBnOffset + (kStats ? kStages * kBnFloats * 4 : 0) + kSmemAlign;
  static_assert(kSmemBytes <= kMaxSmem, "shared memory of one block");
  static_assert(!kStats || BN <= 128, "the fused kernel's registers");
  static_assert(!kStats || kStages * kStageBytes >= kConsumerWarps * 32 * (BN / 16) * 8,
                "the block's statistics are summed in the stages' memory");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.  A wait
// of more than about ten seconds traps: a pipeline fault becomes a launch
// error instead of a hung card.
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

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1)
               : "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// A shared-memory matrix descriptor of wgmma, 128-byte swizzle: start address,
// leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lead, uint32_t stride) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lead >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((stride >> 4) & 0x3FFF) << 32 | static_cast<uint64_t>(1) << 62;
}

// The operands of the wgmma instructions below: the accumulators d[0..N/2)
// as "+f" operands %0..%(N/2 - 1), then A, B and scale_d.
#define PF_ACC8(i)                                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
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

// d (+)= a @ b for one m64nNk16 step, b MN-major (w) from shared memory;
// scale_d = 0 starts a new sum.  mma: a K-major (x) from shared memory;
// mma_rs: a from registers, four 32-bit registers of two bf16 each in the
// layout of mma.m16n8k16's A fragment, warp q of the warpgroup holding rows
// [16 q, 16 q + 16).
template <int N> struct Wgmma;

template <> struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" PF_D32
        "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
        : PF_ACC32(0)
        : "l"(a), "l"(b), "r"(scale_d));
  }
  __device__ __forceinline__ static void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" PF_D32
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : PF_ACC32(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <> struct Wgmma<128> {
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" PF_D64
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : PF_ACC32(0), PF_ACC32(32)
        : "l"(a), "l"(b), "r"(scale_d));
  }
  __device__ __forceinline__ static void mma_rs(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" PF_D64
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : PF_ACC32(0), PF_ACC32(32)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <> struct Wgmma<256> {
  __device__ __forceinline__ static void mma(float (&d)[128], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" PF_D128
        "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
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
__device__ __forceinline__ void fence_registers(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_registers(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Four 8x8 bf16 matrices from shared memory: lanes 8i..8i+7 give the row
// addresses of matrix i, and register i gets this lane's two values of it.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// relu(x * scale + shift) in the plain version's order, each step rounded once
__device__ __forceinline__ float bn_relu(float x, float scale, float shift) {
  const float t = __fadd_rn(__fmul_rn(x, scale), shift);
  return t < 0.0f ? 0.0f : t;
}

// The prologue of two bf16 (the low one first) of an A fragment register.
__device__ __forceinline__ uint32_t bn_relu2(uint32_t v, float scale_lo, float scale_hi,
                                             float shift_lo, float shift_hi) {
  const __nv_bfloat162 z =
      __floats2bfloat162_rn(bn_relu(__uint_as_float(v << 16), scale_lo, shift_lo),
                            bn_relu(__uint_as_float(v & 0xFFFF0000u), scale_hi, shift_hi));
  uint32_t out;
  memcpy(&out, &z, 4);
  return out;
}

// Where k's scale and shift sit in shared memory: within each 16-deep step,
// thread t (lane % 4) of a warp needs k = 2t, 2t + 1, 2t + 8, 2t + 9 (its A
// fragment's columns), which go to slots 4t .. 4t + 3.
__device__ __forceinline__ int bn_slot(int k) {
  const int j = k & 15;
  return (k & ~15) | ((j & 7) >> 1) << 2 | (j >> 3) << 1 | (j & 1);
}

// v[0, 2H) -> v[0, H): each lane keeps the half that its lane bit `mask`
// selects, summed with the partner lane's same half.
template <int H, int R>
__device__ __forceinline__ void fold_half(float (&v)[R], int lane, int mask) {
  const bool upper = (lane & mask) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? v[i] : v[i + H];
    const float keep = upper ? v[i + H] : v[i];
    v[i] = __fadd_rn(keep, __shfl_xor_sync(0xFFFFFFFFu, send, mask));
  }
}

template <int BN, bool kStats>
__global__ void __launch_bounds__(kMmThreads, 1)
matmul_wgmma(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
             const __grid_constant__ CUtensorMap map_y, int M, int K, int N,
             const float* __restrict__ scale, const float* __restrict__ shift,
             double* __restrict__ partials) {
  using T = MmTile<BN, kStats>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + kSmemAlign - 1) & ~static_cast<uint32_t>(kSmemAlign - 1);
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t c_tile = base + T::kStages * T::kStageBytes;
  const uint32_t full_bar = base + T::kBarOffset;           // stage s: full_bar + 8 s
  const uint32_t empty_bar = full_bar + 8 * T::kStages;

  const int64_t n_tiles = (N + BN - 1) / BN;
  const int64_t tiles = ((M + kMmBM - 1) / kMmBM) * n_tiles;
  const int nk = (K + kMmBK - 1) / kMmBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(full_bar + 8 * s, kStats ? 1 + kBnThreads : 1);
      mbar_init(empty_bar + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producers: one thread keeps the ring full of x and w; with kStats the
    // next warp writes each stage's scale and shift
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    const bool loads = threadIdx.x == 256;
    if (loads || (kStats && threadIdx.x >= 288 && threadIdx.x < 288 + kBnThreads)) {
      int stage = 0;
      uint32_t phase = 0;
      for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = static_cast<int>(t / n_tiles) * kMmBM;
        const int n0 = static_cast<int>(t % n_tiles) * BN;
        for (int kb = 0; kb < nk; ++kb) {
          mbar_wait(empty_bar + 8 * stage, phase ^ 1);
          const uint32_t bar = full_bar + 8 * stage;
          if (loads) {
            const uint32_t a = base + stage * T::kStageBytes;
            mbar_expect_tx(bar, T::kStageBytes);
            tma_load(a, &map_x, bar, kb * kMmBK, m0);
#pragma unroll
            for (int p = 0; p < BN / kPanel; ++p)
              tma_load(a + T::kABytes + p * kMmBK * kPanelRowBytes, &map_w, bar, n0 + p * kPanel,
                       kb * kMmBK);
          } else if constexpr (kStats) {
            // k = kb * kMmBK + j goes to slot bn_slot(j) of the stage's
            // scale, then of its shift; zero past K
            float* bn = reinterpret_cast<float*>(smem + T::kBnOffset) + stage * T::kBnFloats;
            for (int j = threadIdx.x & 31; j < kMmBK; j += kBnThreads) {
              const int k = kb * kMmBK + j;
              bn[bn_slot(j)] = k < K ? scale[k] : 0.0f;
              bn[kMmBK + bn_slot(j)] = k < K ? shift[k] : 0.0f;
            }
            mbar_arrive(bar);
          }
          if (++stage == T::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int lane = threadIdx.x & 31;
    const int wq = (threadIdx.x & 127) >> 5;  // warp of the warpgroup: 16 rows each
    const bool leader = (threadIdx.x & 127) == 0;
    const uint32_t c_wg = c_tile + wg * T::kWgCBytes;
    unsigned char* c_wg_ptr = smem + (c_wg - base);
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;  // each tile's first wgmma overwrites it

    // kStats: the stages' scale and shift; this lane's ldmatrix row of a
    // stage; its tile sums
    const float* bn = reinterpret_cast<const float*>(smem + T::kBnOffset);
    const int a_row = wg * 64 + wq * 16 + (lane & 15);
    const uint32_t a_row_offset = a_row * kPanelRowBytes;
    double sums[BN / 16];
    if constexpr (kStats) {
#pragma unroll
      for (int i = 0; i < BN / 16; ++i) sums[i] = 0.0;
    }

    int stage = 0;
    uint32_t phase = 0;
    for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = static_cast<int>(t / n_tiles) * kMmBM;
      const int n0 = static_cast<int>(t % n_tiles) * BN;
      int prev = 0;
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(full_bar + 8 * stage, phase);
        const uint32_t b = base + stage * T::kStageBytes + T::kABytes;
        if constexpr (kStats) {
          // the previous stage's products are done (its A registers are
          // rewritten below): release it
          if (kb > 0) {
            wgmma_wait_all();
            fence_registers(acc);
            if (lane == 0) mbar_arrive(empty_bar + 8 * prev);
          }
          // this warp's 16 rows of the stage, 16 k a step: matrices (rows
          // 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15), each
          // 16-byte row at chunk (k / 8) ^ (row % 8) of the swizzle
          const uint32_t a = base + stage * T::kStageBytes + a_row_offset;
          uint32_t frag[kMmBK / 16][4];
#pragma unroll
          for (int kk = 0; kk < kMmBK / 16; ++kk)
            ldmatrix_x4(frag[kk], a + (((2 * kk + (lane >> 4)) ^ (a_row & 7)) << 4));
#pragma unroll
          for (int kk = 0; kk < kMmBK / 16; ++kk) {
            const float* slot = bn + stage * T::kBnFloats + kk * 16 + 4 * (lane & 3);
            const float4 sc = *reinterpret_cast<const float4*>(slot);
            const float4 sh = *reinterpret_cast<const float4*>(slot + kMmBK);
            frag[kk][0] = bn_relu2(frag[kk][0], sc.x, sc.y, sh.x, sh.y);  // row g, k 2t
            frag[kk][1] = bn_relu2(frag[kk][1], sc.x, sc.y, sh.x, sh.y);  // row g + 8, k 2t
            frag[kk][2] = bn_relu2(frag[kk][2], sc.z, sc.w, sh.z, sh.w);  // row g, k 2t + 8
            frag[kk][3] = bn_relu2(frag[kk][3], sc.z, sc.w, sh.z, sh.w);  // row g + 8, k 2t + 8
            fence_registers(frag[kk]);
          }
          asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
          for (int kk = 0; kk < kMmBK / 16; ++kk)
            Wgmma<BN>::mma_rs(acc, frag[kk],
                              smem_desc(b + kk * 16 * kPanelRowBytes, kMmBK * kPanelRowBytes, 1024),
                              kb > 0 || kk > 0);
          asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        } else {
          const uint32_t a = base + stage * T::kStageBytes + wg * 64 * kPanelRowBytes;
          asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
          for (int kk = 0; kk < kMmBK / 16; ++kk) {
            // x: 16 k to the right (32 bytes) within the swizzled row; w: 16
            // rows down; panels of w kMmBK rows apart, 8-row groups 1 KB apart
            Wgmma<BN>::mma(acc, smem_desc(a + kk * 32, 16, 1024),
                           smem_desc(b + kk * 16 * kPanelRowBytes, kMmBK * kPanelRowBytes, 1024),
                           kb > 0 || kk > 0);
          }
          asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
          if (kb > 0) {  // the previous stage's products are done: release it
            asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
            fence_registers(acc);
            if (lane == 0) mbar_arrive(empty_bar + 8 * prev);
          }
        }
        prev = stage;
        if (++stage == T::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait_all();
      fence_registers(acc);
      if (lane == 0) mbar_arrive(empty_bar + 8 * prev);

      // epilogue: the previous tile's store has read the y tile ...
      if (leader) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      named_barrier(1 + wg, 128);
      // ... so write this one: (row r, 8-column chunk j of panel p) goes to
      // chunk j ^ (r % 8) of row r, as the 128-byte swizzle of the store reads it
      const int r0 = wq * 16 + (lane >> 2);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h;
          const int offset = (j / 8) * 64 * kPanelRowBytes + r * kPanelRowBytes +
                             (((j % 8) ^ (r & 7)) << 4) + ((lane & 3) << 2);
          *reinterpret_cast<__nv_bfloat162*>(c_wg_ptr + offset) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      named_barrier(1 + wg, 128);
      if (leader) {
#pragma unroll
        for (int p = 0; p < BN / kPanel; ++p)
          tma_store(&map_y, c_wg + p * 64 * kPanelRowBytes, n0 + p * kPanel, m0 + wg * 64);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      }

      if constexpr (kStats) {
        // this thread holds rows g and g + 8 of its warp's 16 (g = lane / 4)
        // and columns 8 j + 2 (lane % 4) + c: v[4 j + 2 c] sums y32, v[4 j +
        // 2 c + 1] y32^2 over its rows < M
        const int64_t row = static_cast<int64_t>(m0) + wg * 64 + r0;
        const bool in0 = row < M, in1 = row + 8 < M;
        float v[BN / 2];
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float y0 = in0 ? acc[4 * j + c] : 0.0f;
            const float y1 = in1 ? acc[4 * j + 2 + c] : 0.0f;
            v[4 * j + 2 * c] = __fadd_rn(y0, y1);
            v[4 * j + 2 * c + 1] = __fadd_rn(__fmul_rn(y0, y0), __fmul_rn(y1, y1));
          }
        }
        // over the 8 lanes of a lane % 4 (lane bits 4, 3, 2): lane keeps
        // v[i], i < BN / 16, the sum of the value at i + (lane / 4) BN / 16
        fold_half<BN / 4>(v, lane, 16);
        fold_half<BN / 8>(v, lane, 8);
        fold_half<BN / 16>(v, lane, 4);
#pragma unroll
        for (int i = 0; i < BN / 16; ++i) sums[i] += static_cast<double>(v[i]);
      }
    }
    if (leader) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");

    if constexpr (kStats) {
      // the block's sums: its 8 warps' in order, through the stages' memory
      // (every load has landed and been read once both warpgroups are here)
      double* red = reinterpret_cast<double*>(smem);  // [warp][lane][BN / 16]
      named_barrier(3, kConsumerThreads);
#pragma unroll
      for (int i = 0; i < BN / 16; ++i) red[(threadIdx.x * (BN / 16)) + i] = sums[i];
      named_barrier(3, kConsumerThreads);
      const int n0 = static_cast<int>(blockIdx.x % n_tiles) * BN;  // every tile's column tile
      for (int u = threadIdx.x; u < 2 * BN; u += kConsumerThreads) {
        // column col = 8 j + 2 t + c, sum q (0: y32, 1: y32^2) sits at
        // index 4 j + 2 c + q of lane t's values before the folds
        const int col = u >> 1, q = u & 1;
        const int index = 4 * (col >> 3) + 2 * (col & 1) + q;
        const int from = ((index / (BN / 16)) << 2 | ((col >> 1) & 3)) * (BN / 16) + index % (BN / 16);
        double sum = 0.0;
#pragma unroll
        for (int w = 0; w < kConsumerWarps; ++w) sum += red[w * 32 * (BN / 16) + from];
        if (n0 + col < N) partials[(2 * static_cast<int64_t>(blockIdx.x) + q) * N + n0 + col] = sum;
      }
    }
  }
}

// Launch 2 of the fused kernel: s[col] and ss[col] from the blocks'
// partials of col's column tile, in double, a warp each: lane l sums every
// 32nd of them from the l-th, in block order, then the lanes' sums fold in a
// fixed order.
constexpr int kReduceThreads = 256;

__global__ void __launch_bounds__(kReduceThreads)
stats_reduce(const double* __restrict__ partials, int grid, int n_tiles, int bn, int N,
             float* __restrict__ s, float* __restrict__ ss) {
  const int u = (blockIdx.x * kReduceThreads + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (u >= 2 * N) return;  // the whole warp
  const int q = u / N, col = u % N;
  double sum = 0.0;
  for (int b = col / bn + lane * n_tiles; b < grid; b += 32 * n_tiles)
    sum += partials[(2 * static_cast<int64_t>(b) + q) * N + col];
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) sum += __shfl_down_sync(0xFFFFFFFFu, sum, offset);
  if (lane == 0) (q ? ss : s)[col] = static_cast<float>(sum);
}

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

// A row-major [outer, inner] bf16 matrix, read or written in boxes of
// [box_outer, box_inner], 128-byte swizzle, zeros past the edges.
bool tensor_map(CUtensorMap* map, const void* ptr, uint64_t inner, uint64_t outer,
                uint32_t box_inner, uint32_t box_outer) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {inner * 2};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
                box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

int64_t num_tiles(int64_t M, int N, int BN) { return ((M + kMmBM - 1) / kMmBM) * ((N + BN - 1) / BN); }

// The share of the persistent grid's tile slots (sms a wave) that hold a tile.
double wave_use(int64_t tiles, int sms) {
  const int64_t waves = (tiles + sms - 1) / sms;
  return static_cast<double>(tiles) / static_cast<double>(waves * sms);
}

int sm_count() {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return sms;
}

// The fused kernel's column tile width and grid: a multiple of its column
// tiles (so that each block walks one column tile), at most one block an SM
// where the column tiles allow, and no more blocks than tiles.
int stats_bn(int N) { return N <= 64 ? 64 : 128; }

int64_t stats_grid(int64_t M, int N, int sms) {
  const int bn = stats_bn(N);
  const int64_t n_tiles = (N + bn - 1) / bn;
  const int64_t fill = n_tiles <= sms ? sms - sms % n_tiles : n_tiles;
  const int64_t tiles = num_tiles(M, N, bn);
  return tiles < fill ? tiles : fill;
}

// The tensor maps of x, w and y, the shared memory allowance and the launch
// of matmul_wgmma<BN, kStats> on `grid` blocks.
template <int BN, bool kStats>
int launch(const void* x, const void* w, void* y, int64_t M, int K, int N, int64_t grid,
           const float* scale, const float* shift, double* partials, cudaStream_t stream) {
  using T = MmTile<BN, kStats>;
  CUtensorMap map_x, map_w, map_y;
  if (!tensor_map(&map_x, x, K, M, kMmBK, kMmBM) || !tensor_map(&map_w, w, N, K, kPanel, kMmBK) ||
      !tensor_map(&map_y, y, N, M, kPanel, kMmBM / 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      matmul_wgmma<BN, kStats>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  matmul_wgmma<BN, kStats><<<static_cast<unsigned>(grid), kMmThreads, T::kSmemBytes, stream>>>(
      map_x, map_w, map_y, static_cast<int>(M), K, N, scale, shift, partials);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch_matmul(const void* x, const void* w, void* y, int64_t M, int K, int N, int sms,
                  cudaStream_t stream) {
  const int64_t tiles = num_tiles(M, N, BN);
  return launch<BN, false>(x, w, y, M, K, N, tiles < sms ? tiles : sms, nullptr, nullptr,
                           nullptr, stream);
}

template <int BN>
int launch_stats(const void* x, const void* w, const float* scale, const float* shift, void* y,
                 double* partials, float* s, float* ss, int64_t M, int K, int N, int sms,
                 cudaStream_t stream) {
  const int64_t grid = stats_grid(M, N, sms);
  const int err = launch<BN, true>(x, w, y, M, K, N, grid, scale, shift, partials, stream);
  if (err != 0) return err;
  const int warps_a_block = kReduceThreads / 32;
  stats_reduce<<<(2 * N + warps_a_block - 1) / warps_a_block, kReduceThreads, 0, stream>>>(
      partials, static_cast<int>(grid), (N + BN - 1) / BN, BN, N, s, ss);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x [M, K], w [K, N], y [M, N]: row-major bf16, 16-byte aligned; 1 <= M < 2^31,
// K and N positive multiples of 8.
int pf_matmul_bf16(const void* x, const void* w, void* y, int64_t M, int K, int N,
                   void* stream) {
  if (M < 1 || M > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int sms = sm_count();
  if (N <= 64) return launch_matmul<64>(x, w, y, M, K, N, sms, st);
  if (N <= 128) return launch_matmul<128>(x, w, y, M, K, N, sms, st);
  // 128x256 tiles, unless their last wave leaves many SMs idle where 128x128
  // tiles fill the waves (M=12,544, N=512: 196 tiles on 132 SMs use 74% of
  // two waves; 392 tiles use 99% of three)
  if (wave_use(num_tiles(M, N, 128), sms) > 1.1 * wave_use(num_tiles(M, N, 256), sms))
    return launch_matmul<128>(x, w, y, M, K, N, sms, st);
  return launch_matmul<256>(x, w, y, M, K, N, sms, st);
}

// As pf_matmul_bf16, with scale and shift [K] fp32 and s, ss [N] fp32.
// partials: scratch of 2 * N doubles for each of
// pf_bn_relu_matmul_stats_grid(M, N) blocks.
int pf_bn_relu_matmul_stats(const void* x, const void* w, const float* scale,
                            const float* shift, void* y, double* partials, float* s, float* ss,
                            int64_t M, int K, int N, void* stream) {
  if (M < 1 || M > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int sms = sm_count();
  if (stats_bn(N) == 64)
    return launch_stats<64>(x, w, scale, shift, y, partials, s, ss, M, K, N, sms, st);
  return launch_stats<128>(x, w, scale, shift, y, partials, s, ss, M, K, N, sms, st);
}

// The blocks of pf_bn_relu_matmul_stats on the current device, each with a
// row of partials.
int64_t pf_bn_relu_matmul_stats_grid(int64_t M, int N) { return stats_grid(M, N, sm_count()); }

}  // extern "C"
