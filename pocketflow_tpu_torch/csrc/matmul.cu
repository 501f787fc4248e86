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
// What bounds pf_matmul_bf16 on the card.  A product of [M, K] and [K, N]
// does 2*M*K*N flops on (M*K + K*N + M*N)*2 bytes, so about K*N / (K + N)
// flops a byte: 51 at K=256, N=64, 205 at K=512, N=2048, against the H100's
// ~295 bf16 flops a byte.  Six of the eight ResNet-50 1x1 shapes are bound by
// bytes (reading x once and writing y once at the memory's rate is the whole
// game there), the two stage-4 shapes by the tensor cores.  The TPU kernel
// streamed (TILE_M, K) blocks of x through VMEM against the whole of w.
//
// The design (the usual Hopper GEMM):
//   * TMA loads: one producer warp copies 128x64 tiles of x and 64x64 panels
//     of w into a ring of shared-memory stages (128-byte swizzle), each stage
//     with an mbarrier for its arrival (transaction bytes) and one for its
//     release.  Boxes past M or K fill zeros, so a ragged M or K needs no
//     masked loads; the descriptors are encoded on the host in
//     pf_matmul_bf16 (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint,
//     no -lcuda) and passed as __grid_constant__ parameters.
//   * wgmma: two consumer warpgroups each own 64 rows of a 128-row tile and
//     run m64nBNk16 (bf16 in, fp32 accumulators in registers) on the
//     stage; w stays row-major [K, N], which is the MN-major ("transposed")
//     B operand wgmma reads from the swizzled panels, so no transpose pass.
//     One wgmma group stays in flight while the previous stage is released.
//     The producer warpgroup gives its registers to the consumers
//     (setmaxnreg).
//   * Tile by N: BN = 64, 128 or 256, the least that covers N up to 256, so
//     at N <= 256 one tile spans all of y's columns and each row of x is read
//     from device memory once; wider N takes 128x256 tiles (128x128 where
//     those leave a last wave mostly idle), walked with the column tile
//     fastest so that the tiles of one row tile run at the same time on
//     neighbouring SMs and x is read from memory once while w stays in the
//     50 MB L2.
//   * A persistent grid, one block per SM, walking the output tiles.  The
//     epilogue rounds the accumulators with __float2bfloat16_rn into a
//     swizzled tile in shared memory (no bank conflicts) and stores it with
//     TMA (rows past M and columns past N are clipped), while the producer
//     already loads the next tile's stages.
//
// The fused kernel (pf_bn_relu_matmul_stats) keeps the first, WMMA-based
// design: a block of 256 threads owns a 128x64 tile of y and walks K in steps
// of 32 staged through registers and shared memory; the next k-step's tiles
// are loaded into registers while the current one multiplies.  Its prologue
// needs x in registers between the load and the product, which on the new
// core is the register-A variant of wgmma (later work).  The prologue runs
// while a tile of x is staged in shared memory, spelled with __fmul_rn and
// __fadd_rn (never an FMA) so that z equals the plain version's separate
// multiply and add; k past K gives z = 0 (a zero row of x is not a zero row
// of z: relu(0 * scale + shift) = shift).  The statistics need a sum over all
// rows, which on the TPU ran in grid order into one accumulator.  Hopper
// blocks run in no order, so each block writes the sums of its own rows (rows
// < M only) into a scratch of partials, and a second launch reduces the
// partials of each column in a fixed order, in double.  No float atomics: two
// runs give the same bits.
//
// Plain C interface for ctypes; every entry point returns cudaGetLastError()
// (or cudaErrorInvalidValue when a TMA descriptor cannot be made).

#include <cuda.h>  // CUtensorMap and its enums (types only; nothing is linked from it)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// pf_matmul_bf16: TMA + wgmma, warp-specialised, persistent
// ---------------------------------------------------------------------------

constexpr int kMmBM = 128;        // rows of y a tile: two consumer warpgroups of 64
constexpr int kMmBK = 64;         // k a stage: one 128-byte swizzled row of bf16
constexpr int kPanel = 64;        // columns of one 128-byte swizzled panel
constexpr int kPanelRowBytes = 128;
constexpr int kMmThreads = 384;   // warpgroups 0 and 1 consume, 2 produces
constexpr int kConsumerWarps = 8;
constexpr int kSmemAlign = 1024;  // a 128-byte swizzle repeats every 8 rows of 128 bytes
constexpr long long kWaitTrapCycles = 1LL << 34;  // ~10 s at the H100's clocks

template <int BN> struct MmTile {
  static constexpr int kStages = BN == 256 ? 3 : BN == 128 ? 5 : 8;
  static constexpr int kABytes = kMmBM * kMmBK * 2;            // 16 KB of x
  static constexpr int kBBytes = kMmBK * BN * 2;               // BN/64 panels of w
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kCBytes = kMmBM * BN * 2;               // the bf16 y tile
  static constexpr int kWgCBytes = kCBytes / 2;                // a warpgroup's 64 rows
  static constexpr int kBarOffset = kStages * kStageBytes + kCBytes;
  static constexpr int kSmemBytes = kBarOffset + 2 * kStages * 8 + kSmemAlign;
  static_assert(kSmemBytes <= 232448, "shared memory of one block");
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

// d (+)= a @ b for one m64nNk16 step: a K-major (x), b MN-major (w), both
// from shared memory; scale_d = 0 starts a new sum.
template <int N> struct Wgmma;

template <> struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <> struct Wgmma<128> {
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <> struct Wgmma<256> {
  __device__ __forceinline__ static void mma(float (&d)[128], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};


template <int R>
__device__ __forceinline__ void fence_accumulators(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int BN>
__global__ void __launch_bounds__(kMmThreads, 1)
matmul_wgmma(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
             const __grid_constant__ CUtensorMap map_y, int M, int K, int N) {
  using T = MmTile<BN>;
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
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = static_cast<int>(t / n_tiles) * kMmBM;
        const int n0 = static_cast<int>(t % n_tiles) * BN;
        for (int kb = 0; kb < nk; ++kb) {
          mbar_wait(empty_bar + 8 * stage, phase ^ 1);
          const uint32_t bar = full_bar + 8 * stage;
          const uint32_t a = base + stage * T::kStageBytes;
          mbar_expect_tx(bar, T::kStageBytes);
          tma_load(a, &map_x, bar, kb * kMmBK, m0);
#pragma unroll
          for (int p = 0; p < BN / kPanel; ++p)
            tma_load(a + T::kABytes + p * kMmBK * kPanelRowBytes, &map_w, bar, n0 + p * kPanel,
                     kb * kMmBK);
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
    int stage = 0;
    uint32_t phase = 0;
    for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = static_cast<int>(t / n_tiles) * kMmBM;
      const int n0 = static_cast<int>(t % n_tiles) * BN;
      int prev = 0;
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(full_bar + 8 * stage, phase);
        const uint32_t a = base + stage * T::kStageBytes + wg * 64 * kPanelRowBytes;
        const uint32_t b = base + stage * T::kStageBytes + T::kABytes;
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
          fence_accumulators(acc);
          if (lane == 0) mbar_arrive(empty_bar + 8 * prev);
        }
        prev = stage;
        if (++stage == T::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_accumulators(acc);
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
    }
    if (leader) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
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

template <int BN>
int launch_matmul(const void* x, const void* w, void* y, int64_t M, int K, int N, int sms,
                  cudaStream_t stream) {
  using T = MmTile<BN>;
  CUtensorMap map_x, map_w, map_y;
  if (!tensor_map(&map_x, x, K, M, kMmBK, kMmBM) || !tensor_map(&map_w, w, N, K, kPanel, kMmBK) ||
      !tensor_map(&map_y, y, N, M, kPanel, kMmBM / 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncSetAttribute(matmul_wgmma<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       T::kSmemBytes);
  const int64_t tiles = num_tiles(M, N, BN);
  const unsigned grid = static_cast<unsigned>(tiles < sms ? tiles : sms);
  matmul_wgmma<BN><<<grid, kMmThreads, T::kSmemBytes, stream>>>(map_x, map_w, map_y,
                                                                 static_cast<int>(M), K, N);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// pf_bn_relu_matmul_stats: the WMMA core with the BN/ReLU prologue
// ---------------------------------------------------------------------------

using namespace nvcuda;

constexpr int kBM = 128;                    // rows of y per block
constexpr int kBN = 64;                     // columns of y per block
constexpr int kBK = 32;                     // k per step
constexpr int kThreads = 256;               // 8 warps: 4 along M x 2 along N, 32x32 each
constexpr int kALd = kBK + 8;               // bf16 per row of the x tile in shared memory
constexpr int kBLd = kBN + 8;               // bf16 per row of the w tile
constexpr int kCLd = kBN + 4;               // floats per row of the fp32 y tile
constexpr int kABytes = kBM * kALd * 2;     // 10,240
constexpr int kBBytes = kBK * kBLd * 2;     // 4,608
constexpr int kCBytes = kBM * kCLd * 4;     // 34,816 (reuses the x and w tiles' space)
constexpr int kSmemBytes = kCBytes > kABytes + kBBytes ? kCBytes : kABytes + kBBytes;
constexpr int kStatGroups = kThreads / kBN; // row groups of the per-block column sums
constexpr int kRedCols = 32;                // reduce_stats: columns per block
constexpr int kRedRows = 8;                 // reduce_stats: threads splitting the partials

static_assert(kBM * kBK / 8 == 2 * kThreads, "x tile: two 16-byte chunks a thread");
static_assert(kBK * kBN / 8 == kThreads, "w tile: one 16-byte chunk a thread");

// z = bf16(relu(x * scale + shift)) in the plain version's order, each step rounded once
__device__ __forceinline__ __nv_bfloat16 prologue(__nv_bfloat16 x, float scale, float shift) {
  const float t = __fadd_rn(__fmul_rn(__bfloat162float(x), scale), shift);
  return __float2bfloat16_rn(t < 0.0f ? 0.0f : t);
}

__global__ void __launch_bounds__(kThreads)
bn_relu_matmul_tile(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
            const float* __restrict__ scale, const float* __restrict__ shift,
            __nv_bfloat16* __restrict__ y, float* __restrict__ partial_s,
            float* __restrict__ partial_ss, int64_t M, int K, int N) {
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  __nv_bfloat16* a_tile = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* b_tile = reinterpret_cast<__nv_bfloat16*>(smem + kABytes);
  float* c_tile = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int n_tiles = (N + kBN - 1) / kBN;
  const int64_t m_tile = blockIdx.x / n_tiles;
  const int64_t m0 = m_tile * kBM;
  const int n0 = (blockIdx.x % n_tiles) * kBN;
  const int warp = tid >> 5, wm = warp >> 1, wn = warp & 1;

  // this thread's 16-byte chunks: two of the x tile, one of the w tile
  int a_row[2], a_col[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * kThreads;
    a_row[i] = c >> 2;
    a_col[i] = (c & 3) * 8;
  }
  const int b_row = tid >> 3, b_col = (tid & 7) * 8;
  const bool b_col_ok = n0 + b_col < N;

  uint4 ra[2], rb;
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int64_t m = m0 + a_row[i];
      const int k = k0 + a_col[i];
      ra[i] = (m < M && k < K) ? *reinterpret_cast<const uint4*>(x + m * K + k)
                               : make_uint4(0u, 0u, 0u, 0u);
    }
    const int k = k0 + b_row;
    rb = (k < K && b_col_ok)
             ? *reinterpret_cast<const uint4*>(w + static_cast<int64_t>(k) * N + n0 + b_col)
             : make_uint4(0u, 0u, 0u, 0u);
  };
  auto store = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint4 v = ra[i];
      const int k = k0 + a_col[i];
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
      if (k < K) {
#pragma unroll
        for (int j = 0; j < 8; ++j) e[j] = prologue(e[j], scale[k + j], shift[k + j]);
      }  // else v is zero: k past K adds nothing
      *reinterpret_cast<uint4*>(a_tile + a_row[i] * kALd + a_col[i]) = v;
    }
    *reinterpret_cast<uint4*>(b_tile + b_row * kBLd + b_col) = rb;
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int nk = (K + kBK - 1) / kBK;
  load(0);
  for (int kt = 0; kt < nk; ++kt) {
    store(kt * kBK);
    __syncthreads();
    if (kt + 1 < nk) load((kt + 1) * kBK);  // in flight while the tensor cores work
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], a_tile + (wm * 32 + i * 16) * kALd + kk, kALd);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], b_tile + kk * kBLd + wn * 32 + j * 16, kBLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();  // the tiles are rewritten next step, or become c_tile below
  }

  // fp32 tile of y in shared memory, then bf16 stores of 8 columns a thread
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(c_tile + (wm * 32 + i * 16) * kCLd + wn * 32 + j * 16, acc[i][j],
                              kCLd, wmma::mem_row_major);
  __syncthreads();

  for (int c = tid; c < kBM * kBN / 8; c += kThreads) {
    const int row = c >> 3, col = (c & 7) * 8;
    const int64_t m = m0 + row;
    if (m < M && n0 + col < N) {
      const float4 lo = *reinterpret_cast<const float4*>(c_tile + row * kCLd + col);
      const float4 hi = *reinterpret_cast<const float4*>(c_tile + row * kCLd + col + 4);
      const float f[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      uint4 out;
      __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&out);
#pragma unroll
      for (int j = 0; j < 8; ++j) o[j] = __float2bfloat16_rn(f[j]);
      *reinterpret_cast<uint4*>(y + m * N + n0 + col) = out;
    }
  }

  // column sums of this block's rows < M: kStatGroups groups of rows, each
  // summed in row order, then the groups in order
  __shared__ float red_s[kStatGroups][kBN], red_ss[kStatGroups][kBN];
  const int col = tid % kBN, grp = tid / kBN;
  const int64_t left = M - m0;
  const int rows = left < kBM ? static_cast<int>(left) : kBM;
  constexpr int kPer = kBM / kStatGroups;
  float s = 0.0f, ss = 0.0f;
  for (int r = grp * kPer; r < (grp + 1) * kPer && r < rows; ++r) {
    const float v = c_tile[r * kCLd + col];
    s = __fadd_rn(s, v);
    ss = __fadd_rn(ss, __fmul_rn(v, v));
  }
  red_s[grp][col] = s;
  red_ss[grp][col] = ss;
  __syncthreads();
  if (tid < kBN && n0 + tid < N) {
    s = red_s[0][tid];
    ss = red_ss[0][tid];
#pragma unroll
    for (int g = 1; g < kStatGroups; ++g) {
      s = __fadd_rn(s, red_s[g][tid]);
      ss = __fadd_rn(ss, red_ss[g][tid]);
    }
    partial_s[m_tile * N + n0 + tid] = s;
    partial_ss[m_tile * N + n0 + tid] = ss;
  }
}

// Launch 2 of the fused kernel: s[col] = sum over p of partial_s[p][col] (and
// ss), in double, each thread over a fixed stride of the partials, then the
// threads' sums in order.
__global__ void __launch_bounds__(kRedCols * kRedRows)
reduce_stats(const float* __restrict__ partial_s, const float* __restrict__ partial_ss,
             int64_t nparts, int N, float* __restrict__ s, float* __restrict__ ss) {
  __shared__ double red_s[kRedRows][kRedCols], red_ss[kRedRows][kRedCols];
  const int col = blockIdx.x * kRedCols + threadIdx.x;
  double a = 0.0, b = 0.0;
  if (col < N) {
    for (int64_t p = threadIdx.y; p < nparts; p += kRedRows) {
      a += partial_s[p * N + col];
      b += partial_ss[p * N + col];
    }
  }
  red_s[threadIdx.y][threadIdx.x] = a;
  red_ss[threadIdx.y][threadIdx.x] = b;
  __syncthreads();
  if (threadIdx.y == 0 && col < N) {
    for (int r = 1; r < kRedRows; ++r) {
      a += red_s[r][threadIdx.x];
      b += red_ss[r][threadIdx.x];
    }
    s[col] = static_cast<float>(a);
    ss[col] = static_cast<float>(b);
  }
}

int64_t row_tiles(int64_t M) { return (M + kBM - 1) / kBM; }
int64_t blocks(int64_t M, int N) { return row_tiles(M) * ((N + kBN - 1) / kBN); }

}  // namespace

extern "C" {

// x [M, K], w [K, N], y [M, N]: row-major bf16, 16-byte aligned; 1 <= M < 2^31,
// K and N positive multiples of 8.
int pf_matmul_bf16(const void* x, const void* w, void* y, int64_t M, int K, int N,
                   void* stream) {
  if (M < 1 || M > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
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
// partial_s and partial_ss: scratch of ceil(M / 128) * N floats each.
int pf_bn_relu_matmul_stats(const void* x, const void* w, const float* scale,
                            const float* shift, void* y, float* partial_s, float* partial_ss,
                            float* s, float* ss, int64_t M, int K, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bn_relu_matmul_tile<<<static_cast<unsigned>(blocks(M, N)), kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), scale, shift,
      static_cast<__nv_bfloat16*>(y), partial_s, partial_ss, M, K, N);
  const dim3 block(kRedCols, kRedRows);
  reduce_stats<<<(N + kRedCols - 1) / kRedCols, block, 0, st>>>(partial_s, partial_ss,
                                                                 row_tiles(M), N, s, ss);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
