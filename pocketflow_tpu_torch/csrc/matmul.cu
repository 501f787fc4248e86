// Tiled bf16 matrix product kernels for Hopper (sm_90a).
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
// What bounds them on the card: bytes, at the ResNet-50 1x1 shapes.  A
// product of [M, K] and [K, N] does 2*M*K*N flops on (M*K + M*N)*2 bytes of
// activations, so K*N / (K + N) flops a byte: 51 at K=256, N=64 and 205 at
// K=512, N=2048, under the H100's ~295 bf16 flops a byte.  The TPU kernels
// streamed a (TILE_M, K) block of x through VMEM against the whole of w; here
// a block of 256 threads owns a 128x64 tile of y, walks K in steps of 32, and
// keeps w (at most 2 MB at these shapes) and the current rows of x in the
// 50 MB L2, so each x row is read from device memory about once while the
// column tiles of one row tile run together (the column tile varies fastest
// in the block order).  The tensor cores do the products through WMMA
// (16x16x16 bf16 fragments, fp32 accumulators); the next k-step's tiles are
// loaded into registers while the current one multiplies.  The edges are
// masked: rows past M and k past K load as zeros, columns past N are not
// stored.  This is the simple first version; wgmma, TMA and a deeper pipeline
// are later work.
//
// The fused kernel's prologue runs while a tile of x is staged in shared
// memory, spelled with __fmul_rn and __fadd_rn (never an FMA) so that z equals
// the plain version's separate multiply and add; k past K gives z = 0 (a zero
// row of x is not a zero row of z: relu(0 * scale + shift) = shift).  The
// statistics need a sum over all rows, which on the TPU ran in grid order into
// one accumulator.  Hopper blocks run in no order, so each block writes the
// sums of its own rows (rows < M only) into a scratch of partials, and a
// second launch reduces the partials of each column in a fixed order, in
// double.  No float atomics: two runs give the same bits.
//
// Plain C interface for ctypes; every entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

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

template <bool kFused>
__global__ void __launch_bounds__(kThreads)
matmul_tile(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
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
      if constexpr (kFused) {
        const int k = k0 + a_col[i];
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
        if (k < K) {
#pragma unroll
          for (int j = 0; j < 8; ++j) e[j] = prologue(e[j], scale[k + j], shift[k + j]);
        }  // else v is zero: k past K adds nothing
      }
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

  if constexpr (kFused) {
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

// x [M, K], w [K, N], y [M, N]: row-major bf16, 16-byte aligned; M >= 1,
// K and N positive multiples of 8.
int pf_matmul_bf16(const void* x, const void* w, void* y, int64_t M, int K, int N,
                   void* stream) {
  matmul_tile<false><<<static_cast<unsigned>(blocks(M, N)), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), nullptr,
      nullptr, static_cast<__nv_bfloat16*>(y), nullptr, nullptr, M, K, N);
  return static_cast<int>(cudaGetLastError());
}

// As pf_matmul_bf16, with scale and shift [K] fp32 and s, ss [N] fp32.
// partial_s and partial_ss: scratch of ceil(M / 128) * N floats each.
int pf_bn_relu_matmul_stats(const void* x, const void* w, const float* scale,
                            const float* shift, void* y, float* partial_s, float* partial_ss,
                            float* s, float* ss, int64_t M, int K, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  matmul_tile<true><<<static_cast<unsigned>(blocks(M, N)), kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), scale, shift,
      static_cast<__nv_bfloat16*>(y), partial_s, partial_ss, M, K, N);
  const dim3 block(kRedCols, kRedRows);
  reduce_stats<<<(N + kRedCols - 1) / kRedCols, block, 0, st>>>(partial_s, partial_ss,
                                                                 row_tiles(M), N, s, ss);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
