// Min/max affine fake-quantization kernels for Hopper (sm_90a).
//
//   alpha = max(x) - min(x) + 1e-10,  beta = min(x),  k = 2^bits - 1
//   out   = alpha * round((x - beta) / alpha * k) / k + beta        (fp32)
//
// pf_fake_quant_tensor replaces pocketflow_tpu/ops/fake_quant.py:_fq_pallas_2d
// (body _fq_tensor_kernel): one (alpha, beta) for the whole tensor.
// pf_fake_quant_columns replaces _fq_pallas_cols_grid (body _fq_axis0_kernel):
// one (alpha, beta) per column of a row-major [rows, cols] matrix.
//
// What bounds them on the card: bytes.  Each element is read twice (once for
// the min/max, once to quantize) and written once, with a few flops in
// between, far below the H100's ~300 flops per byte.  The TPU kernels held
// the whole tensor (or a 128-column stripe) in VMEM so that both passes read
// it once from HBM; a block on Hopper has at most 227 KB of shared memory, so
// here the second read comes from device memory or the 50 MB L2, which holds
// every weight of ResNet-50 (the largest, 3x3x512x512 fp32, is 9.4 MB).  The
// design keeps the passes cheap instead: 16-byte vector loads and stores
// (per tensor) or one 128-byte line per warp and row (per column),
// warp-shuffle reductions, enough blocks to keep all 132 SMs reading (the
// per-column kernels cut the rows into chunks, so a matrix of 64 columns is
// more than two blocks), and no padding (the ragged tail is masked, where the
// TPU padded to its (8, 128) tile).
//
// Bits are read from device memory, so a launch never waits for the host.
// Every arithmetic step uses the round-to-nearest intrinsics in the order of
// the reference (no FMA contraction, no reciprocal-multiply) and rintf
// rounds half to even like torch.round and jnp.round, so the result equals
// the plain PyTorch version bit for bit.  Do not build with --use_fast_math.
//
// Plain C interface for ctypes; every entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-10f;
constexpr int kThreads = 256;      // per-tensor kernels: threads per block
constexpr int kColTile = 32;       // per-column kernels: columns per block (one warp wide)
constexpr int kRowWarps = 8;       // per-column kernels: warps splitting a chunk's rows

template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; static constexpr int n = 4; };
template <> struct Vec16<__nv_bfloat16> { using type = uint4; static constexpr int n = 8; };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The reference's op order, each step rounded once.
__device__ __forceinline__ float quantize(float x, float alpha, float beta, float k) {
  const float normalized = __fdiv_rn(__fsub_rn(x, beta), alpha);
  const float q = __fdiv_rn(rintf(__fmul_rn(normalized, k)), k);
  return __fadd_rn(__fmul_rn(alpha, q), beta);
}

__device__ __forceinline__ float levels(const float* bits) {
  return __fsub_rn(exp2f(*bits), 1.0f);
}

__device__ __forceinline__ void warp_minmax(float& lo, float& hi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
}

// Block-wide min/max over blockDim.x (a multiple of 32); every thread gets it.
__device__ __forceinline__ void block_minmax(float& lo, float& hi) {
  __shared__ float s_lo[32], s_hi[32];
  warp_minmax(lo, hi);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) { s_lo[warp] = lo; s_hi[warp] = hi; }
  __syncthreads();
  const int nwarps = blockDim.x >> 5;
  lo = lane < nwarps ? s_lo[lane] : FLT_MAX;
  hi = lane < nwarps ? s_hi[lane] : -FLT_MAX;
  warp_minmax(lo, hi);
}

// Pass 1: each block reduces a grid-stride slice of x to one (min, max).
template <typename T>
__global__ void __launch_bounds__(kThreads)
minmax_partials(const T* __restrict__ x, int64_t n, int vectorized, float2* __restrict__ partials) {
  using V = typename Vec16<T>::type;
  constexpr int kVec = Vec16<T>::n;
  const int64_t tid = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t nvec = vectorized ? n / kVec : 0;
  float lo = FLT_MAX, hi = -FLT_MAX;
  const V* xv = reinterpret_cast<const V*>(x);
  for (int64_t i = tid; i < nvec; i += stride) {
    const V v = xv[i];
    const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float f = to_float(e[j]);
      lo = fminf(lo, f);
      hi = fmaxf(hi, f);
    }
  }
  for (int64_t i = nvec * kVec + tid; i < n; i += stride) {
    const float f = to_float(x[i]);
    lo = fminf(lo, f);
    hi = fmaxf(hi, f);
  }
  block_minmax(lo, hi);
  if (threadIdx.x == 0) partials[blockIdx.x] = make_float2(lo, hi);
}

// Pass 2: each block reduces all partials, then quantizes its grid-stride slice.
template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_tensor(const T* __restrict__ x, T* __restrict__ out, int64_t n, int vectorized,
                const float2* __restrict__ partials, int nparts, const float* __restrict__ bits) {
  using V = typename Vec16<T>::type;
  constexpr int kVec = Vec16<T>::n;
  float lo = FLT_MAX, hi = -FLT_MAX;
  for (int i = threadIdx.x; i < nparts; i += blockDim.x) {
    const float2 p = partials[i];
    lo = fminf(lo, p.x);
    hi = fmaxf(hi, p.y);
  }
  block_minmax(lo, hi);
  const float alpha = __fadd_rn(__fsub_rn(hi, lo), kEps);
  const float beta = lo;
  const float k = levels(bits);

  const int64_t tid = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t nvec = vectorized ? n / kVec : 0;
  const V* xv = reinterpret_cast<const V*>(x);
  V* ov = reinterpret_cast<V*>(out);
  for (int64_t i = tid; i < nvec; i += stride) {
    const V v = xv[i];
    const T* e = reinterpret_cast<const T*>(&v);
    V r;
    T* o = reinterpret_cast<T*>(&r);
#pragma unroll
    for (int j = 0; j < kVec; ++j) o[j] = from_float<T>(quantize(to_float(e[j]), alpha, beta, k));
    ov[i] = r;
  }
  for (int64_t i = nvec * kVec + tid; i < n; i += stride) {
    out[i] = from_float<T>(quantize(to_float(x[i]), alpha, beta, k));
  }
}

// Per-column kernels.  Block (i, j) owns kColTile neighbouring columns and
// the j-th chunk of `chunk` rows: a warp reads 32 consecutive floats of a row
// (one 128-byte line), and kRowWarps warps split the chunk's rows.  Cutting
// the rows into chunks gives the card enough blocks when a matrix has few
// columns (64 output channels make two column tiles).

// Min/max of each column over the block's warps; every thread gets its column's.
__device__ __forceinline__ void column_minmax(float& lo, float& hi) {
  __shared__ float s_lo[kRowWarps][kColTile], s_hi[kRowWarps][kColTile];
  s_lo[threadIdx.y][threadIdx.x] = lo;
  s_hi[threadIdx.y][threadIdx.x] = hi;
  __syncthreads();
  lo = s_lo[0][threadIdx.x];
  hi = s_hi[0][threadIdx.x];
#pragma unroll
  for (int w = 1; w < kRowWarps; ++w) {
    lo = fminf(lo, s_lo[w][threadIdx.x]);
    hi = fmaxf(hi, s_hi[w][threadIdx.x]);
  }
}

// Pass 1: min/max of each column over the block's chunk, into partials[j][col].
__global__ void __launch_bounds__(kColTile * kRowWarps)
column_partials(const float* __restrict__ x, int64_t rows, int64_t cols, int64_t chunk,
                float2* __restrict__ partials) {
  const int64_t col = blockIdx.x * (int64_t)kColTile + threadIdx.x;
  const int64_t r0 = blockIdx.y * chunk;
  const int64_t r1 = r0 + chunk < rows ? r0 + chunk : rows;
  float lo = FLT_MAX, hi = -FLT_MAX;
  if (col < cols) {
#pragma unroll 4
    for (int64_t r = r0 + threadIdx.y; r < r1; r += kRowWarps) {
      const float f = x[r * cols + col];
      lo = fminf(lo, f);
      hi = fmaxf(hi, f);
    }
  }
  column_minmax(lo, hi);
  if (threadIdx.y == 0 && col < cols) partials[blockIdx.y * cols + col] = make_float2(lo, hi);
}

// Pass 2: each block reduces its columns' partials over all chunks, then
// quantizes its own chunk.
__global__ void __launch_bounds__(kColTile * kRowWarps)
quantize_columns(const float* __restrict__ x, float* __restrict__ out, int64_t rows, int64_t cols,
                 int64_t chunk, const float2* __restrict__ partials, int nchunks,
                 const float* __restrict__ bits) {
  const int64_t col = blockIdx.x * (int64_t)kColTile + threadIdx.x;
  const bool active = col < cols;
  float lo = FLT_MAX, hi = -FLT_MAX;
  if (active) {
    for (int c = threadIdx.y; c < nchunks; c += kRowWarps) {
      const float2 p = partials[c * cols + col];
      lo = fminf(lo, p.x);
      hi = fmaxf(hi, p.y);
    }
  }
  column_minmax(lo, hi);
  if (!active) return;
  const float alpha = __fadd_rn(__fsub_rn(hi, lo), kEps);
  const float beta = lo;
  const float k = levels(bits);
  const int64_t r0 = blockIdx.y * chunk;
  const int64_t r1 = r0 + chunk < rows ? r0 + chunk : rows;
#pragma unroll 4
  for (int64_t r = r0 + threadIdx.y; r < r1; r += kRowWarps) {
    out[r * cols + col] = quantize(x[r * cols + col], alpha, beta, k);
  }
}

template <typename T>
void launch_tensor(const void* x, void* out, int64_t n, float2* partials, int nparts,
                   const float* bits, cudaStream_t stream) {
  const int vectorized = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                         (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const T* xt = static_cast<const T*>(x);
  minmax_partials<T><<<nparts, kThreads, 0, stream>>>(xt, n, vectorized, partials);
  quantize_tensor<T><<<nparts, kThreads, 0, stream>>>(xt, static_cast<T*>(out), n, vectorized,
                                                      partials, nparts, bits);
}

}  // namespace

extern "C" {

// x, out: n elements of fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1), n >= 1.
// partials: scratch of nparts float2; nparts in [1, 1024] is also the grid size.
// bits: one fp32 on the device.
int pf_fake_quant_tensor(const void* x, void* out, int64_t n, int is_bf16, void* partials,
                         int nparts, const float* bits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* p = static_cast<float2*>(partials);
  if (is_bf16) {
    launch_tensor<__nv_bfloat16>(x, out, n, p, nparts, bits, s);
  } else {
    launch_tensor<float>(x, out, n, p, nparts, bits, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// x, out: row-major fp32 [rows, cols], rows >= 1, cols >= 1.
// The rows are cut into nchunks chunks of `chunk` rows (nchunks = ceil(rows / chunk),
// at most 65535); partials: scratch of nchunks * cols float2.  bits: one fp32 on the device.
int pf_fake_quant_columns(const float* x, float* out, int64_t rows, int64_t cols, int64_t chunk,
                          void* partials, int nchunks, const float* bits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* p = static_cast<float2*>(partials);
  const dim3 block(kColTile, kRowWarps);
  const dim3 grid(static_cast<unsigned>((cols + kColTile - 1) / kColTile),
                  static_cast<unsigned>(nchunks));
  column_partials<<<grid, block, 0, s>>>(x, rows, cols, chunk, p);
  quantize_columns<<<grid, block, 0, s>>>(x, out, rows, cols, chunk, p, nchunks, bits);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
