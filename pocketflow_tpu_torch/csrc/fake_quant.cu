// Min/max affine fake-quantization kernels for Hopper (sm_90a).
//
//   alpha = max(x) - min(x) + 1e-10,  beta = min(x),  k = 2^bits - 1
//   out   = alpha * round((x - beta) / alpha * k) / k + beta        (fp32)
//
// pf_fake_quant_tensor replaces pocketflow_tpu/ops/fake_quant.py:_fq_pallas_2d
// (body _fq_tensor_kernel): one (alpha, beta) for the whole tensor; with
// `select` it also takes the quant policy's select on bits < 32 (its design
// note is above its kernels below).
// pf_fake_quant_tensor_minmax and pf_fake_quant_tensor_from_range are its
// global-range route under data parallelism: pass 1 alone leaves the
// tensor's (-min, max) in a device buffer, which the caller all-reduces (MAX)
// across the ranks, and pass 2 quantizes against the range in that buffer.
// pf_fake_quant_tensor_group is a second route of _fq_pallas_2d: many fp32
// tensors, each with its own (alpha, beta) and bits, in one pair of launches.
// pf_fake_quant_tensor_group_minmax and pf_fake_quant_tensor_group_from_range
// are its model-axis route under tensor parallelism: pass 1 leaves each
// tensor's (-min, max) in a [T, 2] device buffer, which the caller
// all-reduces (MAX) over the model group (a sharded kernel's range is the
// max over its shards), and pass 2 quantizes each tensor against its range.
// pf_fake_quant_columns_group replaces _fq_pallas_cols_grid (body
// _fq_axis0_kernel): one (alpha, beta) per column of a column matrix, for
// many fp32 tensors, each with its own bits, in one pair of launches; a
// group of one tensor is the per-site bucket ops' route.
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
// grouped kernels cut every tensor into chunks, so a weight of 64 columns is
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
#include <string.h>

namespace {

constexpr float kEps = 1e-10f;
constexpr int kThreads = 256;      // per-tensor kernels: threads per block
constexpr int kColTile = 32;       // grouped per-column kernels: columns a block (one warp wide)
constexpr int kRowWarps = 8;       // grouped per-column kernels: warps splitting a chunk's rows

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

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

// Per-tensor kernels (K1').
//
// One large tensor, fp32 or bf16: the 8-bit activation route quantizes 49
// activations a step, the largest 256x256x56x56 bf16 (411 MB), each followed
// by the policy's select on bits < 32.  Bound: bytes, two reads and a write.
// What the design does about it:
// - The select is folded in: with `select`, a tensor whose bits are >= 32 is
//   copied (its gradient is the identity either way, so autograd needs no
//   select of its own), and pass 1 returns at once.
// - Both passes run persistent blocks (as many as fit on the SMs), each
//   thread with kUnroll independent 16-byte loads in flight.
// - Min and max are exact in any order: pass 1's blocks write their partials
//   and the last block to finish (an atomic count, which it resets to 0 for
//   the next call) reduces them to one (lo, hi), so each pass-2 block reads
//   one pair.
// - Pass 2 walks the tensor from its end, where pass 1 finished: its first
//   reads find pass 1's last lines in L2 (all of a tensor of 50 MB or less).
// - Pass 2 takes a table of outputs built by each block with the steps of
//   quantize(), so that most of an element's arithmetic goes: computed
//   directly, its two divisions (reciprocals on the SM's 16-a-clock units,
//   and their corrections) bound the pass, not its bytes.  A bf16 input has
//   65,536 possible values: the table holds the output of every one in
//   [min, max] (and the NaNs), 128 KB of shared memory indexed by the
//   input's bits, so an element costs one shared-memory load.  An fp32
//   output depends on m = rint((x - beta) / alpha * k) alone, an integer in
//   [0, k]: the table holds the k + 1 outputs (up to kMaxTableLevels), so an
//   element costs one division, one multiply, rintf and a load; above that,
//   or for an m outside the table (only a NaN gives one), it computes
//   quantize()'s last steps directly.  Both tables give the bits of
//   quantize().

constexpr int kUnroll = 4;               // 16-byte loads in flight a thread
constexpr int kMaxTensorBlocks = 2048;   // partials of pass 1 (132 SMs x 8 blocks fit)
constexpr int kMaxTableLevels = 4096;    // entries of the fp32 table by level (16 KB)
constexpr int kLutThreads = 1024;        // bf16 pass 2: one block of these a SM
constexpr int kBf16Values = 65536;       // entries of the bf16 table by input
constexpr int kBf16TableBytes = kBf16Values * sizeof(unsigned short);  // 128 KB

// Scratch of pf_fake_quant_tensor, zeroed once: `done` returns to 0 at the
// end of every pass 1 that counts.
struct TensorScratch {
  unsigned int done;
  unsigned int unused;
  float2 range;                          // (min, max) of the tensor
  float2 partials[kMaxTensorBlocks];
};

// W elements of T, loaded and stored whole (16 bytes, or one element where
// the pointers are not 16-byte aligned).
template <typename T, int W> struct __align__(sizeof(T) * W) Pack { T e[W]; };

template <typename P>
__device__ __forceinline__ P load_pack(const P* p) {
  if constexpr (sizeof(P) == 16) {  // one 16-byte load
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    P v;
    memcpy(&v, &raw, 16);
    return v;
  } else {
    return *p;
  }
}

template <typename P>
__device__ __forceinline__ void store_pack(P* p, const P& v) {
  if constexpr (sizeof(P) == 16) {  // one 16-byte store
    uint4 raw;
    memcpy(&raw, &v, 16);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
    *p = v;
  }
}

template <typename T, int W>
__device__ __forceinline__ void pack_minmax(const Pack<T, W>& v, float& lo, float& hi) {
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const float f = to_float(v.e[j]);
    lo = fminf(lo, f);
    hi = fmaxf(hi, f);
  }
}

// Pass 1: the (min, max) of x into s->range, and (-min, max) into neg_range
// where it is not null (the global-range route all-reduces it with MAX).
template <typename T, int W>
__global__ void __launch_bounds__(kThreads, 4)
tensor_minmax(const T* __restrict__ x, int64_t n, const float* __restrict__ bits, int select,
              TensorScratch* __restrict__ s, float2* __restrict__ neg_range) {
  if (select && *bits >= 32.0f) return;  // pass 2 copies; nothing reads the range
  using P = Pack<T, W>;
  const P* xp = reinterpret_cast<const P*>(x);
  const int64_t units = n / W;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  float lo = FLT_MAX, hi = -FLT_MAX;
  for (int64_t base = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x; base < units;
       base += kUnroll * stride) {
    P v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // past the end: base again, which changes nothing
      const int64_t i = base + u * stride;
      v[u] = load_pack(xp + (i < units ? i : base));
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) pack_minmax(v[u], lo, hi);
  }
  if (blockIdx.x == 0) {  // the ragged tail, fewer than W elements
    for (int64_t i = units * W + threadIdx.x; i < n; i += kThreads) {
      lo = fminf(lo, to_float(x[i]));
      hi = fmaxf(hi, to_float(x[i]));
    }
  }
  block_minmax(lo, hi);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    s->partials[blockIdx.x] = make_float2(lo, hi);
    __threadfence();  // the partial is visible before the count says so
    last = atomicAdd(&s->done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  lo = FLT_MAX;
  hi = -FLT_MAX;
  for (int p = threadIdx.x; p < static_cast<int>(gridDim.x); p += kThreads) {
    const float2 v = __ldcg(&s->partials[p]);  // from L2: other SMs wrote them
    lo = fminf(lo, v.x);
    hi = fmaxf(hi, v.y);
  }
  block_minmax(lo, hi);
  if (threadIdx.x == 0) {
    s->range = make_float2(lo, hi);
    if (neg_range != nullptr) *neg_range = make_float2(-lo, hi);
    s->done = 0;
  }
}

// quantize() of x through the table of outputs by level, where m is in it.
__device__ __forceinline__ float quantize_by_level(float x, float alpha, float beta, float k,
                                                   float table_top, const float* table) {
  const float m = rintf(__fmul_rn(__fdiv_rn(__fsub_rn(x, beta), alpha), k));
  if (m >= 0.0f && m <= table_top) return table[static_cast<int>(m)];
  return __fadd_rn(__fmul_rn(alpha, __fdiv_rn(m, k)), beta);
}

// out = op(x) over n elements, pass 2's walk: persistent blocks of
// `threads`, kUnroll units of W elements in flight a thread, from the end of
// the tensor to its start (the ragged tail, fewer than W elements, first).
template <typename T, int W, typename Op>
__device__ __forceinline__ void quantize_walk(const T* __restrict__ x, T* __restrict__ out,
                                              int64_t n, int threads, Op op) {
  using P = Pack<T, W>;
  const P* xp = reinterpret_cast<const P*>(x);
  P* outp = reinterpret_cast<P*>(out);
  const int64_t units = n / W;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * threads;
  const int64_t span = kUnroll * stride;
  if (blockIdx.x == 0) {
    for (int64_t i = units * W + threadIdx.x; i < n; i += threads) out[i] = op(x[i]);
  }
  for (int64_t g = (units + span - 1) / span - 1; g >= 0; --g) {
    const int64_t base = g * span + blockIdx.x * static_cast<int64_t>(threads) + threadIdx.x;
    P v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + u * stride;
      if (i < units) v[u] = load_pack(xp + i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + u * stride;
      if (i >= units) continue;
#pragma unroll
      for (int j = 0; j < W; ++j) v[u].e[j] = op(v[u].e[j]);
      store_pack(outp + i, v[u]);
    }
  }
}

template <typename T>
struct Copy {
  __device__ __forceinline__ T operator()(T v) const { return v; }
};

struct ByLevel {  // an fp32 input's output, through the table of outputs by level
  float alpha, beta, k, table_top;
  const float* table;
  __device__ __forceinline__ float operator()(float v) const {
    return quantize_by_level(v, alpha, beta, k, table_top, table);
  }
};

struct ByValue {  // a bf16 input's output, from the table by input bits
  const unsigned short* table;
  __device__ __forceinline__ __nv_bfloat16 operator()(__nv_bfloat16 v) const {
    return __ushort_as_bfloat16(table[__bfloat16_as_ushort(v)]);
  }
};

// (alpha, beta, k) from the range and the bits.
struct Scale {
  float alpha, beta, k;
};

__device__ __forceinline__ Scale tensor_scale(float2 range, float bits) {
  return {__fadd_rn(__fsub_rn(range.y, range.x), kEps), range.x, __fsub_rn(exp2f(bits), 1.0f)};
}

// The (min, max) pass 2 quantizes against: pass 1's (the scratch's range),
// or a given (-min, max) (neg_lo; negation is exact, so both give one range).
__device__ __forceinline__ float2 load_range(const float2* range, int neg_lo) {
  const float2 r = *range;
  return make_float2(neg_lo ? -r.x : r.x, r.y);
}

// Pass 2 for fp32: quantize x into out through the table of outputs by
// level (up to kMaxTableLevels levels; above, directly), or copy it (select,
// bits >= 32).
template <int W>
__global__ void __launch_bounds__(kThreads, 4)
tensor_quantize_f32(const float* __restrict__ x, float* __restrict__ out, int64_t n,
                    const float* __restrict__ bits, int select,
                    const float2* __restrict__ range, int neg_lo) {
  __shared__ float by_level[kMaxTableLevels];
  const float b = *bits;
  if (select && b >= 32.0f) {
    quantize_walk<float, W>(x, out, n, kThreads, Copy<float>());
    return;
  }
  const Scale q = tensor_scale(load_range(range, neg_lo), b);
  // the table holds levels 0 .. table_top; -1: no table
  const float table_top =
      q.k >= 0.0f && q.k < static_cast<float>(kMaxTableLevels) ? floorf(q.k) : -1.0f;
  for (int m = threadIdx.x; m <= static_cast<int>(table_top); m += kThreads) {
    by_level[m] = __fadd_rn(__fmul_rn(q.alpha, __fdiv_rn(static_cast<float>(m), q.k)), q.beta);
  }
  __syncthreads();
  quantize_walk<float, W>(x, out, n, kThreads, ByLevel{q.alpha, q.beta, q.k, table_top, by_level});
}

// Pass 2 for bf16 through the table of outputs by input value: each block
// first fills the entries of the values in [min, max] and of the NaNs (no
// other value occurs), then walks.
template <int W>
__global__ void __launch_bounds__(kLutThreads, 1)
tensor_quantize_bf16(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out,
                     int64_t n, const float* __restrict__ bits, int select,
                     const float2* __restrict__ range, int neg_lo) {
  extern __shared__ unsigned short by_value[];
  const float b = *bits;
  if (select && b >= 32.0f) {
    quantize_walk<__nv_bfloat16, W>(x, out, n, kLutThreads, Copy<__nv_bfloat16>());
    return;
  }
  const float2 r = load_range(range, neg_lo);
  const Scale q = tensor_scale(r, b);
  const float lo = r.x, hi = r.y;
  for (int v = threadIdx.x; v < kBf16Values; v += kLutThreads) {
    const float f = __uint_as_float(static_cast<unsigned>(v) << 16);
    if (!(f < lo || f > hi)) {  // in range, or a NaN
      by_value[v] = __bfloat16_as_ushort(__float2bfloat16_rn(quantize(f, q.alpha, q.beta, q.k)));
    }
  }
  __syncthreads();
  quantize_walk<__nv_bfloat16, W>(x, out, n, kLutThreads, ByValue{by_value});
}

// The launch settings below are read once per device and kept in arrays
// indexed by the device's ordinal; the kernels run on the current device.
constexpr int kMaxDevices = 64;

int sm_count(int device) {
  static int sms[kMaxDevices] = {};
  if (!sms[device]) cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
  return sms[device];
}

// Blocks of Kernel (`threads` a block, `smem` bytes of dynamic shared
// memory, which Kernel is first allowed where that is more than the default
// 48 KB) that fit on one SM of `device`; 0 where a CUDA call failed, its
// error left for cudaGetLastError.
template <auto Kernel>
int blocks_per_sm(int device, int threads, int smem) {
  static int per_sm[kMaxDevices] = {};
  if (!per_sm[device]) {
    if (smem > 48 * 1024 &&
        cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
            cudaSuccess) {
      return 0;
    }
    int fit = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, Kernel, threads, smem) !=
            cudaSuccess || fit < 1) {
      return 0;
    }
    per_sm[device] = fit;
  }
  return per_sm[device];
}

// Blocks of `threads` that keep every SM of `device` full (per_sm each), at
// most what `units` needs and what the scratch holds.
int persistent_grid(int device, int per_sm, int threads, int64_t units) {
  int64_t grid = static_cast<int64_t>(per_sm) * sm_count(device);
  const int64_t wanted = (units + threads * kUnroll - 1) / (threads * kUnroll);
  if (grid > wanted) grid = wanted;
  if (grid > kMaxTensorBlocks) grid = kMaxTensorBlocks;
  return grid > 1 ? static_cast<int>(grid) : 1;
}

// The current device (< kMaxDevices), or -1 with the error left for
// cudaGetLastError.
int current_device() {
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return -1;
  return device < kMaxDevices ? device : -1;
}

// Pass 1 on the current device: the range into s->range (and (-min, max)
// into neg_range where it is not null); 0 or a CUDA error (a launch
// setting that could not be read launches nothing).
template <typename T, int W>
int launch_minmax_w(const T* x, int64_t n, TensorScratch* s, const float* bits, int select,
                    float2* neg_range, cudaStream_t stream) {
  const int device = current_device();
  if (device < 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int per_sm = blocks_per_sm<tensor_minmax<T, W>>(device, kThreads, 0);
  if (!per_sm) return static_cast<int>(cudaGetLastError());
  tensor_minmax<T, W><<<persistent_grid(device, per_sm, kThreads, n / W), kThreads, 0,
                        stream>>>(x, n, bits, select, s, neg_range);
  return static_cast<int>(cudaGetLastError());
}

// Pass 2 on the current device against the range at `range` (neg_lo: it
// holds (-min, max)); 0 or a CUDA error.
template <typename T, int W>
int launch_quantize_w(const T* x, T* out, int64_t n, const float* bits, int select,
                      const float2* range, int neg_lo, cudaStream_t stream) {
  const int device = current_device();
  if (device < 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int64_t units = n / W;
  if constexpr (sizeof(T) == 2) {  // bf16
    const int per_sm = blocks_per_sm<tensor_quantize_bf16<W>>(device, kLutThreads,
                                                              kBf16TableBytes);
    if (!per_sm) return static_cast<int>(cudaGetLastError());
    tensor_quantize_bf16<W><<<persistent_grid(device, per_sm, kLutThreads, units), kLutThreads,
                              kBf16TableBytes, stream>>>(x, out, n, bits, select, range, neg_lo);
  } else {
    const int per_sm = blocks_per_sm<tensor_quantize_f32<W>>(device, kThreads, 0);
    if (!per_sm) return static_cast<int>(cudaGetLastError());
    tensor_quantize_f32<W><<<persistent_grid(device, per_sm, kThreads, units), kThreads, 0,
                             stream>>>(x, out, n, bits, select, range, neg_lo);
  }
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Both passes (the fused route): pass 2 reads pass 1's range from the scratch.
template <typename T>
int launch_tensor(const void* x, void* out, int64_t n, TensorScratch* s, const float* bits,
                  int select, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  constexpr int kW = 16 / sizeof(T);
  int err;
  if (aligned16(x) && aligned16(out)) {
    err = launch_minmax_w<T, kW>(xt, n, s, bits, select, nullptr, stream);
    return err ? err : launch_quantize_w<T, kW>(xt, ot, n, bits, select, &s->range, 0, stream);
  }
  err = launch_minmax_w<T, 1>(xt, n, s, bits, select, nullptr, stream);
  return err ? err : launch_quantize_w<T, 1>(xt, ot, n, bits, select, &s->range, 0, stream);
}

template <typename T>
int launch_minmax(const void* x, int64_t n, TensorScratch* s, const float* bits, int select,
                  float2* neg_range, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  if (aligned16(x)) {
    return launch_minmax_w<T, 16 / sizeof(T)>(xt, n, s, bits, select, neg_range, stream);
  }
  return launch_minmax_w<T, 1>(xt, n, s, bits, select, neg_range, stream);
}

template <typename T>
int launch_from_range(const void* x, void* out, int64_t n, const float* bits, int select,
                      const float2* neg_range, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (aligned16(x) && aligned16(out)) {
    return launch_quantize_w<T, 16 / sizeof(T)>(xt, ot, n, bits, select, neg_range, 1, stream);
  }
  return launch_quantize_w<T, 1>(xt, ot, n, bits, select, neg_range, 1, stream);
}

// Grouped per-tensor kernels: T fp32 tensors in one pair of launches.
//
// pf_fake_quant_tensor_group is a second route of the same TPU kernel as
// pf_fake_quant_tensor (_fq_pallas_2d), for the train step's weights: each
// quantized weight went through the per-tensor kernels in two launches of
// its own, then a select on bits < 32, so the 52 weights of ResNet-50 cost
// 156 launches, most of them on tensors too small to fill the card (fixed
// cost: 22% of the bandwidth bound).  Here every tensor is cut into chunks of
// kGroupChunk elements, one block each, listed in a chunk table that depends
// only on the shapes (the wrapper builds it once and keeps it on the device):
// pass 1 writes each chunk's (min, max); pass 2 reduces the partials of its
// chunk's tensor, in a fixed order, and quantizes the chunk, walking the
// chunks backwards so that its first reads find pass 1's last in L2.  What
// bounds it then is bytes: every element read twice (the second time from
// L2 for as much as L2 holds: ResNet-50's weights are 94 MB, the L2 50 MB)
// and written once.  A tensor whose bits are >= 32 is copied unchanged, which
// is the select's result (its gradient is the identity either way); pass 1
// skips it.  The arithmetic is quantize() above, so each tensor's result
// equals pf_fake_quant_tensor's bit for bit.

constexpr int kGroupChunk = kThreads * 4 * 16;  // elements a block: 16 float4 a thread

// One tensor of a group: its input, its output's offset in the flat output
// (a multiple of 4 elements), its size and its first chunk.
struct GroupEntry {
  const float* x;
  int64_t out_offset;
  int64_t n;
  int64_t first_chunk;
};

// [begin, end) of chunk c of tensor e, and whether it can use float4 accesses.
struct ChunkRange {
  int64_t begin, end;
  bool vec;
};

__device__ __forceinline__ ChunkRange chunk_range(const GroupEntry& e, int c) {
  ChunkRange r;
  r.begin = (c - e.first_chunk) * static_cast<int64_t>(kGroupChunk);
  r.end = r.begin + kGroupChunk < e.n ? r.begin + kGroupChunk : e.n;
  r.vec = reinterpret_cast<uintptr_t>(e.x) % 16 == 0;
  return r;
}

__device__ __forceinline__ int64_t num_chunks(int64_t n) {
  return (n + kGroupChunk - 1) / kGroupChunk;
}

// Chunk r of tensor e into o: quantized against (alpha, beta, k), or copied.
__device__ __forceinline__ void quantize_chunk(const GroupEntry& e, const ChunkRange& r,
                                               float* __restrict__ o, bool copy, float alpha,
                                               float beta, float k) {
  int64_t i = r.begin + threadIdx.x * 4;
  if (r.vec) {
    for (; i + 4 <= r.end; i += kThreads * 4) {
      float4 v = *reinterpret_cast<const float4*>(e.x + i);
      if (!copy) {
        v.x = quantize(v.x, alpha, beta, k);
        v.y = quantize(v.y, alpha, beta, k);
        v.z = quantize(v.z, alpha, beta, k);
        v.w = quantize(v.w, alpha, beta, k);
      }
      *reinterpret_cast<float4*>(o + i) = v;
    }
  }
  for (; i < r.end; i += kThreads * 4) {
    for (int64_t j = i; j < i + 4 && j < r.end; ++j) {
      o[j] = copy ? e.x[j] : quantize(e.x[j], alpha, beta, k);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
group_minmax_partials(const GroupEntry* __restrict__ entries, const int* __restrict__ chunk_tensor,
                      const float* __restrict__ bits, float2* __restrict__ partials) {
  const int c = blockIdx.x;
  const int t = chunk_tensor[c];
  if (bits[t] >= 32.0f) return;  // copied in pass 2; no partial is read
  const GroupEntry e = entries[t];
  const ChunkRange r = chunk_range(e, c);
  float lo = FLT_MAX, hi = -FLT_MAX;
  int64_t i = r.begin + threadIdx.x * 4;
  if (r.vec) {
    for (; i + 4 <= r.end; i += kThreads * 4) {
      const float4 v = *reinterpret_cast<const float4*>(e.x + i);
      lo = fminf(fminf(lo, v.x), fminf(v.y, fminf(v.z, v.w)));
      hi = fmaxf(fmaxf(hi, v.x), fmaxf(v.y, fmaxf(v.z, v.w)));
    }
  }
  for (; i < r.end; i += kThreads * 4) {  // the ragged tail, or every element if unaligned
    for (int64_t j = i; j < i + 4 && j < r.end; ++j) {
      lo = fminf(lo, e.x[j]);
      hi = fmaxf(hi, e.x[j]);
    }
  }
  block_minmax(lo, hi);
  if (threadIdx.x == 0) partials[c] = make_float2(lo, hi);
}

__global__ void __launch_bounds__(kThreads)
group_quantize(const GroupEntry* __restrict__ entries, const int* __restrict__ chunk_tensor,
               const float* __restrict__ bits, const float2* __restrict__ partials,
               float* __restrict__ out) {
  // chunks in the reverse of pass 1's order: the last ones pass 1 read are
  // still in L2 when this pass starts
  const int c = gridDim.x - 1 - blockIdx.x;
  const int t = chunk_tensor[c];
  const GroupEntry e = entries[t];
  const ChunkRange r = chunk_range(e, c);
  float* o = out + e.out_offset;
  const bool copy = bits[t] >= 32.0f;
  float alpha = 0.0f, beta = 0.0f, k = 0.0f;
  if (!copy) {  // uniform across the block: block_minmax's barriers are safe
    float lo = FLT_MAX, hi = -FLT_MAX;
    const int64_t p0 = e.first_chunk, p1 = p0 + num_chunks(e.n);
    for (int64_t p = p0 + threadIdx.x; p < p1; p += kThreads) {
      const float2 v = partials[p];
      lo = fminf(lo, v.x);
      hi = fmaxf(hi, v.y);
    }
    block_minmax(lo, hi);
    alpha = __fadd_rn(__fsub_rn(hi, lo), kEps);
    beta = lo;
    k = levels(bits + t);
  }
  quantize_chunk(e, r, o, copy, alpha, beta, k);
}

// The model-axis route's pass 1, second launch: each tensor's (-min, max)
// from its chunks' partials (one block a tensor), (-FLT_MAX, -FLT_MAX) for a
// tensor whose bits are >= 32 (no partial of it exists; the MAX all-reduce
// leaves it as it is and pass 2 copies the tensor).
__global__ void __launch_bounds__(kThreads)
group_ranges(const GroupEntry* __restrict__ entries, const float* __restrict__ bits,
             const float2* __restrict__ partials, float2* __restrict__ neg_ranges) {
  const int t = blockIdx.x;
  float lo = FLT_MAX, hi = -FLT_MAX;
  if (bits[t] < 32.0f) {  // uniform across the block: block_minmax's barriers are safe
    const GroupEntry e = entries[t];
    const int64_t p0 = e.first_chunk, p1 = p0 + num_chunks(e.n);
    for (int64_t p = p0 + threadIdx.x; p < p1; p += kThreads) {
      const float2 v = partials[p];
      lo = fminf(lo, v.x);
      hi = fmaxf(hi, v.y);
    }
    block_minmax(lo, hi);
  }
  if (threadIdx.x == 0) neg_ranges[t] = make_float2(-lo, hi);
}

// The model-axis route's pass 2: group_quantize with each tensor's range
// read from neg_ranges (-min, max) instead of reduced from the partials; the
// same alpha and beta where the range is the tensor's own, so the same bits.
__global__ void __launch_bounds__(kThreads)
group_quantize_from_range(const GroupEntry* __restrict__ entries,
                          const int* __restrict__ chunk_tensor, const float* __restrict__ bits,
                          const float2* __restrict__ neg_ranges, float* __restrict__ out) {
  const int c = gridDim.x - 1 - blockIdx.x;  // pass 1's last chunks first, as group_quantize
  const int t = chunk_tensor[c];
  const GroupEntry e = entries[t];
  const ChunkRange r = chunk_range(e, c);
  const bool copy = bits[t] >= 32.0f;
  float alpha = 0.0f, beta = 0.0f, k = 0.0f;
  if (!copy) {
    const float2 nr = neg_ranges[t];
    const float lo = -nr.x, hi = nr.y;
    alpha = __fadd_rn(__fsub_rn(hi, lo), kEps);
    beta = lo;
    k = levels(bits + t);
  }
  quantize_chunk(e, r, out + e.out_offset, copy, alpha, beta, k);
}

// Grouped per-column kernels: T fp32 tensors in one pair of launches.
//
// pf_fake_quant_columns_group is the bucket routes' counterpart of the
// grouped per-tensor kernels (a second route of _fq_pallas_cols_grid): with
// --uql_use_buckets every quantized weight went through a per-column
// kernel pair of its own, after a copy into its column view and before the
// select on bits < 32, so the 52 weights of ResNet-50 cost 52 launch pairs
// and as many selects a forward.  Here tensor t is a column
// matrix [rows, cols] whose element (r, c) is x[r * cols + c]: channel
// buckets [n / c_out, c_out], split buckets [bucket_size, ceil(n /
// bucket_size)], where an element past n reads as x[n - 1] (the pad of the
// reference) and is never written, so no padded copy is made.  A chunk is a
// tensor, a tile of kColTile columns and kColGroupRows of its rows; the chunk
// table depends only on the shapes (the wrapper builds it once and keeps it
// on the device), and each tensor's chunks are its column tiles in order,
// each tile's row chunks consecutive.  Pass 1 writes each chunk's per-column
// (min, max); pass 2, walking the chunks backwards (its first reads find
// pass 1's last in L2), reduces its tile's partials in a fixed order and
// quantizes its chunk.  With `select` (the bucket routes) a tensor whose
// bits are >= 32 is copied instead (the select, whose gradient is the
// identity either way) and pass 1 skips it; without it (the per-site bucket
// ops, a group of one) every tensor is quantized, 32 bits included, as the
// reference's per-site ops do.  Bound: bytes, each element read twice and
// written once; a warp reads and writes one row's 32 columns, 128
// consecutive bytes.  The arithmetic is quantize(), so each tensor's result
// equals the plain version on its column view bit for bit.

constexpr int kColGroupRows = 512;  // rows of a chunk: 16K elements at 32 columns
constexpr int kColUnroll = 8;       // rows a thread loads before it uses them

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

// One tensor of a column group.
struct ColumnEntry {
  const float* x;
  int64_t out_offset;   // of its output in the flat output, a multiple of 4
  int64_t n;            // its elements
  int64_t rows, cols;   // its column view
  int64_t first_chunk;
  int64_t row_chunks;   // chunks of a column tile: ceil(rows / kColGroupRows)
};

// Chunk c's tensor entry, first column and row range.
struct ColumnChunk {
  int t;
  ColumnEntry e;
  int64_t col, r0, r1, first_partial;
};

__device__ __forceinline__ ColumnChunk column_chunk(const ColumnEntry* entries,
                                                    const int* chunk_tensor, int c) {
  ColumnChunk ch;
  ch.t = chunk_tensor[c];
  ch.e = entries[ch.t];
  const int64_t local = c - ch.e.first_chunk;
  const int64_t tile = local / ch.e.row_chunks;
  ch.col = tile * kColTile + threadIdx.x;
  ch.r0 = (local % ch.e.row_chunks) * kColGroupRows;
  ch.r1 = ch.r0 + kColGroupRows < ch.e.rows ? ch.r0 + kColGroupRows : ch.e.rows;
  ch.first_partial = ch.e.first_chunk + tile * ch.e.row_chunks;
  return ch;
}

__global__ void __launch_bounds__(kColTile * kRowWarps)
column_group_partials(const ColumnEntry* __restrict__ entries, const int* __restrict__ chunk_tensor,
                      const float* __restrict__ bits, int select,
                      float2* __restrict__ partials) {
  const int c = blockIdx.x;
  const ColumnChunk ch = column_chunk(entries, chunk_tensor, c);
  if (select && bits[ch.t] >= 32.0f) return;  // copied in pass 2; no partial is read
  float lo = FLT_MAX, hi = -FLT_MAX;
  if (ch.col < ch.e.cols) {
    const float pad = ch.e.x[ch.e.n - 1];
    for (int64_t r = ch.r0 + threadIdx.y; r < ch.r1; r += kRowWarps * kColUnroll) {
      float f[kColUnroll];
#pragma unroll
      for (int u = 0; u < kColUnroll; ++u) {  // past n: the pad; past the chunk: row r again
        const int64_t row = r + u * kRowWarps, i = row * ch.e.cols + ch.col;
        f[u] = row >= ch.r1 ? f[0] : i < ch.e.n ? ch.e.x[i] : pad;
      }
#pragma unroll
      for (int u = 0; u < kColUnroll; ++u) {
        lo = fminf(lo, f[u]);
        hi = fmaxf(hi, f[u]);
      }
    }
  }
  column_minmax(lo, hi);
  if (threadIdx.y == 0) partials[c * static_cast<int64_t>(kColTile) + threadIdx.x] =
      make_float2(lo, hi);
}

__global__ void __launch_bounds__(kColTile * kRowWarps)
column_group_quantize(const ColumnEntry* __restrict__ entries, const int* __restrict__ chunk_tensor,
                      const float* __restrict__ bits, int select,
                      const float2* __restrict__ partials, float* __restrict__ out) {
  const int c = gridDim.x - 1 - blockIdx.x;  // the reverse of pass 1's order
  const ColumnChunk ch = column_chunk(entries, chunk_tensor, c);
  const bool active = ch.col < ch.e.cols;
  const bool copy = select && bits[ch.t] >= 32.0f;
  float alpha = 0.0f, beta = 0.0f, k = 0.0f;
  if (!copy) {  // uniform across the block: column_minmax's barrier is safe
    float lo = FLT_MAX, hi = -FLT_MAX;
    if (active) {
      for (int64_t j = threadIdx.y; j < ch.e.row_chunks; j += kRowWarps) {
        const float2 p = partials[(ch.first_partial + j) * kColTile + threadIdx.x];
        lo = fminf(lo, p.x);
        hi = fmaxf(hi, p.y);
      }
    }
    column_minmax(lo, hi);
    alpha = __fadd_rn(__fsub_rn(hi, lo), kEps);
    beta = lo;
    k = levels(bits + ch.t);
  }
  if (!active) return;
  float* o = out + ch.e.out_offset;
  for (int64_t r = ch.r0 + threadIdx.y; r < ch.r1; r += kRowWarps * kColUnroll) {
    float f[kColUnroll];
#pragma unroll
    for (int u = 0; u < kColUnroll; ++u) {
      const int64_t row = r + u * kRowWarps, i = row * ch.e.cols + ch.col;
      if (row < ch.r1 && i < ch.e.n) f[u] = ch.e.x[i];
    }
#pragma unroll
    for (int u = 0; u < kColUnroll; ++u) {
      const int64_t row = r + u * kRowWarps, i = row * ch.e.cols + ch.col;
      if (row < ch.r1 && i < ch.e.n) o[i] = copy ? f[u] : quantize(f[u], alpha, beta, k);
    }
  }
}

}  // namespace

extern "C" {

// x, out: n elements of fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1), n >= 1,
// dense in memory.  scratch: pf_fake_quant_tensor_scratch_bytes() on the
// device, zeroed before its first use and used by one stream at a time.
// bits: one fp32 on the device.  select: copy x where bits >= 32.  Runs on
// the current device, which must hold x, out, scratch and stream.
int pf_fake_quant_tensor(const void* x, void* out, int64_t n, int is_bf16, void* scratch,
                         const float* bits, int select, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  TensorScratch* sc = static_cast<TensorScratch*>(scratch);
  if (is_bf16) return launch_tensor<__nv_bfloat16>(x, out, n, sc, bits, select, s);
  return launch_tensor<float>(x, out, n, sc, bits, select, s);
}

int pf_fake_quant_tensor_scratch_bytes() { return static_cast<int>(sizeof(TensorScratch)); }

// The global-range route, pass 1: x, n, is_bf16, scratch, bits and select as
// for pf_fake_quant_tensor; neg_range: two fp32 on the device, set to
// (-min(x), max(x)) (left as they are where select and bits >= 32).
int pf_fake_quant_tensor_minmax(const void* x, int64_t n, int is_bf16, void* scratch,
                                const float* bits, int select, float* neg_range, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  TensorScratch* sc = static_cast<TensorScratch*>(scratch);
  float2* r = reinterpret_cast<float2*>(neg_range);
  if (is_bf16) return launch_minmax<__nv_bfloat16>(x, n, sc, bits, select, r, s);
  return launch_minmax<float>(x, n, sc, bits, select, r, s);
}

// The global-range route, pass 2: out = the fake-quant of x against the
// range (-neg_range[0], neg_range[1]) (two fp32 on the device, 8-byte
// aligned), which holds every element of x (bf16 reads its outputs from a
// table of the values in the range), or x where select and bits >= 32.
int pf_fake_quant_tensor_from_range(const void* x, void* out, int64_t n, int is_bf16,
                                    const float* neg_range, const float* bits, int select,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* r = reinterpret_cast<const float2*>(neg_range);
  if (is_bf16) return launch_from_range<__nv_bfloat16>(x, out, n, bits, select, r, s);
  return launch_from_range<float>(x, out, n, bits, select, r, s);
}

// A group of T fp32 tensors.  entries: T GroupEntry on the device (x, the
// output's offset in `out` in elements, a multiple of 4; n >= 1; the first
// chunk, tensors in order); chunk_tensor: nchunks ints on the device, the
// tensor of each chunk of kGroupChunk elements (nchunks = the sum of
// ceil(n / kGroupChunk)); bits: T fp32 on the device; partials: scratch of
// nchunks float2; out: 16-byte aligned.
int pf_fake_quant_tensor_group(const void* entries, const int* chunk_tensor, int nchunks,
                               const float* bits, void* partials, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const GroupEntry* e = static_cast<const GroupEntry*>(entries);
  float2* p = static_cast<float2*>(partials);
  group_minmax_partials<<<nchunks, kThreads, 0, s>>>(e, chunk_tensor, bits, p);
  group_quantize<<<nchunks, kThreads, 0, s>>>(e, chunk_tensor, bits, p, out);
  return static_cast<int>(cudaGetLastError());
}

// The model-axis route, pass 1: entries, chunk_tensor, nchunks, bits and
// partials as for pf_fake_quant_tensor_group; neg_ranges: ntensors float2
// on the device, set to each tensor's (-min, max) ((-FLT_MAX, -FLT_MAX)
// where its bits are >= 32).
int pf_fake_quant_tensor_group_minmax(const void* entries, const int* chunk_tensor, int nchunks,
                                      const float* bits, void* partials, int ntensors,
                                      float* neg_ranges, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const GroupEntry* e = static_cast<const GroupEntry*>(entries);
  float2* p = static_cast<float2*>(partials);
  group_minmax_partials<<<nchunks, kThreads, 0, s>>>(e, chunk_tensor, bits, p);
  group_ranges<<<ntensors, kThreads, 0, s>>>(e, bits, p, reinterpret_cast<float2*>(neg_ranges));
  return static_cast<int>(cudaGetLastError());
}

// The model-axis route, pass 2: out as for pf_fake_quant_tensor_group, each
// tensor quantized against (-neg_ranges[2t], neg_ranges[2t + 1]) (8-byte
// aligned fp32 on the device), or copied where its bits are >= 32.
int pf_fake_quant_tensor_group_from_range(const void* entries, const int* chunk_tensor,
                                          int nchunks, const float* bits,
                                          const float* neg_ranges, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const GroupEntry* e = static_cast<const GroupEntry*>(entries);
  group_quantize_from_range<<<nchunks, kThreads, 0, s>>>(
      e, chunk_tensor, bits, reinterpret_cast<const float2*>(neg_ranges), out);
  return static_cast<int>(cudaGetLastError());
}

int pf_fake_quant_group_chunk() { return kGroupChunk; }

// A group of T fp32 column matrices.  entries: T ColumnEntry on the device
// (x; the output's offset in `out` in elements, a multiple of 4; n >= 1;
// rows, cols >= 1 with rows * cols >= n; the first chunk and the row chunks
// of a column tile, tensors in order); chunk_tensor: nchunks ints on the
// device, the tensor of each chunk (nchunks = the sum of ceil(cols /
// kColTile) * ceil(rows / kColGroupRows)); bits: T fp32 on the device;
// select: copy the tensors whose bits are >= 32; partials: scratch of
// nchunks * kColTile float2; out: 16-byte aligned.
int pf_fake_quant_columns_group(const void* entries, const int* chunk_tensor, int nchunks,
                                const float* bits, int select, void* partials, float* out,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ColumnEntry* e = static_cast<const ColumnEntry*>(entries);
  float2* p = static_cast<float2*>(partials);
  const dim3 block(kColTile, kRowWarps);
  column_group_partials<<<nchunks, block, 0, s>>>(e, chunk_tensor, bits, select, p);
  column_group_quantize<<<nchunks, block, 0, s>>>(e, chunk_tensor, bits, select, p, out);
  return static_cast<int>(cudaGetLastError());
}

// The constants the wrapper lays its tables out by.
int pf_fake_quant_column_group_rows() { return kColGroupRows; }
int pf_fake_quant_column_tile() { return kColTile; }
int pf_fake_quant_column_entry_bytes() { return static_cast<int>(sizeof(ColumnEntry)); }

}  // extern "C"
