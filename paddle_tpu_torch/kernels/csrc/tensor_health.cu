// Tensor health statistics for Hopper (sm_90a), CUDA C++.
//
// Replaces no TPU kernel. The reference computes the same pass inside its
// compiled train step (paddle_tpu/observability/numerics.py:66-98,
// tensor_stats / stats_tree), where XLA fuses the five reductions of each
// tensor into one pass over it. An eager PyTorch step has no such fusion:
// the plain version (kernels/tensor_health.py, tensor_health_ref) runs
// about eight small kernels a tensor, some 1,200 launches for GPT-2
// small's 148 gradients. This file does the whole list in one launch pair.
//
//   Input: a table of n tensors (pointer, numel, dtype: 0 float32, 1
//   bfloat16), contiguous, any size (0 and odd sizes included).
//   Output, one value a tensor, each element read once and widened to
//   float32 first:
//     nan [n] int32        count of NaN
//     inf [n] int32        count of +-Inf
//     absmax [n] float32   max |x|; NaN when the tensor holds a NaN (the
//                          reference's jnp.max propagates it; fmaxf would
//                          drop it, so the count decides); 0 when empty
//     sq_sum [n] float32   sum of x * x
//     zero_frac [n] f32    exact-zero count / numel, divided in double and
//                          rounded once (the reference's float32 mean may
//                          differ in the last bit); NaN when empty, as the
//                          mean of nothing
//
// What bounds it on this card: bytes. Each element is read once for a few
// compares, a max and a multiply-add, under one operation a byte; GPT-2
// small's float32 gradients are 498 MB, 0.149 ms at 3.35 TB/s.
//
// Design (simple and deterministic):
// - The table travels by value as a __grid_constant__ kernel parameter
//   (no host-to-device copy, so no stream sync): at most kMaxTensors
//   tensors a launch, which keeps the parameter block under the classic
//   4 KB; the wrapper cuts longer lists into several launches.
// - tensor_health_partial_kernel: one block a chunk of kChunk elements of
//   one tensor (a block finds its tensor by binary search over the chunk
//   prefix). 16-byte loads where the chunk is 16-byte aligned (4 float32
//   or 8 bfloat16 values), scalar loads for the rest; each thread keeps
//   its five running values, then a warp-shuffle and shared-memory tree
//   gives the chunk's partials, written to a scratch array.
// - tensor_health_reduce_kernel: one block a tensor sums its chunks'
//   partials in a fixed order (a strided serial pass, then a shared-memory
//   tree; sq_sum in double), with no atomics, so two launches give the
//   same bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTensors = 160;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8192;

struct Table {
  const void* ptr[kMaxTensors];
  long long numel[kMaxTensors];
  int chunk_start[kMaxTensors + 1];  // chunk_start[n] = the launch's chunks
  unsigned char dtype[kMaxTensors];  // 0 float32, 1 bfloat16
  int n;
};

struct Acc {
  int nan, inf, zero;
  float amax, sq;
};

__device__ __forceinline__ void take(Acc& a, float v) {
  a.nan += isnan(v) ? 1 : 0;
  a.inf += isinf(v) ? 1 : 0;
  a.zero += (v == 0.0f) ? 1 : 0;
  a.amax = fmaxf(a.amax, fabsf(v));  // drops NaN: the count carries it
  a.sq = fmaf(v, v, a.sq);
}

// a bfloat16 is the high half of a float32
__device__ __forceinline__ float bf16_lo(unsigned int w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned int w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ void take_bf16x2(Acc& a, unsigned int w) {
  take(a, bf16_lo(w));
  take(a, bf16_hi(w));
}

__device__ __forceinline__ void warp_reduce(Acc& a) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a.nan += __shfl_xor_sync(0xffffffffu, a.nan, o);
    a.inf += __shfl_xor_sync(0xffffffffu, a.inf, o);
    a.zero += __shfl_xor_sync(0xffffffffu, a.zero, o);
    a.amax = fmaxf(a.amax, __shfl_xor_sync(0xffffffffu, a.amax, o));
    a.sq += __shfl_xor_sync(0xffffffffu, a.sq, o);
  }
}

__global__ void __launch_bounds__(kThreads)
    tensor_health_partial_kernel(const __grid_constant__ Table t, int* __restrict__ p_cnt,
                                 float* __restrict__ p_f, int total) {
  const int c = blockIdx.x;
  // the last tensor whose first chunk is at or before c (an empty tensor
  // owns no chunk, so the search passes over it)
  int lo = 0, hi = t.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.chunk_start[mid] <= c)
      lo = mid;
    else
      hi = mid - 1;
  }
  const long long start = (long long)(c - t.chunk_start[lo]) * kChunk;
  const long long end = min(start + (long long)kChunk, t.numel[lo]);
  const int len = (int)(end - start);
  Acc a = {0, 0, 0, 0.0f, 0.0f};
  if (t.dtype[lo] == 0) {
    const float* p = static_cast<const float*>(t.ptr[lo]) + start;
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(p) & 15u) == 0) {
      const int nv = len >> 2;
      const float4* p4 = reinterpret_cast<const float4*>(p);
      for (int i = threadIdx.x; i < nv; i += kThreads) {
        const float4 v = __ldg(p4 + i);
        take(a, v.x);
        take(a, v.y);
        take(a, v.z);
        take(a, v.w);
      }
      done = nv << 2;
    }
    for (int i = done + threadIdx.x; i < len; i += kThreads) take(a, __ldg(p + i));
  } else {
    const unsigned short* p = static_cast<const unsigned short*>(t.ptr[lo]) + start;
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(p) & 15u) == 0) {
      const int nv = len >> 3;
      const uint4* p8 = reinterpret_cast<const uint4*>(p);
      for (int i = threadIdx.x; i < nv; i += kThreads) {
        const uint4 w = __ldg(p8 + i);
        take_bf16x2(a, w.x);
        take_bf16x2(a, w.y);
        take_bf16x2(a, w.z);
        take_bf16x2(a, w.w);
      }
      done = nv << 3;
    }
    for (int i = done + threadIdx.x; i < len; i += kThreads)
      take(a, bf16_lo((unsigned int)__ldg(p + i)));
  }
  warp_reduce(a);
  __shared__ Acc s[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) s[warp] = a;
  __syncthreads();
  if (warp == 0) {
    Acc b = {0, 0, 0, 0.0f, 0.0f};
    if (lane < kWarps) b = s[lane];
    warp_reduce(b);
    if (lane == 0) {
      p_cnt[c] = b.nan;
      p_cnt[total + c] = b.inf;
      p_cnt[2 * total + c] = b.zero;
      p_f[c] = b.amax;
      p_f[total + c] = b.sq;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    tensor_health_reduce_kernel(const __grid_constant__ Table t, const int* __restrict__ p_cnt,
                                const float* __restrict__ p_f, int total, int* __restrict__ out_nan,
                                int* __restrict__ out_inf, float* __restrict__ out_absmax,
                                float* __restrict__ out_sq, float* __restrict__ out_zero_frac) {
  const int i = blockIdx.x;
  const int c0 = t.chunk_start[i], c1 = t.chunk_start[i + 1];
  long long nan = 0, inf = 0, zero = 0;
  float amax = 0.0f;
  double sq = 0.0;
  for (int c = c0 + threadIdx.x; c < c1; c += kThreads) {
    nan += p_cnt[c];
    inf += p_cnt[total + c];
    zero += p_cnt[2 * total + c];
    amax = fmaxf(amax, p_f[c]);
    sq += (double)p_f[total + c];
  }
  __shared__ long long s_nan[kThreads], s_inf[kThreads], s_zero[kThreads];
  __shared__ float s_amax[kThreads];
  __shared__ double s_sq[kThreads];
  const int tid = threadIdx.x;
  s_nan[tid] = nan;
  s_inf[tid] = inf;
  s_zero[tid] = zero;
  s_amax[tid] = amax;
  s_sq[tid] = sq;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (tid < h) {
      s_nan[tid] += s_nan[tid + h];
      s_inf[tid] += s_inf[tid + h];
      s_zero[tid] += s_zero[tid + h];
      s_amax[tid] = fmaxf(s_amax[tid], s_amax[tid + h]);
      s_sq[tid] += s_sq[tid + h];
    }
    __syncthreads();
  }
  if (tid == 0) {
    const long long numel = t.numel[i];
    const float qnan = __int_as_float(0x7fc00000);
    out_nan[i] = (int)min(s_nan[0], 2147483647LL);
    out_inf[i] = (int)min(s_inf[0], 2147483647LL);
    out_absmax[i] = s_nan[0] > 0 ? qnan : s_amax[0];
    out_sq[i] = (float)s_sq[0];
    out_zero_frac[i] = numel > 0 ? (float)((double)s_zero[0] / (double)numel) : qnan;
  }
}

}  // namespace

extern "C" int tensor_health_max_tensors() { return kMaxTensors; }

extern "C" int tensor_health_chunk() { return kChunk; }

// One launch pair over n <= kMaxTensors tensors. p_cnt [3 * total] int32
// and p_f [2 * total] float32 are the wrapper's scratch, total the chunk
// count it computed (sum of ceil(numel / kChunk)); the outputs are n
// values each. Returns a CUDA error code, 0 when both launches went in.
extern "C" int tensor_health(const void* const* ptrs, const long long* numels, const int* dtypes,
                             int n, int* p_cnt, float* p_f, int total, int* out_nan,
                             int* out_inf, float* out_absmax, float* out_sq,
                             float* out_zero_frac, void* stream) {
  if (n < 1 || n > kMaxTensors || total < 0) return (int)cudaErrorInvalidValue;
  Table t;
  t.n = n;
  long long chunks = 0;
  for (int i = 0; i < n; ++i) {
    if (numels[i] < 0 || (dtypes[i] != 0 && dtypes[i] != 1) ||
        (numels[i] > 0 && ptrs[i] == nullptr))
      return (int)cudaErrorInvalidValue;
    t.ptr[i] = ptrs[i];
    t.numel[i] = numels[i];
    t.dtype[i] = (unsigned char)dtypes[i];
    t.chunk_start[i] = (int)chunks;
    chunks += (numels[i] + kChunk - 1) / kChunk;
    if (chunks > 2147483647LL) return (int)cudaErrorInvalidValue;
  }
  t.chunk_start[n] = (int)chunks;
  if (chunks != total || (total > 0 && (p_cnt == nullptr || p_f == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (total > 0) {
    tensor_health_partial_kernel<<<total, kThreads, 0, st>>>(t, p_cnt, p_f, total);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  tensor_health_reduce_kernel<<<n, kThreads, 0, st>>>(t, p_cnt, p_f, total, out_nan, out_inf,
                                                      out_absmax, out_sq, out_zero_frac);
  return (int)cudaGetLastError();
}
