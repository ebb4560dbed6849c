// Ragged paged attention for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernels paddle_tpu/kernels/paged_attention_pallas.py:37
// (`_kernel`, launched by `_ragged_paged_attention_x32`) and, over
// quantized pools, :102 (`_kernel_quant`). Same function:
//
//   q [S, QB, NH, HD]; k_pool, v_pool [NP, PS, NH, HD];
//   block_tables [S, MP] int32; kv_lens [S] int32; q_lens [S] int32.
//   Quantized pools hold int8 or float8 e4m3 codes with per-page-per-head
//   float32 scales k_scale, v_scale [NP, NH]: position p of page g, head
//   h, reads as float(code) * scale[g * NH + h] (quantization/kv.py).
//   Query row j of slot s sits at position kv_lens[s] - q_lens[s] + j and
//   attends positions < min(L, L - q_len + 1 + j) (L = kv_lens[s]);
//   padding rows (j >= q_len) attend the whole extent so they stay
//   finite; kv_len 0 gives zeros. Pages past kv_len are never read.
//   out [S, QB, NH, HD] in q's type; all arithmetic in float32.
//
// What bounds it on this card: bytes. Each layer's K and V stream once,
// sum(kv_len) x NH x HD elements each, against 2 x HD multiply-adds per
// element and query row — a few operations per byte at decode (q_len 1),
// far below the ~295 operations per byte at which the H100's tensor cores
// would become the limit. What the design does about it: every K/V
// element is read from device memory exactly once per (slot, head, row
// tile), only for pages below the block's largest causal limit, by
// neighbouring threads on neighbouring addresses (a page row of one head
// is HD contiguous values), and nothing but the output is written — the
// scores, the running max/sum and the accumulator live in shared memory.
//
// The TPU kernel's grid walked (slot, page) in order and carried its
// running softmax across grid steps in VMEM scratch; here one block owns
// one (row tile, head, slot) and walks the slot's pages in a loop, in
// tiles of kTile positions, and loads its own block-table row and lengths
// (what scalar prefetch did on the TPU). A simple first design: no
// wgmma, no TMA, no split over the KV extent.
//
// Over a quantized pool the bytes streamed halve against bf16 (one byte a
// code, plus two floats a page and head). The codes never reach device
// memory in float: the block reads the scales of a tile's pages once into
// shared memory, then reads the codes four to a 32-bit word (a page row
// of one head is HD contiguous bytes, so neighbouring threads read
// neighbouring words) and widens each to float32 times its page's scale
// as it stores the tile — the same single multiply the plain version
// does, so the staged values are bit-identical to its dequantized pages.
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kRows = 16;      // query rows per block
constexpr int kTile = 64;      // KV positions staged in shared memory

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// one code byte -> float32, exact for both formats
template <typename KVT>
__device__ __forceinline__ float code_f32(uint32_t byte);
template <>
__device__ __forceinline__ float code_f32<int8_t>(uint32_t byte) {
  return (float)(int8_t)(uint8_t)byte;
}
template <>
__device__ __forceinline__ float code_f32<__nv_fp8_e4m3>(uint32_t byte) {
  __nv_fp8_e4m3 v;
  v.__x = (__nv_fp8_storage_t)byte;
  return (float)v;
}

// int8 and float8 codes: the pool types of one byte
template <typename KVT>
struct IsQuant {
  static constexpr bool value = sizeof(KVT) == 1;
};

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int row_limit(int j, int L, int qn) {
  return j < qn ? min(L, L - qn + 1 + j) : L;
}

// a tile of kTile positions spans at most kTile + 1 pages (PS >= 1)
constexpr int kTilePages = kTile + 1;

size_t smem_bytes(int HD, bool quant) {
  const size_t floats = (size_t)kRows * HD          // q tile (pre-scaled)
                        + (size_t)kTile * (HD + 1)  // K tile, padded rows
                        + (size_t)kTile * HD        // V tile
                        + (size_t)kRows * kTile     // scores / probabilities
                        + (size_t)kRows * HD        // accumulator
                        + 3 * kRows                 // running max, sum, alpha
                        + (quant ? 2 * kTilePages : 0);  // page scales
  return floats * sizeof(float) + kRows * sizeof(int);
}

template <typename QT, typename KVT>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attention_kernel(const QT* __restrict__ q,
                              const KVT* __restrict__ k_pool,
                              const KVT* __restrict__ v_pool,
                              const float* __restrict__ k_scale,
                              const float* __restrict__ v_scale,
                              const int* __restrict__ block_tables,
                              const int* __restrict__ kv_lens,
                              const int* __restrict__ q_lens,
                              QT* __restrict__ out, int QB, int NH, int HD,
                              int PS, int MP, float scale, int words) {
  extern __shared__ float smem[];
  const int row0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int s = blockIdx.z;
  const int rows = min(kRows, QB - row0);
  const int kstride = HD + 1;  // odd stride: the score loop reads K rows
                               // of different positions without bank
                               // conflicts
  float* sq = smem;
  float* sk = sq + kRows * HD;
  float* sv = sk + kTile * kstride;
  float* sp = sv + kTile * HD;
  float* sacc = sp + kRows * kTile;
  float* sm = sacc + kRows * HD;
  float* sl = sm + kRows;
  float* salpha = sl + kRows;
  int* slimit = reinterpret_cast<int*>(salpha + kRows);
  float* sks = reinterpret_cast<float*>(slimit + kRows);  // quantized only
  float* svs = sks + kTilePages;

  const int tid = threadIdx.x;
  const int L = min(kv_lens[s], MP * PS);
  const int qn = q_lens[s];
  const size_t head_stride = (size_t)NH * HD;  // one position of one slot
  const size_t q_base = ((size_t)s * QB + row0) * head_stride + (size_t)h * HD;

  if (L <= 0) {  // idle slot: zeros, nothing read
    for (int i = tid; i < rows * HD; i += kThreads) {
      const int r = i / HD, d = i - r * HD;
      out[q_base + r * head_stride + d] = from_f32<QT>(0.f);
    }
    return;
  }

  // the largest causal limit among this block's rows bounds the pages read
  int blim = 0;
  for (int r = 0; r < rows; ++r) blim = max(blim, row_limit(row0 + r, L, qn));

  for (int i = tid; i < rows * HD; i += kThreads) {
    const int r = i / HD, d = i - r * HD;
    sq[i] = to_f32(q[q_base + r * head_stride + d]) * scale;
    sacc[i] = 0.f;
  }
  if (tid < rows) {
    sm[tid] = -INFINITY;
    sl[tid] = 0.f;
    slimit[tid] = row_limit(row0 + tid, L, qn);
  }
  __syncthreads();

  const int* bt = block_tables + (size_t)s * MP;
  const int warp = tid >> 5, lane = tid & 31;
  for (int t0 = 0; t0 < blim; t0 += kTile) {
    const int tn = min(kTile, blim - t0);
    // stage the tile's K/V rows of head h, page by page via the table
    if constexpr (IsQuant<KVT>::value) {
      // the scales of the tile's pages, each read once
      const int p0 = t0 / PS;
      const int np = (t0 + tn - 1) / PS - p0 + 1;
      for (int i = tid; i < np; i += kThreads) {
        const size_t g = (size_t)bt[p0 + i] * NH + h;
        sks[i] = k_scale[g];
        svs[i] = v_scale[g];
      }
      __syncthreads();
      const uint8_t* kb = reinterpret_cast<const uint8_t*>(k_pool);
      const uint8_t* vb = reinterpret_cast<const uint8_t*>(v_pool);
      if (words) {  // HD % 4 == 0 and 4-byte aligned pools: 4 codes a load
        const int W = HD >> 2;
        for (int i = tid; i < tn * W; i += kThreads) {
          const int t = i / W, w = i - t * W;
          const int pos = t0 + t;
          const int page = bt[pos / PS];
          const size_t off = ((size_t)page * PS + (pos % PS)) * head_stride +
                             (size_t)h * HD + 4 * w;
          const float ks = sks[pos / PS - p0], vs = svs[pos / PS - p0];
          const uint32_t kw = *reinterpret_cast<const uint32_t*>(kb + off);
          const uint32_t vw = *reinterpret_cast<const uint32_t*>(vb + off);
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            sk[t * kstride + 4 * w + b] =
                code_f32<KVT>((kw >> (8 * b)) & 0xffu) * ks;
            sv[t * HD + 4 * w + b] =
                code_f32<KVT>((vw >> (8 * b)) & 0xffu) * vs;
          }
        }
      } else {
        for (int i = tid; i < tn * HD; i += kThreads) {
          const int t = i / HD, d = i - t * HD;
          const int pos = t0 + t;
          const int page = bt[pos / PS];
          const size_t off = ((size_t)page * PS + (pos % PS)) * head_stride +
                             (size_t)h * HD + d;
          sk[t * kstride + d] = code_f32<KVT>(kb[off]) * sks[pos / PS - p0];
          sv[t * HD + d] = code_f32<KVT>(vb[off]) * svs[pos / PS - p0];
        }
      }
    } else {
      for (int i = tid; i < tn * HD; i += kThreads) {
        const int t = i / HD, d = i - t * HD;
        const int pos = t0 + t;
        const int page = bt[pos / PS];
        const size_t off =
            ((size_t)page * PS + (pos % PS)) * head_stride + (size_t)h * HD + d;
        sk[t * kstride + d] = to_f32(k_pool[off]);
        sv[t * HD + d] = to_f32(v_pool[off]);
      }
    }
    __syncthreads();
    // scores, masked per row at its causal limit
    for (int i = tid; i < rows * kTile; i += kThreads) {
      const int r = i / kTile, t = i - r * kTile;
      float sc = -INFINITY;
      if (t < tn && t0 + t < slimit[r]) {
        const float* qr = sq + r * HD;
        const float* kr = sk + t * kstride;
        float a = 0.f;
        for (int d = 0; d < HD; ++d) a = fmaf(qr[d], kr[d], a);
        sc = a;
      }
      sp[i] = sc;
    }
    __syncthreads();
    // online softmax, one warp per row
    for (int r = warp; r < rows; r += kThreads / 32) {
      float* pr = sp + r * kTile;
      float mx = -INFINITY;
      for (int t = lane; t < kTile; t += 32) mx = fmaxf(mx, pr[t]);
      mx = warp_max(mx);
      const float m_old = sm[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < kTile; t += 32) {
        const float p = pr[t] == -INFINITY ? 0.f : expf(pr[t] - m_new);
        pr[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
        sl[r] = sl[r] * alpha + sum;
        sm[r] = m_new;
        salpha[r] = alpha;
      }
    }
    __syncthreads();
    // acc = acc * alpha + P @ V
    for (int i = tid; i < rows * HD; i += kThreads) {
      const int r = i / HD, d = i - r * HD;
      const float* pr = sp + r * kTile;
      float a = sacc[i] * salpha[r];
      for (int t = 0; t < tn; ++t) a = fmaf(pr[t], sv[t * HD + d], a);
      sacc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < rows * HD; i += kThreads) {
    const int r = i / HD, d = i - r * HD;
    const float l = sl[r];
    out[q_base + r * head_stride + d] = from_f32<QT>(l > 0.f ? sacc[i] / l : 0.f);
  }
}

template <typename QT, typename KVT>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const float* k_scale, const float* v_scale,
           const void* block_tables, const void* kv_lens, const void* q_lens,
           void* out, int S, int QB, int NH, int HD, int PS, int MP,
           float scale, cudaStream_t stream) {
  const bool quant = IsQuant<KVT>::value;
  if (quant != (k_scale != nullptr && v_scale != nullptr))
    return (int)cudaErrorInvalidValue;  // scales exactly for int8/fp8 pools
  const int words = quant && HD % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(k_pool) % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(v_pool) % 4 == 0;
  const size_t smem = smem_bytes(HD, quant);
  auto kern = ragged_paged_attention_kernel<QT, KVT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((QB + kRows - 1) / kRows, NH, S);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k_pool),
      static_cast<const KVT*>(v_pool), k_scale, v_scale,
      static_cast<const int*>(block_tables),
      static_cast<const int*>(kv_lens), static_cast<const int*>(q_lens),
      static_cast<QT*>(out), QB, NH, HD, PS, MP, scale, words);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: q 0 = float32, 1 = bfloat16; pools those, 2 = int8 codes,
// 3 = float8 e4m3 codes. k_scale/v_scale [NP, NH] float32 for the int8
// and fp8 pools, null otherwise. Returns cudaGetLastError() after the
// launch (0 = launched), or cudaErrorInvalidValue for a dtype pair or
// scale pointers it does not take.
extern "C" int paged_attention_forward(int q_dtype, int kv_dtype, const void* q,
                                       const void* k_pool, const void* v_pool,
                                       const float* k_scale,
                                       const float* v_scale,
                                       const void* block_tables,
                                       const void* kv_lens, const void* q_lens,
                                       void* out, int S, int QB, int NH, int HD,
                                       int PS, int MP, float scale,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PA_LAUNCH(QT, KVT)                                                    \
  return launch<QT, KVT>(q, k_pool, v_pool, k_scale, v_scale, block_tables, \
                         kv_lens, q_lens, out, S, QB, NH, HD, PS, MP, scale, \
                         st)
  if (q_dtype == 0 && kv_dtype == 0) PA_LAUNCH(float, float);
  if (q_dtype == 1 && kv_dtype == 1) PA_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  if (q_dtype == 0 && kv_dtype == 1) PA_LAUNCH(float, __nv_bfloat16);
  if (q_dtype == 1 && kv_dtype == 0) PA_LAUNCH(__nv_bfloat16, float);
  if (q_dtype == 0 && kv_dtype == 2) PA_LAUNCH(float, int8_t);
  if (q_dtype == 1 && kv_dtype == 2) PA_LAUNCH(__nv_bfloat16, int8_t);
  if (q_dtype == 0 && kv_dtype == 3) PA_LAUNCH(float, __nv_fp8_e4m3);
  if (q_dtype == 1 && kv_dtype == 3) PA_LAUNCH(__nv_bfloat16, __nv_fp8_e4m3);
#undef PA_LAUNCH
  return (int)cudaErrorInvalidValue;
}
