// Ragged paged attention for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernels paddle_tpu/kernels/paged_attention_pallas.py:37
// (`_kernel`, launched by `_ragged_paged_attention_x32`) and, over quantized
// pools, :102 (`_kernel_quant`); both are ragged_paged_attention_split_kernel
// and its merge, with ragged_paged_attention_kernel for what the wrapper
// does not route to them. Same function:
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
// element and query row: about 1 operation a byte at decode (q_len 1), ~30
// at a 32-row prefill chunk, far below the ~295 operations per byte at
// which the H100's tensor cores would become the limit. At GPT-2 small's
// decode shape (8 slots, 12 heads of 64, bf16, extents 47-590) the bytes
// are 8.3 MB: 2.5 us at 3.35 TB/s.
//
// Two designs, chosen in kernels/paged_attention.py (split_kv):
// - ragged_paged_attention_split_kernel + ragged_paged_attention_merge_kernel,
//   for float32 and bfloat16 pools (HD % 8 == 0, 16-byte aligned) and for
//   int8 code pools (HD % 16 == 0, 16-byte aligned). Its code-pool entry
//   takes float8 codes as well, which the wrapper keeps on the first
//   design: the engine requantizes the pages it writes, and over fp8
//   codes this design's float32 rounding moves its logits past the
//   card's parity check at the check's request seed, a check the first
//   design fails at 3 of 6 seeds (PERF.md Findings). Spend
//   everything on moving K/V once, 16 bytes a thread, with many loads in
//   flight and the grid filling the card.
//   * Split over the KV extent. The first design (below) gave each
//     (slot, head, row tile) one block that walked the slot's extent
//     alone: 96 blocks on 132 SMs at decode, the longest slot setting the
//     time. Here the grid is (KV split x row tile, head, slot): the
//     wrapper cuts the extent MP x PS into splits of whole pages (128
//     positions at the decode shape: 26 live (slot, split) pairs x 12
//     heads = 312 blocks); a block past its rows' causal limits exits at
//     once. Each split writes its partial (m, l, acc[HD]) in float32 to a
//     workspace the wrapper allocates; the merge kernel combines a row's
//     live splits in split order, so two launches give the same bits (no
//     atomics). It is launched as a programmatic dependent of the split
//     kernel (griddepcontrol), so its launch overlaps the split kernel's
//     tail. With one split the block writes the output itself.
//   * Loads. The block reads its split's block-table entries once into
//     shared memory (over a code pool with its pages' K and V scales for
//     the head), then moves tiles of K and V (a head's page row is HD
//     contiguous values: 128 bytes at HD 64 bf16, 64 at HD 64 int8) with
//     16-byte cp.async.cg into a 4-stage ring, 3 tiles in flight while one
//     computes, one __syncthreads a tile. The copies move bytes, not
//     values: over a code pool each copy carries 16 codes, widened to
//     float32 times the page's scale as the stage is read (int8: one I2F
//     a code; fp8: cvt of two codes to a half2, then to floats, both
//     exact), the single multiply of the plain version (__fmul_rn, never
//     fused), so the values are bit-identical to its dequantized pages.
//   * Arithmetic, all in float32 and the same over float and code pools:
//     q pre-scaled in registers, the correctly rounded expf (as the first
//     design and the TPU kernel's jnp.exp; the __expf intrinsic, up to ~2
//     ulp and more at large arguments, put this design further from the
//     plain version than the first design at all six request seeds of the
//     int8 parity check, PERF.md Findings). A group of G lanes owns one position of
//     the tile: a partial dot over its values, log2(G) shuffles, then an
//     online softmax of its own, P V in registers. G = 8 for float pools;
//     a code row of at most 4 units (HD <= 64: 64 bytes) would leave half
//     of 8 lanes idle, so code pools there take G = 4: 8 groups a warp,
//     32-position stages. At decode (QB = 1) the stage's positions go to the block's groups; for QB > 1
//     each warp takes 4 (or, with more values a lane, fewer) rows and its
//     groups walk the stage in 4 steps, so one staged tile serves all the
//     CTA's rows. The groups merge by shuffles, the warps of a decode
//     block through shared memory once at the end.
//   * Tried (PERF.md Findings): the first design's loads (one 2-byte
//     element a thread, widened into shared memory, no copy in flight)
//     and its serial 64-long dot products; a ring of 6 or 8 stages (no
//     faster than 4 at these extents); 32-, 64- and 256-position splits
//     at decode (128 was the fastest; the prefill chunk, one slot, is
//     fastest at 32, which the wrapper's rule picks). For code pools at
//     HD 64 the alternative to groups of 4 lanes is 8-byte units over
//     groups of 8; groups of 4 keep every copy and every shared-memory
//     read at 16 bytes.
// - ragged_paged_attention_kernel, the first design, for the pools the
//   wrapper does not route to the split design (HD off whole 16-byte
//   units, pools not 16-byte aligned, float8 codes). One block per (row tile of 16, head, slot) walks the
//   slot's pages in tiles of kTile positions, loads its own block-table
//   row and lengths (what scalar prefetch did on the TPU), and keeps
//   scores, running max/sum and accumulator in shared memory. Over a code
//   pool it reads the scales of a tile's pages once into shared memory,
//   then the codes four to a 32-bit word (a page row of one head is HD
//   contiguous bytes, so neighbouring threads read neighbouring words),
//   widening each to float32 times its page's scale as it stores the
//   tile, the same single multiply.
//
// Over a quantized pool the bytes streamed halve against bf16 (one byte a
// code, plus two floats a page and head). The codes never reach device
// memory in float.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
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

// ---------------------------------------------------------------------------
// The split-KV design over float32 / bfloat16 pools (the note above says
// why): ragged_paged_attention_split_kernel writes each split's partial
// (m, l, acc) and ragged_paged_attention_merge_kernel merges them.
// ---------------------------------------------------------------------------
constexpr int kSplitThreads = 128;  // 4 warps of groups of 8 (or 4) lanes
constexpr int kRing = 4;            // ring stages: 3 tiles in flight
constexpr int kMaxSplits = 64;      // splits of the extent the merge takes

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a 16-byte unit of a page row, widened to float32: E values
template <typename KVT>
struct Unit;
template <>
struct Unit<float> {
  static constexpr int E = 4;
  __device__ __forceinline__ static void load(float* f, const unsigned char* p) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
};
template <>
struct Unit<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ __forceinline__ static void load(float* f, const unsigned char* p) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // the low half is the first value
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// 16 one-byte codes, widened to float32 and times the page's scale: the
// single multiply of the plain version (code.float() * scale), never
// contracted into a neighbouring add, so each value is bit-identical to
// the plain version's dequantized page
template <>
struct Unit<int8_t> {
  static constexpr int E = 16;
  __device__ __forceinline__ static void load(float* f, const unsigned char* p, float s) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int b = 0; b < 4; ++b)  // the lowest byte is the first code
        f[4 * i + b] = __fmul_rn((float)(int8_t)(uint8_t)(w[i] >> (8 * b)), s);
  }
};
template <>
struct Unit<__nv_fp8_e4m3> {
  static constexpr int E = 16;
  __device__ __forceinline__ static void load(float* f, const unsigned char* p, float s) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {  // two codes to two halves, then floats: both exact
        const __half2_raw hr = __nv_cvt_fp8x2_to_halfraw2(
            (__nv_fp8x2_storage_t)((w[i] >> (16 * j)) & 0xffffu), __NV_E4M3);
        const float2 x = __half22float2(__half2(hr));
        f[4 * i + 2 * j] = __fmul_rn(x.x, s);
        f[4 * i + 2 * j + 1] = __fmul_rn(x.y, s);
      }
  }
};

// a stage's unit as float32 values: float pools as they are, code pools
// times the page's scale s
template <typename KVT>
__device__ __forceinline__ void stage_unit(float* f, const unsigned char* p, float s) {
  if constexpr (IsQuant<KVT>::value)
    Unit<KVT>::load(f, p, s);
  else
    Unit<KVT>::load(f, p);
}

// A group of G lanes owns one position; a lane holds NU units of a row
// (lane g of its group units g, g + G, ...). G = 8 for every float pool;
// a code pool whose row is at most 4 units (HD <= 64) takes G = 4, so no
// lane of a group idles. A ring stage holds SP positions, one for each
// group of the CTA's 4 warps. DECODE: one query row a CTA, the stage's
// positions spread over all groups; else RW rows a warp, each warp's
// groups walking the stage in 4 steps
template <typename KVT, int NU, int G, bool DECODE>
struct SplitPlan {
  static constexpr int E = Unit<KVT>::E;
  static constexpr int EPL = NU * E;  // values a lane holds of a row
  static constexpr int GPW = 32 / G;  // groups a warp
  static constexpr int SP = 4 * GPW;  // positions a ring stage holds
  static constexpr int RW = DECODE ? 1 : (32 / EPL >= 4 ? 4 : (EPL >= 32 ? 1 : 32 / EPL));
  static constexpr int ROWS = DECODE ? 1 : 4 * RW;  // query rows a CTA
};

// (m, l, acc) of two online softmaxes over disjoint positions, merged
template <int N>
__device__ __forceinline__ void merge_state(float& m, float& l, float (&acc)[N], float mo,
                                            float lo, const float* acco) {
  const float mn = m > mo ? m : mo;
  const float a = m == -INFINITY ? 0.f : expf(m - mn);
  const float b = mo == -INFINITY ? 0.f : expf(mo - mn);
  l = l * a + lo * b;
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = acc[i] * a + acco[i] * b;
  m = mn;
}

// the split's block-table entries (and, over a code pool, its pages' K
// and V scales for the head), rounded up to 16 bytes
__host__ __device__ inline int split_header(int pages, bool quant) {
  return (pages * (quant ? 12 : 4) + 15) / 16 * 16;
}

// the decode block's warps merge (acc, m, l) through shared memory
size_t split_smem(int HD, int kv_bytes, int SL, int PS, int stage_pos, bool decode) {
  return split_header(SL / PS, kv_bytes == 1) + (size_t)kRing * 2 * stage_pos * HD * kv_bytes +
         (decode ? (size_t)4 * (HD + 2) * 4 : 0);
}

template <typename QT, typename KVT, int NU, int G, bool DECODE>
__global__ void __launch_bounds__(kSplitThreads)
ragged_paged_attention_split_kernel(const QT* __restrict__ q, const KVT* __restrict__ k_pool,
                                    const KVT* __restrict__ v_pool,
                                    const float* __restrict__ k_scale,
                                    const float* __restrict__ v_scale,
                                    const int* __restrict__ block_tables,
                                    const int* __restrict__ kv_lens,
                                    const int* __restrict__ q_lens, QT* __restrict__ out,
                                    float* __restrict__ ws, int QB, int NH, int HD, int PS,
                                    int MP, int SL, int nsplit, float scale) {
  using P = SplitPlan<KVT, NU, G, DECODE>;
  constexpr int E = P::E, EPL = P::EPL, RW = P::RW, GPW = P::GPW, SP = P::SP;
  constexpr bool kQuant = IsQuant<KVT>::value;
  extern __shared__ __align__(16) unsigned char psm[];
  // the merge kernel may be scheduled now; it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int split = blockIdx.x % nsplit, rt = blockIdx.x / nsplit;
  const int h = blockIdx.y, s = blockIdx.z, S = gridDim.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane / G, gl = lane % G;  // the lane's group and place in it
  const int row0 = rt * P::ROWS;
  const int L = min(kv_lens[s], MP * PS), qn = q_lens[s];
  const size_t head_stride = (size_t)NH * HD;  // one position of one slot
  const bool direct = ws == nullptr;           // one split: out, not partials

  // positions [p0, p1) of this split that some row of the CTA attends
  int blim = 0;
  if (L > 0)
    for (int r = 0; r < P::ROWS; ++r)
      if (row0 + r < QB) blim = max(blim, row_limit(row0 + r, L, qn));
  const int p0 = split * SL, p1 = min(p0 + SL, blim);
  if (p0 >= p1) {  // past every row's extent: nothing to read
    if (direct)    // (one split: p0 = 0, every row's limit is 0) zeros
      for (int i = tid; i < P::ROWS * HD; i += kSplitThreads) {
        const int r = i / HD, j = row0 + r;
        if (j < QB) out[((size_t)s * QB + j) * head_stride + (size_t)h * HD + i % HD] =
            from_f32<QT>(0.f);
      }
    return;
  }

  // the split's pages of the block table, read once (and over a code pool
  // the K and V scales of those pages for head h)
  int* sbt = reinterpret_cast<int*>(psm);
  float* sks = reinterpret_cast<float*>(sbt + SL / PS);
  float* svs = sks + SL / PS;
  const int pg0 = p0 / PS, npg = (p1 - 1) / PS - pg0 + 1;
  for (int i = tid; i < npg; i += kSplitThreads) {
    const int page = block_tables[(size_t)s * MP + pg0 + i];
    sbt[i] = page;
    if constexpr (kQuant) {
      sks[i] = k_scale[(size_t)page * NH + h];
      svs[i] = v_scale[(size_t)page * NH + h];
    }
  }
  const int RB = HD * (int)sizeof(KVT);  // bytes of one head's page row
  const int U = RB / 16;                 // 16-byte units of a row
  unsigned char* ring = psm + split_header(SL / PS, kQuant);
  const int stage_bytes = 2 * SP * RB;   // K rows, then V rows
  __syncthreads();

  // this thread's share of a tile's copies: K and V rows of positions
  // p0 + SP t + [0, SP), 16 bytes a copy (8 bf16 values, 16 codes),
  // neighbouring threads on neighbouring addresses of a row
  auto load = [&](int t) {
    unsigned char* st = ring + (t % kRing) * stage_bytes;
    const int base = p0 + t * SP;
    for (int i = tid; i < SP * U; i += kSplitThreads) {
      const int pi = i / U, u = i - pi * U;
      const int pos = base + pi;
      if (pos >= p1) break;
      const size_t off = ((size_t)sbt[pos / PS - pg0] * PS + pos % PS) * head_stride +
                         (size_t)h * HD + (size_t)u * E;
      cp_async16(smem_u32(st + pi * RB + u * 16), k_pool + off);
      cp_async16(smem_u32(st + (SP + pi) * RB + u * 16), v_pool + off);
    }
  };
  const int ntiles = (p1 - p0 + SP - 1) / SP;
#pragma unroll
  for (int t = 0; t < kRing - 1; ++t) {
    if (t < ntiles) load(t);
    cp_async_commit();
  }

  // this warp's rows: q in float32, pre-scaled; the causal limits
  float qv[RW][EPL], m[RW], l[RW], acc[RW][EPL];
  int lim[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int j = DECODE ? row0 : row0 + warp * RW + r;
    lim[r] = j < QB ? row_limit(j, L, qn) : 0;
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NU; ++c) {
      const int u = gl + G * c;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        acc[r][c * E + e] = 0.f;
        qv[r][c * E + e] =
            j < QB && u < U
                ? to_f32(q[((size_t)s * QB + j) * head_stride + (size_t)h * HD + u * E + e]) * scale
                : 0.f;
      }
    }
  }

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kRing - 2>();
    __syncthreads();  // tile t landed; every reader of tile t - 1 is done
    if (t + kRing - 1 < ntiles) load(t + kRing - 1);
    cp_async_commit();
    const unsigned char* sk = ring + (t % kRing) * stage_bytes;
    const unsigned char* sv = sk + SP * RB;
#pragma unroll
    for (int step = 0; step < (DECODE ? 1 : 4); ++step) {
      // the group's position: decode spreads the tile over all groups,
      // else each warp's groups walk it in 4 steps
      const int pi = DECODE ? warp * GPW + grp : step * GPW + grp;
      const int pos = p0 + t * SP + pi;
      const bool inside = pos < p1;
      float ks = 1.f, vs = 1.f;  // the position's page scales (code pools)
      if (kQuant && inside) {
        ks = sks[pos / PS - pg0];
        vs = svs[pos / PS - pg0];
      }
      float kf[EPL], vf[EPL];
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        const int u = gl + G * c;
        if (inside && u < U) {
          stage_unit<KVT>(kf + c * E, sk + pi * RB + u * 16, ks);
          stage_unit<KVT>(vf + c * E, sv + pi * RB + u * 16, vs);
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e) kf[c * E + e] = vf[c * E + e] = 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        // the position's score: a partial dot over the lane's values, then
        // the group's G lanes
        float x = 0.f;
#pragma unroll
        for (int i = 0; i < EPL; ++i) x = fmaf(qv[r][i], kf[i], x);
#pragma unroll
        for (int o = 1; o < G; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
        if (inside && pos < lim[r]) {  // online softmax, one position
          if (x > m[r]) {
            const float al = expf(m[r] - x);
            l[r] *= al;
#pragma unroll
            for (int i = 0; i < EPL; ++i) acc[r][i] *= al;
            m[r] = x;
          }
          const float p = expf(x - m[r]);
          l[r] += p;
#pragma unroll
          for (int i = 0; i < EPL; ++i) acc[r][i] = fmaf(p, vf[i], acc[r][i]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // the warp's groups hold disjoint positions of its rows: merge them
#pragma unroll
  for (int o = G; o <= 16; o <<= 1)
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      float acco[EPL];
#pragma unroll
      for (int i = 0; i < EPL; ++i) acco[i] = __shfl_xor_sync(0xffffffffu, acc[r][i], o);
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], o);
      merge_state(m[r], l[r], acc[r], mo, lo, acco);
    }
  if constexpr (DECODE) {  // the 4 warps share the row: merge through smem
    float* sw = reinterpret_cast<float*>(ring + kRing * stage_bytes);
    __syncthreads();
    if (grp == 0) {
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        const int u = gl + G * c;
        if (u < U)
#pragma unroll
          for (int e = 0; e < E; ++e) sw[warp * (HD + 2) + u * E + e] = acc[0][c * E + e];
      }
      if (gl == 0) {
        sw[warp * (HD + 2) + HD] = m[0];
        sw[warp * (HD + 2) + HD + 1] = l[0];
      }
    }
    __syncthreads();
    if (warp != 0) return;
    for (int w = 1; w < 4; ++w) {  // in fixed order
      float acco[EPL];
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        const int u = gl + G * c;
#pragma unroll
        for (int e = 0; e < E; ++e)
          acco[c * E + e] = u < U ? sw[w * (HD + 2) + u * E + e] : 0.f;
      }
      merge_state(m[0], l[0], acc[0], sw[w * (HD + 2) + HD], sw[w * (HD + 2) + HD + 1], acco);
    }
  }
  if (grp != 0) return;  // the first group's lanes write

#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int j = DECODE ? row0 : row0 + warp * RW + r;
    if (j >= QB) continue;
    const size_t row = ((size_t)s * QB + j) * NH + h;  // (s, j, h)
    const size_t wrow = row * nsplit + split;
    const size_t R = (size_t)S * QB * NH;
#pragma unroll
    for (int c = 0; c < NU; ++c) {
      const int u = gl + G * c;
      if (u >= U) continue;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int d = u * E + e;
        if (direct)
          out[row * HD + d] = from_f32<QT>(l[r] > 0.f ? acc[r][c * E + e] / l[r] : 0.f);
        else
          ws[wrow * HD + d] = acc[r][c * E + e];
      }
    }
    if (!direct && gl == 0) {
      ws[R * nsplit * HD + wrow] = m[r];
      ws[R * nsplit * (HD + 1) + wrow] = l[r];
    }
  }
}

// one warp per (slot, row, head): the live splits' partials merged in
// split order (so two launches give the same bits), out = acc / l, each
// split's weight formed once
template <typename QT>
__global__ void __launch_bounds__(128)
ragged_paged_attention_merge_kernel(const float* __restrict__ ws,
                                    const int* __restrict__ kv_lens,
                                    const int* __restrict__ q_lens, QT* __restrict__ out, int S,
                                    int QB, int NH, int HD, int PS, int MP, int SL, int nsplit) {
  const size_t R = (size_t)S * QB * NH;
  const size_t row = (size_t)blockIdx.x * 4 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  // launched early (programmatic stream serialization): wait until the
  // split kernel has finished and its partials are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (row >= R) return;
  const int sj = (int)(row / NH), j = sj % QB, s = sj / QB;
  const int L = min(kv_lens[s], MP * PS);
  const int lim = L > 0 ? max(0, row_limit(j, L, q_lens[s])) : 0;
  const int n = (lim + SL - 1) / SL;  // the splits holding its positions
  const float* wacc = ws + row * nsplit * HD;
  const float* wm = ws + R * nsplit * HD + row * nsplit;
  const float* wl = ws + R * nsplit * (HD + 1) + row * nsplit;
  float M = -INFINITY;
  for (int i = 0; i < n; ++i) M = wm[i] > M ? wm[i] : M;
  // each split's weight exp(m_i - M), once (lane i holds splits i, i + 32)
  __shared__ float wsm[4][kMaxSplits];
  float* w = wsm[threadIdx.x >> 5];
  for (int i = lane; i < n; i += 32) w[i] = expf(wm[i] - M);
  __syncwarp();
  float lt = 0.f;
  for (int i = 0; i < n; ++i) lt += wl[i] * w[i];
  for (int d = lane; d < HD; d += 32) {
    float a = 0.f;
    for (int i = 0; i < n; ++i) a += wacc[(size_t)i * HD + d] * w[i];
    out[row * HD + d] = from_f32<QT>(lt > 0.f ? a / lt : 0.f);
  }
}

template <typename QT, typename KVT, int NU, int G, bool DECODE>
int launch_split_t(const void* q, const void* k_pool, const void* v_pool, const float* k_scale,
                   const float* v_scale, const void* block_tables, const void* kv_lens,
                   const void* q_lens, void* out, float* ws, int S, int QB, int NH, int HD, int PS,
                   int MP, int SL, int nsplit, float scale, cudaStream_t stream) {
  using P = SplitPlan<KVT, NU, G, DECODE>;
  auto kern = ragged_paged_attention_split_kernel<QT, KVT, NU, G, DECODE>;
  const size_t smem = split_smem(HD, sizeof(KVT), SL, PS, P::SP, DECODE);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int rt = (QB + P::ROWS - 1) / P::ROWS;
  kern<<<dim3(nsplit * rt, NH, S), kSplitThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k_pool),
      static_cast<const KVT*>(v_pool), k_scale, v_scale, static_cast<const int*>(block_tables),
      static_cast<const int*>(kv_lens), static_cast<const int*>(q_lens), static_cast<QT*>(out),
      nsplit > 1 ? ws : nullptr, QB, NH, HD, PS, MP, SL, nsplit, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return (int)e;
  // the merge launches while the split kernel runs (programmatic dependent
  // launch), so its launch latency hides behind the split kernel's tail
  const size_t rows = (size_t)S * QB * NH;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((rows + 3) / 4));
  cfg.blockDim = dim3(128);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, ragged_paged_attention_merge_kernel<QT>, (const float*)ws,
                         static_cast<const int*>(kv_lens), static_cast<const int*>(q_lens),
                         static_cast<QT*>(out), S, QB, NH, HD, PS, MP, SL, nsplit);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// NU and G from the row's 16-byte units U, DECODE from QB: float pools
// take groups of 8 lanes holding 1-8 units each; code pools groups of 4
// lanes for rows of up to 4 units (HD <= 64), else of 8 with 1-2 units
template <typename QT, typename KVT>
int launch_split(const void* q, const void* k_pool, const void* v_pool, const float* k_scale,
                 const float* v_scale, const void* block_tables, const void* kv_lens,
                 const void* q_lens, void* out, float* ws, int S, int QB, int NH, int HD, int PS,
                 int MP, int SL, int nsplit, float scale, cudaStream_t st) {
  const int U = HD * (int)sizeof(KVT) / 16;
#define PA_SPLIT(NU, G, DEC)                                                                 \
  return launch_split_t<QT, KVT, NU, G, DEC>(q, k_pool, v_pool, k_scale, v_scale,            \
                                             block_tables, kv_lens, q_lens, out, ws, S, QB, \
                                             NH, HD, PS, MP, SL, nsplit, scale, st)
#define PA_SPLIT_NU(DEC)                 \
  if constexpr (IsQuant<KVT>::value) {   \
    if (U <= 4) PA_SPLIT(1, 4, DEC);     \
    if (U <= 8) PA_SPLIT(1, 8, DEC);     \
    if (U <= 16) PA_SPLIT(2, 8, DEC);    \
  } else {                               \
    if (U <= 8) PA_SPLIT(1, 8, DEC);     \
    if (U <= 16) PA_SPLIT(2, 8, DEC);    \
    if (U <= 32) PA_SPLIT(4, 8, DEC);    \
    if constexpr (sizeof(KVT) == 4) {    \
      if (U <= 64) PA_SPLIT(8, 8, DEC);  \
    }                                    \
  }
  if (QB == 1) {
    PA_SPLIT_NU(true)
  } else {
    PA_SPLIT_NU(false)
  }
#undef PA_SPLIT_NU
#undef PA_SPLIT
  return (int)cudaErrorInvalidValue;
}

// what both split-KV entries check of the extent's cut and the pools
bool split_args_ok(const void* k_pool, const void* v_pool, int HD, int unit, int PS, int MP,
                   int SL, int nsplit, const float* ws) {
  const uintptr_t pools =
      reinterpret_cast<uintptr_t>(k_pool) | reinterpret_cast<uintptr_t>(v_pool);
  return HD % unit == 0 && HD >= unit && HD <= 256 && pools % 16 == 0 && PS >= 1 && SL >= PS &&
         SL % PS == 0 && nsplit >= 1 && nsplit <= kMaxSplits &&
         (long long)nsplit * SL >= (long long)MP * PS &&
         (nsplit == 1 || ws != nullptr);
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

// The split-KV design: as paged_attention_forward, for float32 / bfloat16
// pools (kv_dtype 0 or 1) with HD % 8 == 0, HD <= 256 and 16-byte aligned
// pools. The extent [0, MP * PS) is cut into nsplit <= 64 splits of SL
// positions (SL a multiple of PS); with nsplit > 1, ws holds S * QB * NH *
// nsplit * (HD + 2) floats for the partials (acc, then m, then l) and a
// second kernel merges them. Returns cudaGetLastError() after the
// launches, or cudaErrorInvalidValue for what it does not take.
extern "C" int paged_attention_forward_split(int q_dtype, int kv_dtype, const void* q,
                                             const void* k_pool, const void* v_pool,
                                             const void* block_tables, const void* kv_lens,
                                             const void* q_lens, void* out, float* ws, int S,
                                             int QB, int NH, int HD, int PS, int MP, int SL,
                                             int nsplit, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!split_args_ok(k_pool, v_pool, HD, 8, PS, MP, SL, nsplit, ws))
    return (int)cudaErrorInvalidValue;
#define PA_SPLIT_LAUNCH(QT, KVT)                                                            \
  return launch_split<QT, KVT>(q, k_pool, v_pool, nullptr, nullptr, block_tables, kv_lens, \
                               q_lens, out, ws, S, QB, NH, HD, PS, MP, SL, nsplit, scale, st)
  if (q_dtype == 0 && kv_dtype == 0) PA_SPLIT_LAUNCH(float, float);
  if (q_dtype == 1 && kv_dtype == 1) PA_SPLIT_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  if (q_dtype == 0 && kv_dtype == 1) PA_SPLIT_LAUNCH(float, __nv_bfloat16);
  if (q_dtype == 1 && kv_dtype == 0) PA_SPLIT_LAUNCH(__nv_bfloat16, float);
#undef PA_SPLIT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// The split-KV design over int8 / float8 e4m3 code pools (kv_dtype 2 or
// 3): as paged_attention_forward_split, with the per-page-per-head scales
// k_scale / v_scale [NP, NH] (float32, 4-byte aligned) of
// paged_attention_forward, HD % 16 == 0 (whole 16-code units), HD <= 256
// and 16-byte aligned pools; ws as there.
extern "C" int paged_attention_forward_split_quant(
    int q_dtype, int kv_dtype, const void* q, const void* k_pool, const void* v_pool,
    const float* k_scale, const float* v_scale, const void* block_tables, const void* kv_lens,
    const void* q_lens, void* out, float* ws, int S, int QB, int NH, int HD, int PS, int MP,
    int SL, int nsplit, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t scales =
      reinterpret_cast<uintptr_t>(k_scale) | reinterpret_cast<uintptr_t>(v_scale);
  if (!split_args_ok(k_pool, v_pool, HD, 16, PS, MP, SL, nsplit, ws) || k_scale == nullptr ||
      v_scale == nullptr || scales % 4 != 0)
    return (int)cudaErrorInvalidValue;
#define PA_SPLIT_LAUNCH(QT, KVT)                                                           \
  return launch_split<QT, KVT>(q, k_pool, v_pool, k_scale, v_scale, block_tables, kv_lens, \
                               q_lens, out, ws, S, QB, NH, HD, PS, MP, SL, nsplit, scale, st)
  if (q_dtype == 0 && kv_dtype == 2) PA_SPLIT_LAUNCH(float, int8_t);
  if (q_dtype == 1 && kv_dtype == 2) PA_SPLIT_LAUNCH(__nv_bfloat16, int8_t);
  if (q_dtype == 0 && kv_dtype == 3) PA_SPLIT_LAUNCH(float, __nv_fp8_e4m3);
  if (q_dtype == 1 && kv_dtype == 3) PA_SPLIT_LAUNCH(__nv_bfloat16, __nv_fp8_e4m3);
#undef PA_SPLIT_LAUNCH
  return (int)cudaErrorInvalidValue;
}
