// Flash attention forward and backward for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernels of paddle_tpu/kernels/flash_attention_pallas.py:
//   flash_attention_fwd_kernel     <- _fwd_kernel_resident (:52) and the
//                                     streamed _fwd_kernel (:166)
//   flash_attention_dq_kernel      <- _bwd_dq_kernel_resident (:93) and
//                                     _bwd_dq_kernel (:213)
//   flash_attention_dkv_kernel     <- _bwd_dkv_kernel_resident (:126) and
//                                     _bwd_dkv_kernel (:251)
// The TPU split between "resident" (K/V whole in VMEM, Lk <= 2048) and
// "streamed" (K/V blocks through a sequential grid axis) exists for VMEM
// only. Here every kernel walks its K/V (or Q) tiles in a loop through
// shared memory, which serves every length with one kernel.
//
// Layout: q, out, dout, dq [B, Lq, H, D]; k, v, dk, dv [B, Lk, H, D]
// (contiguous, the reference's public layout); lse and delta float32
// [B*H, Lq]. Inputs float32 or bfloat16; every product and sum in
// float32; outputs in the input type, lse in float32.
//
// Masking (the Python module's docstring states it in full): columns
// >= Lk take no part; causal rows see columns <= row + Lk - Lq
// (bottom-right alignment); a causal row that sees no column (only when
// Lq > Lk) weighs every column alike (its scores count as 0) and passes
// no gradient to q or k, which is what the reference's -1e30 mask makes
// of it.
//
// What bounds these kernels on this card: at GPT-2 small's training
// shape (B=16, H=12, L=1024, D=64, causal, bf16) the attention products
// are ~26 GFLOP forward and ~39 / ~52 GFLOP for dq and dk/dv against
// ~100-150 MB of tensors: far above the ~295 operations per byte at
// which the tensor cores become the limit, so the bound is operations.
// This first design does not reach the tensor cores: it runs the
// products on the CUDA cores in float32, with each thread holding a 4x4
// register tile of the 64x64 score tile and shared-memory tiles padded
// to an odd row stride, so the inner loops read shared memory without
// bank conflicts. What it does about the bound: it never forms the
// [L, L] scores in device memory, skips every tile wholly above the
// causal diagonal, and issues the heavy (late) causal q tiles first.
// wgmma and TMA are later work.
//
// The backward uses no atomics (dq and dk/dv are separate kernels, as in
// the Pallas split), so two runs give bit-identical gradients.
#include "flash_tiles.cuh"

namespace {

enum Mode { kOut = 0, kLive = 1, kDead = 2 };

struct Shape {
  int H, Lq, Lk, D;
  float scale;
  int causal;
  __device__ __forceinline__ int off() const { return Lk - Lq; }
  // the part entry (row, col) plays; rows past Lq compute harmlessly
  __device__ __forceinline__ int mode(int row, int col) const {
    if (col >= Lk) return kOut;
    if (!causal) return kLive;
    if (row + off() < 0) return kDead;
    return col <= row + off() ? kLive : kOut;
  }
  // k tiles [0, hi) that can hold a live column for q rows [q0, q0+64);
  // with dead rows in the tile every column counts (the forward's
  // uniform rows)
  __device__ __forceinline__ int k_hi(int q0, bool dead_counts) const {
    if (!causal || (dead_counts && q0 + off() < 0)) return Lk;
    return max(0, min(Lk, q0 + kTile + off()));
  }
};

template <int DMAX>
size_t fwd_smem() {
  return ((size_t)3 * kTile * ld_of<DMAX>() + (size_t)kTile * kLdp) * sizeof(float);
}
template <int DMAX>
size_t dq_smem() {
  return ((size_t)4 * kTile * ld_of<DMAX>() + (size_t)kTile * kLdp) * sizeof(float);
}
template <int DMAX>
size_t dkv_smem() {
  return ((size_t)4 * kTile * ld_of<DMAX>() + (size_t)2 * kTile * kLdp + 2 * kTile) *
         sizeof(float);
}

// ---------------------------------------------------------------------------
// forward: one block per (b*h, 64-row q tile); loops over k tiles
// ---------------------------------------------------------------------------
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           float* __restrict__ lse, Shape sh) {
  constexpr int ld = ld_of<DMAX>();
  constexpr int kDc = DMAX / 16;  // d columns per thread
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + kTile * ld;
  float* sv = sk + kTile * ld;
  float* sp = sv + kTile * ld;

  const int bh = blockIdx.x;
  const int b = bh / sh.H, h = bh - b * sh.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // heavy tiles first
  const int D = sh.D;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  // q pre-scaled, as the reference's forward does (:58)
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int row = q0 + r;
    sq[r * ld + d] =
        row < sh.Lq ? to_f32(q[row_base(b, row, h, sh.Lq, sh.H, D) + d]) * sh.scale : 0.f;
  }

  float m[kPer], l[kPer], acc[kPer][kDc];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDc; ++j) acc[i][j] = 0.f;
  }

  const int hi = sh.k_hi(q0, true);
  for (int k0 = 0; k0 < hi; k0 += kTile) {
    __syncthreads();  // the last tile's readers are done
    load_tile(sk, ld, k, b, h, k0, sh.Lk, sh.H, D);
    load_tile(sv, ld, v, b, h, k0, sh.Lk, sh.H, D);
    __syncthreads();

    float s[kPer][kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qa[kPer], kb[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) qa[i] = sq[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < kPer; ++j) kb[j] = sk[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = ty + 16 * i, row = q0 + r;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int md = sh.mode(row, k0 + tx + 16 * j);
        s[i][j] = md == kLive ? s[i][j] : (md == kDead ? 0.f : -INFINITY);
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : __expf(s[i][j] - m_new);
        sp[r * kLdp + tx + 16 * j] = p;
        sum += p;
      }
      sum = row_sum(sum);
      const float alpha = m[i] == -INFINITY ? 0.f : __expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kDc; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    const int tn = min(kTile, sh.Lk - k0);
    for (int c = 0; c < tn; ++c) {
      float pa[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) pa[i] = sp[(ty + 16 * i) * kLdp + c];
#pragma unroll
      for (int j = 0; j < kDc; ++j) {
        const float vb = sv[c * ld + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kPer; ++i) acc[i][j] = fmaf(pa[i], vb, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sh.Lq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];  // the reference's (:88)
    const size_t base = row_base(b, row, h, sh.Lq, sh.H, D);
#pragma unroll
    for (int j = 0; j < kDc; ++j) {
      const int d = tx + 16 * j;
      if (d < D) out[base + d] = from_f32<T>(acc[i][j] / l_safe);
    }
    if (tx == 0) lse[(size_t)bh * sh.Lq + row] = m[i] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// backward dq: one block per (b*h, 64-row q tile); loops over k tiles
// ---------------------------------------------------------------------------
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_attention_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, T* __restrict__ dq,
                          Shape sh) {
  constexpr int ld = ld_of<DMAX>();
  constexpr int kDc = DMAX / 16;
  extern __shared__ float smem[];
  float* sq = smem;
  float* sdo = sq + kTile * ld;
  float* sk = sdo + kTile * ld;
  float* sv = sk + kTile * ld;
  float* sds = sv + kTile * ld;

  const int bh = blockIdx.x;
  const int b = bh / sh.H, h = bh - b * sh.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int D = sh.D;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile(sq, ld, q, b, h, q0, sh.Lq, sh.H, D);
  load_tile(sdo, ld, dout, b, h, q0, sh.Lq, sh.H, D);
  float lse_r[kPer], delta_r[kPer], acc[kPer][kDc];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int row = q0 + ty + 16 * i;
    lse_r[i] = row < sh.Lq ? lse[(size_t)bh * sh.Lq + row] : INFINITY;
    delta_r[i] = row < sh.Lq ? delta[(size_t)bh * sh.Lq + row] : 0.f;
#pragma unroll
    for (int j = 0; j < kDc; ++j) acc[i][j] = 0.f;
  }

  const int hi = sh.k_hi(q0, false);  // dead rows pass no gradient to q
  for (int k0 = 0; k0 < hi; k0 += kTile) {
    __syncthreads();
    load_tile(sk, ld, k, b, h, k0, sh.Lk, sh.H, D);
    load_tile(sv, ld, v, b, h, k0, sh.Lk, sh.H, D);
    __syncthreads();

    float s[kPer][kPer], dp[kPer][kPer];
    two_products<DMAX>(sq, sk, sdo, sv, D, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int c = tx + 16 * j;
        float ds = 0.f;
        if (sh.mode(q0 + r, k0 + c) == kLive) {
          const float p = __expf(s[i][j] * sh.scale - lse_r[i]);
          ds = p * (dp[i][j] - delta_r[i]) * sh.scale;
        }
        sds[r * kLdp + c] = ds;
      }
    }
    __syncthreads();

    const int tn = min(kTile, sh.Lk - k0);
    for (int c = 0; c < tn; ++c) {
      float da[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) da[i] = sds[(ty + 16 * i) * kLdp + c];
#pragma unroll
      for (int j = 0; j < kDc; ++j) {
        const float kb = sk[c * ld + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kPer; ++i) acc[i][j] = fmaf(da[i], kb, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sh.Lq) continue;
    const size_t base = row_base(b, row, h, sh.Lq, sh.H, D);
#pragma unroll
    for (int j = 0; j < kDc; ++j) {
      const int d = tx + 16 * j;
      if (d < D) dq[base + d] = from_f32<T>(acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// backward dk/dv: one block per (b*h, 64-row k tile); loops over q tiles
// ---------------------------------------------------------------------------
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_attention_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const T* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           T* __restrict__ dk, T* __restrict__ dv, Shape sh) {
  constexpr int ld = ld_of<DMAX>();
  constexpr int kDc = DMAX / 16;
  extern __shared__ float smem[];
  float* sk = smem;
  float* sv = sk + kTile * ld;
  float* sq = sv + kTile * ld;
  float* sdo = sq + kTile * ld;
  float* sp = sdo + kTile * ld;
  float* sds = sp + kTile * kLdp;
  float* slse = sds + kTile * kLdp;
  float* sdelta = slse + kTile;

  const int bh = blockIdx.x;
  const int b = bh / sh.H, h = bh - b * sh.H;
  const int k0 = blockIdx.y * kTile;  // light causal k tiles are the late ones
  const int D = sh.D;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile(sk, ld, k, b, h, k0, sh.Lk, sh.H, D);
  load_tile(sv, ld, v, b, h, k0, sh.Lk, sh.H, D);
  float dka[kPer][kDc], dva[kPer][kDc];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kDc; ++j) dka[i][j] = dva[i][j] = 0.f;

  // q tiles that can reach this k tile: live rows start at k0 - off;
  // dead rows (the first Lq - Lk rows when Lq > Lk) reach every column
  int lo = 0;
  if (sh.causal && sh.off() >= 0) lo = max(0, k0 - sh.off()) / kTile * kTile;
  for (int q0 = lo; q0 < sh.Lq; q0 += kTile) {
    __syncthreads();
    load_tile(sq, ld, q, b, h, q0, sh.Lq, sh.H, D);
    load_tile(sdo, ld, dout, b, h, q0, sh.Lq, sh.H, D);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      slse[threadIdx.x] = row < sh.Lq ? lse[(size_t)bh * sh.Lq + row] : INFINITY;
      sdelta[threadIdx.x] = row < sh.Lq ? delta[(size_t)bh * sh.Lq + row] : 0.f;
    }
    __syncthreads();

    // rows ty + 16 i of the q tile, columns tx + 16 j of the k tile
    float s[kPer][kPer], dp[kPer][kPer];
    two_products<DMAX>(sq, sk, sdo, sv, D, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = ty + 16 * i;
      const float lr = slse[r], dr = sdelta[r];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int c = tx + 16 * j;
        const int md = sh.mode(q0 + r, k0 + c);
        float p = 0.f, ds = 0.f;
        if (md == kLive) {
          p = __expf(s[i][j] * sh.scale - lr);
          ds = p * (dp[i][j] - dr) * sh.scale;
        } else if (md == kDead) {
          p = __expf(-lr);
        }
        sp[r * kLdp + c] = p;
        sds[r * kLdp + c] = ds;
      }
    }
    __syncthreads();

    // dv[c] += sum_r P[r][c] dO[r]; dk[c] += sum_r dS[r][c] q[r]
    const int tn = min(kTile, sh.Lq - q0);
    for (int r = 0; r < tn; ++r) {
      float pa[kPer], da[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        pa[i] = sp[r * kLdp + ty + 16 * i];
        da[i] = sds[r * kLdp + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < kDc; ++j) {
        const float ob = sdo[r * ld + tx + 16 * j];
        const float qb = sq[r * ld + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          dva[i][j] = fmaf(pa[i], ob, dva[i][j]);
          dka[i][j] = fmaf(da[i], qb, dka[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= sh.Lk) continue;
    const size_t base = row_base(b, row, h, sh.Lk, sh.H, D);
#pragma unroll
    for (int j = 0; j < kDc; ++j) {
      const int d = tx + 16 * j;
      if (d < D) {
        dk[base + d] = from_f32<T>(dka[i][j]);
        dv[base + d] = from_f32<T>(dva[i][j]);
      }
    }
  }
}

template <typename T, int DMAX>
int fwd(const void* q, const void* k, const void* v, void* out, void* lse,
        int B, Shape sh, cudaStream_t st) {
  auto kern = flash_attention_fwd_kernel<T, DMAX>;
  const size_t smem = fwd_smem<DMAX>();
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(B * sh.H, tiles(sh.Lq)), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), static_cast<float*>(lse), sh);
  return (int)cudaGetLastError();
}

template <typename T, int DMAX>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, int B, Shape sh,
           cudaStream_t st) {
  auto kern = flash_attention_dq_kernel<T, DMAX>;
  const size_t smem = dq_smem<DMAX>();
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(B * sh.H, tiles(sh.Lq)), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), sh);
  return (int)cudaGetLastError();
}

template <typename T, int DMAX>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dk, void* dv, int B,
            Shape sh, cudaStream_t st) {
  auto kern = flash_attention_dkv_kernel<T, DMAX>;
  const size_t smem = dkv_smem<DMAX>();
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(B * sh.H, tiles(sh.Lk)), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), sh);
  return (int)cudaGetLastError();
}

Shape make_shape(int H, int Lq, int Lk, int D, float scale, int causal) {
  Shape sh;
  sh.H = H;
  sh.Lq = Lq;
  sh.Lk = Lk;
  sh.D = D;
  sh.scale = scale;
  sh.causal = causal;
  return sh;
}

}  // namespace

extern "C" int flash_attention_forward(int dtype, const void* q, const void* k,
                                       const void* v, void* out, void* lse,
                                       int B, int H, int Lq, int Lk, int D,
                                       float scale, int causal, void* stream) {
  const Shape sh = make_shape(H, Lq, Lk, D, scale, causal);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_FWD(T, DM) fwd<T, DM>(q, k, v, out, lse, B, sh, st)
  FLASH_TILES_DISPATCH(FA_FWD);
#undef FA_FWD
}

extern "C" int flash_attention_backward_dq(int dtype, const void* q,
                                           const void* k, const void* v,
                                           const void* dout, const void* lse,
                                           const void* delta, void* dq, int B,
                                           int H, int Lq, int Lk, int D,
                                           float scale, int causal,
                                           void* stream) {
  const Shape sh = make_shape(H, Lq, Lk, D, scale, causal);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_DQ(T, DM) bwd_dq<T, DM>(q, k, v, dout, lse, delta, dq, B, sh, st)
  FLASH_TILES_DISPATCH(FA_DQ);
#undef FA_DQ
}

extern "C" int flash_attention_backward_dkv(int dtype, const void* q,
                                            const void* k, const void* v,
                                            const void* dout, const void* lse,
                                            const void* delta, void* dk,
                                            void* dv, int B, int H, int Lq,
                                            int Lk, int D, float scale,
                                            int causal, void* stream) {
  const Shape sh = make_shape(H, Lq, Lk, D, scale, causal);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_DKV(T, DM) \
  bwd_dkv<T, DM>(q, k, v, dout, lse, delta, dk, dv, B, sh, st)
  FLASH_TILES_DISPATCH(FA_DKV);
#undef FA_DKV
}
