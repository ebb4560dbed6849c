// Packed (segment-id, block-diagonal) flash attention forward and backward
// for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernels of paddle_tpu/kernels/packed_flash_pallas.py:
//   packed_flash_fwd_kernel,        <- _fwd_kernel (:55)
//   packed_flash_fwd_hopper_kernel
//   packed_flash_dq_kernel,         <- _bwd_dq_kernel (:96)
//   packed_flash_dq_hopper_kernel
//   packed_flash_dkv_kernel,        <- _bwd_dkv_kernel (:132)
//   packed_flash_dkv_hopper_kernel
//
// Several sequences share one row of L tokens; a token attends only to
// tokens of its own segment (seg[b, i] == seg[b, j]) and, with causal, to
// columns j <= i. Layout: q, k, v, out, dout, dq, dk, dv [B, L, H, D]
// (contiguous, the reference's public layout); seg int32 [B, L], read by
// every head of its row (b = bh / H; the reference repeats it per head,
// :314, the port does not copy it); lse and delta float32 [B*H, L].
// Inputs float32, bfloat16 or float16 (float16 on the CUDA-core kernels
// only); every product and sum in float32; outputs in the input type,
// lse in float32. Any L and any D <= 128 (the Pallas wrapper takes only
// L <= 2048 and a multiple of 128, :302-307).
//
// The reference's arithmetic (_seg_causal_mask, :41-52): the forward
// scales q in its own dtype before the product (:59); the backward takes
// q in float32 and scales the product (:114-116); masked scores are
// -1e30, which contribute exp(-1e30 - m) = 0 to every row, since each
// row sees at least its own column. Here a masked entry is left out of
// the sums outright, which gives the same numbers.
//
// Tile skipping, which the TPU kernel's docstring (:8-11) promises but its
// loop does not do: before a (q tile, k tile) pair is computed, the block
// asks whether any valid id of the streamed tile lies inside [min, max]
// of the resident tile's valid ids (one __syncthreads_or). If none does,
// no pair of the two tiles shares a segment, every entry would be masked,
// and the pair is skipped without loading its K/V (or Q/dO) rows. That is
// exact for any ids (contiguous or not, sorted or not), and at BERT's
// pack 4 (four 128-token segments in a 512 row, 64-row tiles) it removes
// 3/4 of the pairs. Causal also skips every tile wholly above the
// diagonal.
//
// What bounds these kernels on this card: at BERT-base pack 4 (B=16,
// H=12, L=512, D=64, bf16) the live pairs are 4 x 128^2 per head, ~3.2
// GFLOP forward against ~50 MB of tensors: ~64 operations a byte, below
// the ~295 at which the bf16 tensor cores become the limit, so the bound
// is the bytes (~15 us). This first design, like flash_attention.cu (same
// tiles and register blocking), runs the products on the CUDA cores in
// float32 and is bound by their rate instead; it reads each live K/V
// tile once per q tile through shared memory and never forms the [L, L]
// scores.
//
// The forward has two designs, chosen in kernels/packed_flash.py by dtype,
// head size, alignment and L alone (hopper_fwd):
// - packed_flash_fwd_hopper_kernel, bf16 at D = 64 or 128 and L <= 16384
//   (every BERT shape): the wgmma/TMA flash forward (flash_attention.cu's
//   note describes it) with segment ids, from the one body both kernels
//   share (csrc/flash_fwd_hopper.cuh, its SEG = true instantiation). At
//   pack 4 the CUDA-core kernel spent its time on float32 products, not
//   bytes; here the products run on the tensor cores and the segments
//   cut the work to the unpacked forward's. Before its loop a CTA (128 q
//   rows) lists, in shared memory, the 64-key tiles that can hold a live
//   pair for one of its two warpgroups: the test above over the
//   warpgroup's 64 rows (exact for any ids, an id in two places
//   included) and, causal, a column at or below one of its rows. At most
//   256 tiles, so L <= 16384; a longer L takes the CUDA-core kernel. At
//   pack 4 a CTA lists 2 of the 8 tiles. The producer warp loads only
//   listed tiles and its lanes write each tile's 64 ids into the stage;
//   each warpgroup computes the tiles live for its rows, waits for and
//   releases the others, so the ring's release accounting is the flash
//   forward's with every tile read by both. The per-element test
//   (seg_q == seg_k, and col <= row with causal) runs only on tiles whose
//   keys and the warpgroup's rows do not all carry one id, on causal
//   diagonal tiles and past L; masked entries stay out of the sums. The
//   build flag PACKED_FWD_STALL_WG=w makes warpgroup w lag on every tile,
//   for the card test of the ring. Rounding: the reference scales q in
//   bf16 before the product (:59); here scale * log2(e) multiplies the
//   float32 scores, as in the flash forward. At D = 64 the scale 1/8 is
//   exact in bf16, so the two agree; at D = 128 they differ by one bf16
//   rounding of q. P is rounded to bf16 before P V, as in the reference
//   (:83-85). lse keeps its definition (natural log, float32, [B*H, L]):
//   the backward kernels read it unchanged.
// - packed_flash_fwd_kernel, the rest: float32 (bert_parity holds it to
//   1e-4, which TF32 tensor cores would break), other head sizes, longer
//   L.
//
// dq and dk/dv have two designs each, chosen by dtype, head size,
// alignment and L alone (hopper_bwd):
// - packed_flash_dq_hopper_kernel and packed_flash_dkv_hopper_kernel, bf16
//   at D = 64 and L <= 16384 (every BERT shape): the wgmma/TMA flash
//   backward (flash_attention.cu's note) with segment ids, from the bodies
//   both backwards share (csrc/flash_bwd_hopper.cuh, SEG = true). What
//   bounds the pair at pack 4 is bytes: 5 and 6 tensors of [16, 512, 12,
//   64] bf16 with the float32 rows and the ids, 0.019 ms for dq and 0.023
//   ms for dk/dv, against 4.8 / 6.4 GFLOP of live pairs (0.005 / 0.0065 ms
//   on the tensor cores). The CUDA-core kernels sat some 21x above that:
//   float32 products on the CUDA cores, 64-row CTAs, every tile staged and
//   widened to float32 by the threads that then computed on it, and a
//   block-wide vote on each streamed tile's ids. Here a CTA owns 128 rows
//   (q rows in dq, keys in dk/dv), TMA keeps a 3-stage ring of 64-row tiles
//   of the other side in flight, and the products run on the tensor cores.
//   Before its loop the CTA lists, in shared memory, the streamed tiles
//   that can hold a live pair for one of its two warpgroups: dq the key
//   tiles, with the packed forward's test; dk/dv the q tiles, with its
//   transpose (some valid id of the q tile inside [min, max] of the
//   warpgroup's key ids and, causal, a row of the tile at or after one of
//   its keys), exact for any ids. At pack 4 every CTA (aligned on 128)
//   covers one segment: dq lists 2 of 8 key tiles and dk/dv 2 of 8 q
//   tiles, all flagged "one id", so the work is the unpacked backward's
//   on 128-token rows and no per-element segment test runs. The producer's
//   lanes write each stage's 64 ids beside it; both warpgroups walk the
//   list, computing the tiles live for their rows and releasing the
//   others. Masked entries get P = 0 and dS = 0 (the reference's exp(-1e30
//   - lse) = 0). Rounding: the reference takes q in float32 and scales the
//   product (:114-116); here the bf16 products are exact and summed in
//   float32, so the only roundings the plain version lacks are P (for dV)
//   and dS in bf16 before their products, as in the flash backward. Keys
//   and rows past L compute harmlessly on TMA's zero fill and are never
//   stored. The CTA's own tiles (Q and dO, or K and V) are in flight
//   while it lists, and each stage's copies are issued before the producer
//   lanes load its ids: both kept, each read faster on the card. Two CTAs
//   an SM for dq (96 registers, spills) read slower without causality and
//   was not kept. dq still reads some 25% above the unpacked flash dq at
//   the same tokens; the list's prologue (global loads and three block
//   barriers before the first key tile is copied) is the likely cause,
//   not measured apart. The build flag PACKED_BWD_STALL_WG=w makes
//   warpgroup w lag on every tile it computes in both kernels, for the
//   card test of the ring.
// - packed_flash_dq_kernel and packed_flash_dkv_kernel, the rest: float32
//   (bert_parity's 1e-4 would not survive bf16 tensor-core products), D =
//   128 (dk/dv's two 64 x 128 float32 accumulators beside S^T and dP^T
//   would pass the 168 registers a thread that one 288-thread CTA an SM
//   allows, and spill, as the flash backward found), other head sizes and
//   longer L (the tile lists hold 256 tiles).
//
// The backward uses no atomics (dq and dk/dv are separate kernels, as in
// the Pallas split), so two runs give bit-identical gradients.
#include <limits.h>

#include "flash_bwd_hopper.cuh"
#include "flash_fwd_hopper.cuh"

namespace {

struct SegShape {
  int H, L, D;
  float scale;
  int causal;
};

// the ids of rows [r0, r0+64) into sseg (threads 0..63); the caller syncs
__device__ __forceinline__ void load_ids(int* sseg, const int* seg_row, int r0,
                                         int L) {
  if (threadIdx.x < kTile) {
    const int row = r0 + threadIdx.x;
    sseg[threadIdx.x] = row < L ? seg_row[row] : 0;
  }
}

// [min, max] of the valid ids of a staged tile (every thread, after a sync)
__device__ __forceinline__ void id_range(const int* sseg, int n, int& lo,
                                         int& hi) {
  lo = INT_MAX;
  hi = INT_MIN;
  for (int r = 0; r < n; ++r) {
    lo = min(lo, sseg[r]);
    hi = max(hi, sseg[r]);
  }
}

// Stage the streamed tile's ids (rows [r0, r0+64)) and return, to every
// thread of the block, whether any valid one lies in [lo, hi]. This is
// also the barrier after which the staged ids may be read.
__device__ __forceinline__ bool stage_and_test(int* sseg, const int* seg_row,
                                               int r0, int L, int lo, int hi) {
  int hit = 0;
  if (threadIdx.x < kTile) {
    const int row = r0 + threadIdx.x;
    const int id = row < L ? seg_row[row] : 0;
    sseg[threadIdx.x] = id;
    hit = row < L && id >= lo && id <= hi;
  }
  return __syncthreads_or(hit) != 0;
}

__device__ __forceinline__ bool live(const SegShape& sh, int row, int col,
                                     int seg_r, int seg_c) {
  return row < sh.L && col < sh.L && seg_r == seg_c && (!sh.causal || col <= row);
}

template <int DMAX>
size_t fwd_smem() {
  return ((size_t)3 * kTile * ld_of<DMAX>() + (size_t)kTile * kLdp) * sizeof(float) +
         2 * kTile * sizeof(int);
}
template <int DMAX>
size_t dq_smem() {
  return ((size_t)4 * kTile * ld_of<DMAX>() + (size_t)kTile * kLdp) * sizeof(float) +
         2 * kTile * sizeof(int);
}
template <int DMAX>
size_t dkv_smem() {
  return ((size_t)4 * kTile * ld_of<DMAX>() + (size_t)2 * kTile * kLdp + 2 * kTile) *
             sizeof(float) +
         2 * kTile * sizeof(int);
}

// ---------------------------------------------------------------------------
// forward: one block per (b*h, 64-row q tile); loops over the k tiles
// ---------------------------------------------------------------------------
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
packed_flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ seg,
                        T* __restrict__ out, float* __restrict__ lse, SegShape sh) {
  constexpr int ld = ld_of<DMAX>();
  constexpr int kDc = DMAX / 16;  // d columns per thread
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + kTile * ld;
  float* sv = sk + kTile * ld;
  float* sp = sv + kTile * ld;
  int* sseg_q = reinterpret_cast<int*>(sp + kTile * kLdp);
  int* sseg_k = sseg_q + kTile;

  const int bh = blockIdx.x;
  const int b = bh / sh.H, h = bh - b * sh.H;
  // causal: the late (heavy) q tiles first
  const int q0 = (sh.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kTile;
  const int D = sh.D, L = sh.L;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int* seg_row = seg + (size_t)b * L;

  // q scaled in its own dtype, as the reference's forward does (:59)
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int row = q0 + r;
    sq[r * ld + d] =
        row < L ? to_f32(from_f32<T>(to_f32(q[row_base(b, row, h, L, sh.H, D) + d]) *
                                     sh.scale))
                : 0.f;
  }
  load_ids(sseg_q, seg_row, q0, L);
  __syncthreads();
  int lo, hi_id;
  id_range(sseg_q, min(kTile, L - q0), lo, hi_id);

  float m[kPer], l[kPer], acc[kPer][kDc];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDc; ++j) acc[i][j] = 0.f;
  }

  const int k_end = sh.causal ? min(L, q0 + kTile) : L;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the last tile's readers are done
    if (!stage_and_test(sseg_k, seg_row, k0, L, lo, hi_id)) continue;
    load_tile(sk, ld, k, b, h, k0, L, sh.H, D);
    load_tile(sv, ld, v, b, h, k0, L, sh.H, D);
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
      const int sr = sseg_q[r];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int c = tx + 16 * j;
        if (!live(sh, row, k0 + c, sr, sseg_k[c])) s[i][j] = -INFINITY;
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

    const int tn = min(kTile, L - k0);
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
    if (row >= L) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];  // the reference's (:91)
    const size_t base = row_base(b, row, h, L, sh.H, D);
#pragma unroll
    for (int j = 0; j < kDc; ++j) {
      const int d = tx + 16 * j;
      if (d < D) out[base + d] = from_f32<T>(acc[i][j] / l_safe);
    }
    if (tx == 0) lse[(size_t)bh * L + row] = m[i] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// backward dq: one block per (b*h, 64-row q tile); loops over the k tiles
// ---------------------------------------------------------------------------
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
packed_flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ seg,
                       const T* __restrict__ dout, const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dq,
                       SegShape sh) {
  constexpr int ld = ld_of<DMAX>();
  constexpr int kDc = DMAX / 16;
  extern __shared__ float smem[];
  float* sq = smem;
  float* sdo = sq + kTile * ld;
  float* sk = sdo + kTile * ld;
  float* sv = sk + kTile * ld;
  float* sds = sv + kTile * ld;
  int* sseg_q = reinterpret_cast<int*>(sds + kTile * kLdp);
  int* sseg_k = sseg_q + kTile;

  const int bh = blockIdx.x;
  const int b = bh / sh.H, h = bh - b * sh.H;
  const int q0 = (sh.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kTile;
  const int D = sh.D, L = sh.L;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int* seg_row = seg + (size_t)b * L;

  load_tile(sq, ld, q, b, h, q0, L, sh.H, D);
  load_tile(sdo, ld, dout, b, h, q0, L, sh.H, D);
  load_ids(sseg_q, seg_row, q0, L);
  float lse_r[kPer], delta_r[kPer], acc[kPer][kDc];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int row = q0 + ty + 16 * i;
    lse_r[i] = row < L ? lse[(size_t)bh * L + row] : INFINITY;
    delta_r[i] = row < L ? delta[(size_t)bh * L + row] : 0.f;
#pragma unroll
    for (int j = 0; j < kDc; ++j) acc[i][j] = 0.f;
  }
  __syncthreads();
  int lo, hi_id;
  id_range(sseg_q, min(kTile, L - q0), lo, hi_id);

  const int k_end = sh.causal ? min(L, q0 + kTile) : L;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();
    if (!stage_and_test(sseg_k, seg_row, k0, L, lo, hi_id)) continue;
    load_tile(sk, ld, k, b, h, k0, L, sh.H, D);
    load_tile(sv, ld, v, b, h, k0, L, sh.H, D);
    __syncthreads();

    float s[kPer][kPer], dp[kPer][kPer];
    two_products<DMAX>(sq, sk, sdo, sv, D, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = ty + 16 * i;
      const int sr = sseg_q[r];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int c = tx + 16 * j;
        float ds = 0.f;
        if (live(sh, q0 + r, k0 + c, sr, sseg_k[c])) {
          const float p = __expf(s[i][j] * sh.scale - lse_r[i]);
          ds = p * (dp[i][j] - delta_r[i]) * sh.scale;
        }
        sds[r * kLdp + c] = ds;
      }
    }
    __syncthreads();

    const int tn = min(kTile, L - k0);
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
    if (row >= L) continue;
    const size_t base = row_base(b, row, h, L, sh.H, D);
#pragma unroll
    for (int j = 0; j < kDc; ++j) {
      const int d = tx + 16 * j;
      if (d < D) dq[base + d] = from_f32<T>(acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// backward dk/dv: one block per (b*h, 64-row k tile); loops over the q tiles
// ---------------------------------------------------------------------------
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
packed_flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ seg,
                        const T* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dk,
                        T* __restrict__ dv, SegShape sh) {
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
  int* sseg_k = reinterpret_cast<int*>(sdelta + kTile);
  int* sseg_q = sseg_k + kTile;

  const int bh = blockIdx.x;
  const int b = bh / sh.H, h = bh - b * sh.H;
  const int k0 = blockIdx.y * kTile;  // causal: the light k tiles are the late ones
  const int D = sh.D, L = sh.L;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int* seg_row = seg + (size_t)b * L;

  load_tile(sk, ld, k, b, h, k0, L, sh.H, D);
  load_tile(sv, ld, v, b, h, k0, L, sh.H, D);
  load_ids(sseg_k, seg_row, k0, L);
  float dka[kPer][kDc], dva[kPer][kDc];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kDc; ++j) dka[i][j] = dva[i][j] = 0.f;
  __syncthreads();
  int lo, hi_id;
  id_range(sseg_k, min(kTile, L - k0), lo, hi_id);

  // causal: rows below k0 see no column of this tile
  for (int q0 = sh.causal ? k0 : 0; q0 < L; q0 += kTile) {
    __syncthreads();
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      slse[threadIdx.x] = row < L ? lse[(size_t)bh * L + row] : INFINITY;
      sdelta[threadIdx.x] = row < L ? delta[(size_t)bh * L + row] : 0.f;
    }
    if (!stage_and_test(sseg_q, seg_row, q0, L, lo, hi_id)) continue;
    load_tile(sq, ld, q, b, h, q0, L, sh.H, D);
    load_tile(sdo, ld, dout, b, h, q0, L, sh.H, D);
    __syncthreads();

    // rows ty + 16 i of the q tile, columns tx + 16 j of the k tile
    float s[kPer][kPer], dp[kPer][kPer];
    two_products<DMAX>(sq, sk, sdo, sv, D, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = ty + 16 * i;
      const float lr = slse[r], dr = sdelta[r];
      const int sr = sseg_q[r];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int c = tx + 16 * j;
        float p = 0.f, ds = 0.f;
        if (live(sh, q0 + r, k0 + c, sr, sseg_k[c])) {
          p = __expf(s[i][j] * sh.scale - lr);
          ds = p * (dp[i][j] - dr) * sh.scale;
        }
        sp[r * kLdp + c] = p;
        sds[r * kLdp + c] = ds;
      }
    }
    __syncthreads();

    // dv[c] += sum_r P[r][c] dO[r]; dk[c] += sum_r dS[r][c] q[r]
    const int tn = min(kTile, L - q0);
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
    if (row >= L) continue;
    const size_t base = row_base(b, row, h, L, sh.H, D);
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
int fwd(const void* q, const void* k, const void* v, const void* seg, void* out,
        void* lse, int B, SegShape sh, cudaStream_t st) {
  auto kern = packed_flash_fwd_kernel<T, DMAX>;
  const size_t smem = fwd_smem<DMAX>();
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(B * sh.H, tiles(sh.L)), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(seg),
      static_cast<T*>(out), static_cast<float*>(lse), sh);
  return (int)cudaGetLastError();
}

template <typename T, int DMAX>
int bwd_dq(const void* q, const void* k, const void* v, const void* seg,
           const void* dout, const void* lse, const void* delta, void* dq,
           int B, SegShape sh, cudaStream_t st) {
  auto kern = packed_flash_dq_kernel<T, DMAX>;
  const size_t smem = dq_smem<DMAX>();
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(B * sh.H, tiles(sh.L)), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(seg),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), sh);
  return (int)cudaGetLastError();
}

template <typename T, int DMAX>
int bwd_dkv(const void* q, const void* k, const void* v, const void* seg,
            const void* dout, const void* lse, const void* delta, void* dk,
            void* dv, int B, SegShape sh, cudaStream_t st) {
  auto kern = packed_flash_dkv_kernel<T, DMAX>;
  const size_t smem = dkv_smem<DMAX>();
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(B * sh.H, tiles(sh.L)), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(seg),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), sh);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// forward on wgmma and TMA (bf16, D = 64 or 128, L <= 64 * kMaxKeyTiles):
// the flash forward's body (csrc/flash_fwd_hopper.cuh) with segment ids
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(HopperFwd<D>::THREADS, HopperFwd<D>::MIN_BLOCKS)
packed_flash_fwd_hopper_kernel(const __grid_constant__ CUtensorMap qmap,
                               const __grid_constant__ CUtensorMap kmap,
                               const __grid_constant__ CUtensorMap vmap,
                               __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                               Shape sh, float scale_log2, const int* __restrict__ seg) {
  fwd_hopper_body<D, true>(qmap, kmap, vmap, out, lse, sh, scale_log2, seg);
}

// ---------------------------------------------------------------------------
// backward on wgmma and TMA (bf16, D = 64, L <= 64 * kMaxKeyTiles): the
// flash backward's bodies (csrc/flash_bwd_hopper.cuh) with segment ids
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(HopperBwd<D>::THREADS, 1)
packed_flash_dq_hopper_kernel(const __grid_constant__ CUtensorMap qmap,
                              const __grid_constant__ CUtensorMap kmap,
                              const __grid_constant__ CUtensorMap vmap,
                              const __grid_constant__ CUtensorMap domap,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dq, Shape sh, float scale_log2,
                              const int* __restrict__ seg) {
  dq_hopper_body<D, true>(qmap, kmap, vmap, domap, lse, delta, dq, sh, scale_log2, seg);
}

template <int D>
__global__ void __launch_bounds__(HopperBwd<D>::THREADS, 1)
packed_flash_dkv_hopper_kernel(const __grid_constant__ CUtensorMap qmap,
                               const __grid_constant__ CUtensorMap kmap,
                               const __grid_constant__ CUtensorMap vmap,
                               const __grid_constant__ CUtensorMap domap,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                               Shape sh, float scale_log2, const int* __restrict__ seg) {
  dkv_hopper_body<D, true>(qmap, kmap, vmap, domap, lse, delta, dk, dv, sh, scale_log2, seg);
}

// the wgmma kernels' Shape of a packed call: Lq = Lk = L
Shape hopper_shape(int H, int L, int D, float scale, int causal) {
  Shape sh;
  sh.H = H;
  sh.Lq = sh.Lk = L;
  sh.D = D;
  sh.scale = scale;
  sh.causal = causal;
  return sh;
}

template <int D>
int fwd_hopper(const void* q, const void* k, const void* v, const void* seg, void* out,
               void* lse, int B, int H, int L, float scale, int causal, cudaStream_t st) {
  return launch_fwd_hopper<D, true>(packed_flash_fwd_hopper_kernel<D>, q, k, v,
                                    static_cast<const int*>(seg), out, lse, B,
                                    hopper_shape(H, L, D, scale, causal), st);
}

SegShape make_shape(int H, int L, int D, float scale, int causal) {
  SegShape sh;
  sh.H = H;
  sh.L = L;
  sh.D = D;
  sh.scale = scale;
  sh.causal = causal;
  return sh;
}

}  // namespace

extern "C" int packed_flash_forward(int dtype, const void* q, const void* k,
                                    const void* v, const void* seg, void* out,
                                    void* lse, int B, int H, int L, int D,
                                    float scale, int causal, void* stream) {
  const SegShape sh = make_shape(H, L, D, scale, causal);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PF_FWD(T, DM) fwd<T, DM>(q, k, v, seg, out, lse, B, sh, st)
  FLASH_TILES_DISPATCH(PF_FWD);
#undef PF_FWD
}

// The wgmma/TMA forward: as packed_flash_forward, for bfloat16 (dtype 1) at
// D = 64 or 128 and L <= 64 * kMaxKeyTiles (16384), with 16-byte aligned q,
// k, v and out; anything else returns cudaErrorInvalidValue (the caller
// routes it to the entry above).
extern "C" int packed_flash_forward_hopper(int dtype, const void* q, const void* k,
                                           const void* v, const void* seg, void* out, void* lse,
                                           int B, int H, int L, int D, float scale, int causal,
                                           void* stream) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
  if (dtype != 1 || (D != 64 && D != 128) || any % 16 != 0 || L < 1 ||
      L > 64 * kMaxKeyTiles)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return fwd_hopper<64>(q, k, v, seg, out, lse, B, H, L, scale, causal, st);
  return fwd_hopper<128>(q, k, v, seg, out, lse, B, H, L, scale, causal, st);
}

extern "C" int packed_flash_backward_dq(int dtype, const void* q,
                                        const void* k, const void* v,
                                        const void* seg, const void* dout,
                                        const void* lse, const void* delta,
                                        void* dq, int B, int H, int L, int D,
                                        float scale, int causal,
                                        void* stream) {
  const SegShape sh = make_shape(H, L, D, scale, causal);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PF_DQ(T, DM) \
  bwd_dq<T, DM>(q, k, v, seg, dout, lse, delta, dq, B, sh, st)
  FLASH_TILES_DISPATCH(PF_DQ);
#undef PF_DQ
}

extern "C" int packed_flash_backward_dkv(int dtype, const void* q,
                                         const void* k, const void* v,
                                         const void* seg, const void* dout,
                                         const void* lse, const void* delta,
                                         void* dk, void* dv, int B, int H,
                                         int L, int D, float scale,
                                         int causal, void* stream) {
  const SegShape sh = make_shape(H, L, D, scale, causal);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PF_DKV(T, DM) \
  bwd_dkv<T, DM>(q, k, v, seg, dout, lse, delta, dk, dv, B, sh, st)
  FLASH_TILES_DISPATCH(PF_DKV);
#undef PF_DKV
}

// The wgmma/TMA backward: as packed_flash_backward_dq and
// packed_flash_backward_dkv, for bfloat16 (dtype 1) at D = 64 and L <= 64 *
// kMaxKeyTiles (16384), with 16-byte aligned q, k, v, dout and outputs;
// anything else returns cudaErrorInvalidValue (the caller routes it to the
// entries above).
static bool bwd_hopper_ok(int dtype, int D, int L, uintptr_t any) {
  return dtype == 1 && D == 64 && any % 16 == 0 && L >= 1 && L <= 64 * kMaxKeyTiles;
}

extern "C" int packed_flash_backward_dq_hopper(int dtype, const void* q, const void* k,
                                               const void* v, const void* seg, const void* dout,
                                               const void* lse, const void* delta, void* dq,
                                               int B, int H, int L, int D, float scale,
                                               int causal, void* stream) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
                        reinterpret_cast<uintptr_t>(dq);
  if (!bwd_hopper_ok(dtype, D, L, any)) return (int)cudaErrorInvalidValue;
  return launch_dq_hopper<64, true>(packed_flash_dq_hopper_kernel<64>, q, k, v, dout,
                                    static_cast<const int*>(seg), lse, delta, dq, B,
                                    hopper_shape(H, L, D, scale, causal),
                                    static_cast<cudaStream_t>(stream));
}

extern "C" int packed_flash_backward_dkv_hopper(int dtype, const void* q, const void* k,
                                                const void* v, const void* seg, const void* dout,
                                                const void* lse, const void* delta, void* dk,
                                                void* dv, int B, int H, int L, int D, float scale,
                                                int causal, void* stream) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
                        reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv);
  if (!bwd_hopper_ok(dtype, D, L, any)) return (int)cudaErrorInvalidValue;
  return launch_dkv_hopper<64, true>(packed_flash_dkv_hopper_kernel<64>, q, k, v, dout,
                                     static_cast<const int*>(seg), lse, delta, dk, dv, B,
                                     hopper_shape(H, L, D, scale, causal),
                                     static_cast<cudaStream_t>(stream));
}
