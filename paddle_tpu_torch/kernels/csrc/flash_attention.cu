// Flash attention forward and backward for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernels of paddle_tpu/kernels/flash_attention_pallas.py:
//   flash_attention_fwd_kernel,      <- _fwd_kernel_resident (:52) and the
//   flash_attention_fwd_hopper_kernel   streamed _fwd_kernel (:166)
//   flash_attention_dq_kernel,       <- _bwd_dq_kernel_resident (:93) and
//   flash_attention_dq_hopper_kernel    _bwd_dq_kernel (:213)
//   flash_attention_dkv_kernel,      <- _bwd_dkv_kernel_resident (:126) and
//   flash_attention_dkv_hopper_kernel   _bwd_dkv_kernel (:251)
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
// which the tensor cores become the limit, so the bound is operations
// (the forward's 0.026 ms of products sit just under its 0.030 ms of
// bytes at this shape; either way only the tensor cores come near it).
//
// Each kernel has two designs, chosen in kernels/flash_attention.py by
// dtype, head size and alignment alone (hopper_fwd for the forward,
// hopper_bwd for dq and dk/dv):
// - flash_attention_fwd_hopper_kernel, bf16 at D = 64 or 128 (every GPT-2
//   and BERT shape; its body is csrc/flash_fwd_hopper.cuh's, which
//   packed_flash.cu's packed_flash_fwd_hopper_kernel runs with segment
//   ids): the products on the tensor cores by wgmma, the tiles
//   in by TMA. One CTA per (b*h, 128-row q tile), heavy causal tiles
//   first: two consumer warpgroups of 64 q rows and one producer warp
//   that loads Q once and keeps a 3-stage ring of 64-key K and V tiles in
//   flight through 4-D tensor maps over [B, L, H, D] (a box past L
//   zero-fills inside its own batch), each a stack of 64-column boxes
//   under 128-byte swizzle. Under causality the lower warpgroup reads
//   fewer key tiles than the upper, so each warpgroup releases the
//   stages it read on empty barriers of its own, and the producer reuses
//   a stage once every warpgroup that reads its tile has released it
//   (the build flag FLASH_FWD_STALL_WG=w makes warpgroup w lag, for the
//   card test of that). S = Q K^T by wgmma from shared memory (both
//   K-major); the online softmax in float32 on the accumulator fragments
//   (a row lives in one quad: two shuffles), base 2 with scale * log2(e)
//   applied to the float32 scores, masks only on tiles that cross Lk, the
//   diagonal or dead rows, tiles wholly above a warpgroup's diagonal
//   skipped; O += P V with P as wgmma's register operand (the bf16 pairs
//   of the accumulator fragment are the A fragment of a k16 slice, so P
//   never touches shared memory) and V MN-major. Tile j's S is issued
//   with tile j-1's P V, and its softmax runs while that product does.
//   The epilogue writes O / l in bf16 over the warpgroup's own Q rows
//   (swizzled, no bank conflicts) and stores 16-byte rows. Its one
//   rounding that the plain version lacks is P in bf16 before P V.
//   At D = 64 two CTAs share an SM (65 KB of shared memory each, and
//   registers capped at 112 a thread, a few of them spilled), so one
//   CTA's softmax and loads hide behind the other's products. 128-key
//   tiles with one CTA an SM, three consumer warpgroups and 2-5 stages
//   were tried; PERF.md (Findings) says what that did and did not show.
// - flash_attention_dq_hopper_kernel and flash_attention_dkv_hopper_kernel,
//   bf16 at D = 64 (every GPT-2 and BERT shape): the forward's building
//   blocks. dq: one CTA per (b*h, 128-row q tile), heavy causal tiles
//   first; the producer loads the CTA's Q and dO once and streams 64-key
//   K and V tiles through a 3-stage ring. Each thread holds lse * log2(e)
//   and delta of its two fragment rows (rows past Lq read lse = +inf, so
//   P = 0 there). S = Q K^T and dP = dO V^T by wgmma from shared memory;
//   P = 2^(S scale log2(e) - lse log2(e)) and dS = P (dP - delta) scale in
//   float32 on the fragments, packed to bf16 pairs; dq += dS K with dS as
//   the register operand and K read MN-major through a second descriptor
//   over the same swizzled tile S read K-major. dk/dv: one CTA per (b*h,
//   128-key tile), K and V loaded once, 64-row Q and dO tiles streamed
//   with their 64 lse and delta values in the same stage (the producer
//   warp's lanes write them; TMA brings the tiles). S^T = K Q^T and
//   dP^T = V dO^T put each key in a fragment row, so P^T and dS^T come
//   straight from the accumulators with lse and delta read per column,
//   and dV += P^T dO, dK += dS^T Q take them as register operands, dO and
//   Q MN-major. q tiles start at the first that reaches the key tile;
//   under causality the upper keys' warpgroup starts a tile later than
//   the lower one, so (as in the forward, whose upper rows read more) each
//   warpgroup releases what it read on its own empty barriers and the
//   producer waits for the readers of a stage's tile alone, counting each
//   reader's phase from its own first tile (FLASH_BWD_STALL_WG=w makes
//   warpgroup w lag in both kernels, for the card test). Masks only on
//   tiles that cross Lk, the diagonal or dead rows; in dk/dv keys past Lk
//   compute harmlessly on zero-filled K and V rows and are never stored.
//   Rounding points the plain version lacks: P (for dV) and dS in bf16
//   before their products. Both kernels take one CTA an SM (288 threads
//   need a 9-warp share of the register file: 168 a thread at most). dq
//   holds its accumulator, S and dP (126 registers, no spill); two CTAs an
//   SM capped it at 96 with spills and ran slower. At D = 128 dk/dv would
//   hold 128 accumulator registers beside S^T and dP^T: over the cap, it
//   spilled, so D = 128 stays on the CUDA-core kernels. Issuing the next
//   tile's S and dP behind dq's product, or forming dS^T while dV's
//   product runs, read slower on the card than this plain order.
// - flash_attention_fwd_kernel, flash_attention_dq_kernel and
//   flash_attention_dkv_kernel, the rest: float32 (the parity runs hold
//   it to 1e-4, which TF32 tensor cores would break) and other head
//   sizes. They run the products on the CUDA cores in float32, each
//   thread holding a 4x4 register tile of the 64x64 score tile,
//   shared-memory tiles padded to an odd row stride (no bank conflicts);
//   they never form the [L, L] scores in device memory, skip every tile
//   wholly above the causal diagonal and issue the heavy causal tiles
//   first.
//
// The backward uses no atomics (dq and dk/dv are separate kernels, as in
// the Pallas split), so two runs give bit-identical gradients.
#include "flash_fwd_hopper.cuh"

namespace {

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

// ---------------------------------------------------------------------------
// forward on wgmma and TMA: the body is csrc/flash_fwd_hopper.cuh's, shared
// with the packed forward
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(HopperFwd<D>::THREADS, HopperFwd<D>::MIN_BLOCKS)
flash_attention_fwd_hopper_kernel(const __grid_constant__ CUtensorMap qmap,
                                  const __grid_constant__ CUtensorMap kmap,
                                  const __grid_constant__ CUtensorMap vmap,
                                  __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                                  Shape sh, float scale_log2, const int* __restrict__ seg) {
  fwd_hopper_body<D, false>(qmap, kmap, vmap, out, lse, sh, scale_log2, seg);
}

// ---------------------------------------------------------------------------
// backward on wgmma and TMA (bf16, D = 64): dq and dk/dv, two kernels as in
// the Pallas split, no atomics. A CTA owns BM = 128 rows (q rows for dq,
// keys for dk/dv), two consumer warpgroups of 64 each, and streams BN =
// 64-row tiles of the other side through a ring. Written for any D that
// is a multiple of 64, built for 64 alone (the file's note says why).
// ---------------------------------------------------------------------------
template <int D>
struct HopperBwd {
  static constexpr int BM = 128;                 // rows a CTA owns
  static constexpr int BN = 64;                  // rows a stage streams
  static constexpr int STAGES = 3;
  static constexpr int BOXES = D / 64;           // 64-column boxes of a row
  static constexpr int BIG_BYTES = BM * D * 2;   // Q or dO (dq); K or V (dk/dv)
  static constexpr int TILE_BYTES = BN * D * 2;  // one streamed tile
  static constexpr int A_OFF = 0;                // Q (dq); K (dk/dv)
  static constexpr int B_OFF = BIG_BYTES;        // dO (dq); V (dk/dv)
  static constexpr int R0_OFF = 2 * BIG_BYTES;   // ring: K tiles (dq); Q tiles (dk/dv)
  static constexpr int R1_OFF = R0_OFF + STAGES * TILE_BYTES;    // V tiles; dO tiles
  static constexpr int ROWS_OFF = R1_OFF + STAGES * TILE_BYTES;  // dk/dv: lse, delta a stage
  static constexpr int BAR_OFF = ROWS_OFF + STAGES * 2 * BN * 4;
  // big_full, r0_full[S], r1_full[S], empty[2][S]; 1024 bytes of alignment slack
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 4 * STAGES) + 1024;
  static constexpr int THREADS = 2 * 128 + 32;
};

// The producer's wait before it reloads ring stage s with tile u: every
// consumer warpgroup that read tile u - S must have released it. A
// warpgroup reads a contiguous run of tiles from f (its first) and
// arrives once on empty(w, s) for each tile it reads in stage s: u - S,
// u - 2S, ... back to f, so its release of u - S completes phase
// (u - S - f) / S of that barrier.
__device__ __forceinline__ uint32_t release_parity(int u_prev, int f, int stages) {
  return ((u_prev - f) / stages) & 1;
}

// key tiles [0, n) that q rows [qw, qw + 64) read in the backward: none
// for rows past Lq or dead rows (they pass no gradient to q), else up to
// the diagonal of the tile's last row
template <int BN>
__device__ __forceinline__ int dq_row_tiles(const Shape& sh, int qw, int nkt) {
  if (qw >= sh.Lq) return 0;
  if (!sh.causal) return nkt;
  const int last = qw + 63 + sh.off();  // the last column row qw + 63 sees
  return last < 0 ? 0 : min(nkt, last / BN + 1);
}

// the first q tile that reaches keys [kw, kw + 64), of nqt: rows from
// kw - off on see them under causality (dead rows, when Lq > Lk, see
// every key); keys past Lk read none
template <int BN>
__device__ __forceinline__ int dkv_first_tile(const Shape& sh, int kw, int nqt) {
  if (kw >= sh.Lk) return nqt;
  if (!sh.causal || sh.off() < 0) return 0;
  return min(nqt, max(0, kw - sh.off()) / BN);
}

// A warpgroup's 64 x D float32 accumulator out as bf16 rows [r0, r0 + 64)
// of a [B, L, H, D] tensor: through the warpgroup's own rows of a tile at
// so, swizzled as TMA wrote it (boxes BR rows apart, so the writes meet no
// bank conflicts), then 16-byte stores of the rows below L
template <int D, int BR>
__device__ __forceinline__ void store_rows_bf16(const float (&acc)[D / 2], unsigned char* so,
                                                int wg, int t, __nv_bfloat16* __restrict__ out,
                                                int r0, int L, int b, int h, int H) {
  const int lane = t % 32;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int rl = 16 * (t / 32) + lane / 4 + 8 * ((i & 3) >> 1);
    const int col = 8 * (i >> 2) + 2 * (lane & 3);
    const int box = col / 64, chunk = (col % 64) / 8;
    *reinterpret_cast<uint32_t*>(so + box * BR * 128 + rl * 128 + ((chunk ^ (rl % 8)) * 16) +
                                 (col % 8) * 2) = pack_bf16(acc[i], acc[i + 1]);
  }
  named_sync(1 + wg, 128);
  constexpr int CPR = D / 8;  // 16-byte chunks a row
  for (int idx = t; idx < 64 * CPR; idx += 128) {
    const int rl = idx / CPR, c = idx % CPR, row = r0 + rl;
    if (row >= L) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(so + (c / 8) * BR * 128 + rl * 128 +
                                                    (((c % 8) ^ (rl % 8)) * 16));
    *reinterpret_cast<uint4*>(out + row_base(b, row, h, L, H, D) + c * 8) = v;
  }
}

// dS = P (dP - delta) scale with P = 2^(S scale log2(e) - lse log2(e)), on
// the fragments of one 64 x BN tile of dq (rows ra, ra + 8 of this thread,
// columns from k0), into sc; with `mask` (the tile crosses Lk, the
// diagonal or dead rows) every entry that is not live gets 0
template <int BN>
__device__ __forceinline__ void dq_ds(float (&sc)[BN / 2], const float (&dp)[BN / 2],
                                      const float (&lse2)[2], const float (&dlt)[2],
                                      const Shape& sh, int ra, int k0, int lane,
                                      float scale_log2, bool mask) {
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int r = (i & 3) >> 1;
    float ds = ex2(fmaf(sc[i], scale_log2, -lse2[r])) * (dp[i] - dlt[r]) * sh.scale;
    if (mask) {
      const int col = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      ds = sh.mode(ra + 8 * r, col) == kLive ? ds : 0.f;
    }
    sc[i] = ds;
  }
}

// P^T and dS^T on the fragments of one 64-key x BN-row tile of dk/dv (keys
// ka, ka + 8 of this thread, q rows from q0), lse log2(e) and delta per
// column from the stage: sc becomes P^T, dp dS^T. With `mask` (the tile
// crosses the diagonal or holds dead rows) dead rows weigh every key by
// exp(-lse) and pass no dS, and entries above the diagonal get 0. Keys
// past Lk compute harmlessly: their rows are never stored.
template <int BN>
__device__ __forceinline__ void dkv_p_ds(float (&sc)[BN / 2], float (&dp)[BN / 2],
                                         const float* lse2, const float* dlt, const Shape& sh,
                                         int ka, int q0, int lane, float scale_log2, bool mask) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * (lane & 3);
    const float2 l2 = *reinterpret_cast<const float2*>(lse2 + c);
    const float2 d2 = *reinterpret_cast<const float2*>(dlt + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      const float lc = (e & 1) ? l2.y : l2.x, dc = (e & 1) ? d2.y : d2.x;
      float p = ex2(fmaf(sc[i], scale_log2, -lc));
      float ds = p * (dp[i] - dc) * sh.scale;
      if (mask) {
        const int md = sh.mode(q0 + c + (e & 1), ka + 8 * (e >> 1));
        p = md == kLive ? p : (md == kDead ? ex2(-lc) : 0.f);
        ds = md == kLive ? ds : 0.f;
      }
      sc[i] = p;
      dp[i] = ds;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(HopperBwd<D>::THREADS, 1)
flash_attention_dq_hopper_kernel(const __grid_constant__ CUtensorMap qmap,
                                 const __grid_constant__ CUtensorMap kmap,
                                 const __grid_constant__ CUtensorMap vmap,
                                 const __grid_constant__ CUtensorMap domap,
                                 const float* __restrict__ lse, const float* __restrict__ delta,
                                 __nv_bfloat16* __restrict__ dq, Shape sh, float scale_log2) {
  using C = HopperBwd<D>;
  constexpr int S = C::STAGES, BM = C::BM, BN = C::BN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzled boxes start on 1024 bytes
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t qd_full = base + C::BAR_OFF;   // Q and dO
  auto k_full = [=](int s) { return qd_full + 8 * (1 + s); };
  auto v_full = [=](int s) { return qd_full + 8 * (1 + S + s); };
  auto empty = [=](int w, int s) { return qd_full + 8 * (1 + (2 + w) * S + s); };

  const int bh = blockIdx.x;
  const int b = bh / sh.H, h = bh - b * sh.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // heavy tiles first
  const int off = sh.off();
  const int nkt = (sh.Lk + BN - 1) / BN;
  // warpgroup w reads key tiles [0, n_w); the lower one fewer under causality
  const int n0 = dq_row_tiles<BN>(sh, q0, nkt), n1 = dq_row_tiles<BN>(sh, q0 + 64, nkt);

  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(0, s), 128);
      mbar_init(empty(1, s), 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 2 * 128) {  // the producer warp: one thread issues every copy
    if (threadIdx.x == 2 * 128) {
      mbar_expect_tx(qd_full, 2 * C::BIG_BYTES);
      for (int c = 0; c < C::BOXES; ++c) {
        tma_load_4d(base + C::A_OFF + c * BM * 128, &qmap, qd_full, c * 64, h, q0, b);
        tma_load_4d(base + C::B_OFF + c * BM * 128, &domap, qd_full, c * 64, h, q0, b);
      }
      const int nt = max(n0, n1);
      for (int kt = 0; kt < nt; ++kt) {
        const int s = kt % S;
        if (kt >= S) {  // tile kt - S leaves the stage once each reader of it is done
          if (kt - S < n0) mbar_wait(empty(0, s), release_parity(kt - S, 0, S));
          if (kt - S < n1) mbar_wait(empty(1, s), release_parity(kt - S, 0, S));
        }
        const uint32_t sk = base + C::R0_OFF + s * C::TILE_BYTES;
        const uint32_t sv = base + C::R1_OFF + s * C::TILE_BYTES;
        mbar_expect_tx(k_full(s), C::TILE_BYTES);
        for (int c = 0; c < C::BOXES; ++c)
          tma_load_4d(sk + c * BN * 128, &kmap, k_full(s), c * 64, h, kt * BN, b);
        mbar_expect_tx(v_full(s), C::TILE_BYTES);
        for (int c = 0; c < C::BOXES; ++c)
          tma_load_4d(sv + c * BN * 128, &vmap, v_full(s), c * 64, h, kt * BN, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns q rows [qw, qw + 64); this thread rows ra
  // and ra + 8, whose lse (times log2 e) and delta it holds. Rows past Lq
  // read lse = +inf, so their P is 0.
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, lane = t % 32;
  const int qw = q0 + 64 * wg;
  const int ra = qw + 16 * (t / 32) + lane / 4;
  const int nw = wg ? n1 : n0;
  const bool dead_rows = sh.causal && qw + off < 0;
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = ra + 8 * r;
    lse2[r] = row < sh.Lq ? lse[(size_t)bh * sh.Lq + row] * 1.4426950408889634f : INFINITY;
    dlt[r] = row < sh.Lq ? delta[(size_t)bh * sh.Lq + row] : 0.f;
  }
  float acc[D / 2], sc[BN / 2], dp[BN / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  uint32_t pa[BN / 16][4];  // dS in bf16: the A fragments of its k16 slices
  const uint32_t sq = base + C::A_OFF + wg * 64 * 128, sdo = base + C::B_OFF + wg * 64 * 128;

  mbar_wait(qd_full, 0);  // also before the epilogue reuses the Q rows
  for (int kt = 0; kt < nw; ++kt) {
    const int s = kt % S;
    const uint32_t par = (kt / S) & 1;
#ifdef FLASH_BWD_STALL_WG
    // test hook: this warpgroup lags the other by a while on every tile
    if (wg == FLASH_BWD_STALL_WG) __nanosleep(2000);
#endif
    const uint32_t sk = base + C::R0_OFF + s * C::TILE_BYTES;
    const uint32_t sv = base + C::R1_OFF + s * C::TILE_BYTES;
    mbar_wait(k_full(s), par);
    mma_abt<D, BM, BN>(sc, sq, sk);   // S = Q K^T
    mbar_wait(v_full(s), par);
    mma_abt<D, BM, BN>(dp, sdo, sv);  // dP = dO V^T
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    const int k0 = kt * BN;
    const bool mask =
        dead_rows || k0 + BN > sh.Lk || (sh.causal && k0 + BN - 1 > qw + off);
    dq_ds<BN>(sc, dp, lse2, dlt, sh, ra, k0, lane, scale_log2, mask);
    to_pa<BN>(pa, sc);
    mma_rs_mn<D, BN>(acc, pa, sk);    // dq += dS K, K read MN-major
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
    mbar_arrive(empty(wg, s));
  }
  store_rows_bf16<D, BM>(acc, gbase + C::A_OFF + wg * 64 * 128, wg, t, dq, qw, sh.Lq, b, h,
                         sh.H);
}

template <int D>
__global__ void __launch_bounds__(HopperBwd<D>::THREADS, 1)
flash_attention_dkv_hopper_kernel(const __grid_constant__ CUtensorMap qmap,
                                  const __grid_constant__ CUtensorMap kmap,
                                  const __grid_constant__ CUtensorMap vmap,
                                  const __grid_constant__ CUtensorMap domap,
                                  const float* __restrict__ lse,
                                  const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                                  __nv_bfloat16* __restrict__ dv, Shape sh, float scale_log2) {
  using C = HopperBwd<D>;
  constexpr int S = C::STAGES, BM = C::BM, BN = C::BN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  float* rows = reinterpret_cast<float*>(gbase + C::ROWS_OFF);  // [S][lse2 | delta][BN]
  const uint32_t kv_full = base + C::BAR_OFF;  // K and V
  // full(s): the stage's Q, dO (TMA) and its lse and delta (the producer
  // warp's 32 lanes each write two rows and arrive)
  auto full = [=](int s) { return kv_full + 8 * (1 + s); };
  auto empty = [=](int w, int s) { return kv_full + 8 * (1 + (2 + w) * S + s); };

  const int bh = blockIdx.x;
  const int b = bh / sh.H, h = bh - b * sh.H;
  const int k0 = blockIdx.y * BM;  // light causal key tiles are the late ones
  const int off = sh.off();
  const int nqt = (sh.Lq + BN - 1) / BN;
  // warpgroup w reads q tiles [f_w, nqt); under causality the upper keys'
  // warpgroup starts a tile later: the lower one reads tiles it skips
  const int f0 = dkv_first_tile<BN>(sh, k0, nqt), f1 = dkv_first_tile<BN>(sh, k0 + 64, nqt);
  const int lo = min(f0, f1);

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 32);
      mbar_init(empty(0, s), 128);
      mbar_init(empty(1, s), 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 2 * 128) {  // the producer warp
    const int lane = threadIdx.x - 2 * 128;
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * C::BIG_BYTES);
      for (int c = 0; c < C::BOXES; ++c) {
        tma_load_4d(base + C::A_OFF + c * BM * 128, &kmap, kv_full, c * 64, h, k0, b);
        tma_load_4d(base + C::B_OFF + c * BM * 128, &vmap, kv_full, c * 64, h, k0, b);
      }
    }
    for (int u = lo; u < nqt; ++u) {
      const int s = (u - lo) % S;
      if (u - lo >= S) {  // tile u - S leaves the stage once each reader of it is done
        if (u - S >= f0) mbar_wait(empty(0, s), release_parity(u - S, f0, S));
        if (u - S >= f1) mbar_wait(empty(1, s), release_parity(u - S, f1, S));
      }
      float* sr = rows + s * 2 * BN;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int rl = 2 * lane + j, row = u * BN + rl;
        sr[rl] = row < sh.Lq ? lse[(size_t)bh * sh.Lq + row] * 1.4426950408889634f : INFINITY;
        sr[BN + rl] = row < sh.Lq ? delta[(size_t)bh * sh.Lq + row] : 0.f;
      }
      if (lane == 0) {
        const uint32_t sq = base + C::R0_OFF + s * C::TILE_BYTES;
        const uint32_t sdo = base + C::R1_OFF + s * C::TILE_BYTES;
        mbar_expect_tx(full(s), 2 * C::TILE_BYTES);
        for (int c = 0; c < C::BOXES; ++c) {
          tma_load_4d(sq + c * BN * 128, &qmap, full(s), c * 64, h, u * BN, b);
          tma_load_4d(sdo + c * BN * 128, &domap, full(s), c * 64, h, u * BN, b);
        }
      } else {
        mbar_arrive(full(s));
      }
    }
    return;
  }

  // consumers: warpgroup wg owns keys [kw, kw + 64); this thread keys ka
  // and ka + 8 (its accumulator rows: S^T puts each key in a row)
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, lane = t % 32;
  const int kw = k0 + 64 * wg;
  const int ka = kw + 16 * (t / 32) + lane / 4;
  const int fw = wg ? f1 : f0;
  float dka[D / 2], dva[D / 2], sc[BN / 2], dp[BN / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  uint32_t pp[BN / 16][4], pd[BN / 16][4];  // P^T and dS^T in bf16: A fragments
  const uint32_t sk = base + C::A_OFF + wg * 64 * 128, sv = base + C::B_OFF + wg * 64 * 128;

  mbar_wait(kv_full, 0);  // also before the epilogue reuses the K and V rows
  for (int u = fw; u < nqt; ++u) {
    const int s = (u - lo) % S;
#ifdef FLASH_BWD_STALL_WG
    if (wg == FLASH_BWD_STALL_WG) __nanosleep(2000);
#endif
    const uint32_t sq = base + C::R0_OFF + s * C::TILE_BYTES;
    const uint32_t sdo = base + C::R1_OFF + s * C::TILE_BYTES;
    mbar_wait(full(s), ((u - lo) / S) & 1);
    mma_abt<D, BM, BN>(sc, sk, sq);   // S^T = K Q^T
    mma_abt<D, BM, BN>(dp, sv, sdo);  // dP^T = V dO^T
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    const int q0 = u * BN;
    const bool mask = sh.causal && q0 + off < kw + 63;
    const float* sr = rows + s * 2 * BN;
    dkv_p_ds<BN>(sc, dp, sr, sr + BN, sh, ka, q0, lane, scale_log2, mask);
    to_pa<BN>(pp, sc);
    to_pa<BN>(pd, dp);
    mma_rs_mn<D, BN>(dva, pp, sdo);   // dV += P^T dO
    mma_rs_mn<D, BN>(dka, pd, sq);    // dK += dS^T Q
    wgmma_wait<0>();
    fence_regs(dka);
    fence_regs(dva);
    fence_regs(pp);
    fence_regs(pd);
    mbar_arrive(empty(wg, s));
  }
  store_rows_bf16<D, BM>(dka, gbase + C::A_OFF + wg * 64 * 128, wg, t, dk, kw, sh.Lk, b, h,
                         sh.H);
  store_rows_bf16<D, BM>(dva, gbase + C::B_OFF + wg * 64 * 128, wg, t, dv, kw, sh.Lk, b, h,
                         sh.H);
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

// the wgmma/TMA forward (csrc/flash_fwd_hopper.cuh)
template <int D>
int fwd_hopper(const void* q, const void* k, const void* v, void* out, void* lse, int B,
               Shape sh, cudaStream_t st) {
  return launch_fwd_hopper<D, false>(flash_attention_fwd_hopper_kernel<D>, q, k, v, nullptr,
                                     out, lse, B, sh, st);
}

// the wgmma/TMA backward: dq over 128-row q tiles (Q and dO in boxes of
// 128 rows, K and V streamed in 64), dk/dv over 128-key tiles (the reverse)
template <int D>
int bwd_maps(CUtensorMap (&m)[4], const void* q, const void* k, const void* v, const void* dout,
             int B, Shape sh, int q_rows, int kv_rows) {
  int e = map_bld<D>(&m[0], q, B, sh.H, sh.Lq, q_rows);
  if (!e) e = map_bld<D>(&m[1], k, B, sh.H, sh.Lk, kv_rows);
  if (!e) e = map_bld<D>(&m[2], v, B, sh.H, sh.Lk, kv_rows);
  if (!e) e = map_bld<D>(&m[3], dout, B, sh.H, sh.Lq, q_rows);
  return e;
}

template <int D>
int bwd_dq_hopper(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, void* dq, int B, Shape sh,
                  cudaStream_t st) {
  using C = HopperBwd<D>;
  CUtensorMap m[4];
  const int e = bwd_maps<D>(m, q, k, v, dout, B, sh, C::BM, C::BN);
  if (e) return e;
  auto kern = flash_attention_dq_hopper_kernel<D>;
  cudaError_t ce = allow_smem(kern, C::SMEM);
  if (ce != cudaSuccess) return (int)ce;
  kern<<<dim3(B * sh.H, (sh.Lq + C::BM - 1) / C::BM), C::THREADS, C::SMEM, st>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), sh, sh.scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

template <int D>
int bwd_dkv_hopper(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dk, void* dv, int B, Shape sh,
                   cudaStream_t st) {
  using C = HopperBwd<D>;
  CUtensorMap m[4];
  const int e = bwd_maps<D>(m, q, k, v, dout, B, sh, C::BN, C::BM);
  if (e) return e;
  auto kern = flash_attention_dkv_hopper_kernel<D>;
  cudaError_t ce = allow_smem(kern, C::SMEM);
  if (ce != cudaSuccess) return (int)ce;
  kern<<<dim3(B * sh.H, (sh.Lk + C::BM - 1) / C::BM), C::THREADS, C::SMEM, st>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), sh,
      sh.scale * 1.4426950408889634f);
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

// The wgmma/TMA forward: as flash_attention_forward, for bfloat16 (dtype 1)
// at D = 64 or 128 with 16-byte aligned q, k, v and out; anything else
// returns cudaErrorInvalidValue (the caller routes it to the entry above).
extern "C" int flash_attention_forward_hopper(int dtype, const void* q, const void* k,
                                              const void* v, void* out, void* lse, int B,
                                              int H, int Lq, int Lk, int D, float scale,
                                              int causal, void* stream) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
  if (dtype != 1 || (D != 64 && D != 128) || any % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const Shape sh = make_shape(H, Lq, Lk, D, scale, causal);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return fwd_hopper<64>(q, k, v, out, lse, B, sh, st);
  return fwd_hopper<128>(q, k, v, out, lse, B, sh, st);
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

// The wgmma/TMA backward: as flash_attention_backward_dq and
// flash_attention_backward_dkv, for bfloat16 (dtype 1) at D = 64 with
// 16-byte aligned q, k, v, dout and outputs; anything else returns
// cudaErrorInvalidValue (the caller routes it to the entries above).
static bool bwd_hopper_ok(int dtype, int D, uintptr_t any) {
  return dtype == 1 && D == 64 && any % 16 == 0;
}

extern "C" int flash_attention_backward_dq_hopper(int dtype, const void* q, const void* k,
                                                  const void* v, const void* dout,
                                                  const void* lse, const void* delta, void* dq,
                                                  int B, int H, int Lq, int Lk, int D,
                                                  float scale, int causal, void* stream) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
                        reinterpret_cast<uintptr_t>(dq);
  if (!bwd_hopper_ok(dtype, D, any)) return (int)cudaErrorInvalidValue;
  const Shape sh = make_shape(H, Lq, Lk, D, scale, causal);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bwd_dq_hopper<64>(q, k, v, dout, lse, delta, dq, B, sh, st);
}

extern "C" int flash_attention_backward_dkv_hopper(int dtype, const void* q, const void* k,
                                                   const void* v, const void* dout,
                                                   const void* lse, const void* delta, void* dk,
                                                   void* dv, int B, int H, int Lq, int Lk, int D,
                                                   float scale, int causal, void* stream) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
                        reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv);
  if (!bwd_hopper_ok(dtype, D, any)) return (int)cudaErrorInvalidValue;
  const Shape sh = make_shape(H, Lq, Lk, D, scale, causal);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bwd_dkv_hopper<64>(q, k, v, dout, lse, delta, dk, dv, B, sh, st);
}
