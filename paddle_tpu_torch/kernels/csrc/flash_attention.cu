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
//   Both bodies are csrc/flash_bwd_hopper.cuh's, which packed_flash.cu's
//   packed_flash_dq_hopper_kernel and packed_flash_dkv_hopper_kernel run
//   with segment ids.
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
#include "flash_bwd_hopper.cuh"
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
// backward on wgmma and TMA (bf16, D = 64): the bodies are
// csrc/flash_bwd_hopper.cuh's, shared with the packed backward (seg unused)
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(HopperBwd<D>::THREADS, 1)
flash_attention_dq_hopper_kernel(const __grid_constant__ CUtensorMap qmap,
                                 const __grid_constant__ CUtensorMap kmap,
                                 const __grid_constant__ CUtensorMap vmap,
                                 const __grid_constant__ CUtensorMap domap,
                                 const float* __restrict__ lse, const float* __restrict__ delta,
                                 __nv_bfloat16* __restrict__ dq, Shape sh, float scale_log2,
                                 const int* __restrict__ seg) {
  dq_hopper_body<D, false>(qmap, kmap, vmap, domap, lse, delta, dq, sh, scale_log2, seg);
}

template <int D>
__global__ void __launch_bounds__(HopperBwd<D>::THREADS, 1)
flash_attention_dkv_hopper_kernel(const __grid_constant__ CUtensorMap qmap,
                                  const __grid_constant__ CUtensorMap kmap,
                                  const __grid_constant__ CUtensorMap vmap,
                                  const __grid_constant__ CUtensorMap domap,
                                  const float* __restrict__ lse,
                                  const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                                  __nv_bfloat16* __restrict__ dv, Shape sh, float scale_log2,
                                  const int* __restrict__ seg) {
  dkv_hopper_body<D, false>(qmap, kmap, vmap, domap, lse, delta, dk, dv, sh, scale_log2, seg);
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
  return launch_dq_hopper<64, false>(flash_attention_dq_hopper_kernel<64>, q, k, v, dout, nullptr,
                                     lse, delta, dq, B, sh, st);
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
  return launch_dkv_hopper<64, false>(flash_attention_dkv_hopper_kernel<64>, q, k, v, dout,
                                      nullptr, lse, delta, dk, dv, B, sh, st);
}
