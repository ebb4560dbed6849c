// The wgmma/TMA flash-attention backward, one body for dq and one for
// dk/dv, each run by two kernels:
//   flash_attention_dq_hopper_kernel,  flash_attention_dkv_hopper_kernel
//     (flash_attention.cu), SEG = false
//   packed_flash_dq_hopper_kernel,     packed_flash_dkv_hopper_kernel
//     (packed_flash.cu),    SEG = true
// flash_attention.cu's source note describes the design; packed_flash.cu's
// says why segment ids take it. What segment ids add:
// - before the loop the CTA lists the streamed tiles that can hold a live
//   pair for one of its warpgroups (list_tiles): dq (128 q rows, 64-key
//   tiles) lists key tiles, as the packed forward does; dk/dv (128 keys,
//   64-row Q and dO tiles) q tiles, by the transposed test. Each tile is flagged
//   per warpgroup: live, and "one id" (no per-element segment test needed);
// - the producer warp loads the listed tiles only; its 32 lanes write each
//   stage's 64 streamed ids (key ids in dq; q ids in dk/dv, beside the lse
//   and delta values the stage already carries) and arrive on the stage's
//   full barrier (count 32). Lane 0 issues the copies first, their bytes
//   expected on the barrier without an arrival, so the ids' loads overlap
//   them;
// - both warpgroups walk the whole list: each computes the tiles live for
//   its own rows and waits for and releases the others, so every listed
//   tile is read by both and the producer's release accounting is the
//   unpacked one with f = 0 over list positions;
// - a pair is live when seg_q == seg_k and mode(row, col) == kLive; the
//   per-element test runs on tiles not flagged "one id", on causal
//   diagonal tiles and on tiles that cross L, and a masked entry gets P = 0
//   and dS = 0. Packed attention has no dead rows (Lq = Lk, and each row
//   sees its own column), so kDead never fires under SEG.
#pragma once

#include "flash_fwd_hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// backward on wgmma and TMA (bf16, D = 64): dq and dk/dv, two kernels as in
// the Pallas split, no atomics. A CTA owns BM = 128 rows (q rows for dq,
// keys for dk/dv), two consumer warpgroups of 64 each, and streams BN =
// 64-row tiles of the other side through a ring. Written for any D that
// is a multiple of 64, built for 64 alone (flash_attention.cu's note says
// why).
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
  // segment ids (the packed backward): each stage's 64 streamed ids, the
  // list of streamed tiles (index << 4 | flags), each tile's flags before
  // the list is compacted, and the id statistics of the CTA's own rows
  static constexpr int ID_OFF = BAR_OFF + 128;
  static constexpr int LIST_OFF = ID_OFF + STAGES * BN * 4;
  static constexpr int TFLAG_OFF = LIST_OFF + kMaxKeyTiles * 4;
  static constexpr int STAT_OFF = TFLAG_OFF + kMaxKeyTiles * 4;
  static constexpr int SMEM_SEG = STAT_OFF + 16 * 4 + 1024;
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
// diagonal or dead rows, or, with segment ids, is not flagged "one id")
// every entry that is not live gets 0. SEG: an entry is live only where
// the row's id (rid) equals the key's (kid, the tile's 64 ids).
template <int BN, bool SEG>
__device__ __forceinline__ void dq_ds(float (&sc)[BN / 2], const float (&dp)[BN / 2],
                                      const float (&lse2)[2], const float (&dlt)[2],
                                      const Shape& sh, int ra, int k0, int lane,
                                      float scale_log2, bool mask, const int (&rid)[2],
                                      const int* kid) {
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int r = (i & 3) >> 1;
    float ds = ex2(fmaf(sc[i], scale_log2, -lse2[r])) * (dp[i] - dlt[r]) * sh.scale;
    if (mask) {
      const int col = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      bool live = sh.mode(ra + 8 * r, col) == kLive;
      if constexpr (SEG) live = live && rid[r] == kid[col - k0];
      ds = live ? ds : 0.f;
    }
    sc[i] = ds;
  }
}

// P^T and dS^T on the fragments of one 64-key x BN-row tile of dk/dv (keys
// ka, ka + 8 of this thread, q rows from q0), lse log2(e) and delta per
// column from the stage: sc becomes P^T, dp dS^T. With `mask` (the tile
// crosses the diagonal or holds dead rows, or, with segment ids, is not
// flagged "one id") dead rows weigh every key by exp(-lse) and pass no
// dS, and entries that are not live get 0. SEG: an entry is live only
// where the key's id (kid) equals the row's (qid, the tile's 64 ids).
// Keys past Lk compute harmlessly: their rows are never stored.
template <int BN, bool SEG>
__device__ __forceinline__ void dkv_p_ds(float (&sc)[BN / 2], float (&dp)[BN / 2],
                                         const float* lse2, const float* dlt, const Shape& sh,
                                         int ka, int q0, int lane, float scale_log2, bool mask,
                                         const int (&kid)[2], const int* qid) {
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
        int md = sh.mode(q0 + c + (e & 1), ka + 8 * (e >> 1));
        if constexpr (SEG) {
          if (md == kLive && qid[c + (e & 1)] != kid[e >> 1]) md = kOut;
        }
        p = md == kLive ? p : (md == kDead ? ex2(-lc) : 0.f);
        ds = md == kLive ? ds : 0.f;
      }
      sc[i] = p;
      dp[i] = ds;
    }
  }
}

// dq's body. SEG = false: flash attention over Shape's masking rule (seg
// unused). SEG = true: packed attention (Lq = Lk = L), seg the int32 ids
// [B, L].
template <int D, bool SEG>
__device__ __forceinline__ void dq_hopper_body(const CUtensorMap& qmap, const CUtensorMap& kmap,
                                               const CUtensorMap& vmap, const CUtensorMap& domap,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ delta,
                                               __nv_bfloat16* __restrict__ dq, const Shape& sh,
                                               float scale_log2, const int* __restrict__ seg) {
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
  // segment ids: this row's ids, the stages' key ids and the tile list
  const int* seg_row = SEG ? seg + (size_t)b * sh.Lk : nullptr;
  int* ids = reinterpret_cast<int*>(gbase + C::ID_OFF);
  int* list = reinterpret_cast<int*>(gbase + C::LIST_OFF);
  int* stat = reinterpret_cast<int*>(gbase + C::STAT_OFF);

  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(k_full(s), SEG ? 32 : 1);  // SEG: the producer lanes write the key ids
      mbar_init(v_full(s), 1);
      mbar_init(empty(0, s), 128);
      mbar_init(empty(1, s), 128);
    }
    mbar_fence_init();
    if constexpr (SEG) {  // Q and dO in flight while the CTA lists its tiles
      mbar_expect_tx(qd_full, 2 * C::BIG_BYTES);
      for (int c = 0; c < C::BOXES; ++c) {
        tma_load_4d(base + C::A_OFF + c * BM * 128, &qmap, qd_full, c * 64, h, q0, b);
        tma_load_4d(base + C::B_OFF + c * BM * 128, &domap, qd_full, c * 64, h, q0, b);
      }
    }
  }
  if constexpr (SEG)
    list_tiles<BM, BN, false>(sh, seg_row, q0, list,
                              reinterpret_cast<int*>(gbase + C::TFLAG_OFF), stat);
  __syncthreads();

  // the producer warp: one thread issues every copy (with segment ids, the
  // warp's lanes write each stage's key ids beside it)
  if (threadIdx.x >= 2 * 128) {
    const int pl = threadIdx.x - 2 * 128;
    if constexpr (SEG) {
      const int n = stat[12];
      for (int i = 0; i < n; ++i) {
        const int s = i % S, kt = list[i] >> 4;
        if (i >= S) {  // both warpgroups release every listed tile
          mbar_wait(empty(0, s), release_parity(i - S, 0, S));
          mbar_wait(empty(1, s), release_parity(i - S, 0, S));
        }
        const uint32_t sk = base + C::R0_OFF + s * C::TILE_BYTES;
        const uint32_t sv = base + C::R1_OFF + s * C::TILE_BYTES;
        if (pl == 0) {  // the copies first, so the ids' loads below overlap them
          mbar_expect_bytes(k_full(s), C::TILE_BYTES);
          for (int c = 0; c < C::BOXES; ++c)
            tma_load_4d(sk + c * BN * 128, &kmap, k_full(s), c * 64, h, kt * BN, b);
          mbar_expect_tx(v_full(s), C::TILE_BYTES);
          for (int c = 0; c < C::BOXES; ++c)
            tma_load_4d(sv + c * BN * 128, &vmap, v_full(s), c * 64, h, kt * BN, b);
        }
        int* kid = ids + s * BN;
        for (int c = pl; c < BN; c += 32) {
          const int col = kt * BN + c;
          kid[c] = col < sh.Lk ? seg_row[col] : 0;  // past L: masked by mode()
        }
        mbar_arrive(k_full(s));  // every lane, once its ids are written
      }
    } else if (pl == 0) {
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
  // and ra + 8, whose lse (times log2 e) and delta it holds, and with
  // segment ids their ids (-1 past L). Rows past Lq read lse = +inf, so
  // their P is 0.
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, lane = t % 32;
  const int qw = q0 + 64 * wg;
  const int ra = qw + 16 * (t / 32) + lane / 4;
  const bool dead_rows = sh.causal && qw + off < 0;
  float lse2[2], dlt[2];
  int rid[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = ra + 8 * r;
    lse2[r] = row < sh.Lq ? lse[(size_t)bh * sh.Lq + row] * 1.4426950408889634f : INFINITY;
    dlt[r] = row < sh.Lq ? delta[(size_t)bh * sh.Lq + row] : 0.f;
    if constexpr (SEG) rid[r] = row < sh.Lq ? seg_row[row] : -1;
  }
  float acc[D / 2], sc[BN / 2], dp[BN / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  uint32_t pa[BN / 16][4];  // dS in bf16: the A fragments of its k16 slices
  const uint32_t sq = base + C::A_OFF + wg * 64 * 128, sdo = base + C::B_OFF + wg * 64 * 128;

  mbar_wait(qd_full, 0);  // also before the epilogue reuses the Q rows
  // key tiles [0, n_w) in order; with segment ids every listed tile, the
  // ones not live for these rows waited for and released
  const int n = SEG ? stat[12] : (wg ? n1 : n0);
  for (int i = 0; i < n; ++i) {
    const int s = i % S;
    const uint32_t par = (i / S) & 1;
    int k0 = i * BN, f = 0;
    if constexpr (SEG) {
      f = list[i];
      k0 = (f >> 4) * BN;
      if (!(f & (1 << wg))) {
        mbar_wait(k_full(s), par);  // the stage's copies have landed: release it
        mbar_wait(v_full(s), par);
        mbar_arrive(empty(wg, s));
        continue;
      }
    }
    // test hooks: this warpgroup lags the other by a while on every tile
#ifdef FLASH_BWD_STALL_WG
    if (!SEG && wg == FLASH_BWD_STALL_WG) __nanosleep(2000);
#endif
#ifdef PACKED_BWD_STALL_WG
    if (SEG && wg == PACKED_BWD_STALL_WG) __nanosleep(2000);
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
    const bool mask = dead_rows || k0 + BN > sh.Lk || (sh.causal && k0 + BN - 1 > qw + off) ||
                      (SEG && !(f & (4 << wg)));
    dq_ds<BN, SEG>(sc, dp, lse2, dlt, sh, ra, k0, lane, scale_log2, mask, rid, ids + s * BN);
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

// dk/dv's body; SEG as in dq_hopper_body
template <int D, bool SEG>
__device__ __forceinline__ void dkv_hopper_body(const CUtensorMap& qmap, const CUtensorMap& kmap,
                                                const CUtensorMap& vmap, const CUtensorMap& domap,
                                                const float* __restrict__ lse,
                                                const float* __restrict__ delta,
                                                __nv_bfloat16* __restrict__ dk,
                                                __nv_bfloat16* __restrict__ dv, const Shape& sh,
                                                float scale_log2, const int* __restrict__ seg) {
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
  // warpgroup starts a tile later: the lower one reads tiles it skips.
  // Tile u sits at ring position u - lo. With segment ids both read every
  // listed tile, at its list position.
  const int f0 = SEG ? 0 : dkv_first_tile<BN>(sh, k0, nqt);
  const int f1 = SEG ? 0 : dkv_first_tile<BN>(sh, k0 + 64, nqt);
  const int lo = min(f0, f1);
  // segment ids: this row's ids, the stages' q ids and the tile list
  const int* seg_row = SEG ? seg + (size_t)b * sh.Lq : nullptr;
  int* ids = reinterpret_cast<int*>(gbase + C::ID_OFF);
  int* list = reinterpret_cast<int*>(gbase + C::LIST_OFF);
  int* stat = reinterpret_cast<int*>(gbase + C::STAT_OFF);

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 32);
      mbar_init(empty(0, s), 128);
      mbar_init(empty(1, s), 128);
    }
    mbar_fence_init();
    if constexpr (SEG) {  // K and V in flight while the CTA lists its tiles
      mbar_expect_tx(kv_full, 2 * C::BIG_BYTES);
      for (int c = 0; c < C::BOXES; ++c) {
        tma_load_4d(base + C::A_OFF + c * BM * 128, &kmap, kv_full, c * 64, h, k0, b);
        tma_load_4d(base + C::B_OFF + c * BM * 128, &vmap, kv_full, c * 64, h, k0, b);
      }
    }
  }
  if constexpr (SEG)
    list_tiles<BM, BN, true>(sh, seg_row, k0, list,
                             reinterpret_cast<int*>(gbase + C::TFLAG_OFF), stat);
  __syncthreads();
  const int n = SEG ? stat[12] : nqt - lo;  // ring positions

  if (threadIdx.x >= 2 * 128) {  // the producer warp
    const int lane = threadIdx.x - 2 * 128;
    if (!SEG && lane == 0) {
      mbar_expect_tx(kv_full, 2 * C::BIG_BYTES);
      for (int c = 0; c < C::BOXES; ++c) {
        tma_load_4d(base + C::A_OFF + c * BM * 128, &kmap, kv_full, c * 64, h, k0, b);
        tma_load_4d(base + C::B_OFF + c * BM * 128, &vmap, kv_full, c * 64, h, k0, b);
      }
    }
    for (int i = 0; i < n; ++i) {
      const int s = i % S, u = SEG ? list[i] >> 4 : lo + i;
      if (i >= S) {  // the tile of position i - S leaves the stage once each reader of it is done
        const int up = lo + i - S;
        if (SEG || up >= f0) mbar_wait(empty(0, s), release_parity(up, f0, S));
        if (SEG || up >= f1) mbar_wait(empty(1, s), release_parity(up, f1, S));
      }
      const uint32_t sq = base + C::R0_OFF + s * C::TILE_BYTES;
      const uint32_t sdo = base + C::R1_OFF + s * C::TILE_BYTES;
      auto copy = [&] {
        for (int c = 0; c < C::BOXES; ++c) {
          tma_load_4d(sq + c * BN * 128, &qmap, full(s), c * 64, h, u * BN, b);
          tma_load_4d(sdo + c * BN * 128, &domap, full(s), c * 64, h, u * BN, b);
        }
      };
      if (SEG && lane == 0) {  // the copies first, so the row loads below overlap them
        mbar_expect_bytes(full(s), 2 * C::TILE_BYTES);
        copy();
      }
      float* sr = rows + s * 2 * BN;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int rl = 2 * lane + j, row = u * BN + rl;
        sr[rl] = row < sh.Lq ? lse[(size_t)bh * sh.Lq + row] * 1.4426950408889634f : INFINITY;
        sr[BN + rl] = row < sh.Lq ? delta[(size_t)bh * sh.Lq + row] : 0.f;
        if constexpr (SEG) ids[s * BN + rl] = row < sh.Lq ? seg_row[row] : 0;
      }
      if (!SEG && lane == 0) {
        mbar_expect_tx(full(s), 2 * C::TILE_BYTES);
        copy();
      } else {
        mbar_arrive(full(s));  // SEG: every lane, once its rows are written
      }
    }
    return;
  }

  // consumers: warpgroup wg owns keys [kw, kw + 64); this thread keys ka
  // and ka + 8 (its accumulator rows: S^T puts each key in a row), and with
  // segment ids their ids (-1 past L)
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, lane = t % 32;
  const int kw = k0 + 64 * wg;
  const int ka = kw + 16 * (t / 32) + lane / 4;
  const int fw = wg ? f1 : f0;
  int kid[2] = {0, 0};
  if constexpr (SEG) {
#pragma unroll
    for (int r = 0; r < 2; ++r) kid[r] = ka + 8 * r < sh.Lk ? seg_row[ka + 8 * r] : -1;
  }
  float dka[D / 2], dva[D / 2], sc[BN / 2], dp[BN / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  uint32_t pp[BN / 16][4], pd[BN / 16][4];  // P^T and dS^T in bf16: A fragments
  const uint32_t sk = base + C::A_OFF + wg * 64 * 128, sv = base + C::B_OFF + wg * 64 * 128;

  mbar_wait(kv_full, 0);  // also before the epilogue reuses the K and V rows
  for (int i = fw - lo; i < n; ++i) {
    const int s = i % S;
    const uint32_t par = (i / S) & 1;
    int u = lo + i, f = 0;
    if constexpr (SEG) {
      f = list[i];
      u = f >> 4;
      if (!(f & (1 << wg))) {
        mbar_wait(full(s), par);  // the stage has landed: release it
        mbar_arrive(empty(wg, s));
        continue;
      }
    }
#ifdef FLASH_BWD_STALL_WG
    if (!SEG && wg == FLASH_BWD_STALL_WG) __nanosleep(2000);
#endif
#ifdef PACKED_BWD_STALL_WG
    if (SEG && wg == PACKED_BWD_STALL_WG) __nanosleep(2000);
#endif
    const uint32_t sq = base + C::R0_OFF + s * C::TILE_BYTES;
    const uint32_t sdo = base + C::R1_OFF + s * C::TILE_BYTES;
    mbar_wait(full(s), par);
    mma_abt<D, BM, BN>(sc, sk, sq);   // S^T = K Q^T
    mma_abt<D, BM, BN>(dp, sv, sdo);  // dP^T = V dO^T
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    const int q0 = u * BN;
    const bool mask = (sh.causal && q0 + off < kw + 63) || (SEG && !(f & (4 << wg)));
    const float* sr = rows + s * 2 * BN;
    dkv_p_ds<BN, SEG>(sc, dp, sr, sr + BN, sh, ka, q0, lane, scale_log2, mask, kid,
                      ids + s * BN);
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

// the backward's tensor maps: q and dO in boxes of q_rows rows, k and v in
// boxes of kv_rows (dq: Q and dO 128 rows, K and V streamed in 64; dk/dv
// the reverse)
template <int D>
int bwd_maps(CUtensorMap (&m)[4], const void* q, const void* k, const void* v, const void* dout,
             int B, const Shape& sh, int q_rows, int kv_rows) {
  int e = map_bld<D>(&m[0], q, B, sh.H, sh.Lq, q_rows);
  if (!e) e = map_bld<D>(&m[1], k, B, sh.H, sh.Lk, kv_rows);
  if (!e) e = map_bld<D>(&m[2], v, B, sh.H, sh.Lk, kv_rows);
  if (!e) e = map_bld<D>(&m[3], dout, B, sh.H, sh.Lq, q_rows);
  return e;
}

// Launch a dq kernel built on dq_hopper_body<D, SEG>: a CTA per (b*h,
// 128-row q tile)
template <int D, bool SEG, typename Kern>
int launch_dq_hopper(Kern kern, const void* q, const void* k, const void* v, const void* dout,
                     const int* seg, const void* lse, const void* delta, void* dq, int B,
                     const Shape& sh, cudaStream_t st) {
  using C = HopperBwd<D>;
  CUtensorMap m[4];
  const int e = bwd_maps<D>(m, q, k, v, dout, B, sh, C::BM, C::BN);
  if (e) return e;
  const int smem = SEG ? C::SMEM_SEG : C::SMEM;
  cudaError_t ce = allow_smem(kern, smem);
  if (ce != cudaSuccess) return (int)ce;
  kern<<<dim3(B * sh.H, (sh.Lq + C::BM - 1) / C::BM), C::THREADS, smem, st>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), sh, sh.scale * 1.4426950408889634f, seg);
  return (int)cudaGetLastError();
}

// Launch a dk/dv kernel built on dkv_hopper_body<D, SEG>: a CTA per (b*h,
// 128-key tile)
template <int D, bool SEG, typename Kern>
int launch_dkv_hopper(Kern kern, const void* q, const void* k, const void* v, const void* dout,
                      const int* seg, const void* lse, const void* delta, void* dk, void* dv,
                      int B, const Shape& sh, cudaStream_t st) {
  using C = HopperBwd<D>;
  CUtensorMap m[4];
  const int e = bwd_maps<D>(m, q, k, v, dout, B, sh, C::BN, C::BM);
  if (e) return e;
  const int smem = SEG ? C::SMEM_SEG : C::SMEM;
  cudaError_t ce = allow_smem(kern, smem);
  if (ce != cudaSuccess) return (int)ce;
  kern<<<dim3(B * sh.H, (sh.Lk + C::BM - 1) / C::BM), C::THREADS, smem, st>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), sh,
      sh.scale * 1.4426950408889634f, seg);
  return (int)cudaGetLastError();
}

}  // namespace
