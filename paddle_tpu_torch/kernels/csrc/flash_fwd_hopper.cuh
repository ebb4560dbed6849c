// The wgmma/TMA flash-attention forward, one body for two kernels:
//   flash_attention_fwd_hopper_kernel (flash_attention.cu), SEG = false
//   packed_flash_fwd_hopper_kernel    (packed_flash.cu),    SEG = true
// flash_attention.cu's source note describes the design; this header also
// holds the pieces the wgmma backward (csrc/flash_bwd_hopper.cuh) shares
// (Shape, mma_abt, mma_rs_mn, to_pa, map_bld, the packed kernels' tile
// lists). What segment ids add (packed_flash.cu's note says why):
// - before the loop the CTA lists the key tiles that can hold a live pair
//   for one of its warpgroups (some valid key id inside [min, max] of the
//   warpgroup's valid row ids and, causal, a column at or below one of its
//   rows), at most kMaxKeyTiles of them, and flags each tile per warpgroup:
//   live, and "one id": every key of the tile and every row of the
//   warpgroup carry the same id, so no per-element segment test is needed;
// - the producer warp loads the listed tiles only, and its 32 lanes write
//   each tile's 64 key ids into the stage beside K (two a lane) and
//   arrive on its full barrier (count 32; lane 0's arrival carries the
//   TMA bytes);
// - each consumer warpgroup walks the whole list, computes the tiles live
//   for its rows and, for the rest, waits for the stage and releases it,
//   so every stage is released by both warpgroups once a round;
// - a pair is live when seg_q == seg_k and, with causal, col <= row; each
//   thread holds its two rows' ids in registers.
#pragma once

#include <limits.h>

#include "flash_tiles.cuh"
#include "hopper.cuh"

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

// the packed kernels' lists hold at most this many 64-row tiles: L <= 16384
constexpr int kMaxKeyTiles = 256;

// ---------------------------------------------------------------------------
// forward on wgmma and TMA (bf16, D = 64 or 128): one CTA per (b*h, 128-row
// q tile); two consumer warpgroups of 64 q rows each and one producer warp
// ---------------------------------------------------------------------------
template <int D>
struct HopperFwd {
  static constexpr int BM = 128;                 // q rows a CTA
  static constexpr int BN = 64;                  // keys a stage
  // at D = 64 registers and shared memory leave room for two CTAs an SM
  static constexpr int MIN_BLOCKS = D == 64 ? 2 : 1;
  static constexpr int STAGES = 3;
  static constexpr int BOXES = D / 64;           // 64-column boxes of a row
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;    // one K (or V) tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // q_full, k_full[S], v_full[S], empty[2][S]; 1024 bytes of alignment slack
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 4 * STAGES) + 1024;
  static constexpr int THREADS = 2 * 128 + 32;
  // segment ids (the packed forward): each stage's 64 key ids, the list of
  // key tiles (index << 4 | flags), each tile's flags before the list is
  // compacted, and the row-id statistics
  static constexpr int KID_OFF = BAR_OFF + 128;
  static constexpr int LIST_OFF = KID_OFF + STAGES * BN * 4;
  static constexpr int TFLAG_OFF = LIST_OFF + kMaxKeyTiles * 4;
  static constexpr int STAT_OFF = TFLAG_OFF + kMaxKeyTiles * 4;
  static constexpr int SMEM_SEG = STAT_OFF + 16 * 4 + 1024;
};

// sc = A B^T over the depth D (both K-major), issued, not waited for: A's
// 64 rows at sa in boxes BM rows apart, B's BN rows at sb in boxes BN rows
// apart (D / 64 boxes of 64 columns each). S = Q K^T in the forward and
// dq, S^T = K Q^T and dP^T = V dO^T in dk/dv.
template <int D, int BM, int BN>
__device__ __forceinline__ void mma_abt(float (&sc)[BN / 2], uint32_t sa, uint32_t sb) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t ko = (kk % 4) * 32;  // 16 columns in a box
    wgmma_ss<0, 0>(sc, sw128_desc(sa + (kk / 4) * BM * 128 + ko, 16, 1024),
                   sw128_desc(sb + (kk / 4) * BN * 128 + ko, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// o += A B with A from registers (the bf16 pairs of a 64 x BN accumulator)
// and B the BN x D tile at sb read MN-major, issued: O += P V in the
// forward, dq += dS K, dV += P^T dO and dK += dS^T Q in the backward
template <int D, int BN>
__device__ __forceinline__ void mma_rs_mn(float (&o)[D / 2], const uint32_t (&pa)[BN / 16][4],
                                          uint32_t sb) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    wgmma_rs<1>(o, pa[kk], sw128_desc(sb + kk * 16 * 128, BN * 128, 1024), 1);
  wgmma_commit();
}

// The online softmax of one key tile's scores (this thread's rows ra and
// ra + 8, columns from k0): sc becomes P (f32), alpha the rescale of what
// O holds, l and m updated. Masks only where the tile crosses Lk, the
// diagonal or dead rows (rows [qw, qw + 64) are the warpgroup's), and,
// with segment ids, on tiles not flagged "one id" (seg_mask): there a
// pair is out unless the row's id (rid0, rid1) equals the key's (kid,
// the tile's 64 ids).
template <int BN, bool SEG = false>
__device__ __forceinline__ void fwd_softmax(float (&sc)[BN / 2], float (&m)[2], float (&l)[2],
                                            float (&alpha)[2], const Shape& sh, int ra, int k0,
                                            int lane, float scale_log2, bool dead_rows, int qw,
                                            bool seg_mask = false, int rid0 = 0, int rid1 = 0,
                                            const int* kid = nullptr) {
  const bool mask = dead_rows || k0 + BN > sh.Lk ||
                    (sh.causal && k0 + BN - 1 > qw + sh.off()) || (SEG && seg_mask);
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int e = i & 3;
    float x = sc[i] * scale_log2;
    if (mask) {
      const int row = ra + 8 * (e >> 1);
      const int col = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (e & 1);
      int md = sh.mode(row, col);
      if constexpr (SEG) {
        if (md == kLive && ((e >> 1) ? rid1 : rid0) != kid[col - k0]) md = kOut;
      }
      x = md == kLive ? x : (md == kDead ? 0.f : -INFINITY);
    }
    sc[i] = x;
    mx[e >> 1] = fmaxf(mx[e >> 1], x);
  }
  float mu[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float mn = fmaxf(m[r], mx[r]);
    mu[r] = mn == -INFINITY ? 0.f : mn;
    alpha[r] = ex2(m[r] - mu[r]);
    m[r] = mn;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int r = (i & 3) >> 1;
    sc[i] = ex2(sc[i] - mu[r]);
    l[r] += sc[i];
  }
}

// The key tiles that q rows [qw, qw + 64) read, of the CTA's nkt: the
// rest lie wholly above their diagonal. Dead rows see every column.
template <int BN>
__device__ __forceinline__ int fwd_row_tiles(const Shape& sh, int qw, int nkt) {
  const bool dead_rows = sh.causal && qw + sh.off() < 0;
  return sh.causal && !dead_rows ? min(nkt, (qw + 63 + sh.off()) / BN + 1) : nkt;
}

// a 64 x BN accumulator as bf16 A fragments of its k16 slices
template <int BN>
__device__ __forceinline__ void to_pa(uint32_t (&pa)[BN / 16][4], const float (&sc)[BN / 2]) {
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) pa[i / 8][(i % 8) / 2] = pack_bf16(sc[i], sc[i + 1]);
}

// The packed kernels' lists of streamed tiles (all THREADS threads; ends
// with a __syncthreads): the key tiles of a CTA of q rows (the packed
// forward and dq, OWN_KEYS false) or the q tiles of a CTA of keys (dk/dv,
// OWN_KEYS true, the same test transposed). seg_row: the ids of this CTA's row b. The CTA owns
// rows [r0, r0 + BM) of it (q rows in the forward and dq, keys in dk/dv),
// 64 for each warpgroup, and streams BN-row tiles of the other side. A
// tile is live for warpgroup w when some valid id of the tile lies in
// [min, max] of w's valid ids and, causal, the two can meet: with keys
// streamed (OWN_KEYS false) the tile's first key lies at or below w's last
// row; with q rows streamed (OWN_KEYS true) the tile's last row lies at or
// after w's first key. list[i] = tile << 4 | flags: bit w (1 << w) live
// for warpgroup w, bit 2 + w "one id" for it (the tile is whole, and its
// ids and all 64 of w's are one value). stat[12] = the list's length.
template <int BM, int BN, bool OWN_KEYS>
__device__ __forceinline__ void list_tiles(const Shape& sh, const int* __restrict__ seg_row,
                                           int r0, int* list, int* tflag, int* stat) {
  const int L = sh.Lk, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  // tiles [first, nt) can meet a row of the CTA: causal, streamed keys end
  // at its last row and streamed q rows start at its first key
  int first = 0, last = L;
  if (sh.causal) {
    if (OWN_KEYS)
      first = r0 / BN;
    else
      last = min(L, r0 + BM);
  }
  const int nt = (last + BN - 1) / BN;
  // each warp's first tile's ids load with the CTA's own, in one round trip
  int kt = first + warp, i0 = 0, i1 = 0;
  if (kt < nt) {
    const int c0 = kt * BN + lane, c1 = c0 + 32;
    i0 = c0 < L ? seg_row[c0] : 0;
    i1 = c1 < L ? seg_row[c1] : 0;
  }
  if (threadIdx.x < BM) {  // warps 0-1 hold warpgroup 0's rows, 2-3 warpgroup 1's
    const int row = r0 + threadIdx.x;
    const bool ok = row < L;
    const int id = ok ? seg_row[row] : 0;
    const int lo = __reduce_min_sync(0xffffffffu, ok ? id : INT_MAX);
    const int hi = __reduce_max_sync(0xffffffffu, ok ? id : INT_MIN);
    const int nv = __popc(__ballot_sync(0xffffffffu, ok));
    if (lane == 0) {
      stat[warp] = lo;
      stat[4 + warp] = hi;
      stat[8 + warp] = nv;
    }
  }
  __syncthreads();
  int lo[2], hi[2];
  bool one[2];
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    lo[w] = min(stat[2 * w], stat[2 * w + 1]);
    hi[w] = max(stat[4 + 2 * w], stat[5 + 2 * w]);
    one[w] = lo[w] == hi[w] && stat[8 + 2 * w] + stat[9 + 2 * w] == 64;
  }
  for (; kt < nt; kt += nwarps) {
    const int c0 = kt * BN + lane, c1 = c0 + 32;
    const bool v0 = c0 < L, v1 = c1 < L;
    if (kt >= first + nwarps) {  // later rounds load their ids here
      i0 = v0 ? seg_row[c0] : 0;
      i1 = v1 ? seg_row[c1] : 0;
    }
    const int kmin = __reduce_min_sync(0xffffffffu, min(v0 ? i0 : INT_MAX, v1 ? i1 : INT_MAX));
    const int kmax = __reduce_max_sync(0xffffffffu, max(v0 ? i0 : INT_MIN, v1 ? i1 : INT_MIN));
    const bool full = kt * BN + BN <= L;
    int f = 0;
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      const bool hit = __any_sync(0xffffffffu, (v0 && i0 >= lo[w] && i0 <= hi[w]) ||
                                                   (v1 && i1 >= lo[w] && i1 <= hi[w]));
      const bool meet = !sh.causal || (OWN_KEYS ? kt * BN + BN - 1 >= r0 + 64 * w
                                                : kt * BN <= r0 + 64 * w + 63);
      if (hit && meet) f |= 1 << w;
      if (full && kmin == kmax && one[w] && kmin == lo[w]) f |= 4 << w;
    }
    if (lane == 0) tflag[kt] = f;
  }
  __syncthreads();
  if (warp == 0) {  // compact the live tiles, in order
    int n = 0;
    for (int base = first; base < nt; base += 32) {
      const int kt = base + lane;
      const int f = kt < nt ? tflag[kt] : 0;
      const unsigned live = __ballot_sync(0xffffffffu, (f & 3) != 0);
      if (f & 3) list[n + __popc(live & ((1u << lane) - 1))] = kt << 4 | f;
      n += __popc(live);
    }
    if (lane == 0) stat[12] = n;
  }
  __syncthreads();
}

// The forward's body. SEG = false: flash attention over Shape's masking
// rule (seg unused). SEG = true: packed attention (Lq = Lk = L, no dead
// rows), seg the int32 ids [B, L].
template <int D, bool SEG>
__device__ __forceinline__ void fwd_hopper_body(const CUtensorMap& qmap, const CUtensorMap& kmap,
                                                const CUtensorMap& vmap,
                                                __nv_bfloat16* __restrict__ out,
                                                float* __restrict__ lse, const Shape& sh,
                                                float scale_log2, const int* __restrict__ seg) {
  using C = HopperFwd<D>;
  constexpr int S = C::STAGES, BM = C::BM, BN = C::BN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzled boxes start on 1024 bytes
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t q_full = base + C::BAR_OFF;
  auto k_full = [=](int s) { return q_full + 8 * (1 + s); };
  auto v_full = [=](int s) { return q_full + 8 * (1 + S + s); };
  // empty(w, s): warpgroup w is done with stage s. Each warpgroup has its
  // own, since the two read different numbers of tiles under causality.
  auto empty = [=](int w, int s) { return q_full + 8 * (1 + (2 + w) * S + s); };

  const int bh = blockIdx.x;
  const int b = bh / sh.H, h = bh - b * sh.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // heavy tiles first
  const int off = sh.off();
  // key tiles that can hold a live column for rows [q0, q0 + BM); with dead
  // rows in the tile every column counts
  int hi = sh.Lk;
  if (sh.causal && q0 + off >= 0) hi = min(sh.Lk, q0 + BM + off);
  const int nkt = (hi + BN - 1) / BN;
  // segment ids: this row's ids, the stages' key ids and the tile list
  const int* seg_row = SEG ? seg + (size_t)b * sh.Lk : nullptr;
  int* kids = reinterpret_cast<int*>(gbase + C::KID_OFF);
  int* list = reinterpret_cast<int*>(gbase + C::LIST_OFF);
  int* stat = reinterpret_cast<int*>(gbase + C::STAT_OFF);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(k_full(s), SEG ? 32 : 1);  // SEG: the producer lanes write the key ids
      mbar_init(v_full(s), 1);
      mbar_init(empty(0, s), 128);  // every thread of the warpgroup releases
      mbar_init(empty(1, s), 128);
    }
    mbar_fence_init();
  }
  if constexpr (SEG)
    list_tiles<BM, BN, false>(sh, seg_row, q0, list,
                              reinterpret_cast<int*>(gbase + C::TFLAG_OFF), stat);
  __syncthreads();

  // the producer warp: one thread issues every copy (with segment ids, the
  // warp's lanes write each stage's key ids beside it)
  if (threadIdx.x >= 2 * 128) {
    if constexpr (SEG) {
      const int pl = threadIdx.x - 2 * 128, n = stat[12];
      if (pl == 0) {
        mbar_expect_tx(q_full, C::Q_BYTES);
        for (int c = 0; c < C::BOXES; ++c)
          tma_load_4d(base + c * BM * 128, &qmap, q_full, c * 64, h, q0, b);
      }
      for (int i = 0; i < n; ++i) {
        const int s = i % S, round = i / S, kt = list[i] >> 4;
        if (round > 0) {  // both warpgroups release every stage once a round
          mbar_wait(empty(0, s), (round - 1) & 1);
          mbar_wait(empty(1, s), (round - 1) & 1);
        }
        int* kid = kids + s * BN;
        for (int c = pl; c < BN; c += 32) {
          const int col = kt * BN + c;
          kid[c] = col < sh.Lk ? seg_row[col] : 0;  // past L: masked by mode()
        }
        const uint32_t sk = base + C::K_OFF + s * C::KV_BYTES;
        const uint32_t sv = base + C::V_OFF + s * C::KV_BYTES;
        if (pl == 0) {
          mbar_expect_tx(k_full(s), C::KV_BYTES);
          for (int c = 0; c < C::BOXES; ++c)
            tma_load_4d(sk + c * BN * 128, &kmap, k_full(s), c * 64, h, kt * BN, b);
          mbar_expect_tx(v_full(s), C::KV_BYTES);
          for (int c = 0; c < C::BOXES; ++c)
            tma_load_4d(sv + c * BN * 128, &vmap, v_full(s), c * 64, h, kt * BN, b);
        } else {
          mbar_arrive(k_full(s));
        }
      }
    } else if (threadIdx.x == 2 * 128) {
      mbar_expect_tx(q_full, C::Q_BYTES);
      for (int c = 0; c < C::BOXES; ++c)
        tma_load_4d(base + c * BM * 128, &qmap, q_full, c * 64, h, q0, b);
      const int nw0 = fwd_row_tiles<BN>(sh, q0, nkt), nw1 = fwd_row_tiles<BN>(sh, q0 + 64, nkt);
      for (int kt = 0; kt < nkt; ++kt) {
        const int s = kt % S, round = kt / S;
        if (round > 0) {  // tile kt - S leaves the stage once each reader of it is done
          if (kt - S < nw0) mbar_wait(empty(0, s), (round - 1) & 1);
          if (kt - S < nw1) mbar_wait(empty(1, s), (round - 1) & 1);
        }
        const uint32_t sk = base + C::K_OFF + s * C::KV_BYTES;
        const uint32_t sv = base + C::V_OFF + s * C::KV_BYTES;
        mbar_expect_tx(k_full(s), C::KV_BYTES);
        for (int c = 0; c < C::BOXES; ++c)
          tma_load_4d(sk + c * BN * 128, &kmap, k_full(s), c * 64, h, kt * BN, b);
        mbar_expect_tx(v_full(s), C::KV_BYTES);
        for (int c = 0; c < C::BOXES; ++c)
          tma_load_4d(sv + c * BN * 128, &vmap, v_full(s), c * 64, h, kt * BN, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns q rows [qw, qw + 64); this thread rows
  // ra and ra + 8. It reads key tiles [0, nw) and releases each of them,
  // and only them, on its own empty barriers.
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, lane = t % 32;
  const int qw = q0 + 64 * wg;
  const int ra = qw + 16 * (t / 32) + lane / 4;
  const uint32_t sq = base + wg * 64 * 128;
  const bool dead_rows = sh.causal && qw + off < 0;
  float o[D / 2], sc[BN / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
  uint32_t pa[BN / 16][4];  // P in bf16: the A fragments of its k16 slices
  const uint32_t sk0 = base + C::K_OFF, sv0 = base + C::V_OFF;

  if constexpr (SEG) {
    // Every listed tile in order: live ones computed, the others waited for
    // and released. A live tile's S is issued with the previous live
    // tile's P V (pending) when the two are consecutive in the list;
    // before a skipped tile the pending P V is finished and released, so
    // no stage is held while a later one is waited for.
    const int n = stat[12];
    const int rid0 = ra < sh.Lq ? seg_row[ra] : -1;
    const int rid1 = ra + 8 < sh.Lq ? seg_row[ra + 8] : -1;
    bool pend = false;
    int sp = 0;
    uint32_t pp = 0;
    mbar_wait(q_full, 0);
    for (int i = 0; i < n; ++i) {
      const int s = i % S, f = list[i];
      const uint32_t ph = (i / S) & 1;
      if (!(f & (1 << wg))) {
        if (pend) {
          mbar_wait(v_full(sp), pp);
          mma_rs_mn<D, BN>(o, pa, sv0 + sp * C::KV_BYTES);
          wgmma_wait<0>();
          fence_regs(o);
          mbar_arrive(empty(wg, sp));
          pend = false;
        }
        mbar_wait(k_full(s), ph);  // the stage's copies have landed: release it
        mbar_wait(v_full(s), ph);
        mbar_arrive(empty(wg, s));
        continue;
      }
#ifdef PACKED_FWD_STALL_WG
      // test hook: this warpgroup lags the other by a while on every tile
      if (wg == PACKED_FWD_STALL_WG) __nanosleep(2000);
#endif
      mbar_wait(k_full(s), ph);
      mma_abt<D, BM, BN>(sc, sq, sk0 + s * C::KV_BYTES);
      if (pend) {
        mbar_wait(v_full(sp), pp);
        mma_rs_mn<D, BN>(o, pa, sv0 + sp * C::KV_BYTES);
        wgmma_wait<1>();  // S of this tile is done; the pending P V may run on
      } else {
        wgmma_wait<0>();
      }
      fence_regs(sc);
      fwd_softmax<BN, true>(sc, m, l, alpha, sh, ra, (f >> 4) * BN, lane, scale_log2, false, qw,
                            !(f & (4 << wg)), rid0, rid1, kids + s * BN);
      if (pend) {
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pa);  // the product has read P: pa may be rewritten
      }
#pragma unroll
      for (int j = 0; j < D / 2; ++j) o[j] *= alpha[(j & 3) >> 1];
      to_pa<BN>(pa, sc);
      if (pend) mbar_arrive(empty(wg, sp));
      pend = true;
      sp = s;
      pp = ph;
    }
    if (pend) {
      mbar_wait(v_full(sp), pp);
      mma_rs_mn<D, BN>(o, pa, sv0 + sp * C::KV_BYTES);
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(empty(wg, sp));
    }
  } else {
    const int nw = fwd_row_tiles<BN>(sh, qw, nkt);
    // Tile kt's scores are computed while tile kt - 1's P V runs, and its
    // softmax overlaps that product; O is rescaled once the product is done
    mbar_wait(q_full, 0);
    mbar_wait(k_full(0), 0);
    mma_abt<D, BM, BN>(sc, sq, sk0);
    wgmma_wait<0>();
    fence_regs(sc);
    fwd_softmax<BN>(sc, m, l, alpha, sh, ra, 0, lane, scale_log2, dead_rows, qw);
    to_pa<BN>(pa, sc);
    for (int kt = 1; kt < nw; ++kt) {
      const int s = kt % S, sp = (kt - 1) % S;
#ifdef FLASH_FWD_STALL_WG
      // test hook: this warpgroup lags the other by a while on every tile
      if (wg == FLASH_FWD_STALL_WG) __nanosleep(2000);
#endif
      mbar_wait(k_full(s), (kt / S) & 1);
      mma_abt<D, BM, BN>(sc, sq, sk0 + s * C::KV_BYTES);
      mbar_wait(v_full(sp), ((kt - 1) / S) & 1);
      mma_rs_mn<D, BN>(o, pa, sv0 + sp * C::KV_BYTES);
      wgmma_wait<1>();  // S of tile kt is done; P V of kt - 1 may run on
      fence_regs(sc);
      fwd_softmax<BN>(sc, m, l, alpha, sh, ra, kt * BN, lane, scale_log2, dead_rows, qw);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);  // the product has read P: pa may be rewritten
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i & 3) >> 1];
      to_pa<BN>(pa, sc);
      mbar_arrive(empty(wg, sp));
    }
    const int sl = (nw - 1) % S;
    mbar_wait(v_full(sl), ((nw - 1) / S) & 1);
    mma_rs_mn<D, BN>(o, pa, sv0 + sl * C::KV_BYTES);
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(empty(wg, sl));
  }

  // epilogue: O / l in bf16 into this warpgroup's own q rows (swizzled as
  // TMA wrote q, so the writes meet no bank conflicts), then 16-byte rows out
  float inv[2], lsafe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    lsafe[r] = l[r] == 0.f ? 1.f : l[r];  // the reference's (:88)
    inv[r] = 1.f / lsafe[r];
  }
  unsigned char* so = gbase + wg * 64 * 128;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int r = (i & 3) >> 1;
    const int rl = 16 * (t / 32) + lane / 4 + 8 * r, col = 8 * (i >> 2) + 2 * (lane & 3);
    const int box = col / 64, chunk = (col % 64) / 8;
    *reinterpret_cast<uint32_t*>(so + box * BM * 128 + rl * 128 + ((chunk ^ (rl % 8)) * 16) +
                                 (col % 8) * 2) = pack_bf16(o[i] * inv[r], o[i + 1] * inv[r]);
  }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = ra + 8 * r;
      if (row < sh.Lq)
        lse[(size_t)bh * sh.Lq + row] = (m[r] + log2f(lsafe[r])) * 0.69314718055994531f;
    }
  }
  named_sync(1 + wg, 128);
  constexpr int CPR = D / 8;  // 16-byte chunks a row
  for (int idx = t; idx < 64 * CPR; idx += 128) {
    const int rl = idx / CPR, c = idx % CPR, row = qw + rl;
    if (row >= sh.Lq) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(so + (c / 8) * BM * 128 + rl * 128 +
                                                    (((c % 8) ^ (rl % 8)) * 16));
    *reinterpret_cast<uint4*>(out + row_base(b, row, h, sh.Lq, sh.H, D) + c * 8) = v;
  }
}

// A 4-D tensor map (D, H, L, B) of a [B, L, H, D] bf16 tensor with boxes
// of 64 columns and `rows` rows, so a box past L zero-fills inside its
// own batch
template <int D>
int map_bld(CUtensorMap* map, const void* p, int B, int H, int L, int rows) {
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)H, (uint64_t)L, (uint64_t)B};
  const uint64_t strides[3] = {2ull * D, 2ull * D * H, 2ull * D * H * L};
  const uint32_t box[4] = {64, 1, (uint32_t)rows, 1};
  return encode_bf16_map(map, p, 4, dims, strides, box);
}

// Launch a forward kernel built on fwd_hopper_body<D, SEG>: one tensor map
// per input, a CTA per (b*h, 128-row q tile)
template <int D, bool SEG, typename Kern>
int launch_fwd_hopper(Kern kern, const void* q, const void* k, const void* v, const int* seg,
                      void* out, void* lse, int B, const Shape& sh, cudaStream_t st) {
  using C = HopperFwd<D>;
  CUtensorMap qm, km, vm;
  int e = map_bld<D>(&qm, q, B, sh.H, sh.Lq, C::BM);
  if (!e) e = map_bld<D>(&km, k, B, sh.H, sh.Lk, C::BN);
  if (!e) e = map_bld<D>(&vm, v, B, sh.H, sh.Lk, C::BN);
  if (e) return e;
  const int smem = SEG ? C::SMEM_SEG : C::SMEM;
  cudaError_t ce = allow_smem(kern, smem);
  if (ce != cudaSuccess) return (int)ce;
  kern<<<dim3(B * sh.H, (sh.Lq + C::BM - 1) / C::BM), C::THREADS, smem, st>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), sh,
      sh.scale * 1.4426950408889634f, seg);
  return (int)cudaGetLastError();
}

}  // namespace
