// Fused LM head + softmax cross entropy for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernels of paddle_tpu/kernels/fused_ce_pallas.py:
//   fused_ce_fwd_hopper_kernel, fused_ce_fwd_kernel
//                        <- _fwd_kernel    (:62)  per-token (m, l, target)
//                                                  of softmax(h @ w^T)
//   fused_ce_dh_hopper_kernel<false, *>, fused_ce_dh_kernel<T, false>
//                        <- _bwd_dh_kernel (:101) dh = dl @ w
//   fused_ce_dw_hopper_kernel, fused_ce_dw_kernel
//                        <- _bwd_dw_kernel (:129) dw = dl^T @ h
// with dl = (softmax(h @ w^T) - onehot(label)) * g recomputed tile by tile,
// so the [T, V] logits never reach device memory, forward or backward.
// The shared-dl pair (the reference's _SHARE_P) trades dw's recompute for
// one bf16 [T, V] buffer:
//   fused_ce_dh_hopper_kernel<true, *>, fused_ce_dh_kernel<T, true>
//                                 <- _bwd_dh_kernel_sharep (:158) dh as
//                                    above, and each dl tile stored as bf16
//   fused_ce_dw_sharep_kernel     <- _bwd_dw_kernel_sharep (:189) dw = dl^T @ h
//                                    over the stored dl: no logits, no exp
//
// Layout: h [T, d] and w [V, d] row-major (the tied head: logits = h @ w^T),
// labels int32 [T], lse and g float32 [T]; dh [T, d] and dw [V, d] in the
// inputs' type. Inputs float32 or bfloat16, the same type for h and w. Any
// T and V: token rows >= T load as zeros and are never written, vocab
// columns >= V count as -inf (probability 0, no gradient). A label outside
// [0, V) picks no column: its nll is the lse and its one-hot is zero. d is
// padded with zeros to a multiple of 16 inside shared memory; d <= 768.
//
// What bounds these kernels on this card: at GPT-2 small's training shape
// (T = 16384, d = 768, V = 50304) each of the three does 1.3-2.5 TFLOP
// against ~100 MB of operands, far above the ~295 operations per byte at
// which the tensor cores become the limit: the bound is operations. The
// design does this about it:
// - bfloat16 goes through the tensor cores (nvcuda::wmma 16x16x16, bf16 in,
//   f32 accumulation). float32, used by the parity runs, takes a plain FFMA
//   path in the same templates (one Engine per type), so its products are
//   full float32, summed 16 terms at a time before they join the total.
// - Each block keeps one operand tile resident in shared memory for its
//   whole life (the forward's and dh's token tile, dw's vocab tile) and
//   streams the other through a ring of buffers with cp.async, so the next
//   tiles load while this one computes. The backward's second product
//   reuses the streamed tile: w (dh) or h (dw) is read once per tile for
//   both products. The accumulators of dh ([32, d]) and dw ([32, d]) stay
//   in registers, their columns split across the 8 warps; d is never split
//   across the grid, so the logits product is computed once per tile.
// - Each fragment loaded from shared memory feeds more than one product: a
//   logits warp tile is 32 x 16 (one B fragment, two products) and a dh/dw
//   warp owns both 16-row slices of its columns. A logits tile with fewer
//   warp tiles than warps splits its d range across warps (partial tiles
//   summed in a fixed order in the epilogue).
// The forward splits the vocabulary across grid.y (fused_ce_forward_splits
// picks enough blocks for every SM at any T) and writes per-split (m, l,
// target); a small PyTorch reduction combines them (fused_ce.py).
// chip_smoke.py times the split forward against a single split. No atomics
// anywhere: every output
// element is summed by one block in a fixed order, so two launches give
// bit-identical results.
// The shared-dl pair: the dh kernel stores the dl tile it already holds in
// shared memory (the same tile that feeds its dh product, so in bf16 dh is
// the recomputing kernel's bit for bit; in float32 a bf16 rounding of the
// float tile) with 16-byte stores into rows of V rounded up to 8 columns,
// the columns past V as zeros. dw_sharep is then one plain product, dw =
// dl^T @ h: 1.27 TFLOP at the training shape (1.28 ms at the bf16 peak)
// against a 1.65 GB dl read once (0.49 ms at 3.35 TB/s): bound by
// operations, if dl is read from memory about once.
// Two designs, chosen in kernels/fused_ce.py by dtype and d alone
// (hopper_dw_sharep):
// - fused_ce_dw_sharep_hopper_kernel, bf16 h with d a multiple of 8: a
//   GEMM with M = V, N = d, K = T on wgmma and TMA. One CTA per 128 x 256
//   tile of dw (d = 768: three column tiles); two consumer warpgroups each
//   hold a 64 x 256 float32 accumulator in registers (m64n256k16, both
//   operands MN-major: dl^T from dl's [token, vocab] rows, h as it lies);
//   one producer warp keeps a 4-stage TMA ring of (dl [64 tokens x 128
//   vocab], h [64 tokens x 256]) tiles, 48 KB a stage; a stage is
//   released once the next tile's products are issued and its own are
//   done. The three column tiles of a vocab block are neighbours in
//   launch order, so they run together and can share its dl tiles
//   through L2; h (25 MB) fits in L2. Edges (V, T, d) zero-fill by TMA;
//   rows >= V and columns >= d are never stored. No split over T: each
//   dw element is summed by one CTA in a fixed order, so two launches are
//   bit-identical. Its dw equals the recomputing dw's in bf16 when both
//   form dl alike (the same k16 slices of the same bf16 dl in the same
//   token order): the wgmma dh_sharep and the wgmma dw both add the
//   logits' two halves of d in one order (chip_smoke.py reports
//   dw_bit_identical_to_row11); a dl formed another way can round one bf16
//   step apart.
// - fused_ce_dw_sharep_kernel, float32 and d % 8 != 0: the first design,
//   (h, dl) tile pairs through the three-stage cp.async ring, float32
//   widening dl in shared memory; one block owns each 32-row dw tile.
// Two designs of the forward, chosen in kernels/fused_ce.py by dtype, d and
// alignment alone (hopper_recompute, the predicate of the recomputing
// backward below):
// - fused_ce_fwd_hopper_kernel<kFull>, bf16 h and w with d a multiple of 8:
//   wgmma and TMA. One CTA per (64-token block, vocab split): h's block
//   resident in shared memory as twelve swizzled [64 x 64] boxes (96 KB,
//   one TMA load); a producer warp streams w as [128 vocab x 64 d] boxes
//   (16 KB) through an 8-stage ring (128 KB), tile after tile, each tile's
//   boxes along d; two consumer warpgroups take alternate 128-vocab tiles,
//   each forming S = h w^T [64 x 128] in 64 float32 registers a thread
//   (m64n128k16, both operands K-major, 4 k16 steps a box, 48 at
//   d = 768), releasing each box's stage once the next box's products are
//   issued and its own are done. The logits never leave the registers:
//   the row max and sum take two quad shuffles each, exp by ex2 with the
//   log2(e) prescale folded into one FFMA, the label's logit picked by the
//   lane that holds its column; each warpgroup keeps its own running
//   (m, l, target) for the 64 rows, and at the end warpgroup 1's state
//   goes through shared memory and warpgroup 0 merges it after its own,
//   in that fixed order, into the split's parts. While one warpgroup runs
//   its softmax the other's products keep the tensor cores busy: the
//   ring's order (tile j's boxes before tile j + 1's) staggers them. Each
//   warpgroup has its own full barrier a stage: it reads a stage only in
//   alternate runs of rounds, and a parity wait on a barrier that also
//   counts the other's rounds could be two phases ahead and pass on an
//   old phase; the single empty barrier a stage counts the 128 arrivals
//   of the box's one reader, and the producer waits on it every round.
//   1.27 TFLOP at the training shape (1.28 ms at the bf16 peak); every
//   CTA streams all of its split's w (77 MB at one split) through L2, 64
//   FLOP a byte of it. The vocab split (grid.y) comes from T, V and the
//   SM count (fwd_hopper_splits): one CTA an SM (its 226 KB of shared
//   memory leave room for no second) in whole waves while the token
//   blocks are fewer than the SMs, one split from there on; no atomics,
//   so two launches give the same bits. kFull (d > 704) unrolls the box
//   loop over all twelve boxes; below, the loop runs over the
//   ceil(d / 64) boxes that hold d. FUSED_CE_FWD_STALL_WG=w makes
//   warpgroup w lag on every tile (a card test holds that build to the
//   plain one's bits).
// - fused_ce_fwd_kernel<T>, float32 and other d: the first design below.
//   Why it stood 9x above its bound: nvcuda::wmma 16x16x16 fragments,
//   each 32-vocab tile's logits stored from the fragments to a float tile
//   in shared memory and read back by every thread for the online max
//   and sum (a barrier before and after, a shared-memory pass the size of
//   the logits), the load, the product and the softmax in turn between
//   __syncthreads(), and w streamed in 32-row tiles of all of d, so the
//   ring held two tiles and the tensor cores idled through every softmax.
// Two designs of the recomputing dw, chosen in kernels/fused_ce.py by dtype,
// d and alignment alone (hopper_recompute):
// - fused_ce_dw_hopper_kernel, bf16 h and w with d a multiple of 8: wgmma
//   and TMA. The dw row block [64 x d] of one CTA lives in the registers of
//   two consumer warpgroups, 384 columns each (192 float32 a thread at
//   d = 768; a 128-row block would need twice that), so d is split inside
//   the CTA and no logits are recomputed: 2.56 TFLOP at the training
//   shape. w's 64-row block stays in shared memory (96 KB); h streams in
//   32-token tiles (48 KB, all of d) through a 2-stage TMA ring; each
//   warpgroup forms the logits' partial over its half of d (m64n32k16),
//   the two partials meet in a double-buffered exchange in shared memory
//   and are added in one order, dl^T goes to bf16 A fragments in
//   registers and dw += dl^T h (m64n128k16, h MN-major from the same
//   stage). One named barrier a tile; thread 0 issues the next tile once
//   it has passed it (both warpgroups' products on the stage it reuses are
//   then done); no producer warp, so 255 registers a thread are there for
//   the accumulators (242 used, no spill). Neither dw's accumulators nor
//   the logits' are written by any instruction but a wgmma inside the
//   loop (the first tile's products ignore them): a zeroing move between
//   the products made the compiler serialise every wgmma (8.4 against
//   10.2 ms). Below d = 641 the CTA loads and multiplies only the
//   128-column chunks that hold d (at d = 64 two of the twelve boxes),
//   on a second build whose products are predicated on the warpgroup's
//   chunk count; ptxas serialises that build's wgmma (C7520), so the
//   training shape keeps the build with every chunk live.
// - fused_ce_dw_kernel, float32 and other d: the first design below.
// Two designs of the recomputing dh and of the shared-dl pair's dh pass,
// chosen by the same predicate (hopper_recompute):
// - fused_ce_dh_hopper_kernel<kStoreDl, kFull>, bf16 h and w with d a
//   multiple of 8: the dw design above with tokens and vocabulary
//   swapped. One CTA per 64-token block, its dh rows [64 x d] in the two
//   warpgroups' registers; h's block resident (96 KB), w streamed in
//   32-vocab-row tiles through the 2-stage ring; the CTA's labels, lse and
//   g loaded once into shared memory. Per tile the partial logits
//   S_c [64 tokens x 32 vocab] = h[:, c] w[:, c]^T, summed S_0 + S_1 in
//   shared memory, dl in float32 rounded to bf16 A fragments, and
//   dh[:, c] += dl w[:, c] (w MN-major from the same stage). 2.53 TFLOP at
//   the training shape, 256 CTAs; every CTA streams all of w (77 MB, more
//   than L2), and the CTAs of a wave walk the vocabulary in step, so one
//   read of each tile from memory serves the wave through L2. kStoreDl
//   (the shared-dl pair) also writes the bf16 fragments that feed dh's
//   product to dl: each warpgroup one of its two rows, a 4 x 4 transpose
//   across each quad of lanes giving a lane 8 columns, one 16-byte store
//   (evict-first, so 1.65 GB of dl does not push w's tiles out of L2).
//   So its dh equals the recomputing dh bit for bit.
// - fused_ce_dh_kernel<T, kStoreDl>, float32 and other d: the first design.
// What holds the first designs (the forward, dh and dw in float32) ~10x
// above their bound: one block of 8 warps per SM (its shared memory and
// register accumulators leave room for no second) runs the phases of a
// tile (load, logits product, dl, second product) one after another
// between barriers, so their latencies add up, and the 32-row tiles
// stream all of w (or h) through L2 for every block.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxD = 768;  // the dh/dw register accumulators cover d <= 768

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

// exp of the softmax: the intrinsic for bf16 (its error is far below bf16's
// rounding), the accurate expf for the float32 parity path
template <typename T>
__device__ __forceinline__ float soft_exp(float x);
template <>
__device__ __forceinline__ float soft_exp<bf16>(float x) { return __expf(x); }
template <>
__device__ __forceinline__ float soft_exp<float>(float x) { return expf(x); }

// Tile sizes and shared-memory row padding per input type. PAD keeps bf16
// rows 16-byte aligned (cp.async, wmma's ldm rule); float rows get an odd
// stride so the FFMA loops read shared memory without bank conflicts (and
// load synchronously: cp.async needs 16-byte aligned rows).
template <typename T>
struct Cfg;
template <>
struct Cfg<bf16> {
  static constexpr int PAD = 8, CPAD = 4, LPAD = 8;
  static constexpr int FWD_BT = 64, FWD_BV = 32;  // resident tokens, streamed vocab
  static constexpr int DH_BT = 32, DH_BV = 32;    // resident tokens, streamed vocab
  static constexpr int DW_BV = 32, DW_BT = 32;    // resident vocab, streamed tokens
  static constexpr int FWD_STAGES = 2, DH_STAGES = 3, DW_STAGES = 3;  // streamed buffers
};
template <>
struct Cfg<float> {
  static constexpr int PAD = 1, CPAD = 1, LPAD = 1;
  static constexpr int FWD_BT = 32, FWD_BV = 16;
  static constexpr int DH_BT = 32, DH_BV = 16;
  static constexpr int DW_BV = 32, DW_BT = 16;
  static constexpr int FWD_STAGES = 2, DH_STAGES = 2, DW_STAGES = 2;
};

// ---------------------------------------------------------------------------
// Engines: acc[16 x 16] += A[16 x 16] . B[16 x 16] for one warp, A and B in
// shared memory, row- or column-major. A(m, k) is a[m * lda + k] (row) or
// a[k * lda + m] (col); B(k, n) is b[k * ldb + n] (row) or b[n * ldb + k].
// ---------------------------------------------------------------------------
template <bool ROW>
struct WLayout {
  using type = wmma::row_major;
};
template <>
struct WLayout<false> {
  using type = wmma::col_major;
};

template <typename T>
struct Engine;

template <>
struct Engine<bf16> {  // tensor cores
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  template <bool ROW>
  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, typename WLayout<ROW>::type>;
  template <bool ROW>
  using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, typename WLayout<ROW>::type>;
  static __device__ __forceinline__ void zero(Acc& a) { wmma::fill_fragment(a, 0.f); }
  static __device__ __forceinline__ void add(Acc& a, const Acc& b) {
#pragma unroll
    for (int e = 0; e < a.num_elements; ++e) a.x[e] += b.x[e];
  }
  template <bool ROW>
  static __device__ __forceinline__ void load_a(FragA<ROW>& f, const bf16* p, int ld) {
    wmma::load_matrix_sync(f, p, ld);
  }
  template <bool ROW>
  static __device__ __forceinline__ void load_b(FragB<ROW>& f, const bf16* p, int ld) {
    wmma::load_matrix_sync(f, p, ld);
  }
  template <bool AR, bool BR>
  static __device__ __forceinline__ void mma(Acc& acc, const FragA<AR>& a, const FragB<BR>& b) {
    wmma::mma_sync(acc, a, b, acc);
  }
  static __device__ __forceinline__ void store(float* c, int ldc, const Acc& a) {
    wmma::store_matrix_sync(c, a, ldc, wmma::mem_row_major);
  }
};

struct FmaAcc {
  float x[8];
};
template <bool ROW>
struct SmemRef {
  const float* p;
  int ld;
};

template <>
struct Engine<float> {  // CUDA cores; lane owns row lane/2, 8 columns
  using Acc = FmaAcc;
  template <bool ROW>
  using FragA = SmemRef<ROW>;
  template <bool ROW>
  using FragB = SmemRef<ROW>;
  static __device__ __forceinline__ void zero(Acc& a) {
#pragma unroll
    for (int j = 0; j < 8; ++j) a.x[j] = 0.f;
  }
  static __device__ __forceinline__ void add(Acc& a, const Acc& b) {
#pragma unroll
    for (int j = 0; j < 8; ++j) a.x[j] += b.x[j];
  }
  template <bool ROW>
  static __device__ __forceinline__ void load_a(FragA<ROW>& f, const float* p, int ld) {
    f.p = p;
    f.ld = ld;
  }
  template <bool ROW>
  static __device__ __forceinline__ void load_b(FragB<ROW>& f, const float* p, int ld) {
    f.p = p;
    f.ld = ld;
  }
  template <bool AR, bool BR>
  static __device__ __forceinline__ void mma(Acc& acc, const FragA<AR>& a, const FragB<BR>& b) {
    const int lane = threadIdx.x & 31, r = lane >> 1, c0 = (lane & 1) * 8;
    float part[8];  // 16 terms summed apart, then added: a shorter error walk
#pragma unroll
    for (int j = 0; j < 8; ++j) part[j] = 0.f;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float av = AR ? a.p[r * a.ld + k] : a.p[k * a.ld + r];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float bv = BR ? b.p[k * b.ld + c0 + j] : b.p[(c0 + j) * b.ld + k];
        part[j] = fmaf(av, bv, part[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) acc.x[j] += part[j];
  }
  static __device__ __forceinline__ void store(float* c, int ldc, const Acc& a) {
    const int lane = threadIdx.x & 31, r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) c[r * ldc + c0 + j] = a.x[j];
  }
};

// ---------------------------------------------------------------------------
// building blocks
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}
// the first nbytes (0..16) of src, the rest of the 16 bytes zeros
__device__ __forceinline__ void cp_async_n(void* dst, const void* src, int nbytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(nbytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's copy groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [r0, r0 + rows) of src [*, d] into dst [rows][ld] as T, columns
// [d, dpad) and rows past nrows (the ragged tail) as zeros. bf16 rows with
// 16-byte aligned sources go by cp.async (complete after the next commit
// and wait); the rest load synchronously.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* __restrict__ src, int r0,
                                          int nrows, int rows, int d, int dpad, bool vec) {
  constexpr int VE = 16 / sizeof(T);
  constexpr bool kAsync = (Cfg<T>::PAD * sizeof(T)) % 16 == 0;
  if (vec) {  // d % VE == 0 and src 16-byte aligned
    // chunk i = threadIdx.x + n * kThreads is chunk cc of row r (cpr chunks
    // a row); both step without a division per chunk
    const int cpr = dpad / VE, sr = kThreads / cpr, sc = kThreads - sr * cpr;
    int r = threadIdx.x / cpr, cc = threadIdx.x - r * cpr;
#pragma unroll 4
    for (int i = threadIdx.x; i < rows * cpr; i += kThreads) {
      const int c = cc * VE;
      const bool in = r < nrows && c < d;
      const T* from = in ? src + (size_t)(r0 + r) * d + c : src;
      if (kAsync) {
        cp_async16(dst + r * ld + c, from, in);
      } else {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (in) v = *reinterpret_cast<const uint4*>(from);
        const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
        for (int j = 0; j < VE; ++j) dst[r * ld + c + j] = e[j];
      }
      r += sr;
      cc += sc;
      if (cc >= cpr) {
        cc -= cpr;
        ++r;
      }
    }
  } else {
    for (int i = threadIdx.x; i < rows * dpad; i += kThreads) {
      const int r = i / dpad, c = i - r * dpad;
      dst[r * ld + c] = (r < nrows && c < d) ? src[(size_t)(r0 + r) * d + c] : from_f32<T>(0.f);
    }
  }
}

// per-row label / lse / g of rows [r0, r0 + rows); rows >= T get a label
// that matches nothing, lse 0 and g 0, so their dl is exactly 0
__device__ __forceinline__ void load_row_stats(int* slab, float* slse, float* sg,
                                               const int* __restrict__ lab,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ g, int r0, int rows,
                                               int T) {
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    const bool in = r0 + i < T;
    slab[i] = in ? lab[r0 + i] : -1;
    slse[i] = in ? lse[r0 + i] : 0.f;
    sg[i] = in ? g[r0 + i] : 0.f;
  }
}

// How a BT x BV logits tile is spread over the warps: a warp computes WI
// 16-row slices of one 16-column slice (the B fragment loaded once for
// WI products); with fewer such warp tiles than warps, each one's d range
// is split in KSPLIT parts (partial tiles at ss + part * BT * lds, summed
// in a fixed order by logit()).
template <int BT, int BV>
struct LogitsSplit {
  static constexpr int NI = BT / 16, NJ = BV / 16, WI = NI < 2 ? NI : 2;
  static constexpr int GROUPS = (NI / WI) * NJ;
  static constexpr int KSPLIT = GROUPS >= kWarps ? 1 : kWarps / GROUPS;
  static constexpr int TPW = GROUPS >= kWarps ? GROUPS / kWarps : 1;
  static_assert(GROUPS % kWarps == 0 || kWarps % GROUPS == 0, "tiles and warps divide");
};

template <int BT, int BV>
__device__ __forceinline__ float logit(const float* ss, int lds, int r, int c) {
  float s = ss[r * lds + c];
#pragma unroll
  for (int p = 1; p < LogitsSplit<BT, BV>::KSPLIT; ++p) s += ss[p * BT * lds + r * lds + c];
  return s;
}

// ss[BT x BV] = sa[BT x dpad] . sb[BV x dpad]^T (the logits tile), f32
template <typename T, int BT, int BV>
__device__ __forceinline__ void logits_tile(float* ss, int lds, const T* sa, const T* sb, int ld,
                                            int dpad) {
  using E = Engine<T>;
  using S = LogitsSplit<BT, BV>;
  constexpr int WI = S::WI, IB = S::NI / WI;
  const int warp = threadIdx.x >> 5;
  const int steps = dpad / 16, per = (steps + S::KSPLIT - 1) / S::KSPLIT;
  const int part = S::KSPLIT > 1 ? warp / S::GROUPS : 0;
  const int k_lo = part * per * 16, k_hi = min(dpad, (part + 1) * per * 16);
#pragma unroll
  for (int u = 0; u < S::TPW; ++u) {
    const int grp = S::KSPLIT > 1 ? warp % S::GROUPS : warp + u * kWarps;
    const int i0 = (grp % IB) * WI, j = grp / IB;
    const T* b = sb + j * 16 * ld;
    typename E::Acc acc[WI];
#pragma unroll
    for (int wi = 0; wi < WI; ++wi) E::zero(acc[wi]);
    for (int k = k_lo; k < k_hi; k += 16) {
      typename E::template FragB<false> fb;
      E::template load_b<false>(fb, b + k, ld);
#pragma unroll
      for (int wi = 0; wi < WI; ++wi) {
        typename E::template FragA<true> fa;
        E::template load_a<true>(fa, sa + (i0 + wi) * 16 * ld + k, ld);
        E::template mma<true, false>(acc[wi], fa, fb);
      }
    }
#pragma unroll
    for (int wi = 0; wi < WI; ++wi)
      E::store(ss + part * BT * lds + (i0 + wi) * 16 * lds + j * 16, lds, acc[wi]);
  }
}

// dl[r][c] = (exp(s - lse_r) - [col == label_r]) * g_r for the tile whose
// logits are in ss (rows r of the token side, columns c of the vocab side
// starting at v0); columns >= V give 0
template <typename T, int BT, int BV>
__device__ __forceinline__ void dlogits_tile(T* sdl, int ldl, const float* ss, int lds,
                                             const int* slab, const float* slse,
                                             const float* sg, int v0, int V) {
  for (int i = threadIdx.x; i < BT * BV; i += kThreads) {
    const int r = i / BV, c = i - r * BV, col = v0 + c;
    float val = 0.f;
    if (col < V) {
      const float p = soft_exp<T>(logit<BT, BV>(ss, lds, r, c) - slse[r]);
      val = (p - (col == slab[r] ? 1.f : 0.f)) * sg[r];
    }
    sdl[r * ldl + c] = from_f32<T>(val);
  }
}

// the dl tile (BT x BV in sdl, T) to rows [t0, t0 + nrows) of dl (bf16, row
// stride ldd), columns [v0, v0 + BV) below vend (V rounded up to 8; the
// tile's columns >= V hold zeros), one 16-byte chunk of 8 columns a thread
template <typename T, int BT, int BV>
__device__ __forceinline__ void store_dl_tile(bf16* __restrict__ dl, int ldd, const T* sdl,
                                              int ldl, int t0, int nrows, int v0, int vend) {
  constexpr int CPR = BV / 8;
  static_assert(BV % 8 == 0, "whole 16-byte chunks");
  for (int i = threadIdx.x; i < BT * CPR; i += kThreads) {
    const int r = i / CPR, c = (i - r * CPR) * 8;
    if (r >= nrows || v0 + c >= vend) continue;
    uint4 v;
    if constexpr (std::is_same<T, bf16>::value) {
      v = *reinterpret_cast<const uint4*>(sdl + r * ldl + c);  // ldl * 2 bytes: 16-byte rows
    } else {
      bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(sdl[r * ldl + c + j]);
    }
    *reinterpret_cast<uint4*>(dl + (size_t)(t0 + r) * ldd + v0 + c) = v;
  }
}

// rows [t0, t0 + nrows) x columns [v0, v0 + BV) of dl (bf16, row stride
// ldd, rows 16-byte aligned) into dst [BT][ldl] as T; columns >= V (never
// read) and rows past nrows as zeros. bf16 goes by cp.async (complete after
// the next commit and wait), float32 is widened synchronously.
template <typename T, int BT, int BV>
__device__ __forceinline__ void load_dl_tile(T* dst, int ldl, const bf16* __restrict__ dl, int ldd,
                                             int t0, int nrows, int v0, int V) {
  constexpr int CPR = BV / 8;
  for (int i = threadIdx.x; i < BT * CPR; i += kThreads) {
    const int r = i / CPR, c = (i - r * CPR) * 8, col = v0 + c;
    const int n = r < nrows ? max(0, min(8, V - col)) : 0;  // live columns of the chunk
    const bf16* src = n ? dl + (size_t)(t0 + r) * ldd + col : dl;
    if constexpr (std::is_same<T, bf16>::value) {
      cp_async_n(dst + r * ldl + c, src, 2 * n);
    } else {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      bf16* e = reinterpret_cast<bf16*>(&v);
      if (n == 8) {
        v = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int j = 0; j < n; ++j) e[j] = src[j];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[r * ldl + c + j] = j < n ? __bfloat162float(e[j]) : 0.f;
    }
  }
}

template <typename T, int R>
using AccArray = typename Engine<T>::Acc[(R / 16) * (kMaxD / 16 / kWarps)];

// acc[R x dpad] += A[R x K] . B[K x dpad] with B row-major in shared memory
// (ldb) and A row-major (AR) or column-major; each warp owns every 16-row
// slice of every kWarps-th 16-column slice of d (warp, warp + 8, ...), so
// each B fragment feeds R/16 products. acc[i * NJW + u] is row slice i of
// column slice warp + u * kWarps.
template <typename T, int R, int K, bool AR>
__device__ __forceinline__ void acc_product(AccArray<T, R>& acc, const T* sa, int lda,
                                            const T* sb, int ldb, int dpad) {
  using E = Engine<T>;
  constexpr int NI = R / 16, NJW = kMaxD / 16 / kWarps;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; k += 16) {
    typename E::template FragA<AR> fa[NI];
#pragma unroll
    for (int i = 0; i < NI; ++i)
      E::template load_a<AR>(fa[i], AR ? sa + i * 16 * lda + k : sa + k * lda + i * 16, lda);
#pragma unroll
    for (int u = 0; u < NJW; ++u) {
      const int j = warp + u * kWarps;  // 16-column slice of d
      if (j * 16 < dpad) {
        typename E::template FragB<true> fb;
        E::template load_b<true>(fb, sb + k * ldb + j * 16, ldb);
#pragma unroll
        for (int i = 0; i < NI; ++i) E::template mma<AR, true>(acc[i * NJW + u], fa[i], fb);
      }
    }
  }
}

// the accumulators to out rows [r0, r0 + min(R, nrows)) through shared
// memory (sc, ldc), converted to T
template <typename T, int R>
__device__ __forceinline__ void store_acc(T* __restrict__ out, float* sc, int ldc,
                                          const AccArray<T, R>& acc, int r0, int nrows, int d,
                                          int dpad) {
  using E = Engine<T>;
  constexpr int NI = R / 16, NJW = kMaxD / 16 / kWarps;
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // every warp is done reading the tiles sc overlays
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int u = 0; u < NJW; ++u) {
      const int j = warp + u * kWarps;
      if (j * 16 < dpad) E::store(sc + i * 16 * ldc + j * 16, ldc, acc[i * NJW + u]);
    }
  __syncthreads();
  const int n = min(R, nrows);
  for (int e = threadIdx.x; e < n * d; e += kThreads) {
    const int r = e / d, c = e - r * d;
    out[(size_t)(r0 + r) * d + c] = from_f32<T>(sc[r * ldc + c]);
  }
}

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

// Shared memory of a kernel: the resident tile (RES rows), STAGES buffers
// of the streamed tile (STR rows), KSPLIT partial logits tiles [BT x LDS],
// the dl tile and the per-row stats. The f32 accumulator store at the end
// overlays the start.
template <typename T, int RES, int STR, int BT, int BV, int ACC_ROWS, int STAGES>
struct Plan {
  static constexpr int LDS = BV + 4, LDL = BV + Cfg<T>::LPAD;
  int ld, ldc;
  size_t str_off, str_bytes, ss_off, sdl_off, stat_off, bytes;
  __host__ __device__ explicit Plan(int dpad) {
    ld = dpad + Cfg<T>::PAD;
    ldc = dpad + Cfg<T>::CPAD;
    str_off = align128((size_t)RES * ld * sizeof(T));
    str_bytes = align128((size_t)STR * ld * sizeof(T));
    ss_off = str_off + STAGES * str_bytes;
    sdl_off = ss_off + align128((size_t)LogitsSplit<BT, BV>::KSPLIT * BT * LDS * sizeof(float));
    stat_off = sdl_off + align128((size_t)BT * LDL * sizeof(T));
    const size_t end = stat_off + (size_t)3 * BT * 4;
    const size_t acc = (size_t)ACC_ROWS * ldc * sizeof(float);
    bytes = end > acc ? end : acc;
  }
};

template <typename T>
using FwdPlan = Plan<T, Cfg<T>::FWD_BT, Cfg<T>::FWD_BV, Cfg<T>::FWD_BT, Cfg<T>::FWD_BV, 0,
                     Cfg<T>::FWD_STAGES>;
template <typename T>
using DhPlan = Plan<T, Cfg<T>::DH_BT, Cfg<T>::DH_BV, Cfg<T>::DH_BT, Cfg<T>::DH_BV, Cfg<T>::DH_BT,
                    Cfg<T>::DH_STAGES>;
template <typename T>
using DwPlan = Plan<T, Cfg<T>::DW_BV, Cfg<T>::DW_BT, Cfg<T>::DW_BT, Cfg<T>::DW_BV, Cfg<T>::DW_BV,
                    Cfg<T>::DW_STAGES>;

// Shared memory of dw_sharep: STAGES buffers, each an h tile [DW_BT x ld]
// and a dl tile [DW_BT x LDL]; the f32 accumulator store at the end
// overlays the start.
template <typename T>
struct DwSharepPlan {
  static constexpr int BV = Cfg<T>::DW_BV, BT = Cfg<T>::DW_BT, STAGES = Cfg<T>::DW_STAGES;
  static constexpr int LDL = BV + Cfg<T>::LPAD;
  int ld, ldc;
  size_t dl_off, stage_bytes, bytes;
  __host__ __device__ explicit DwSharepPlan(int dpad) {
    ld = dpad + Cfg<T>::PAD;
    ldc = dpad + Cfg<T>::CPAD;
    dl_off = align128((size_t)BT * ld * sizeof(T));
    stage_bytes = dl_off + align128((size_t)BT * LDL * sizeof(T));
    const size_t end = STAGES * stage_bytes, acc = (size_t)BV * ldc * sizeof(float);
    bytes = end > acc ? end : acc;
  }
};

// The streamed tiles go through a ring of S buffers: S - 1 tiles are in
// flight before the loop; iteration i waits for tile i, passes a barrier
// (after which no warp still reads buffer (i - 1) % S) and only then
// issues tile i + S - 1 into that buffer, one copy group a tile.
template <typename P>
__device__ __forceinline__ unsigned char* stage(unsigned char* smem, const P& plan, int i,
                                                int stages) {
  return smem + plan.str_off + (size_t)(i % stages) * plan.str_bytes;
}

// ---------------------------------------------------------------------------
// forward: one block per (FWD_BT-token tile, vocab split); streams the
// split's vocab tiles with an online (m, l) and picks the label's logit
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_ce_fwd_kernel(const T* __restrict__ h, const T* __restrict__ w, const int* __restrict__ lab,
                    float* __restrict__ m_out, float* __restrict__ l_out,
                    float* __restrict__ t_out, int T_, int V, int d, int dpad, int tiles_per_split,
                    bool vec) {
  using P = FwdPlan<T>;
  constexpr int BT = Cfg<T>::FWD_BT, BV = Cfg<T>::FWD_BV;
  constexpr int TPR = kThreads / BT, CPT = BV / TPR;  // threads a row, columns a thread
  static_assert(TPR <= 32 && 32 % TPR == 0, "a row's threads share a warp");
  extern __shared__ __align__(128) unsigned char smem[];
  const P plan(dpad);
  T* sh = reinterpret_cast<T*>(smem);
  float* ss = reinterpret_cast<float*>(smem + plan.ss_off);

  const int t0 = blockIdx.x * BT;
  const int nvt = (V + BV - 1) / BV;
  const int vt_lo = blockIdx.y * tiles_per_split;
  const int vt_hi = min(nvt, vt_lo + tiles_per_split);
  constexpr int S = Cfg<T>::FWD_STAGES;
  load_rows(sh, plan.ld, h, t0, T_ - t0, BT, d, dpad, vec);
  for (int p = 0; p < S - 1; ++p) {
    const int vt = vt_lo + p;
    if (vt < vt_hi)
      load_rows(reinterpret_cast<T*>(stage(smem, plan, p, S)), plan.ld, w, vt * BV,
                V - vt * BV, BV, d, dpad, vec);
    cp_async_commit();
  }

  const int r = threadIdx.x / TPR, q = threadIdx.x % TPR;
  // a label past V would otherwise match a masked column of the last tile
  const int label = t0 + r < T_ && lab[t0 + r] < V ? lab[t0 + r] : -1;
  float m = -INFINITY, l = 0.f, tgt = 0.f;
  for (int vt = vt_lo; vt < vt_hi; ++vt) {
    const int v0 = vt * BV, i = vt - vt_lo, nx = vt + S - 1;
    cp_async_wait<S - 2>();
    __syncthreads();
    if (nx < vt_hi)
      load_rows(reinterpret_cast<T*>(stage(smem, plan, i + S - 1, S)), plan.ld, w, nx * BV,
                V - nx * BV, BV, d, dpad, vec);
    cp_async_commit();
    logits_tile<T, BT, BV>(ss, P::LDS, sh, reinterpret_cast<const T*>(stage(smem, plan, i, S)),
                           plan.ld, dpad);
    __syncthreads();
    float s[CPT], mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = q + j * TPR, col = v0 + c;
      s[j] = col < V ? logit<BT, BV>(ss, P::LDS, r, c) : -INFINITY;
      if (col == label) tgt += s[j];
      mx = fmaxf(mx, s[j]);
    }
#pragma unroll
    for (int o = TPR / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_new = fmaxf(m, mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) sum += s[j] == -INFINITY ? 0.f : soft_exp<T>(s[j] - m_new);
#pragma unroll
    for (int o = TPR / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float alpha = m == -INFINITY ? 0.f : soft_exp<T>(m - m_new);
    l = l * alpha + sum;
    m = m_new;
    // no trailing barrier: the next iteration's barrier comes before
    // anything rewrites ss or this buffer
  }
  cp_async_wait<0>();  // an empty split leaves its resident tile's copy
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1) tgt += __shfl_xor_sync(0xffffffffu, tgt, o);
  if (q == 0 && t0 + r < T_) {
    const size_t at = (size_t)blockIdx.y * T_ + t0 + r;
    m_out[at] = m;
    l_out[at] = l;
    t_out[at] = tgt;
  }
}

// ---------------------------------------------------------------------------
// backward dh: one block per DH_BT-token tile; streams every vocab tile.
// With kStoreDl (the shared-dl pair) each dl tile also goes to dl [T, ldd].
// ---------------------------------------------------------------------------
template <typename T, bool kStoreDl>
__global__ void __launch_bounds__(kThreads)
fused_ce_dh_kernel(const T* __restrict__ h, const T* __restrict__ w, const int* __restrict__ lab,
                   const float* __restrict__ lse, const float* __restrict__ g,
                   T* __restrict__ dh, bf16* __restrict__ dl, int ldd, int T_, int V, int d,
                   int dpad, bool vec) {
  using P = DhPlan<T>;
  constexpr int BT = Cfg<T>::DH_BT, BV = Cfg<T>::DH_BV;
  extern __shared__ __align__(128) unsigned char smem[];
  const P plan(dpad);
  T* sh = reinterpret_cast<T*>(smem);
  float* ss = reinterpret_cast<float*>(smem + plan.ss_off);
  T* sdl = reinterpret_cast<T*>(smem + plan.sdl_off);
  int* slab = reinterpret_cast<int*>(smem + plan.stat_off);
  float* slse = reinterpret_cast<float*>(slab + BT);
  float* sg = slse + BT;

  constexpr int S = Cfg<T>::DH_STAGES;
  const int t0 = blockIdx.x * BT, ntiles = (V + BV - 1) / BV;
  load_rows(sh, plan.ld, h, t0, T_ - t0, BT, d, dpad, vec);
  for (int p = 0; p < S - 1; ++p) {
    if (p < ntiles)
      load_rows(reinterpret_cast<T*>(stage(smem, plan, p, S)), plan.ld, w, p * BV, V - p * BV,
                BV, d, dpad, vec);
    cp_async_commit();
  }
  load_row_stats(slab, slse, sg, lab, lse, g, t0, BT, T_);
  AccArray<T, BT> acc;
#pragma unroll
  for (int u = 0; u < (BT / 16) * (kMaxD / 16 / kWarps); ++u) Engine<T>::zero(acc[u]);

  for (int it = 0; it < ntiles; ++it) {
    const int v0 = it * BV, nx = it + S - 1;
    cp_async_wait<S - 2>();
    __syncthreads();
    if (nx < ntiles)
      load_rows(reinterpret_cast<T*>(stage(smem, plan, nx, S)), plan.ld, w, nx * BV,
                V - nx * BV, BV, d, dpad, vec);
    cp_async_commit();
    const T* sw = reinterpret_cast<const T*>(stage(smem, plan, it, S));
    logits_tile<T, BT, BV>(ss, P::LDS, sh, sw, plan.ld, dpad);
    __syncthreads();
    dlogits_tile<T, BT, BV>(sdl, P::LDL, ss, P::LDS, slab, slse, sg, v0, V);
    __syncthreads();
    // both only read sdl; the next iteration's barriers come before its rewrite
    if (kStoreDl) store_dl_tile<T, BT, BV>(dl, ldd, sdl, P::LDL, t0, T_ - t0, v0, (V + 7) & ~7);
    acc_product<T, BT, BV, true>(acc, sdl, P::LDL, sw, plan.ld, dpad);  // dl @ w
  }
  store_acc<T, BT>(dh, reinterpret_cast<float*>(smem), plan.ldc, acc, t0, T_ - t0, d, dpad);
}

// ---------------------------------------------------------------------------
// backward dw: one block per DW_BV-row vocab tile; streams every token tile
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_ce_dw_kernel(const T* __restrict__ h, const T* __restrict__ w, const int* __restrict__ lab,
                   const float* __restrict__ lse, const float* __restrict__ g,
                   T* __restrict__ dw, int T_, int V, int d, int dpad, bool vec) {
  using P = DwPlan<T>;
  constexpr int BV = Cfg<T>::DW_BV, BT = Cfg<T>::DW_BT;
  extern __shared__ __align__(128) unsigned char smem[];
  const P plan(dpad);
  T* sw = reinterpret_cast<T*>(smem);
  float* ss = reinterpret_cast<float*>(smem + plan.ss_off);
  T* sdl = reinterpret_cast<T*>(smem + plan.sdl_off);
  int* slab = reinterpret_cast<int*>(smem + plan.stat_off);
  float* slse = reinterpret_cast<float*>(slab + BT);
  float* sg = slse + BT;

  constexpr int S = Cfg<T>::DW_STAGES;
  const int v0 = blockIdx.x * BV, ntiles = (T_ + BT - 1) / BT;
  load_rows(sw, plan.ld, w, v0, V - v0, BV, d, dpad, vec);
  for (int p = 0; p < S - 1; ++p) {
    if (p < ntiles)
      load_rows(reinterpret_cast<T*>(stage(smem, plan, p, S)), plan.ld, h, p * BT, T_ - p * BT,
                BT, d, dpad, vec);
    cp_async_commit();
  }
  AccArray<T, BV> acc;
#pragma unroll
  for (int u = 0; u < (BV / 16) * (kMaxD / 16 / kWarps); ++u) Engine<T>::zero(acc[u]);

  for (int it = 0; it < ntiles; ++it) {
    const int t0 = it * BT, nx = it + S - 1;
    cp_async_wait<S - 2>();
    __syncthreads();
    if (nx < ntiles)
      load_rows(reinterpret_cast<T*>(stage(smem, plan, nx, S)), plan.ld, h, nx * BT,
                T_ - nx * BT, BT, d, dpad, vec);
    cp_async_commit();
    // the last tile's dl pass, which read the stats, ended before a barrier
    load_row_stats(slab, slse, sg, lab, lse, g, t0, BT, T_);
    const T* sh = reinterpret_cast<const T*>(stage(smem, plan, it, S));
    logits_tile<T, BT, BV>(ss, P::LDS, sh, sw, plan.ld, dpad);
    __syncthreads();
    dlogits_tile<T, BT, BV>(sdl, P::LDL, ss, P::LDS, slab, slse, sg, v0, V);
    __syncthreads();
    acc_product<T, BV, BT, false>(acc, sdl, P::LDL, sh, plan.ld, dpad);  // dl^T @ h
  }
  store_acc<T, BV>(dw, reinterpret_cast<float*>(smem), plan.ldc, acc, v0, V - v0, d, dpad);
}

// ---------------------------------------------------------------------------
// backward dw over a stored dl (the shared-dl pair): one block per DW_BV-row
// vocab tile; streams every (dl, h) token tile; dw = dl^T @ h
// ---------------------------------------------------------------------------
template <typename T>
__device__ __forceinline__ void load_dw_sharep_stage(unsigned char* smem,
                                                     const DwSharepPlan<T>& plan, int t,
                                                     const T* __restrict__ h,
                                                     const bf16* __restrict__ dl, int ldd, int T_,
                                                     int v0, int V, int d, int dpad, bool vec) {
  using P = DwSharepPlan<T>;
  unsigned char* st = smem + (size_t)(t % P::STAGES) * plan.stage_bytes;
  const int t0 = t * P::BT;
  load_rows(reinterpret_cast<T*>(st), plan.ld, h, t0, T_ - t0, P::BT, d, dpad, vec);
  load_dl_tile<T, P::BT, P::BV>(reinterpret_cast<T*>(st + plan.dl_off), P::LDL, dl, ldd, t0,
                                T_ - t0, v0, V);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_ce_dw_sharep_kernel(const T* __restrict__ h, const bf16* __restrict__ dl,
                          T* __restrict__ dw, int ldd, int T_, int V, int d, int dpad, bool vec) {
  using P = DwSharepPlan<T>;
  constexpr int BV = P::BV, BT = P::BT, S = P::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  const P plan(dpad);
  const int v0 = blockIdx.x * BV, ntiles = (T_ + BT - 1) / BT;
  for (int p = 0; p < S - 1; ++p) {
    if (p < ntiles) load_dw_sharep_stage<T>(smem, plan, p, h, dl, ldd, T_, v0, V, d, dpad, vec);
    cp_async_commit();
  }
  AccArray<T, BV> acc;
#pragma unroll
  for (int u = 0; u < (BV / 16) * (kMaxD / 16 / kWarps); ++u) Engine<T>::zero(acc[u]);

  for (int it = 0; it < ntiles; ++it) {
    const int nx = it + S - 1;
    cp_async_wait<S - 2>();
    __syncthreads();  // tile it has landed; no warp still reads buffer (it - 1) % S
    if (nx < ntiles) load_dw_sharep_stage<T>(smem, plan, nx, h, dl, ldd, T_, v0, V, d, dpad, vec);
    cp_async_commit();
    const unsigned char* st = smem + (size_t)(it % S) * plan.stage_bytes;
    acc_product<T, BV, BT, false>(acc, reinterpret_cast<const T*>(st + plan.dl_off), P::LDL,
                                  reinterpret_cast<const T*>(st), plan.ld, dpad);  // dl^T @ h
  }
  store_acc<T, BV>(dw, reinterpret_cast<float*>(smem), plan.ldc, acc, v0, V - v0, d, dpad);
}

// ---------------------------------------------------------------------------
// dw_sharep on wgmma and TMA (bf16 h, d % 8 == 0): dw = dl^T @ h as a GEMM
// with M = V, N = d, K = T. One CTA per 128 x 256 tile of dw; two consumer
// warpgroups (64 vocab rows each, a 64 x 256 f32 accumulator in registers)
// and one producer warp that keeps a ring of (dl, h) token tiles in flight
// ---------------------------------------------------------------------------
struct DwHopper {
  static constexpr int BM = 128, BN = 256, BK = 64;  // vocab rows, columns of d, tokens
  static constexpr int STAGES = 4;
  static constexpr int A_BYTES = BK * BM * 2;        // dl: two [BK][64] boxes
  static constexpr int B_BYTES = BK * BN * 2;        // h: four [BK][64] boxes
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int BAR_OFF = STAGES * STAGE_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * 2 * STAGES + 1024;  // + alignment slack
  static constexpr int THREADS = 2 * 128 + 32;
};

__global__ void __launch_bounds__(DwHopper::THREADS, 1)
fused_ce_dw_sharep_hopper_kernel(const __grid_constant__ CUtensorMap dlmap,
                                 const __grid_constant__ CUtensorMap hmap, bf16* __restrict__ dw,
                                 int T_, int V, int d, int col_tiles) {
  using C = DwHopper;
  constexpr int S = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzled boxes start on 1024 bytes
  auto full = [=](int s) { return base + C::BAR_OFF + 8 * s; };
  auto empty = [=](int s) { return base + C::BAR_OFF + 8 * (S + s); };
  // the column tiles of one vocab block are neighbours in the launch order,
  // so they run together and read its dl tiles from L2 rather than memory
  const int vb = blockIdx.x / col_tiles, ct = blockIdx.x - vb * col_tiles;
  const int v0 = vb * C::BM, c0 = ct * C::BN;
  const int nk = (T_ + C::BK - 1) / C::BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * 128);  // every consumer thread releases a stage
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 2 * 128) {  // the producer warp: one thread issues every copy
    if (threadIdx.x == 2 * 128) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % S, round = kt / S;
        if (round > 0) mbar_wait(empty(s), (round - 1) & 1);
        const uint32_t st = base + s * C::STAGE_BYTES;
        mbar_expect_tx(full(s), C::STAGE_BYTES);
        for (int a = 0; a < C::BM / 64; ++a)
          tma_load_2d(st + a * C::BK * 128, &dlmap, full(s), v0 + 64 * a, kt * C::BK);
        for (int c = 0; c < C::BN / 64; ++c)
          tma_load_2d(st + C::A_BYTES + c * C::BK * 128, &hmap, full(s), c0 + 64 * c,
                      kt * C::BK);
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, lane = t % 32;
  float acc[C::BN / 2];
#pragma unroll
  for (int i = 0; i < C::BN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % S;
    const uint32_t st = base + s * C::STAGE_BYTES;
    mbar_wait(full(s), (kt / S) & 1);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::BK / 16; ++kk)  // both operands MN-major
      wgmma_ss<1, 1>(acc, sw128_desc(st + wg * C::BK * 128 + kk * 2048, C::BK * 128, 1024),
                     sw128_desc(st + C::A_BYTES + kk * 2048, C::BK * 128, 1024), 1);
    wgmma_commit();
    wgmma_wait<1>();  // the previous tile's products are done: release its stage
    fence_regs(acc);
    if (kt > 0) mbar_arrive(empty((kt - 1) % S));
  }
  wgmma_wait<0>();
  fence_regs(acc);

  const int r0 = v0 + 64 * wg + 16 * (t / 32) + lane / 4;
#pragma unroll
  for (int i = 0; i < C::BN / 2; i += 2) {
    const int row = r0 + 8 * ((i & 3) >> 1), col = c0 + 8 * (i >> 2) + 2 * (lane & 3);
    if (row < V && col < d)
      *reinterpret_cast<uint32_t*>(dw + (size_t)row * d + col) = pack_bf16(acc[i], acc[i + 1]);
  }
}

// ---------------------------------------------------------------------------
// The tile of both recomputing designs on wgmma and TMA (dw, then dh): the
// resident operand (w's vocab block for dw, h's token block for dh) and the
// streamed one (h's token tiles for dw, w's vocab tiles for dh)
// ---------------------------------------------------------------------------
struct RecomputeTile {
  static constexpr int BM = 64;               // output rows a CTA: the resident block
  static constexpr int BK = 32;               // streamed rows a ring stage
  static constexpr int NB = kMaxD / 64;       // 64-column boxes of d, at most
  static constexpr int WG_BOXES = NB / 2;     // of them a warpgroup's
  static constexpr int WG_CHUNKS = WG_BOXES / 2;  // its 128-column chunks
  static constexpr int RES_BOX = BM * 128;    // bytes of a [64 x 64] resident box
  static constexpr int STR_BOX = BK * 128;    // bytes of a [32 x 64] streamed box
  static constexpr int STAGES = 2;
  static constexpr int STAGE_BYTES = NB * STR_BOX;
  static constexpr int STR_OFF = NB * RES_BOX;  // the resident block first
  // the partial logits, double-buffered: [tile parity][warpgroup][16][128]
  static constexpr int X_OFF = STR_OFF + STAGES * STAGE_BYTES;
  static constexpr int X_FLOATS = 2 * 16 * 128;  // one tile's two partials
  // token statistics (label, lse, g): dw's for each stage's 32 tokens, dh's
  // for the CTA's 64
  static constexpr int ST_OFF = X_OFF + 2 * X_FLOATS * 4;
  static_assert(STAGES * BK == BM, "dw's stage statistics take dh's room");
  static constexpr int BAR_OFF = ST_OFF + 3 * BM * 4;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + STAGES) + 1024;  // + alignment slack
  static constexpr int THREADS = 2 * 128;
};

// ---------------------------------------------------------------------------
// the recomputing dw on wgmma and TMA (bf16 h and w, d % 8 == 0): one CTA
// per 64-row vocab block, its whole dw row [64 x d] in the registers of two
// consumer warpgroups (warpgroup c owns columns [384 c, 384 c + 384) of d),
// w's block resident in shared memory, h streamed in 32-token tiles
// through a 2-stage TMA ring; per tile:
//   1. each warpgroup: the logits' partial over its own columns of d,
//      S^T_c [64 vocab x 32 tokens] = w[:, c] h[:, c]^T (m64n32k16, both
//      K-major, 24 k16 steps);
//   2. the two partials meet in shared memory and each warpgroup sums
//      them in the fixed order S^T_0 + S^T_1, so both hold the same bits;
//   3. dl^T = (exp(S^T - lse) - onehot) g in float32, rounded to bf16 as
//      A fragments in registers (the accumulator layout's k16 slices);
//   4. dw[:, c] += dl^T h[:, c] (m64n128k16 three times a k16 step, h read
//      MN-major from the stage the logits read).
// ---------------------------------------------------------------------------
// kFull: d > 640, every chunk of both warpgroups live (the training
// shape); else the CTA loads and multiplies the ceil(d / 128) chunks that
// hold d, and a warpgroup skips the products of its chunks past them
template <bool kFull>
__global__ void __launch_bounds__(RecomputeTile::THREADS, 1)
fused_ce_dw_hopper_kernel(const __grid_constant__ CUtensorMap wmap,
                          const __grid_constant__ CUtensorMap hmap, const int* __restrict__ lab,
                          const float* __restrict__ lse, const float* __restrict__ g,
                          bf16* __restrict__ dw, int T_, int V, int d) {
  using C = RecomputeTile;
  constexpr int BK = C::BK;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzled boxes start on 1024 bytes
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t w_full = base + C::BAR_OFF;
  auto h_full = [=](int s) { return w_full + 8 * (1 + s); };
  float* xs = reinterpret_cast<float*>(gbase + C::X_OFF);
  float* stats = reinterpret_cast<float*>(gbase + C::ST_OFF);
  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128, lane = t % 32;
  const int v0 = blockIdx.x * C::BM;
  const int nt = (T_ + BK - 1) / BK;
  // the boxes of d loaded (whole 128-column chunks; a box past d loads as
  // zeros) and this warpgroup's live chunks of them
  const int nb = kFull ? C::NB : 2 * ((d + 127) / 128);
  const int ncw = kFull ? C::WG_CHUNKS : min(max(nb / 2 - C::WG_CHUNKS * wg, 0), C::WG_CHUNKS);

  // tile kt's h boxes into its stage (one thread), and its labels, lse
  // and g beside them (warp 0; rows >= T pick nothing and weigh 0)
  auto load_h = [&](int kt) {
    const int s = kt % C::STAGES;
    mbar_expect_tx(h_full(s), nb * C::STR_BOX);
    for (int c = 0; c < nb; ++c)
      tma_load_2d(base + C::STR_OFF + s * C::STAGE_BYTES + c * C::STR_BOX, &hmap, h_full(s),
                  64 * c, kt * BK);
  };
  auto load_stats = [&](int kt) {
    float* st = stats + (kt % C::STAGES) * 3 * BK;
    const int row = kt * BK + lane;  // BK == 32: a row a lane
    const bool in = row < T_;
    reinterpret_cast<int*>(st)[lane] = in ? lab[row] : -1;
    st[BK + lane] = in ? lse[row] : 0.f;
    st[2 * BK + lane] = in ? g[row] : 0.f;
  };
  if (tid == 0) {
    mbar_init(w_full, 1);
    for (int s = 0; s < C::STAGES; ++s) mbar_init(h_full(s), 1);
    mbar_fence_init();
    mbar_expect_tx(w_full, nb * C::RES_BOX);
    for (int c = 0; c < nb; ++c)
      tma_load_2d(base + c * C::RES_BOX, &wmap, w_full, 64 * c, v0);
    for (int kt = 0; kt < C::STAGES && kt < nt; ++kt) load_h(kt);
  }
  if (tid < 32)
    for (int kt = 0; kt < C::STAGES && kt < nt; ++kt) load_stats(kt);
  __syncthreads();

  // this thread's rows of S^T and dw: vocab rows ra and ra + 8
  const int ra = v0 + 16 * (t / 32) + lane / 4;
  // this warpgroup's boxes of d: the logits' depth and dw's columns
  const uint32_t wbase = base + C::WG_BOXES * wg * C::RES_BOX;
  const int c0 = 64 * C::WG_BOXES * wg;
  // dw's accumulators: the first tile's products ignore what they hold, so
  // no instruction but a wgmma ever writes them (a zeroing move between
  // the products would make the compiler serialise every wgmma)
  float acc[3][64];
  float sc[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) sc[j] = 0.f;
  uint32_t pa[BK / 16][4];  // dl^T in bf16: the A fragments of its k16 slices
#pragma unroll
  for (int i = 0; i < BK / 16; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) pa[i][j] = 0u;

  mbar_wait(w_full, 0);
  for (int i = 0; i < nt; ++i) {
    const int s = i % C::STAGES;
    const uint32_t sh = base + C::STR_OFF + s * C::STAGE_BYTES;
    // test hook: this warpgroup lags the other by a while on every tile
#ifdef FUSED_CE_DW_STALL_WG
    if (wg == FUSED_CE_DW_STALL_WG) __nanosleep(2000);
#endif
    mbar_wait(h_full(s), (i / C::STAGES) & 1);
    // 1. the partial logits over this warpgroup's columns of d (the first
    // step ignores what sc holds)
    // (w's addresses go through an empty asm each tile, so the compiler
    // builds their 24 descriptors here rather than holding them in
    // registers across the loop)
    uint32_t wb = wbase;
    asm volatile("" : "+r"(wb));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * C::WG_BOXES; ++kk) {
      const uint32_t ko = (kk % 4) * 32;  // 16 columns in a box
      if (kk < 8 * ncw)
        wgmma_ss<0, 0>(sc, sw128_desc(wb + (kk / 4) * C::RES_BOX + ko, 16, 1024),
                       sw128_desc(sh + (C::WG_BOXES * wg + kk / 4) * C::STR_BOX + ko, 16, 1024),
                       kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();  // also the previous tile's dw products
    fence_regs(sc);
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    fence_regs(acc[2]);
    fence_regs(pa);
    // 2. the partials meet: both warpgroups sum S^T_0 + S^T_1
    float* xb = xs + (i % 2) * C::X_FLOATS;
#pragma unroll
    for (int j = 0; j < 16; ++j) xb[(wg * 16 + j) * 128 + t] = sc[j];
    named_sync(1, C::THREADS);  // both partials written; stage i - 1 read by all
    if (i >= 1 && i + 1 < nt) {  // stage (i + 1) % 2 held tile i - 1, whose products are done
      if (tid == 0) load_h(i + 1);
      if (tid < 32) load_stats(i + 1);
    }
    // (addition commutes, so both warpgroups form the same bits)
    const float* other = xb + (1 - wg) * 16 * 128 + t;
    // 3. dl^T = (softmax - onehot) g for this thread's (vocab, token)
    // pairs, straight into bf16 A fragments (sc stays the logits' own:
    // only wgmma writes it inside the loop)
    const float* st = stats + s * 3 * BK;
    const int* slab = reinterpret_cast<const int*>(st);
    auto dl = [&](int j) {
      const int v = ra + 8 * ((j & 3) >> 1);
      const int tk = 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
      if (v >= V) return 0.f;
      const float p = __expf(sc[j] + other[j * 128] - st[BK + tk]);
      return (p - (v == slab[tk] ? 1.f : 0.f)) * st[2 * BK + tk];
    };
#pragma unroll
    for (int j = 0; j < 16; j += 2) pa[j / 8][(j % 8) / 2] = pack_bf16(dl(j), dl(j + 1));
    // 4. dw[:, c] += dl^T h[:, c], h MN-major in the stage
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int c = 0; c < C::WG_CHUNKS; ++c)
        if (c < ncw)
          wgmma_rs<1>(acc[c], pa[kk],
                      sw128_desc(sh + (C::WG_BOXES * wg + 2 * c) * C::STR_BOX + kk * 2048,
                                 C::STR_BOX, 1024),
                      i > 0 || kk > 0);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(acc[0]);
  fence_regs(acc[1]);
  fence_regs(acc[2]);
  fence_regs(pa);

  // vocab rows >= V and columns >= d (every chunk past ncw) are never stored
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int row = ra + 8 * ((i & 3) >> 1);
      const int col = c0 + 128 * c + 8 * (i >> 2) + 2 * (lane & 3);
      if (row < V && col < d)
        *reinterpret_cast<uint32_t*>(dw + (size_t)row * d + col) =
            pack_bf16(acc[c][i], acc[c][i + 1]);
    }
}

// ---------------------------------------------------------------------------
// the recomputing dh on wgmma and TMA (bf16 h and w, d % 8 == 0): the dw
// kernel above with tokens and vocabulary swapped. One CTA per 64-token
// block, its dh rows [64 x d] in the registers of the two warpgroups
// (warpgroup c owns columns [384 c, 384 c + 384) of d), h's block resident,
// w streamed in 32-vocab-row tiles through the 2-stage ring, the CTA's
// labels, lse and g in shared memory; per tile:
//   1. each warpgroup: S_c [64 tokens x 32 vocab] = h[:, c] w[:, c]^T
//      (m64n32k16, both K-major);
//   2. both warpgroups sum the two partials S_0 + S_1 from shared memory;
//   3. dl = (exp(S - lse) - onehot) g in float32 (0 at vocab columns >= V),
//      rounded to bf16 A fragments;
//   4. dh[:, c] += dl w[:, c] (m64n128k16 three times a k16 step, w read
//      MN-major from the stage step 1 read).
// kStoreDl (the shared-dl pair's dh pass) also writes those fragments to
// dl [T, ldd], zeros in the columns from V to V rounded up to 8. kFull as
// in the dw kernel.
// ---------------------------------------------------------------------------
template <bool kStoreDl, bool kFull>
__global__ void __launch_bounds__(RecomputeTile::THREADS, 1)
fused_ce_dh_hopper_kernel(const __grid_constant__ CUtensorMap hmap,
                          const __grid_constant__ CUtensorMap wmap, const int* __restrict__ lab,
                          const float* __restrict__ lse, const float* __restrict__ g,
                          bf16* __restrict__ dh, bf16* __restrict__ dl, int ldd, int T_, int V,
                          int d) {
  using C = RecomputeTile;
  constexpr int BK = C::BK;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzled boxes start on 1024 bytes
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t h_full = base + C::BAR_OFF;
  auto w_full = [=](int s) { return h_full + 8 * (1 + s); };
  float* xs = reinterpret_cast<float*>(gbase + C::X_OFF);
  int* slab = reinterpret_cast<int*>(gbase + C::ST_OFF);  // the CTA's labels, lse, g
  float* slse = reinterpret_cast<float*>(slab + C::BM);
  float* sg = slse + C::BM;
  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128, lane = t % 32;
  const int t0 = blockIdx.x * C::BM;
  const int nt = (V + BK - 1) / BK;
  // the boxes of d loaded and this warpgroup's live chunks, as in dw
  const int nb = kFull ? C::NB : 2 * ((d + 127) / 128);
  const int ncw = kFull ? C::WG_CHUNKS : min(max(nb / 2 - C::WG_CHUNKS * wg, 0), C::WG_CHUNKS);

  // vocab tile vt's w boxes into its stage (one thread)
  auto load_w = [&](int vt) {
    const int s = vt % C::STAGES;
    mbar_expect_tx(w_full(s), nb * C::STR_BOX);
    for (int c = 0; c < nb; ++c)
      tma_load_2d(base + C::STR_OFF + s * C::STAGE_BYTES + c * C::STR_BOX, &wmap, w_full(s),
                  64 * c, vt * BK);
  };
  if (tid == 0) {
    mbar_init(h_full, 1);
    for (int s = 0; s < C::STAGES; ++s) mbar_init(w_full(s), 1);
    mbar_fence_init();
    mbar_expect_tx(h_full, nb * C::RES_BOX);
    for (int c = 0; c < nb; ++c) tma_load_2d(base + c * C::RES_BOX, &hmap, h_full, 64 * c, t0);
    for (int vt = 0; vt < C::STAGES && vt < nt; ++vt) load_w(vt);
  }
  if (tid < C::BM) {  // token rows >= T pick nothing and weigh 0
    const int row = t0 + tid;
    const bool in = row < T_;
    slab[tid] = in ? lab[row] : -1;
    slse[tid] = in ? lse[row] : 0.f;
    sg[tid] = in ? g[row] : 0.f;
  }
  __syncthreads();

  // this thread's rows of S and dh: tokens ra and ra + 8 of the block
  const int ra = 16 * (t / 32) + lane / 4;
  // this warpgroup's boxes of d: the logits' depth and dh's columns
  const uint32_t hbase = base + C::WG_BOXES * wg * C::RES_BOX;
  const int c0 = 64 * C::WG_BOXES * wg;
  // dh's accumulators, written by no instruction but a wgmma (the first
  // tile's products ignore what they hold), as dw's
  float acc[3][64];
  float sc[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) sc[j] = 0.f;
  uint32_t pa[BK / 16][4];  // dl in bf16: the A fragments of its k16 slices
#pragma unroll
  for (int i = 0; i < BK / 16; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) pa[i][j] = 0u;

  mbar_wait(h_full, 0);
  for (int i = 0; i < nt; ++i) {
    const int s = i % C::STAGES, v0 = i * BK;
    const uint32_t sw = base + C::STR_OFF + s * C::STAGE_BYTES;
    // test hook: this warpgroup lags the other by a while on every tile
#ifdef FUSED_CE_DH_STALL_WG
    if (wg == FUSED_CE_DH_STALL_WG) __nanosleep(2000);
#endif
    mbar_wait(w_full(s), (i / C::STAGES) & 1);
    // 1. the partial logits over this warpgroup's columns of d (h's
    // addresses through an empty asm each tile, as dw's w)
    uint32_t hb = hbase;
    asm volatile("" : "+r"(hb));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * C::WG_BOXES; ++kk) {
      const uint32_t ko = (kk % 4) * 32;  // 16 columns in a box
      if (kk < 8 * ncw)
        wgmma_ss<0, 0>(sc, sw128_desc(hb + (kk / 4) * C::RES_BOX + ko, 16, 1024),
                       sw128_desc(sw + (C::WG_BOXES * wg + kk / 4) * C::STR_BOX + ko, 16, 1024),
                       kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();  // also the previous tile's dh products
    fence_regs(sc);
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    fence_regs(acc[2]);
    fence_regs(pa);
    // 2. the partials meet: both warpgroups sum S_0 + S_1
    float* xb = xs + (i % 2) * C::X_FLOATS;
#pragma unroll
    for (int j = 0; j < 16; ++j) xb[(wg * 16 + j) * 128 + t] = sc[j];
    named_sync(1, C::THREADS);  // both partials written; stage i - 1 read by all
    // stage (i + 1) % 2 held tile i - 1, whose products are done
    if (tid == 0 && i >= 1 && i + 1 < nt) load_w(i + 1);
    const float* other = xb + (1 - wg) * 16 * 128 + t;
    // 3. dl = (softmax - onehot) g for this thread's (token, vocab) pairs,
    // straight into bf16 A fragments
    auto dlv = [&](int j) {
      const int r = ra + 8 * ((j & 3) >> 1);
      const int v = v0 + 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
      if (v >= V) return 0.f;
      const float p = __expf(sc[j] + other[j * 128] - slse[r]);
      return (p - (v == slab[r] ? 1.f : 0.f)) * sg[r];
    };
#pragma unroll
    for (int j = 0; j < 16; j += 2) pa[j / 8][(j % 8) / 2] = pack_bf16(dlv(j), dlv(j + 1));
    if (kStoreDl) {
      // warpgroup wg stores row ra + 8 wg of the tile: lane q of a quad
      // holds its columns 8 k + 2 q, +1 (k = 0..3); a 4 x 4 transpose across
      // the quad (lanes 2 apart, then neighbours) gives lane q columns
      // 8 q .. 8 q + 7
      uint32_t x[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) x[k] = wg ? pa[k >> 1][2 * (k & 1) + 1] : pa[k >> 1][2 * (k & 1)];
      const int q = lane & 3;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const uint32_t got = __shfl_xor_sync(0xffffffffu, (q & 2) ? x[k] : x[2 + k], 2);
        if (q & 2)
          x[k] = got;
        else
          x[2 + k] = got;
      }
#pragma unroll
      for (int k = 0; k < 4; k += 2) {
        const uint32_t got = __shfl_xor_sync(0xffffffffu, (q & 1) ? x[k] : x[k + 1], 1);
        if (q & 1)
          x[k] = got;
        else
          x[k + 1] = got;
      }
      const int row = t0 + ra + 8 * wg, col = v0 + 8 * q;
      if (row < T_ && col < ((V + 7) & ~7))  // st.global.cs: evict first from L2
        asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(
                         dl + (size_t)row * ldd + col),
                     "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]));
    }
    // 4. dh[:, c] += dl w[:, c], w MN-major in the stage
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int c = 0; c < C::WG_CHUNKS; ++c)
        if (c < ncw)
          wgmma_rs<1>(acc[c], pa[kk],
                      sw128_desc(sw + (C::WG_BOXES * wg + 2 * c) * C::STR_BOX + kk * 2048,
                                 C::STR_BOX, 1024),
                      i > 0 || kk > 0);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(acc[0]);
  fence_regs(acc[1]);
  fence_regs(acc[2]);
  fence_regs(pa);

  // token rows >= T and columns >= d (every chunk past ncw) are never stored
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int row = t0 + ra + 8 * ((i & 3) >> 1);
      const int col = c0 + 128 * c + 8 * (i >> 2) + 2 * (lane & 3);
      if (row < T_ && col < d)
        *reinterpret_cast<uint32_t*>(dh + (size_t)row * d + col) =
            pack_bf16(acc[c][i], acc[c][i + 1]);
    }
}

// ---------------------------------------------------------------------------
// The forward on wgmma and TMA (bf16 h and w, d % 8 == 0): one CTA per
// (64-token block, vocab split), h's block resident, w streamed as
// [128 vocab x 64 d] boxes through a ring, the two consumer warpgroups
// taking alternate 128-vocab tiles
// ---------------------------------------------------------------------------
struct FwdHopper {
  static constexpr int BM = 64;             // tokens a CTA: the resident block
  static constexpr int BV = 128;            // vocab rows a tile (and a box)
  static constexpr int NB = kMaxD / 64;     // 64-column boxes of d, at most
  static constexpr int RES_BOX = BM * 128;  // bytes of a [64 x 64] resident box
  static constexpr int STR_BOX = BV * 128;  // bytes of a [128 x 64] streamed box
  // the deepest ring that fits beside h: on an H100 the forward at the
  // training shape ran faster with each stage added from 4 to 8
  static constexpr int STAGES = 8;
  static constexpr int STR_OFF = NB * RES_BOX;  // the resident block first
  // warpgroup 1's (m, l, target) of the 64 rows, for the merge
  static constexpr int X_OFF = STR_OFF + STAGES * STR_BOX;
  static constexpr int BAR_OFF = X_OFF + 3 * BM * 4;
  // h_full, full[2][S] (a stage's full barrier for each warpgroup),
  // empty[S]; 1024 bytes of alignment slack
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 3 * STAGES) + 1024;
  static constexpr int THREADS = 2 * 128 + 32;  // two consumer warpgroups, a producer warp
  static_assert(SMEM <= 232448, "a block's shared memory on sm_90");
};

constexpr float kLog2e = 1.4426950408889634f;

// One 128-column tile of logits in the m64n128 accumulator layout (this
// thread: rows ra and ra + 8, columns 8 k + 2 (lane % 4) (+1) from v0) into
// the rows' running max m, sum l = sum exp(s - m) and the label's logit;
// kEdge: the tile crosses V, whose columns from V on count as -inf. The
// logits are only read: they stay the wgmma's own registers.
template <bool kEdge>
__device__ __forceinline__ void fwd_tile_stats(const float (&sc)[64], float (&m)[2], float (&l)[2],
                                               float (&tgt)[2], const int (&label)[2], int v0,
                                               int V, int lane) {
  auto logit = [&](int i) {
    if (!kEdge) return sc[i];
    return v0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1) < V ? sc[i] : -INFINITY;
  };
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 64; ++i) mx[(i & 3) >> 1] = fmaxf(mx[(i & 3) >> 1], logit(i));
  float mul[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float mn = fmaxf(m[r], mx[r]);
    const float mu = mn == -INFINITY ? 0.f : mn;
    l[r] *= ex2((m[r] - mu) * kLog2e);  // m = -inf: 0
    m[r] = mn;
    mul[r] = mu * kLog2e;
    const int c = label[r] - v0;  // the label's column in this tile
    if (c >= 0 && c < FwdHopper::BV && ((c >> 1) & 3) == (lane & 3)) {
#pragma unroll
      for (int i = 0; i < 64; ++i)
        if (((i & 3) >> 1) == r && 8 * (i >> 2) + (i & 1) == (c & ~6)) tgt[r] += sc[i];
    }
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i & 3) >> 1;
    sum[r] += ex2(fmaf(logit(i), kLog2e, -mul[r]));  // exp(s - m)
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    l[r] += sum[r];
  }
}

// kFull: d > 704, every box of d live (the training shape); else the CTA
// loads and multiplies the ceil(d / 64) boxes that hold d, in a loop of
// run-time length
template <bool kFull>
__global__ void __launch_bounds__(FwdHopper::THREADS, 1)
fused_ce_fwd_hopper_kernel(const __grid_constant__ CUtensorMap hmap,
                           const __grid_constant__ CUtensorMap wmap, const int* __restrict__ lab,
                           float* __restrict__ m_out, float* __restrict__ l_out,
                           float* __restrict__ t_out, int T_, int V, int d, int tiles_per_split) {
  using C = FwdHopper;
  constexpr int S = C::STAGES, BV = C::BV;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzled boxes start on 1024 bytes
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t h_full = base + C::BAR_OFF;
  // full(w, s): stage s holds a box of warpgroup w's. Each warpgroup has its
  // own: it reads a stage only in some of its rounds, and a wait on a
  // barrier shared with the other's rounds could be two phases ahead of it
  // and pass on the parity of an earlier one.
  auto full = [=](int w, int s) { return h_full + 8 * (1 + w * S + s); };
  auto empty = [=](int s) { return h_full + 8 * (1 + 2 * S + s); };
  float* xs = reinterpret_cast<float*>(gbase + C::X_OFF);

  const int t0 = blockIdx.x * C::BM;
  const int nvt_all = (V + BV - 1) / BV;
  const int vt_lo = blockIdx.y * tiles_per_split;
  const int nvt = max(0, min(nvt_all, vt_lo + tiles_per_split) - vt_lo);  // this split's tiles
  const int nb = kFull ? C::NB : (d + 63) / 64;

  if (threadIdx.x == 0) {
    mbar_init(h_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full(0, s), 1);
      mbar_init(full(1, s), 1);
      mbar_init(empty(s), 128);  // a box has one reader: every thread of its warpgroup releases
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the producer warp: one thread issues every copy, h's block, then the
  // split's boxes in order (tile by tile, each tile's boxes along d)
  if (threadIdx.x >= 2 * 128) {
    if (threadIdx.x == 2 * 128) {
      mbar_expect_tx(h_full, nb * C::RES_BOX);
      for (int c = 0; c < nb; ++c) tma_load_2d(base + c * C::RES_BOX, &hmap, h_full, 64 * c, t0);
      int i = 0;
      for (int j = 0; j < nvt; ++j)
        for (int c = 0; c < nb; ++c, ++i) {
          const int s = i % S, round = i / S;
          if (round > 0) mbar_wait(empty(s), (round - 1) & 1);
          mbar_expect_tx(full(j & 1, s), C::STR_BOX);
          tma_load_2d(base + C::STR_OFF + s * C::STR_BOX, &wmap, full(j & 1, s), 64 * c,
                      (vt_lo + j) * BV);
        }
    }
    return;
  }

  // consumers: warpgroup wg takes the split's tiles wg, wg + 2, ...; this
  // thread holds rows ra and ra + 8 of the block, columns 8 k + 2 (lane % 4)
  // (+1) of a tile
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, lane = t % 32;
  const int ra = 16 * (t / 32) + lane / 4;
  int label[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // a label outside [0, V) picks no column
    const int row = t0 + ra + 8 * r;
    const int lb = row < T_ ? lab[row] : -1;
    label[r] = lb >= 0 && lb < V ? lb : -1;
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, tgt[2] = {0.f, 0.f};
  // the logits of a tile: written by no instruction but a wgmma (each
  // tile's first product ignores what they hold)
  float sc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) sc[i] = 0.f;

  uint32_t phase = 0;  // bit s: the parity of this warpgroup's next wait on full(wg, s)
  mbar_wait(h_full, 0);
  for (int j = wg; j < nvt; j += 2) {
    // test hook: this warpgroup lags the other by a while on every tile
#ifdef FUSED_CE_FWD_STALL_WG
    if (wg == FUSED_CE_FWD_STALL_WG) __nanosleep(2000);
#endif
    const int v0 = (vt_lo + j) * BV;
    // h's addresses through an empty asm each tile, as in dh
    uint32_t hb = base;
    asm volatile("" : "+r"(hb));
    // 1. S = h w^T over d, box by box as each lands; a box's stage is
    // released once the products of the next box are issued and its own
    // are done
    int prev = -1;
#pragma unroll(kFull ? C::NB : 1)
    for (int c = 0; c < nb; ++c) {
      const int i = j * nb + c, s = i % S;
      const uint32_t sw = base + C::STR_OFF + s * C::STR_BOX;
      mbar_wait(full(wg, s), (phase >> s) & 1);
      phase ^= 1u << s;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // 16 columns of the box a step
        wgmma_ss<0, 0>(sc, sw128_desc(hb + c * C::RES_BOX + kk * 32, 16, 1024),
                       sw128_desc(sw + kk * 32, 16, 1024), c > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sc);
      if (prev >= 0) mbar_arrive(empty(prev));
      prev = s;
    }
    wgmma_wait<0>();
    fence_regs(sc);
    mbar_arrive(empty(prev));
    // 2. the online (m, l) of each row over the tile's columns, and the
    // label's logit where the tile holds it
    if (v0 + BV > V)
      fwd_tile_stats<true>(sc, m, l, tgt, label, v0, V, lane);
    else
      fwd_tile_stats<false>(sc, m, l, tgt, label, v0, V, lane);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // one lane of the quad holds the label's logit
    tgt[r] += __shfl_xor_sync(0xffffffffu, tgt[r], 1);
    tgt[r] += __shfl_xor_sync(0xffffffffu, tgt[r], 2);
  }
  // 3. the two warpgroups' states merge in one order, warpgroup 0's then
  // warpgroup 1's, and the split's parts are stored
  if (wg == 1 && (lane & 3) == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      xs[ra + 8 * r] = m[r];
      xs[C::BM + ra + 8 * r] = l[r];
      xs[2 * C::BM + ra + 8 * r] = tgt[r];
    }
  named_sync(1, 2 * 128);
  if (wg == 0 && (lane & 3) == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = t0 + ra + 8 * r;
      const float m1 = xs[ra + 8 * r], l1 = xs[C::BM + ra + 8 * r];
      const float mn = fmaxf(m[r], m1);
      const float mu = mn == -INFINITY ? 0.f : mn;
      const float lm = l[r] * ex2((m[r] - mu) * kLog2e) + l1 * ex2((m1 - mu) * kLog2e);
      if (row < T_) {
        const size_t at = (size_t)blockIdx.y * T_ + row;
        m_out[at] = mn;
        l_out[at] = lm;
        t_out[at] = tgt[r] + xs[2 * C::BM + ra + 8 * r];
      }
    }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
template <typename Kern>
cudaError_t prepare(Kern kern, size_t smem) {
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return cudaSuccess;
}

int pad16(int d) { return (d + 15) / 16 * 16; }

template <typename T>
bool vec_ok(int d, const void* a, const void* b) {
  constexpr int VE = 16 / sizeof(T);
  return d % VE == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

constexpr int kVocabPerSplit = 1024;  // a forward vocab split keeps >= 1024 columns

// Vocab splits of the forward grid: about two blocks an SM at this T, each
// split at least kVocabPerSplit columns wide; 0 if the device is unknown.
template <typename T>
int fwd_splits(int T_, int V, int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return 0;
  const int tiles = (T_ + Cfg<T>::FWD_BT - 1) / Cfg<T>::FWD_BT;
  const int want = (2 * sms + tiles - 1) / tiles;
  const int most = (V + kVocabPerSplit - 1) / kVocabPerSplit;
  const int n = want < most ? want : most;
  return n > 1 ? n : 1;
}

template <typename T>
int fwd(const void* h, const void* w, const void* lab, void* m, void* l, void* t, int T_, int V,
        int d, int nsplit, cudaStream_t st) {
  constexpr int BT = Cfg<T>::FWD_BT, BV = Cfg<T>::FWD_BV;
  const int dpad = pad16(d);
  const FwdPlan<T> plan(dpad);
  auto kern = fused_ce_fwd_kernel<T>;
  cudaError_t e = prepare(kern, plan.bytes);
  if (e != cudaSuccess) return (int)e;
  const int nvt = (V + BV - 1) / BV;
  const int tps = (nvt + nsplit - 1) / nsplit;
  dim3 grid((T_ + BT - 1) / BT, nsplit);
  kern<<<grid, kThreads, plan.bytes, st>>>(
      static_cast<const T*>(h), static_cast<const T*>(w), static_cast<const int*>(lab),
      static_cast<float*>(m), static_cast<float*>(l), static_cast<float*>(t), T_, V, d, dpad,
      tps, vec_ok<T>(d, h, w));
  return (int)cudaGetLastError();
}

template <typename T, bool kStoreDl>
int bwd_dh(const void* h, const void* w, const void* lab, const void* lse, const void* g,
           void* dh, void* dl, int ldd, int T_, int V, int d, cudaStream_t st) {
  constexpr int BT = Cfg<T>::DH_BT;
  const int dpad = pad16(d);
  const DhPlan<T> plan(dpad);
  auto kern = fused_ce_dh_kernel<T, kStoreDl>;
  cudaError_t e = prepare(kern, plan.bytes);
  if (e != cudaSuccess) return (int)e;
  kern<<<(T_ + BT - 1) / BT, kThreads, plan.bytes, st>>>(
      static_cast<const T*>(h), static_cast<const T*>(w), static_cast<const int*>(lab),
      static_cast<const float*>(lse), static_cast<const float*>(g), static_cast<T*>(dh),
      static_cast<bf16*>(dl), ldd, T_, V, d, dpad, vec_ok<T>(d, h, w));
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_dw(const void* h, const void* w, const void* lab, const void* lse, const void* g,
           void* dw, int T_, int V, int d, cudaStream_t st) {
  constexpr int BV = Cfg<T>::DW_BV;
  const int dpad = pad16(d);
  const DwPlan<T> plan(dpad);
  auto kern = fused_ce_dw_kernel<T>;
  cudaError_t e = prepare(kern, plan.bytes);
  if (e != cudaSuccess) return (int)e;
  kern<<<(V + BV - 1) / BV, kThreads, plan.bytes, st>>>(
      static_cast<const T*>(h), static_cast<const T*>(w), static_cast<const int*>(lab),
      static_cast<const float*>(lse), static_cast<const float*>(g), static_cast<T*>(dw), T_, V,
      d, dpad, vec_ok<T>(d, h, w));
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_dw_sharep(const void* h, const void* dl, void* dw, int ldd, int T_, int V, int d,
                  cudaStream_t st) {
  constexpr int BV = Cfg<T>::DW_BV;
  const int dpad = pad16(d);
  const DwSharepPlan<T> plan(dpad);
  auto kern = fused_ce_dw_sharep_kernel<T>;
  cudaError_t e = prepare(kern, plan.bytes);
  if (e != cudaSuccess) return (int)e;
  kern<<<(V + BV - 1) / BV, kThreads, plan.bytes, st>>>(
      static_cast<const T*>(h), static_cast<const bf16*>(dl), static_cast<T*>(dw), ldd, T_, V, d,
      dpad, vec_ok<T>(d, h, h));
  return (int)cudaGetLastError();
}

// dw_sharep on wgmma/TMA: tensor maps over dl [T, V] (rows ldd apart; no
// column >= V is read) and h [T, d]; boxes past T, V or d load as zeros
int bwd_dw_sharep_hopper(const void* h, const void* dl, void* dw, int ldd, int T_, int V, int d,
                         cudaStream_t st) {
  using C = DwHopper;
  CUtensorMap dlmap, hmap;
  const uint64_t dl_dims[2] = {(uint64_t)V, (uint64_t)T_}, dl_stride[1] = {2ull * ldd};
  const uint64_t h_dims[2] = {(uint64_t)d, (uint64_t)T_}, h_stride[1] = {2ull * d};
  const uint32_t box[2] = {64, C::BK};
  int e = encode_bf16_map(&dlmap, dl, 2, dl_dims, dl_stride, box);
  if (!e) e = encode_bf16_map(&hmap, h, 2, h_dims, h_stride, box);
  if (e) return e;
  auto kern = fused_ce_dw_sharep_hopper_kernel;
  cudaError_t ce = prepare(kern, C::SMEM);
  if (ce != cudaSuccess) return (int)ce;
  const int col_tiles = (d + C::BN - 1) / C::BN, vocab_blocks = (V + C::BM - 1) / C::BM;
  kern<<<vocab_blocks * col_tiles, C::THREADS, C::SMEM, st>>>(
      dlmap, hmap, static_cast<bf16*>(dw), T_, V, d, col_tiles);
  return (int)cudaGetLastError();
}

// tensor maps of a recomputing design on wgmma/TMA: the resident operand
// [rows_r, d] in boxes of 64 rows and the streamed one [rows_s, d] in boxes
// of 32 (64 columns each); boxes past the rows or d load as zeros
int recompute_maps(CUtensorMap* rmap, const void* r, int rows_r, CUtensorMap* smap, const void* s,
                   int rows_s, int d) {
  using C = RecomputeTile;
  const uint64_t r_dims[2] = {(uint64_t)d, (uint64_t)rows_r};
  const uint64_t s_dims[2] = {(uint64_t)d, (uint64_t)rows_s};
  const uint64_t stride[1] = {2ull * d};
  const uint32_t r_box[2] = {64, C::BM}, s_box[2] = {64, C::BK};
  const int e = encode_bf16_map(rmap, r, 2, r_dims, stride, r_box);
  return e ? e : encode_bf16_map(smap, s, 2, s_dims, stride, s_box);
}

// the recomputing dw on wgmma/TMA: w resident, h streamed
int bwd_dw_hopper(const void* h, const void* w, const void* lab, const void* lse, const void* g,
                  void* dw, int T_, int V, int d, cudaStream_t st) {
  using C = RecomputeTile;
  CUtensorMap wmap, hmap;
  const int e = recompute_maps(&wmap, w, V, &hmap, h, T_, d);
  if (e) return e;
  auto kern = d > kMaxD - 128 ? fused_ce_dw_hopper_kernel<true> : fused_ce_dw_hopper_kernel<false>;
  cudaError_t ce = prepare(kern, C::SMEM);
  if (ce != cudaSuccess) return (int)ce;
  kern<<<(V + C::BM - 1) / C::BM, C::THREADS, C::SMEM, st>>>(
      wmap, hmap, static_cast<const int*>(lab), static_cast<const float*>(lse),
      static_cast<const float*>(g), static_cast<bf16*>(dw), T_, V, d);
  return (int)cudaGetLastError();
}

// the recomputing dh on wgmma/TMA (kStoreDl: and dl): h resident, w streamed
template <bool kStoreDl>
int bwd_dh_hopper(const void* h, const void* w, const void* lab, const void* lse, const void* g,
                  void* dh, void* dl, int ldd, int T_, int V, int d, cudaStream_t st) {
  using C = RecomputeTile;
  CUtensorMap hmap, wmap;
  const int e = recompute_maps(&hmap, h, T_, &wmap, w, V, d);
  if (e) return e;
  auto kern = d > kMaxD - 128 ? fused_ce_dh_hopper_kernel<kStoreDl, true>
                              : fused_ce_dh_hopper_kernel<kStoreDl, false>;
  cudaError_t ce = prepare(kern, C::SMEM);
  if (ce != cudaSuccess) return (int)ce;
  kern<<<(T_ + C::BM - 1) / C::BM, C::THREADS, C::SMEM, st>>>(
      hmap, wmap, static_cast<const int*>(lab), static_cast<const float*>(lse),
      static_cast<const float*>(g), static_cast<bf16*>(dh), static_cast<bf16*>(dl), ldd, T_, V,
      d);
  return (int)cudaGetLastError();
}

// Vocab splits of the wgmma forward's grid: one CTA an SM (its shared
// memory leaves room for no second) while the 64-token blocks are fewer
// than the SMs, whole waves only, each split at least kVocabPerSplit
// columns wide; 0 if the device is unknown
int fwd_hopper_splits(int T_, int V, int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return 0;
  const int blocks = (T_ + FwdHopper::BM - 1) / FwdHopper::BM;
  const int want = blocks >= sms ? 1 : sms / blocks;
  const int most = (V + kVocabPerSplit - 1) / kVocabPerSplit;
  const int n = want < most ? want : most;
  return n > 1 ? n : 1;
}

// the forward on wgmma/TMA: tensor maps over h [T, d] in [64 x 64] boxes
// and w [V, d] in [128 x 64] boxes; boxes past T, V or d load as zeros
int fwd_hopper(const void* h, const void* w, const void* lab, void* m, void* l, void* t, int T_,
               int V, int d, int nsplit, cudaStream_t st) {
  using C = FwdHopper;
  CUtensorMap hmap, wmap;
  const uint64_t h_dims[2] = {(uint64_t)d, (uint64_t)T_}, w_dims[2] = {(uint64_t)d, (uint64_t)V};
  const uint64_t stride[1] = {2ull * d};
  const uint32_t h_box[2] = {64, C::BM}, w_box[2] = {64, C::BV};
  int e = encode_bf16_map(&hmap, h, 2, h_dims, stride, h_box);
  if (!e) e = encode_bf16_map(&wmap, w, 2, w_dims, stride, w_box);
  if (e) return e;
  auto kern = d > kMaxD - 64 ? fused_ce_fwd_hopper_kernel<true> : fused_ce_fwd_hopper_kernel<false>;
  cudaError_t ce = prepare(kern, C::SMEM);
  if (ce != cudaSuccess) return (int)ce;
  const int nvt = (V + C::BV - 1) / C::BV;
  const int tps = (nvt + nsplit - 1) / nsplit;
  dim3 grid((T_ + C::BM - 1) / C::BM, nsplit);
  kern<<<grid, C::THREADS, C::SMEM, st>>>(hmap, wmap, static_cast<const int*>(lab),
                                          static_cast<float*>(m), static_cast<float*>(l),
                                          static_cast<float*>(t), T_, V, d, tps);
  return (int)cudaGetLastError();
}

// what the recomputing designs on wgmma/TMA take: bfloat16 (dtype 1), d a
// multiple of 8 (16-byte rows for TMA), h and w 16-byte aligned
bool recompute_ok(int dtype, int d, const void* h, const void* w) {
  return dtype == 1 && d % 8 == 0 &&
         (reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(w)) % 16 == 0;
}

// a dl buffer the kernels take: bf16 rows of ldd >= V elements, ldd a
// multiple of 8 (so at least V rounded up to 8), the base 16-byte aligned
bool dl_ok(const void* dl, int ldd, int V) {
  return ldd % 8 == 0 && ldd >= V && reinterpret_cast<uintptr_t>(dl) % 16 == 0;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Each entry returns
// cudaGetLastError() after its launch (0 = launched), or
// cudaErrorInvalidValue for a dtype, hidden size (1 <= d <= 768) or shape
// it does not take. T = 0 launches nothing (the caller fills the outputs).
#define FCE_CHECK()                                                                \
  if ((dtype != 0 && dtype != 1) || d < 1 || d > kMaxD || T_ < 0 || V < 1)         \
    return (int)cudaErrorInvalidValue;                                             \
  if (T_ == 0) return 0

// How many vocab splits fused_ce_forward should run with at this T and V on
// CUDA device `device` (its m/l/t parts are [nsplit, T]); 0 for a dtype,
// shape or device it does not take.
extern "C" int fused_ce_forward_splits(int dtype, int T_, int V, int device) {
  if ((dtype != 0 && dtype != 1) || T_ < 1 || V < 1) return 0;
  return dtype == 0 ? fwd_splits<float>(T_, V, device) : fwd_splits<bf16>(T_, V, device);
}

extern "C" int fused_ce_forward(int dtype, const void* h, const void* w, const void* labels,
                                void* m_part, void* l_part, void* t_part, int T_, int V, int d,
                                int nsplit, void* stream) {
  FCE_CHECK();
  if (nsplit < 1 || nsplit > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd<float>(h, w, labels, m_part, l_part, t_part, T_, V, d, nsplit, st);
  return fwd<bf16>(h, w, labels, m_part, l_part, t_part, T_, V, d, nsplit, st);
}

// The split count of fused_ce_forward_hopper at this T and V on device
// `device`; 0 for a dtype other than bfloat16, a shape or a device it does
// not take.
extern "C" int fused_ce_forward_hopper_splits(int dtype, int T_, int V, int device) {
  if (dtype != 1 || T_ < 1 || V < 1) return 0;
  return fwd_hopper_splits(T_, V, device);
}

// The forward on wgmma/TMA: as fused_ce_forward, for bfloat16 h and w
// (dtype 1) with d a multiple of 8 and h, w 16-byte aligned; anything else
// returns cudaErrorInvalidValue (the caller routes it to the entry above).
extern "C" int fused_ce_forward_hopper(int dtype, const void* h, const void* w,
                                       const void* labels, void* m_part, void* l_part,
                                       void* t_part, int T_, int V, int d, int nsplit,
                                       void* stream) {
  FCE_CHECK();
  if (!recompute_ok(dtype, d, h, w) || nsplit < 1 || nsplit > 65535)
    return (int)cudaErrorInvalidValue;
  return fwd_hopper(h, w, labels, m_part, l_part, t_part, T_, V, d, nsplit,
                    static_cast<cudaStream_t>(stream));
}

extern "C" int fused_ce_backward_dh(int dtype, const void* h, const void* w, const void* labels,
                                    const void* lse, const void* g, void* dh, int T_, int V,
                                    int d, void* stream) {
  FCE_CHECK();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return bwd_dh<float, false>(h, w, labels, lse, g, dh, nullptr, 0, T_, V, d, st);
  return bwd_dh<bf16, false>(h, w, labels, lse, g, dh, nullptr, 0, T_, V, d, st);
}

extern "C" int fused_ce_backward_dw(int dtype, const void* h, const void* w, const void* labels,
                                    const void* lse, const void* g, void* dw, int T_, int V,
                                    int d, void* stream) {
  FCE_CHECK();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return bwd_dw<float>(h, w, labels, lse, g, dw, T_, V, d, st);
  return bwd_dw<bf16>(h, w, labels, lse, g, dw, T_, V, d, st);
}

// The recomputing dw on wgmma/TMA: as fused_ce_backward_dw, for bfloat16
// h and w (dtype 1) with d a multiple of 8 and h, w 16-byte aligned;
// anything else returns cudaErrorInvalidValue (the caller routes it to the
// entry above).
extern "C" int fused_ce_backward_dw_hopper(int dtype, const void* h, const void* w,
                                           const void* labels, const void* lse, const void* g,
                                           void* dw, int T_, int V, int d, void* stream) {
  FCE_CHECK();
  if (!recompute_ok(dtype, d, h, w)) return (int)cudaErrorInvalidValue;
  return bwd_dw_hopper(h, w, labels, lse, g, dw, T_, V, d, static_cast<cudaStream_t>(stream));
}

// The recomputing dh on wgmma/TMA: as fused_ce_backward_dh, for what the
// dw entry above takes; anything else returns cudaErrorInvalidValue.
extern "C" int fused_ce_backward_dh_hopper(int dtype, const void* h, const void* w,
                                           const void* labels, const void* lse, const void* g,
                                           void* dh, int T_, int V, int d, void* stream) {
  FCE_CHECK();
  if (!recompute_ok(dtype, d, h, w)) return (int)cudaErrorInvalidValue;
  return bwd_dh_hopper<false>(h, w, labels, lse, g, dh, nullptr, 0, T_, V, d,
                              static_cast<cudaStream_t>(stream));
}

// The shared-dl pair. dh_sharep writes dh as fused_ce_backward_dh does and
// dl = (softmax - onehot) * g as bf16 rows of ldd elements (columns V up to
// V rounded up to 8 as zeros, the rest untouched); dw_sharep computes
// dw [V, d] = dl^T @ h from such a buffer and reads no column >= V.
// Both refuse a dl buffer dl_ok() does not take.
extern "C" int fused_ce_backward_dh_sharep(int dtype, const void* h, const void* w,
                                           const void* labels, const void* lse, const void* g,
                                           void* dh, void* dl, int ldd, int T_, int V, int d,
                                           void* stream) {
  FCE_CHECK();
  if (!dl_ok(dl, ldd, V)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return bwd_dh<float, true>(h, w, labels, lse, g, dh, dl, ldd, T_, V, d, st);
  return bwd_dh<bf16, true>(h, w, labels, lse, g, dh, dl, ldd, T_, V, d, st);
}

extern "C" int fused_ce_backward_dw_sharep(int dtype, const void* h, const void* dl, void* dw,
                                           int ldd, int T_, int V, int d, void* stream) {
  FCE_CHECK();
  if (!dl_ok(dl, ldd, V)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return bwd_dw_sharep<float>(h, dl, dw, ldd, T_, V, d, st);
  return bwd_dw_sharep<bf16>(h, dl, dw, ldd, T_, V, d, st);
}

// dw_sharep on wgmma/TMA: as fused_ce_backward_dw_sharep, for bfloat16 h
// (dtype 1) with d a multiple of 8 and h 16-byte aligned; anything else
// returns cudaErrorInvalidValue (the caller routes it to the entry above).
extern "C" int fused_ce_backward_dw_sharep_hopper(int dtype, const void* h, const void* dl,
                                                  void* dw, int ldd, int T_, int V, int d,
                                                  void* stream) {
  FCE_CHECK();
  if (dtype != 1 || d % 8 != 0 || reinterpret_cast<uintptr_t>(h) % 16 != 0 ||
      !dl_ok(dl, ldd, V))
    return (int)cudaErrorInvalidValue;
  return bwd_dw_sharep_hopper(h, dl, dw, ldd, T_, V, d, static_cast<cudaStream_t>(stream));
}

// dh_sharep on wgmma/TMA: as fused_ce_backward_dh_sharep, for what
// fused_ce_backward_dh_hopper takes; anything else returns
// cudaErrorInvalidValue. In bf16 its dh equals that entry's bit for bit.
extern "C" int fused_ce_backward_dh_sharep_hopper(int dtype, const void* h, const void* w,
                                                  const void* labels, const void* lse,
                                                  const void* g, void* dh, void* dl, int ldd,
                                                  int T_, int V, int d, void* stream) {
  FCE_CHECK();
  if (!recompute_ok(dtype, d, h, w) || !dl_ok(dl, ldd, V)) return (int)cudaErrorInvalidValue;
  return bwd_dh_hopper<true>(h, w, labels, lse, g, dh, dl, ldd, T_, V, d,
                             static_cast<cudaStream_t>(stream));
}
