// Tile helpers shared by flash_attention.cu and packed_flash.cu: both run
// 64-row tiles of q and of k through shared memory on 256 threads, each
// thread holding a 4 x 4 register tile of the 64 x 64 score tile, with
// every product and sum in float32 on the CUDA cores.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kTile = 64;      // rows of a q tile and of a k tile
constexpr int kPer = 4;        // each thread: 4 rows x 4 columns
constexpr int kLdp = kTile + 1;  // row stride of a score tile in smem

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

// reductions over the 16 lanes that share a row (lane = 16 * (ty & 1) + tx)
__device__ __forceinline__ float row_max(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// element (b, row, h, 0) of a [B, L, H, D] tensor
__device__ __forceinline__ size_t row_base(int b, int row, int h, int L,
                                           int H, int D) {
  return (((size_t)b * L + row) * H + h) * (size_t)D;
}

// stage rows [r0, r0+64) of head (b, h) into smem as float, zero past L
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int b, int h, int r0, int L, int H,
                                          int D) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int row = r0 + r;
    dst[r * ld + d] = row < L ? to_f32(src[row_base(b, row, h, L, H, D) + d]) : 0.f;
  }
}

template <int DMAX>
__host__ __device__ constexpr int ld_of() { return DMAX + 1; }  // odd: no bank conflicts

// two products over one 64 x 64 tile, 4 x 4 entries a thread: s = sa . sb
// (q . k, unscaled) and dp = sa2 . sb2 (dO . v), for rows ty + 16 i of sa
// and sa2 and columns tx + 16 j of sb and sb2
template <int DMAX>
__device__ __forceinline__ void two_products(const float* sa, const float* sb,
                                             const float* sa2, const float* sb2,
                                             int D, int ty, int tx,
                                             float (&s)[kPer][kPer],
                                             float (&dp)[kPer][kPer]) {
  constexpr int ld = ld_of<DMAX>();
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) s[i][j] = dp[i][j] = 0.f;
  for (int d = 0; d < D; ++d) {
    float a[kPer], a2[kPer], bb[kPer], bb2[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      a[i] = sa[(ty + 16 * i) * ld + d];
      a2[i] = sa2[(ty + 16 * i) * ld + d];
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      bb[j] = sb[(tx + 16 * j) * ld + d];
      bb2[j] = sb2[(tx + 16 * j) * ld + d];
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        s[i][j] = fmaf(a[i], bb[j], s[i][j]);
        dp[i][j] = fmaf(a2[i], bb2[j], dp[i][j]);
      }
  }
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

int tiles(int L) { return (L + kTile - 1) / kTile; }

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. An entry returns
// cudaGetLastError() after its launch (0 = launched), or
// cudaErrorInvalidValue for a dtype or head size it does not take
// (D <= 128). CALL(T, DMAX) launches for element type T and the
// shared-memory plan of head size DMAX.
#define FLASH_TILES_DISPATCH(CALL)                                          \
  if (D < 1 || D > 128 || (dtype != 0 && dtype != 1))                       \
    return (int)cudaErrorInvalidValue;                                      \
  if (dtype == 0 && D <= 64) return CALL(float, 64);                        \
  if (dtype == 0) return CALL(float, 128);                                  \
  if (D <= 64) return CALL(__nv_bfloat16, 64);                              \
  return CALL(__nv_bfloat16, 128)
