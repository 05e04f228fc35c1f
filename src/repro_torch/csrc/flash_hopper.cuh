// The flash kernels' part of the Hopper machinery (K6, K7 and K8's bf16
// design; the generic part is hopper_common.cuh): the design rule, the
// 3-D tensor maps of (b x heads, s, d) operands, the tile products, row
// reductions of the accumulator fragment and its stores.
//
// A tile of R rows x D columns is D / 64 panels of R rows x 64 columns
// (128-byte swizzle).  S = Q K^T and dP = dO V^T read both operands
// K-major; O += P V and dQ += dS K take A from registers and read B
// MN-major.
#pragma once

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace flash {
namespace hopper {

using namespace ::sm90;

constexpr float LOG2E = 1.4426950408889634f;

// The bf16 design's rule: wgmma needs a row stride of a multiple of 16
// bytes (d % 8 == 0); every other case runs the CUDA-core kernels.
__host__ inline bool use_wgmma(int dtype, int d) { return dtype == 1 && d % 8 == 0; }

// All D / 64 panels of a rows x D tile, rows [row, row + rows) of matrix `mat`.
template <int D, int ROWS>
__device__ __forceinline__ void tma_tile(bf16* dst, const CUtensorMap* map, uint64_t* bar,
                                         int row, int mat) {
#pragma unroll
  for (int p = 0; p < D / 64; ++p) tma_load_3d(dst + p * ROWS * 64, map, bar, p * 64, row, mat);
}

// The map of `mats` contiguous (rows, d) bf16 matrices, read in boxes of
// 64 columns x box_rows rows with 128-byte swizzle.  A box past `rows` or
// `d` is filled with zeros, so a tile never reads the next matrix.
__host__ inline int make_map(CUtensorMap* map, const void* base, int d, int rows, int mats,
                             int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)mats};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  return encode_bf16(map, base, 3, dims, strides, box);
}

// acc[64 x N] (+)= A[64 x D] B[N x D]^T, both K-major panels: A's rows at
// a (panel stride a_panel bytes), B's at b (panel stride b_panel bytes).
template <int N, int D>
__device__ __forceinline__ void mma_abt(float (&acc)[N / 2], const bf16* a, int a_panel,
                                        const bf16* b, int b_panel) {
#pragma unroll
  for (int p = 0; p < D / 64; ++p)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_ss<N>(acc, desc(reinterpret_cast<const char*>(a) + p * a_panel + kk * 32, 16, 1024),
                desc(reinterpret_cast<const char*>(b) + p * b_panel + kk * 32, 16, 1024),
                p + kk > 0);
}

// acc[64 x D] += A[64 x K] B[K x D]: A is `frag` (the bf16 A fragments of
// K / 16 steps), B a rows-K x D tile of K rows (MN-major panels).
template <int K, int D>
__device__ __forceinline__ void mma_ab(float (&acc)[D / 2], const uint32_t (&frag)[K / 16][4],
                                       const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    mma_rs<D>(acc, frag[kk], desc(b + kk * 16 * 64, K * 128, 1024));
}

// ---- the accumulator fragment ----------------------------------------------

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The accumulator of a 64 x K product as the A fragments of a product over K.
template <int K>
__device__ __forceinline__ void to_frag(const float (&s)[K / 2], uint32_t (&frag)[K / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) frag[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
}

// Rows [row0, row0 + 64) of a fragment divided by their row's `div`
// (div[0] the thread's first row, div[1] the one 8 below) to out (row
// stride d), rounded to bf16, skipping rows >= rows and columns >= d.
template <int N>
__device__ __forceinline__ void store_frag(bf16* out, const float (&acc)[N / 2], int row0,
                                           int rows, int d, const float (&div)[2]) {
#pragma unroll
  for (int i = 0; i < N / 2; i += 2) {
    const int r = row0 + frag_row(i), c = frag_col(i);
    const float q = div[(i >> 1) & 1];
    if (r < rows && c < d)
      *reinterpret_cast<__nv_bfloat162*>(out + (long long)r * d + c) =
          __floats2bfloat162_rn(acc[i] / q, acc[i + 1] / q);
  }
}

}  // namespace hopper
}  // namespace flash
