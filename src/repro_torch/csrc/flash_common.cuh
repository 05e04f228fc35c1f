// Shared tile machinery of K6, K7 and K8 (flash attention forward, dQ,
// dK/dV), for sm_90a: the masking of every design, and the CUDA-core
// design's tiles (each of the three also has a tensor-core design for
// bf16, flash_hopper.cuh).
//
// Every CUDA-core kernel of the family runs 256 threads as a 16 x 16
// grid: lane group ty = tid / 16 owns score rows ty + 16 i, lane
// tx = tid % 16 owns score columns tx + 16 j and output columns tx + 16 c.
// A row's 16 lanes share one warp, so row reductions are four shuffles.
// Operand tiles are staged in shared memory as fp32, head_dim padded with
// zeros to the compile-time D (32, 64, 128 or 256) and rows padded to
// D + 1 floats so that the 16 lanes reading 16 different rows hit 16
// different banks.
//
// Masking follows the JAX kernels: positions from 0 for q and k, causal
// keeps k <= q, a window keeps q - k < window, a masked score is
// NEG_INF = -2^30 (so a row that sees no key weighs every key by 1).  Keys
// past the ragged edge (k >= sk) do not exist in the JAX kernels, whose
// blocks divide the sequence: here they score -inf and weigh 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace flash {

typedef __nv_bfloat16 bf16;

constexpr float NEG_INF = -1073741824.0f;  // -2**30, the reference's mask value
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16_rn(x); }
// p.astype(v.dtype): fp32 keeps p, bf16 rounds it
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const bf16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// over the 16 lanes of one row group (lanes 0-15 or 16-31 of a warp)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// rows x d elements at src (row stride d) -> dst (rows x (D + 1) fp32),
// zero past rows_valid and past d
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int rows,
                                          int rows_valid, int d) {
  for (int e = threadIdx.x; e < rows * D; e += THREADS) {
    const int r = e / D, c = e % D;
    dst[r * (D + 1) + c] = (r < rows_valid && c < d) ? to_f32(src[(long long)r * d + c]) : 0.f;
  }
}

struct Masking {
  int sq, sk;
  float scale, softcap;  // softcap <= 0: none
  int causal, window;    // window <= 0: none

  // Does some query row see no key at all?  Only a window can do that:
  // rows q >= sk + window - 1.
  __device__ __forceinline__ bool keyless(int q) const {
    return window > 0 && q >= sk + window - 1;
  }

  // The keys [lo, hi) that query rows q0..q1 can see; all keys when one
  // of the rows sees none (it averages V over all of them).  Tiles
  // outside the range are skipped, which is exact for every other row:
  // blocks before its first visible key add junk that alpha =
  // exp(NEG_INF - m) wipes to exactly 0, blocks after it add p = 0.
  __device__ __forceinline__ void key_range(int q0, int q1, int& lo, int& hi) const {
    if (keyless(q1)) {
      lo = 0;
      hi = sk;
      return;
    }
    lo = window > 0 ? max(0, q0 - window + 1) : 0;
    hi = causal ? min(sk, q1 + 1) : sk;
  }

  // The query rows [lo, hi) that can see keys k0..k1, extended to the end
  // when keyless rows exist: they weigh every key by 1.  Rows in between
  // contribute exactly 0.
  __device__ __forceinline__ void query_range(int k0, int k1, int& lo, int& hi) const {
    lo = causal ? k0 : 0;
    hi = window > 0 ? min(sq, k1 + window) : sq;
    if (keyless(sq - 1)) hi = sq;
  }

  // dot * scale, soft-capped; *th receives tanh(dot * scale / softcap)
  // (0 without softcap).
  __device__ __forceinline__ float cap(float dot, float* th) const {
    float s = dot * scale;
    float t = 0.f;
    if (softcap > 0.f) {
      t = tanhf(s / softcap);
      s = softcap * t;
    }
    *th = t;
    return s;
  }

  // Do rows [q0, q1] see every key of [k0, k1]?  Then no score of the
  // tile needs the mask.
  __device__ __forceinline__ bool sees_all(int q0, int q1, int k0, int k1) const {
    return k1 < sk && (!causal || k1 <= q0) && (window <= 0 || q1 - k0 < window);
  }

  // The score the JAX kernels use: dot * scale, soft-capped, masked.
  __device__ __forceinline__ float score(float dot, int q, int k, float* th) const {
    const float s = cap(dot, th);
    if (k >= sk) return -INFINITY;
    if ((causal && k > q) || (window > 0 && q - k >= window)) return NEG_INF;
    return s;
  }
};

template <typename Kernel>
__host__ int allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

// the common argument checks of the three C entries
__host__ inline int check_args(int batch, int heads, int kv_heads, int sk, int d) {
  if (kv_heads <= 0 || heads % kv_heads != 0 || sk <= 0 || d <= 0 || d > 256 ||
      (long long)batch * heads > 65535)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace flash
