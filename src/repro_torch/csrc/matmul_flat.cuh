// The CTA tile shared by K4 (matmul_mcast.cu) and K5 (matmul_unicast.cu).
//
// tile_gemm computes one (BM x BN) block of C = A @ B with fp32 FMA on
// the CUDA cores and stores it in A's dtype, with no epilogue: the TPU
// kernels of both schedules return the bare product in a.dtype, and the
// caller runs bias and activation after them.
//
//   * A and B are read through their strides and may each be bf16 or
//     fp32; they are widened to fp32 as they are staged in shared memory.
//     The load mapping follows whichever axis is unit-stride, so a
//     transposed view (the tied logits read the bf16 table as table.t())
//     is read coalesced.
//   * The K loop stages a (BM x BK) panel of A and a (BK x BN) tile of B
//     in shared memory; the next step's tiles are loaded into registers
//     while the current ones are consumed, so one round of global loads
//     is always in flight.
//   * Thread (ty, tx) owns rows ty + i*TY and columns tx + j*TX:
//     interleaved, so shared-memory reads and global stores are
//     unit-stride across a warp.  The shared arrays are padded by one
//     column, so transposing stores do not collide on a bank.
//   * Ragged M/N/K edges are masked on load and store; nothing is padded.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flat {

typedef __nv_bfloat16 bf16;
typedef long long ll;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<bf16>(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16_rn(x); }

// The operands of one call: A and B with their strides and group strides
// (elements), G groups of (M, N, K).
struct Call {
  const void* a;
  ll sam, sak, sag;
  const void* b;
  ll sbk, sbn, sbg;
  int G, M, N, K;
};

template <int BM, int BN, int TM, int TN>
__host__ __device__ constexpr int threads() { return (BM / TM) * (BN / TN); }

template <typename TA, typename TB, int BM, int BN, int BK, int TM, int TN>
__device__ __forceinline__ void tile_gemm(const TA* __restrict__ A, ll sam, ll sak,
                                          const TB* __restrict__ B, ll sbk, ll sbn,
                                          TA* __restrict__ C, int m0, int n0, int M, int N,
                                          int K) {
  constexpr int TX = BN / TN, TY = BM / TM, NT = TX * TY;
  constexpr int A_PER = BM * BK / NT, B_PER = BK * BN / NT;
  static_assert(A_PER * NT == BM * BK && B_PER * NT == BK * BN, "tiles split evenly");
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const bool a_k_contig = sak == 1, b_n_contig = sbn == 1;
  float ra[A_PER], rb[B_PER];

  // element e of this thread's share of the A panel / B tile, as (m, k) / (k, n)
  auto a_at = [&](int e, int& m, int& k) {
    const int idx = tid + e * NT;
    if (a_k_contig) { m = idx / BK; k = idx % BK; } else { k = idx / BM; m = idx % BM; }
  };
  auto b_at = [&](int e, int& k, int& n) {
    const int idx = tid + e * NT;
    if (b_n_contig) { k = idx / BN; n = idx % BN; } else { n = idx / BK; k = idx % BK; }
  };
  auto load = [&](int k0) {
#pragma unroll
    for (int e = 0; e < A_PER; ++e) {
      int m, k;
      a_at(e, m, k);
      const int gm = m0 + m, gk = k0 + k;
      ra[e] = (gm < M && gk < K) ? to_f32(A[gm * sam + gk * sak]) : 0.f;
    }
#pragma unroll
    for (int e = 0; e < B_PER; ++e) {
      int k, n;
      b_at(e, k, n);
      const int gk = k0 + k, gn = n0 + n;
      rb[e] = (gk < K && gn < N) ? to_f32(B[gk * sbk + gn * sbn]) : 0.f;
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  load(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int e = 0; e < A_PER; ++e) {
      int m, k;
      a_at(e, m, k);
      As[k][m] = ra[e];
    }
#pragma unroll
    for (int e = 0; e < B_PER; ++e) {
      int k, n;
      b_at(e, k, n);
      Bs[k][n] = rb[e];
    }
    __syncthreads();
    if (k0 + BK < K) load(k0 + BK);  // in flight while this step computes
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + i * TY];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + i * TY;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * TX;
      if (gn < N) C[(ll)gm * N + gn] = from_f32<TA>(acc[i][j]);
    }
  }
}

}  // namespace flat

// dtype codes: 0 = float32, 1 = bfloat16 (repro_torch.kernels.matmul.matmul).
// Calls LAUNCH(TA, TB) for the operand pair; C has A's dtype.
#define FLAT_DISPATCH(a_dt, b_dt, LAUNCH)                       \
  do {                                                          \
    if (a_dt == 0 && b_dt == 0) { LAUNCH(float, float); }       \
    else if (a_dt == 0 && b_dt == 1) { LAUNCH(float, flat::bf16); } \
    else if (a_dt == 1 && b_dt == 0) { LAUNCH(flat::bf16, float); } \
    else if (a_dt == 1 && b_dt == 1) { LAUNCH(flat::bf16, flat::bf16); } \
    else return (int)cudaErrorInvalidValue;                     \
  } while (0)
