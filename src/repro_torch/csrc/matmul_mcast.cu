// K4 — the flat multicast matmul, for sm_90a.
//
// Replaces: src/repro/kernels/matmul/matmul.py : matmul_mcast (_mcast_call),
// the paper's schedule "load B once, deliver it to every cluster".  On the
// TPU the grid is (N/bn, K/bk) with the full-M A panel resident in VMEM,
// so every B tile is fetched from HBM once and consumed by all row blocks.
//
// Computes C = A @ B in A's dtype with fp32 accumulation and no epilogue
// (kernels/api.py runs bias and activation after it, as the JAX package
// does after the pallas_call).
//
// Design: one CTA per BN-column tile owns every row of C.  It walks K,
// staging each (BK x BN) tile of B in shared memory once, where all of
// its rows read it.  So for M <= RESIDENT_ROWS (256) every element of B
// is read from global memory exactly once per launch: the hardware
// analogue of the TPU schedule's single B fetch, with the CTA's shared
// memory in the role of VMEM.  Beyond RESIDENT_ROWS the CTA walks row
// panels of that size, and each panel reads B again (ceil(M/256) reads).
// The work is never handed to another kernel.
//
// What bounds it on the H100: at the serving shapes M is 1-64 against
// K, N of 1024-151936, so the call should be bound by the bytes of B.
// Known weakness: the grid has only ceil(N/BN) CTAs (16-88 for N of
// 1024-2816 at the decode shapes), far fewer than the 132 SMs need to
// keep HBM busy, and one CTA runs all 256-row panels of a large M in
// sequence.  The hardware form of the paper's mechanism — a thread-block
// cluster along M fed by one TMA load with .multicast::cluster — is the
// redesign for later work (ROADMAP Queue 2).
//
// Tiles, chosen by M: M <= 16 a 16-row tile (BN 64, 128 threads, 2x4
// outputs each); M <= 64 a 64-row tile (BN 64, 256 threads, 4x4 each);
// larger M the 256-row resident panel (BN 64, 256 threads, 8x8 each).
#include "matmul_flat.cuh"

namespace {

constexpr int RESIDENT_ROWS = 256;

template <typename TA, typename TB, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__(flat::threads<BM, BN, TM, TN>())
matmul_mcast_kernel(const TA* __restrict__ A, long long sam, long long sak,
                    const TB* __restrict__ B, long long sbk, long long sbn,
                    TA* __restrict__ C, int M, int N, int K) {
  const int n0 = blockIdx.x * BN;
  for (int m0 = 0; m0 < M; m0 += BM)  // one pass when M <= BM
    flat::tile_gemm<TA, TB, BM, BN, BK, TM, TN>(A, sam, sak, B, sbk, sbn, C, m0, n0, M, N, K);
}

template <typename TA, typename TB, int BM, int BN, int BK, int TM, int TN>
int launch(const void* a, long long sam, long long sak, const void* b, long long sbk,
           long long sbn, void* c, int M, int N, int K, cudaStream_t s) {
  matmul_mcast_kernel<TA, TB, BM, BN, BK, TM, TN>
      <<<(N + BN - 1) / BN, flat::threads<BM, BN, TM, TN>(), 0, s>>>(
          static_cast<const TA*>(a), sam, sak, static_cast<const TB*>(b), sbk, sbn,
          static_cast<TA*>(c), M, N, K);
  return 0;
}

}  // namespace

extern "C" int matmul_mcast(const void* a, int a_dtype, long long sam, long long sak,
                            const void* b, int b_dtype, long long sbk, long long sbn, void* c,
                            int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K4_LAUNCH(TA, TB)                                                                     \
  if (M <= 16)                                                                                \
    launch<TA, TB, 16, 64, 32, 2, 4>(a, sam, sak, b, sbk, sbn, c, M, N, K, s);                \
  else if (M <= 64)                                                                           \
    launch<TA, TB, 64, 64, 32, 4, 4>(a, sam, sak, b, sbk, sbn, c, M, N, K, s);                \
  else                                                                                        \
    launch<TA, TB, RESIDENT_ROWS, 64, 16, 8, 8>(a, sam, sak, b, sbk, sbn, c, M, N, K, s);
  FLAT_DISPATCH(a_dtype, b_dtype, K4_LAUNCH);
#undef K4_LAUNCH
  return (int)cudaGetLastError();
}
