// K5 — the multiple-unicast matmul baseline, for sm_90a.
//
// Replaces: src/repro/kernels/matmul/matmul.py : matmul_unicast
// (_unicast_call), the classic (M/bm, N/bn, K/bk) grid in which every
// row block fetches its own copy of each B tile: the paper's baseline
// against which multicast is measured.
//
// Computes C = A @ B in A's dtype with fp32 accumulation and no epilogue
// (kernels/api.py runs bias and activation after it).
//
// Design: one CTA per (BM x BN) output tile, with a K loop through shared
// memory (the tile of matmul_flat.cuh, as K4 uses).  CTAs are numbered in
// plain row-major order, with no grouping: blockIdx walks the N tiles of
// one row block, then the next row block.  Every CTA reads its B tiles
// from global memory, so B is requested ceil(M/BM) times per launch;
// whatever of that L2 absorbs is the cache's doing, not the schedule's.
//
// What bounds it on the H100: as for K4, the bytes of B at the serving
// shapes (M 1-64), where one row block covers M and the two schedules
// coincide; at M of hundreds to thousands, the fp32 FMA rate of the
// CUDA cores.
//
// Tiles, chosen by M: M <= 16 a 16-row tile (BN 64, 128 threads, 2x4
// outputs each), otherwise a 64-row tile (BN 64, 256 threads, 4x4 each).
#include "matmul_flat.cuh"

namespace {

template <typename TA, typename TB, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__(flat::threads<BM, BN, TM, TN>())
matmul_unicast_kernel(const TA* __restrict__ A, long long sam, long long sak,
                      const TB* __restrict__ B, long long sbk, long long sbn,
                      TA* __restrict__ C, int M, int N, int K) {
  const int num_n = (N + BN - 1) / BN;
  const int pid_m = blockIdx.x / num_n, pid_n = blockIdx.x % num_n;  // row-major
  flat::tile_gemm<TA, TB, BM, BN, BK, TM, TN>(A, sam, sak, B, sbk, sbn, C, pid_m * BM,
                                              pid_n * BN, M, N, K);
}

template <typename TA, typename TB, int BM, int BN, int BK, int TM, int TN>
int launch(const void* a, long long sam, long long sak, const void* b, long long sbk,
           long long sbn, void* c, int M, int N, int K, cudaStream_t s) {
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  matmul_unicast_kernel<TA, TB, BM, BN, BK, TM, TN>
      <<<tiles, flat::threads<BM, BN, TM, TN>(), 0, s>>>(
          static_cast<const TA*>(a), sam, sak, static_cast<const TB*>(b), sbk, sbn,
          static_cast<TA*>(c), M, N, K);
  return 0;
}

}  // namespace

extern "C" int matmul_unicast(const void* a, int a_dtype, long long sam, long long sak,
                              const void* b, int b_dtype, long long sbk, long long sbn,
                              void* c, int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K5_LAUNCH(TA, TB)                                                        \
  if (M <= 16)                                                                   \
    launch<TA, TB, 16, 64, 32, 2, 4>(a, sam, sak, b, sbk, sbn, c, M, N, K, s);   \
  else                                                                           \
    launch<TA, TB, 64, 64, 32, 4, 4>(a, sam, sak, b, sbk, sbn, c, M, N, K, s);
  FLAT_DISPATCH(a_dtype, b_dtype, K5_LAUNCH);
#undef K5_LAUNCH
  return (int)cudaGetLastError();
}
