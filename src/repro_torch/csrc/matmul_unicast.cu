// K5 — the multiple-unicast matmul baseline, for sm_90a.
//
// Replaces: src/repro/kernels/matmul/matmul.py : matmul_unicast
// (_unicast_call), the classic (M/bm, N/bn, K/bk) grid in which every
// row block fetches its own copy of each B tile: the paper's baseline
// against which multicast is measured.
//
// Computes C = A @ B in A's dtype with fp32 accumulation and no epilogue
// (kernels/api.py runs bias and activation after it).  CTAs are numbered
// in plain row-major order, with no grouping of row blocks and no cluster
// multicast (those define K1 and K4): every CTA reads its B tiles from
// global memory, so B is requested once per row block per launch.
//
// What bounds it on the H100: the bytes of B at the serving shapes (M
// 1-64: 4 x 1024 x 151936 needs 94 us for its bytes and 19 us of fp32
// FMA), the tensor cores' rate at M of hundreds to thousands.  Four
// designs, chosen by a fixed rule (design_of below):
//
// The tensor-core kernels are matmul_wgmma.cuh's, shared with K1 and K4;
// K5 instantiates them with the row-major raster and PlainEpilogue (C in
// A's dtype, no bias, no activation).
// wgmma, M > 64, bf16 x bf16: gemm_wgmma, one CTA per 128 x 128 tile of C
//   in plain row-major order; A K- or M-major, B N- or K-major.
// wgmma-swapab, M <= 64, bf16 x bf16 (decode, short prefill): gemm_swapab,
//   C^T = B^T A^T with K split until the grid has at least 132 CTAs, the
//   partials summed in split order by the last CTA of each column tile;
//   A must be K-major.
// wgmma-swapab-3xbf16, M <= 64, fp32 A x bf16 B (the tied logits): as
//   wgmma-swapab, with A split into three bf16 pieces (sized in
//   tests/test_torch_matmul_unicast.py); C in fp32.
// cuda-core: every other case — fp32 x fp32, bf16 x fp32, mixed dtypes at
//   M > 64, an operand whose base is not 16-byte aligned or whose strides
//   TMA cannot describe (a unit stride on one axis, the other a multiple
//   of 16 bytes), K = 0: one CTA per (BM x BN) output tile with a K loop
//   through shared memory on fp32 FMA (matmul_flat.cuh, as K4), BM 16
//   (BN 64, 128 threads) up to M = 16, else 64 (BN 64, 256 threads).
//
// Groups (the MoE expert matmuls of kernels.grouped_linear, JAX's vmap of
// the kernel over the expert axis): every design takes G products in one
// launch, the group in the grid's z (see matmul_wgmma.cuh); the row-major
// raster orders the tiles of one group.
#include "matmul_flat.cuh"
#include "matmul_wgmma.cuh"

namespace {

using namespace mm90;

// ---- cuda-core ------------------------------------------------------------

template <typename TA, typename TB, int BM, int BN, int BK_, int TM, int TN>
__global__ void __launch_bounds__(flat::threads<BM, BN, TM, TN>())
matmul_unicast_kernel(const TA* __restrict__ A, long long sam, long long sak, long long sag,
                      const TB* __restrict__ B, long long sbk, long long sbn, long long sbg,
                      TA* __restrict__ C, int M, int N, int K) {
  A += blockIdx.z * sag;  // the group's operands
  B += blockIdx.z * sbg;
  C += (long long)blockIdx.z * M * N;
  const int num_n = (N + BN - 1) / BN;
  const int pid_m = blockIdx.x / num_n, pid_n = blockIdx.x % num_n;  // row-major
  flat::tile_gemm<TA, TB, BM, BN, BK_, TM, TN>(A, sam, sak, B, sbk, sbn, C, pid_m * BM,
                                               pid_n * BN, M, N, K);
}

template <typename TA, typename TB, int BM, int BN, int BK_, int TM, int TN>
int launch_flat(const flat::Call& p, void* c, cudaStream_t s) {
  const int tiles = ((p.M + BM - 1) / BM) * ((p.N + BN - 1) / BN);
  matmul_unicast_kernel<TA, TB, BM, BN, BK_, TM, TN>
      <<<dim3(tiles, 1, p.G), flat::threads<BM, BN, TM, TN>(), 0, s>>>(
          static_cast<const TA*>(p.a), p.sam, p.sak, p.sag, static_cast<const TB*>(p.b), p.sbk,
          p.sbn, p.sbg, static_cast<TA*>(c), p.M, p.N, p.K);
  return 0;
}

int launch_cuda_core(const flat::Call& p, int a_dtype, int b_dtype, void* c, cudaStream_t s) {
#define K5_LAUNCH(TA, TB)                              \
  if (p.M <= 16)                                       \
    launch_flat<TA, TB, 16, 64, 32, 2, 4>(p, c, s);    \
  else                                                 \
    launch_flat<TA, TB, 64, 64, 32, 4, 4>(p, c, s);
  FLAT_DISPATCH(a_dtype, b_dtype, K5_LAUNCH);
#undef K5_LAUNCH
  return 0;
}

// ---- the tensor-core designs ----------------------------------------------

struct RowMajorRaster {
  __device__ __forceinline__ void tile(int, int N, int& m0, int& n0) const {
    const int tiles_n = (N + LARGE_BN - 1) / LARGE_BN;
    m0 = blockIdx.x / tiles_n * LARGE_BM;
    n0 = blockIdx.x % tiles_n * LARGE_BN;
  }
  static dim3 grid(int M, int N) {
    return dim3(((M + LARGE_BM - 1) / LARGE_BM) * ((N + LARGE_BN - 1) / LARGE_BN));
  }
};

int launch_tensor_core(int design, bool ak, bool bk, const flat::Call& p, void* c, float* w,
                       int* cnt, cudaStream_t s) {
  const long long gs = (long long)p.M * p.N;
  if (design == WGMMA_SWAPAB_3XBF16)  // fp32 A: C in fp32
    return launch_swapab<true>(bk, p.a, p.sam, p.sak, p.sag, p.b, p.sbk, p.sbn, p.sbg,
                               PlainEpilogue<float>{{static_cast<float*>(c), p.N, gs}}, w, cnt,
                               p.G, p.M, p.N, p.K, s);
  const PlainEpilogue<bf16> epi{{static_cast<bf16*>(c), p.N, gs}};
  if (design == WGMMA_SWAPAB)
    return launch_swapab<false>(bk, p.a, p.sam, p.sak, p.sag, p.b, p.sbk, p.sbn, p.sbg, epi, w,
                                cnt, p.G, p.M, p.N, p.K, s);
#define K5_LARGE(AK, BKM)                                                                     \
  launch_large<AK, BKM, 1, RowMajorRaster>(p.a, p.sam, p.sak, p.sag, p.b, p.sbk, p.sbn, p.sbg, \
                                           epi, p.G, p.M, p.N, p.K, s)
  return ak ? (bk ? K5_LARGE(true, true) : K5_LARGE(true, false))
            : (bk ? K5_LARGE(false, true) : K5_LARGE(false, false));
#undef K5_LARGE
}

// The design a call runs (the fixed rule): see the head of this file.
int design_of(const void* a, int a_dtype, long long sam, long long sak, long long sag,
              const void* b, int b_dtype, long long sbk, long long sbn, long long sbg, int G,
              int M, int N, int K, bool* ak, bool* bk) {
  return design_rule(a, a_dtype, sam, sak, sag, b, b_dtype, sbk, sbn, sbg, G, M, N, K, true, ak,
                     bk);
}

}  // namespace

// C (G, M, N) contiguous in A's dtype: for each group g,
// C[g] = A_g (M, K) @ B_g (K, N), A and B read through their strides
// (elements; A_g at a + g sag, B_g at b + g sbg), each of dtype
// 0 = float32 or 1 = bfloat16.  G = 1 is one product.  ws and counters:
// the split-K workspace (splits x G x M x N fp32, matmul_unicast_splits)
// and one int per group and 64-column tile, zero before the launch and
// zero after it; both may be null when the design does not split K.  The
// design comes from matmul_unicast_design; a failure to build a tensor
// map or to launch returns its cudaError, and nothing retries on another
// design.
extern "C" int matmul_unicast(const void* a, int a_dtype, long long sam, long long sak,
                              long long sag, const void* b, int b_dtype, long long sbk,
                              long long sbn, long long sbg, void* c, int G, int M, int N, int K,
                              void* ws, void* counters, void* stream) {
  if (G <= 0 || M <= 0 || N <= 0) return 0;
  if (G > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  int* cnt = static_cast<int*>(counters);
  const flat::Call p{a, sam, sak, sag, b, sbk, sbn, sbg, G, M, N, K};
  bool ak = true, bk = true;
  const int design =
      design_of(a, a_dtype, sam, sak, sag, b, b_dtype, sbk, sbn, sbg, G, M, N, K, &ak, &bk);
  const int rc = design == CUDA_CORE ? launch_cuda_core(p, a_dtype, b_dtype, c, s)
                                     : launch_tensor_core(design, ak, bk, p, c, w, cnt, s);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// The design matmul_unicast runs for these operands: 0 cuda-core, 1 wgmma,
// 2 wgmma-swapab, 3 wgmma-swapab-3xbf16.
extern "C" int matmul_unicast_design(const void* a, int a_dtype, long long sam, long long sak,
                                     long long sag, const void* b, int b_dtype, long long sbk,
                                     long long sbn, long long sbg, int G, int M, int N, int K) {
  bool ak, bk;
  return design_of(a, a_dtype, sam, sak, sag, b, b_dtype, sbk, sbn, sbg, G, M, N, K, &ak, &bk);
}

// The K split of the swapab designs at (N, K) over G groups: the
// workspace holds this many G x M x N fp32 partials when it exceeds 1.
extern "C" int matmul_unicast_splits(int N, int K, int G) { return splits_of(N, K, G); }
