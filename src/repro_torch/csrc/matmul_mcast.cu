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
// What bounds it on the H100: the bytes of B at the serving shapes (M
// 1-64 against K, N of 1024-151936), the tensor cores' rate at M of
// hundreds to thousands.  K4 keeps the paper's property — B fetched from
// global memory once per cluster of row blocks, and once per launch where
// M fits one cluster — without costing the grid its parallelism.  Four
// designs, chosen by a fixed rule (design_of below):
//
// wgmma-cluster, M > 64, bf16 A (K-major) x bf16 B (N- or K-major): the
//   hardware form of the paper's mechanism.  matmul_wgmma.cuh's gemm_wgmma
//   in thread-block clusters of CL CTAs along M: the CTAs of a cluster own
//   CL consecutive 128-row blocks of one 128-column tile of C.  Each B
//   k-tile is fetched from global memory once per cluster, by
//   cp.async.bulk.tensor ... .multicast::cluster into the shared memory of
//   all CL CTAs.  Each CTA issues 1/CL of the box with the full CTA mask,
//   rather than one CTA issuing it all: the TMA issue and the L2 requests
//   spread over the cluster's SMs, and every CTA's barriers see the same
//   traffic (one rule for the empty-slot count).  A is loaded per CTA.
//   CL by a fixed rule from M (cluster_of): CLUSTER_SMALL = 2 up to
//   CLUSTER_SMALL_MAX_M = 256 rows, else CLUSTER_LARGE = 4.  So B is read
//   once per launch at M <= 512 (once at M = 256, with CL = 2), and
//   ceil(M / (128 CL)) times beyond: 5 at M = 2049.  Clusters of 2 and 4
//   fit any GPC (8 is the portable limit).  A CTA whose row block lies
//   wholly past M still joins its cluster's multicast and barriers; it
//   receives zero-filled A and stores nothing.
// wgmma-swapab, M <= 64, bf16 A (K-major) x bf16 B, and
// wgmma-swapab-3xbf16, M <= 64, fp32 A x bf16 B (the tied logits): K4 and
//   K5 coincide here.  With a single row block, each k-slice of each B
//   column tile is read by exactly one CTA, so B is read once per launch
//   while K is split across the card (unicast with a single row block is
//   multicast); the same gemm_swapab instantiations as K5, no epilogue.
// cuda-core: every other case (fp32 B, bf16 x fp32, M-major A or mixed
//   dtypes above 64 rows, bases or strides TMA cannot read, K = 0): one
//   CTA per BN-column tile owns every row of C and walks K, staging each
//   (BK x BN) tile of B in shared memory once, where all of its rows read
//   it (fp32 FMA, matmul_flat.cuh); beyond RESIDENT_ROWS it walks row
//   panels of that size, each re-reading B.  Tiles by M: M <= 16 a 16-row
//   tile (BN 64, 128 threads), M <= 64 a 64-row tile (BN 64, 256 threads),
//   larger M the 256-row panel (BN 64, 256 threads).
//
// Groups (the MoE expert matmuls of kernels.grouped_linear, JAX's vmap of
// the kernel over the expert axis): every design takes G products in one
// launch, the group in the grid's z (see matmul_wgmma.cuh).  A cluster
// lies along x, so its CTAs share one group's B k-tiles and never span
// two groups.
#include "matmul_flat.cuh"
#include "matmul_wgmma.cuh"

namespace {

using namespace mm90;

// ---- cuda-core ------------------------------------------------------------

constexpr int RESIDENT_ROWS = 256;

template <typename TA, typename TB, int BM, int BN, int BK_, int TM, int TN>
__global__ void __launch_bounds__(flat::threads<BM, BN, TM, TN>())
matmul_mcast_kernel(const TA* __restrict__ A, long long sam, long long sak, long long sag,
                    const TB* __restrict__ B, long long sbk, long long sbn, long long sbg,
                    TA* __restrict__ C, int M, int N, int K) {
  A += blockIdx.z * sag;  // the group's operands
  B += blockIdx.z * sbg;
  C += (long long)blockIdx.z * M * N;
  const int n0 = blockIdx.x * BN;
  for (int m0 = 0; m0 < M; m0 += BM)  // one pass when M <= BM
    flat::tile_gemm<TA, TB, BM, BN, BK_, TM, TN>(A, sam, sak, B, sbk, sbn, C, m0, n0, M, N, K);
}

template <typename TA, typename TB, int BM, int BN, int BK_, int TM, int TN>
int launch_flat(const flat::Call& p, void* c, cudaStream_t s) {
  matmul_mcast_kernel<TA, TB, BM, BN, BK_, TM, TN>
      <<<dim3((p.N + BN - 1) / BN, 1, p.G), flat::threads<BM, BN, TM, TN>(), 0, s>>>(
          static_cast<const TA*>(p.a), p.sam, p.sak, p.sag, static_cast<const TB*>(p.b), p.sbk,
          p.sbn, p.sbg, static_cast<TA*>(c), p.M, p.N, p.K);
  return 0;
}

int launch_cuda_core(const flat::Call& p, int a_dtype, int b_dtype, void* c, cudaStream_t s) {
#define K4_LAUNCH(TA, TB)                                                      \
  if (p.M <= 16)                                                               \
    launch_flat<TA, TB, 16, 64, 32, 2, 4>(p, c, s);                            \
  else if (p.M <= 64)                                                          \
    launch_flat<TA, TB, 64, 64, 32, 4, 4>(p, c, s);                            \
  else                                                                         \
    launch_flat<TA, TB, RESIDENT_ROWS, 64, 16, 8, 8>(p, c, s);
  FLAT_DISPATCH(a_dtype, b_dtype, K4_LAUNCH);
#undef K4_LAUNCH
  return 0;
}

// ---- the tensor-core designs ----------------------------------------------

// The cluster size at M > 64 rows (kernel_blocks reads these constants).
constexpr int CLUSTER_SMALL = 2, CLUSTER_LARGE = 4, CLUSTER_SMALL_MAX_M = 256;

__host__ inline int cluster_of(int M) {
  return M <= CLUSTER_SMALL_MAX_M ? CLUSTER_SMALL : CLUSTER_LARGE;
}

// Clusters of CL CTAs along the grid's x, one per CL row blocks of a
// column tile (the grid's y): rank r of a cluster owns its r-th row block.
template <int CL>
struct ClusterRaster {
  __device__ __forceinline__ void tile(int, int, int& m0, int& n0) const {
    m0 = (blockIdx.x / CL * CL + (int)cluster_rank()) * LARGE_BM;
    n0 = blockIdx.y * LARGE_BN;
  }
  static dim3 grid(int M, int N) {
    const int blocks = (M + LARGE_BM - 1) / LARGE_BM;
    return dim3((blocks + CL - 1) / CL * CL, (N + LARGE_BN - 1) / LARGE_BN);
  }
};

int launch_tensor_core(int design, bool bk, const flat::Call& p, void* c, float* w, int* cnt,
                       cudaStream_t s) {
  const long long gs = (long long)p.M * p.N;
  if (design == WGMMA_SWAPAB_3XBF16)  // fp32 A: C in fp32
    return launch_swapab<true>(bk, p.a, p.sam, p.sak, p.sag, p.b, p.sbk, p.sbn, p.sbg,
                               PlainEpilogue<float>{{static_cast<float*>(c), p.N, gs}}, w, cnt,
                               p.G, p.M, p.N, p.K, s);
  const PlainEpilogue<bf16> epi{{static_cast<bf16*>(c), p.N, gs}};
  if (design == WGMMA_SWAPAB)
    return launch_swapab<false>(bk, p.a, p.sam, p.sak, p.sag, p.b, p.sbk, p.sbn, p.sbg, epi, w,
                                cnt, p.G, p.M, p.N, p.K, s);
#define K4_CLUSTER(CL)                                                                        \
  (bk ? launch_large<true, true, CL, ClusterRaster<CL>>(p.a, p.sam, p.sak, p.sag, p.b, p.sbk, \
                                                        p.sbn, p.sbg, epi, p.G, p.M, p.N,     \
                                                        p.K, s)                               \
      : launch_large<true, false, CL, ClusterRaster<CL>>(p.a, p.sam, p.sak, p.sag, p.b,       \
                                                         p.sbk, p.sbn, p.sbg, epi, p.G, p.M,  \
                                                         p.N, p.K, s))
  return cluster_of(p.M) == CLUSTER_SMALL ? K4_CLUSTER(CLUSTER_SMALL)
                                          : K4_CLUSTER(CLUSTER_LARGE);
#undef K4_CLUSTER
}

// How many clusters of wgmma-cluster at CL fit on the card at once (the
// occupancy API's answer; 0 if it fails).
template <int CL>
int active_clusters() {
  auto kernel = gemm_wgmma<true, false, CL, ClusterRaster<CL>, PlainEpilogue<bf16>>;
  if (opt_in_smem(kernel, LargeSmem::BYTES) != 0) return 0;
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg = cluster_config<CL>(dim3(CL * SMS), nullptr, &cluster);
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) == cudaSuccess ? n : 0;
}

// The design a call runs (the fixed rule): see the head of this file;
// WGMMA is wgmma-cluster, for K-major A only.
int design_of(const void* a, int a_dtype, long long sam, long long sak, long long sag,
              const void* b, int b_dtype, long long sbk, long long sbn, long long sbg, int G,
              int M, int N, int K, bool* ak, bool* bk) {
  return design_rule(a, a_dtype, sam, sak, sag, b, b_dtype, sbk, sbn, sbg, G, M, N, K, false, ak,
                     bk);
}

}  // namespace

// C (G, M, N) contiguous in A's dtype: for each group g,
// C[g] = A_g (M, K) @ B_g (K, N), A and B read through their strides
// (elements; A_g at a + g sag, B_g at b + g sbg), each of dtype
// 0 = float32 or 1 = bfloat16.  G = 1 is one product.  ws and counters:
// the split-K workspace (splits x G x M x N fp32, matmul_mcast_splits)
// and one int per group and 64-column tile, zero before the launch and
// zero after it; both may be null when the design does not split K.  The
// design comes from matmul_mcast_design; a failure to build a tensor map
// or to launch returns its cudaError, and nothing retries on another
// design.
extern "C" int matmul_mcast(const void* a, int a_dtype, long long sam, long long sak,
                            long long sag, const void* b, int b_dtype, long long sbk,
                            long long sbn, long long sbg, void* c, int G, int M, int N, int K,
                            void* ws, void* counters, void* stream) {
  if (G <= 0 || M <= 0 || N <= 0) return 0;
  if (G > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const flat::Call p{a, sam, sak, sag, b, sbk, sbn, sbg, G, M, N, K};
  bool ak = true, bk = true;
  const int design =
      design_of(a, a_dtype, sam, sak, sag, b, b_dtype, sbk, sbn, sbg, G, M, N, K, &ak, &bk);
  const int rc = design == CUDA_CORE
                     ? launch_cuda_core(p, a_dtype, b_dtype, c, s)
                     : launch_tensor_core(design, bk, p, c, static_cast<float*>(ws),
                                          static_cast<int*>(counters), s);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// The design matmul_mcast runs for these operands: 0 cuda-core,
// 1 wgmma-cluster, 2 wgmma-swapab, 3 wgmma-swapab-3xbf16.
extern "C" int matmul_mcast_design(const void* a, int a_dtype, long long sam, long long sak,
                                   long long sag, const void* b, int b_dtype, long long sbk,
                                   long long sbn, long long sbg, int G, int M, int N, int K) {
  bool ak, bk;
  return design_of(a, a_dtype, sam, sak, sag, b, b_dtype, sbk, sbn, sbg, G, M, N, K, &ak, &bk);
}

// The K split of the swapab designs at (N, K) over G groups: the
// workspace holds this many G x M x N fp32 partials when it exceeds 1.
extern "C" int matmul_mcast_splits(int N, int K, int G) { return splits_of(N, K, G); }

// The cluster size of wgmma-cluster at M rows (B is read ceil(M / (128
// CL)) times per launch).
extern "C" int matmul_mcast_cluster(int M) { return cluster_of(M); }

// How many of those clusters the card holds at once.
extern "C" int matmul_mcast_active_clusters(int M) {
  return cluster_of(M) == CLUSTER_SMALL ? active_clusters<CLUSTER_SMALL>()
                                        : active_clusters<CLUSTER_LARGE>();
}
