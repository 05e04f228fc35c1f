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
// wgmma, M > 64, bf16 x bf16 (matmul_hopper.cuh's mainloop):
//   * one CTA per 128 x 128 tile of C, row-major; 288 threads: two
//     consumer warpgroups of 64 rows, one producer warp whose first
//     thread keeps a 4-slot TMA ring of A and B k-tiles (64 deep) full;
//   * A may be K-major (activations) or M-major (a.t(), the dB product of
//     grad(linear)), B N-major (weights) or K-major (b.t(), table.t()):
//     the tensor maps describe the underlying layout, no copy;
//   * one k-tile's wgmmas stay in flight while the next is issued.
// wgmma-swapab, M <= 64, bf16 x bf16 (decode, short prefill):
//   * C^T = B^T A^T: 64 columns of C fill wgmma's 64 rows and M, padded
//     to MP = 8, 16, 32 or 64, is its N; one consumer warpgroup and one
//     producer warp (160 threads), a 6-slot ring of B (64 x 64) and A (MP
//     x 64) k-tiles; A must be K-major;
//   * K is split until the grid has at least 132 CTAs (one per SM):
//     each CTA sums its share of the k-tiles, writes the fp32 partial to
//     a workspace, and the last CTA of its column tile to arrive (a
//     counter per tile, reset by that CTA) sums the partials in split
//     order and stores C: one launch, a deterministic sum.
// wgmma-swapab-3xbf16, M <= 64, fp32 A x bf16 B (the tied logits): as
//   wgmma-swapab, with each k-tile of A read by the consumers and split
//   into three bf16 pieces, A = a1 + a2 + a3 to 2^-24, each multiplied by
//   the bf16 B exactly: fp32 arithmetic on the tensor cores (sized in
//   tests/test_torch_matmul_unicast.py); C in fp32.
// cuda-core: every other case — fp32 x fp32, bf16 x fp32, mixed dtypes at
//   M > 64, an operand whose base is not 16-byte aligned or whose strides
//   TMA cannot describe (a unit stride on one axis, the other a multiple
//   of 16 bytes), K = 0: one CTA per (BM x BN) output tile with a K loop
//   through shared memory on fp32 FMA (matmul_flat.cuh, as K4), BM 16
//   (BN 64, 128 threads) up to M = 16, else 64 (BN 64, 256 threads).
#include <type_traits>

#include "matmul_flat.cuh"
#include "matmul_hopper.cuh"

namespace {

using mm90::BK;

// The tiles of the two wgmma regimes (repro_torch.kernels.matmul
// kernel_blocks reads them).
constexpr int LARGE_BM = 128, LARGE_BN = 128, LARGE_STAGES = 4;
constexpr int SMALL_M_MAX = 64, SMALL_BN = 64, SMALL_STAGES = 6;
constexpr int SMS = 132;  // the H100 SXM's SMs: the split-K target

enum Design { CUDA_CORE = 0, WGMMA = 1, WGMMA_SWAPAB = 2, WGMMA_SWAPAB_3XBF16 = 3 };

// ---- cuda-core ------------------------------------------------------------

template <typename TA, typename TB, int BM, int BN, int BK_, int TM, int TN>
__global__ void __launch_bounds__(flat::threads<BM, BN, TM, TN>())
matmul_unicast_kernel(const TA* __restrict__ A, long long sam, long long sak,
                      const TB* __restrict__ B, long long sbk, long long sbn,
                      TA* __restrict__ C, int M, int N, int K) {
  const int num_n = (N + BN - 1) / BN;
  const int pid_m = blockIdx.x / num_n, pid_n = blockIdx.x % num_n;  // row-major
  flat::tile_gemm<TA, TB, BM, BN, BK_, TM, TN>(A, sam, sak, B, sbk, sbn, C, pid_m * BM,
                                               pid_n * BN, M, N, K);
}

template <typename TA, typename TB, int BM, int BN, int BK_, int TM, int TN>
int launch_flat(const void* a, long long sam, long long sak, const void* b, long long sbk,
                long long sbn, void* c, int M, int N, int K, cudaStream_t s) {
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  matmul_unicast_kernel<TA, TB, BM, BN, BK_, TM, TN>
      <<<tiles, flat::threads<BM, BN, TM, TN>(), 0, s>>>(
          static_cast<const TA*>(a), sam, sak, static_cast<const TB*>(b), sbk, sbn,
          static_cast<TA*>(c), M, N, K);
  return 0;
}

int launch_cuda_core(const void* a, int a_dtype, long long sam, long long sak, const void* b,
                     int b_dtype, long long sbk, long long sbn, void* c, int M, int N, int K,
                     cudaStream_t s) {
#define K5_LAUNCH(TA, TB)                                                             \
  if (M <= 16)                                                                        \
    launch_flat<TA, TB, 16, 64, 32, 2, 4>(a, sam, sak, b, sbk, sbn, c, M, N, K, s);   \
  else                                                                                \
    launch_flat<TA, TB, 64, 64, 32, 4, 4>(a, sam, sak, b, sbk, sbn, c, M, N, K, s);
  FLAT_DISPATCH(a_dtype, b_dtype, K5_LAUNCH);
#undef K5_LAUNCH
  return 0;
}

using namespace mm90;

__device__ __forceinline__ void store_c(bf16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ void store_c(float* p, float x) { *p = x; }

// ---- wgmma: M > 64, 128 x 128 tiles ---------------------------------------

constexpr int LARGE_THREADS = 288;  // two consumer warpgroups, one producer warp

struct LargeSmem {
  static constexpr uint32_t A = tile_bytes<LARGE_BM>(), B = tile_bytes<LARGE_BN>();
  static constexpr size_t BYTES = 1024 + LARGE_STAGES * (A + B) + 16 * LARGE_STAGES;
};

template <bool AK, bool BKM>
__global__ void __launch_bounds__(LARGE_THREADS, 1)
unicast_wgmma(__grid_constant__ const CUtensorMap ta, __grid_constant__ const CUtensorMap tb,
              bf16* __restrict__ C, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* as = reinterpret_cast<bf16*>(base);                              // STAGES A k-tiles
  bf16* bs = reinterpret_cast<bf16*>(base + LARGE_STAGES * LargeSmem::A);  // STAGES B k-tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(base + LARGE_STAGES * (LargeSmem::A + LargeSmem::B));
  uint64_t* empty = full + LARGE_STAGES;

  const int tiles_n = (N + LARGE_BN - 1) / LARGE_BN;
  const int m0 = blockIdx.x / tiles_n * LARGE_BM, n0 = blockIdx.x % tiles_n * LARGE_BN;
  const int steps = (K + BK - 1) / BK;
  constexpr int A_EL = LARGE_BM * BK, B_EL = LARGE_BN * BK;

  if (threadIdx.x == 0) {
    ring_init<LARGE_STAGES>(full, empty, 8);
    bar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    if (threadIdx.x == 256)
      ring_produce<LARGE_STAGES>(full, empty, steps, LargeSmem::A + LargeSmem::B,
                                 [&](int i, int s, uint64_t* bar) {
                                   load_tile<AK, LARGE_BM>(as + s * A_EL, &ta, bar, m0, i * BK);
                                   load_tile<BKM, LARGE_BN>(bs + s * B_EL, &tb, bar, n0, i * BK);
                                 });
    return;
  }
  const int wr = 64 * (threadIdx.x / 128);  // this warpgroup's rows of the tile
  float acc[LARGE_BN / 2];
#pragma unroll
  for (int j = 0; j < LARGE_BN / 2; ++j) acc[j] = 0.f;
  for (int i = 0; i < steps; ++i) {
    const int s = i % LARGE_STAGES;
    ring_wait<LARGE_STAGES>(full, i);
    own(acc);
    mma_fence();
    mma_ktile<LARGE_BN, AK, BKM, LARGE_BM, LARGE_BN>(acc, as + s * A_EL, wr, bs + s * B_EL, 0,
                                                     i == 0);
    mma_commit();
    mma_wait<1>();  // this k-tile's wgmmas run on while the previous slot is released
    own(acc);
    if (i > 0) ring_release<LARGE_STAGES>(empty, i - 1);
  }
  mma_wait_all();
  own(acc);

  const bool pairs = N % 2 == 0;
#pragma unroll
  for (int j = 0; j < LARGE_BN / 2; j += 2) {
    const int r = m0 + wr + frag_row(j), c = n0 + frag_col(j);
    if (r >= M || c >= N) continue;
    bf16* out = C + (long long)r * N + c;
    if (pairs) {
      *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(acc[j], acc[j + 1]);
    } else {
      out[0] = __float2bfloat16_rn(acc[j]);
      if (c + 1 < N) out[1] = __float2bfloat16_rn(acc[j + 1]);
    }
  }
}

template <bool AK, bool BKM>
int launch_large(const void* a, long long sam, long long sak, const void* b, long long sbk,
                 long long sbn, void* c, int M, int N, int K, cudaStream_t stream) {
  CUtensorMap ta, tb;
  int rc = operand_map(&ta, a, AK, M, K, AK ? sam : sak, LARGE_BM);
  if (rc == 0) rc = operand_map(&tb, b, BKM, N, K, BKM ? sbn : sbk, LARGE_BN);
  if (rc == 0) rc = opt_in_smem(unicast_wgmma<AK, BKM>, LargeSmem::BYTES);
  if (rc != 0) return rc;
  const int grid = ((M + LARGE_BM - 1) / LARGE_BM) * ((N + LARGE_BN - 1) / LARGE_BN);
  unicast_wgmma<AK, BKM><<<grid, LARGE_THREADS, LargeSmem::BYTES, stream>>>(
      ta, tb, static_cast<bf16*>(c), M, N, K);
  return 0;
}

// ---- wgmma-swapab: M <= 64, C^T = B^T A^T, split K ------------------------

constexpr int SMALL_THREADS = 160;  // one consumer warpgroup, one producer warp

template <int MP, bool A_F32>
struct SmallSmem {
  static constexpr uint32_t B = tile_bytes<SMALL_BN>(), A = tile_bytes<MP>();
  // fp32 A: no A in the ring; the consumers' three bf16 pieces instead
  static constexpr uint32_t SLOT = A_F32 ? B : B + A;
  static constexpr size_t BYTES =
      1024 + SMALL_STAGES * SLOT + (A_F32 ? 3 * A : 0) + 16 * SMALL_STAGES + 16;
};

// The split of K a (M, N, K) call at M <= 64 runs: at least SMS CTAs
// where the column tiles leave room, at most one k-tile each.
__host__ __device__ inline int splits_of(int N, int K) {
  const int tiles = (N + SMALL_BN - 1) / SMALL_BN, steps = (K + BK - 1) / BK;
  if (tiles >= SMS || steps <= 1) return 1;
  const int want = (SMS + tiles - 1) / tiles;
  return want < steps ? want : steps;
}

// K-major element (r, k) of a 128-byte-swizzled MP x 64 tile
__device__ __forceinline__ int swz(int r, int k) { return r * 64 + (((k / 8) ^ (r % 8)) * 8) + k % 8; }

template <int MP, bool BKM, bool A_F32>
__global__ void __launch_bounds__(SMALL_THREADS)
unicast_swapab(__grid_constant__ const CUtensorMap tb, __grid_constant__ const CUtensorMap ta,
               const float* __restrict__ a32, long long sam, long long sak,
               std::conditional_t<A_F32, float, bf16>* __restrict__ C, float* __restrict__ ws,
               int* __restrict__ counters, int M, int N, int K) {
  using S = SmallSmem<MP, A_F32>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* pieces = reinterpret_cast<bf16*>(base + SMALL_STAGES * S::SLOT);  // fp32 A: 3 x MP x 64
  uint64_t* full = reinterpret_cast<uint64_t*>(base + SMALL_STAGES * S::SLOT + (A_F32 ? 3 * S::A : 0));
  uint64_t* empty = full + SMALL_STAGES;
  __shared__ int last;

  const int n0 = blockIdx.x * SMALL_BN, split = blockIdx.y, splits = gridDim.y;
  const int all = (K + BK - 1) / BK;
  const int kt0 = (int)((long long)all * split / splits);
  const int steps = (int)((long long)all * (split + 1) / splits) - kt0;
  auto bslot = [&](int s) { return reinterpret_cast<bf16*>(base + s * S::SLOT); };
  auto aslot = [&](int s) { return reinterpret_cast<bf16*>(base + s * S::SLOT + S::B); };

  if (threadIdx.x == 0) {
    ring_init<SMALL_STAGES>(full, empty, 4);
    bar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    if (threadIdx.x == 128)
      ring_produce<SMALL_STAGES>(full, empty, steps, S::SLOT, [&](int i, int s, uint64_t* bar) {
        load_tile<BKM, SMALL_BN>(bslot(s), &tb, bar, n0, (kt0 + i) * BK);
        if constexpr (!A_F32) load_tile<true, MP>(aslot(s), &ta, bar, 0, (kt0 + i) * BK);
      });
    return;
  }

  // fp32 A: each thread reads MP / 2 elements of a k-tile, one step ahead
  constexpr int PER = A_F32 ? MP * BK / 128 : 1;
  float next[PER];
#define K5_FETCH(KT)                                                        \
  _Pragma("unroll") for (int e = 0; e < PER; ++e) {                         \
    const int idx = threadIdx.x + 128 * e, m = idx / BK, k = (KT) * BK + idx % BK; \
    next[e] = (m < M && k < K) ? a32[m * sam + k * sak] : 0.f;              \
  }
  if constexpr (A_F32) {
    if (steps > 0) { K5_FETCH(kt0) }
  }

  float acc[MP / 2];
#pragma unroll
  for (int j = 0; j < MP / 2; ++j) acc[j] = 0.f;
  for (int i = 0; i < steps; ++i) {
    const int s = i % SMALL_STAGES;
    const bf16* at = aslot(s);
    if constexpr (A_F32) {
      named_sync(1, 128);  // the previous k-tile's wgmmas no longer read the pieces
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        const int idx = threadIdx.x + 128 * e, m = idx / BK, k = idx % BK;
        const bf16 h = __float2bfloat16_rn(next[e]);
        const float r1 = next[e] - __bfloat162float(h);
        const bf16 mid = __float2bfloat16_rn(r1);
        pieces[swz(m, k)] = h;
        pieces[MP * BK + swz(m, k)] = mid;
        pieces[2 * MP * BK + swz(m, k)] = __float2bfloat16_rn(r1 - __bfloat162float(mid));
      }
      fence_async_smem();
      named_sync(1, 128);
      if (i + 1 < steps) { K5_FETCH(kt0 + i + 1) }
      at = pieces;
    }
    ring_wait<SMALL_STAGES>(full, i);
    own(acc);
    mma_fence();
#pragma unroll
    for (int piece = 0; piece < (A_F32 ? 3 : 1); ++piece)
      mma_ktile<MP, BKM, true, SMALL_BN, MP>(acc, bslot(s), 0, at + piece * MP * BK, 0,
                                             i == 0 && piece == 0);
    mma_commit();
    mma_wait_all();
    own(acc);
    ring_release<SMALL_STAGES>(empty, i);
  }

#undef K5_FETCH

  // the fragment is C^T: row n0 + frag_row(j) of it is column n of C
  if (splits == 1) {
#pragma unroll
    for (int j = 0; j < MP / 2; ++j) {
      const int n = n0 + frag_row(j), m = frag_col(j);
      if (m < M && n < N) store_c(C + (long long)m * N + n, acc[j]);
    }
    return;
  }
  float* part = ws + (long long)split * M * N;
#pragma unroll
  for (int j = 0; j < MP / 2; ++j) {
    const int n = n0 + frag_row(j), m = frag_col(j);
    if (m < M && n < N) part[(long long)m * N + n] = acc[j];
  }
  __threadfence();
  named_sync(1, 128);
  if (threadIdx.x == 0) last = atomicAdd(&counters[blockIdx.x], 1) == splits - 1;
  named_sync(1, 128);
  if (!last) return;
  __threadfence();  // every other split's partial is visible
  for (int e = threadIdx.x; e < M * SMALL_BN; e += 128) {
    const int m = e / SMALL_BN, n = n0 + e % SMALL_BN;
    if (n >= N) continue;
    float sum = 0.f;
    for (int p = 0; p < splits; ++p) sum += __ldcg(ws + ((long long)p * M + m) * N + n);
    store_c(C + (long long)m * N + n, sum);
  }
  if (threadIdx.x == 0) counters[blockIdx.x] = 0;  // ready for the next launch
}

template <int MP, bool BKM, bool A_F32>
int launch_small_mp(const void* a, long long sam, long long sak, const void* b, long long sbk,
                    long long sbn, void* c, float* ws, int* counters, int M, int N, int K,
                    cudaStream_t stream) {
  using S = SmallSmem<MP, A_F32>;
  auto kernel = unicast_swapab<MP, BKM, A_F32>;
  CUtensorMap tb, ta;
  int rc = operand_map(&tb, b, BKM, N, K, BKM ? sbn : sbk, SMALL_BN);
  if (rc == 0 && !A_F32) rc = operand_map(&ta, a, true, M, K, sam, MP);
  if (rc == 0) rc = opt_in_smem(kernel, S::BYTES);
  if (rc != 0) return rc;
  const int splits = splits_of(N, K);
  if (splits > 1 && (ws == nullptr || counters == nullptr)) return (int)cudaErrorInvalidValue;
  dim3 grid((N + SMALL_BN - 1) / SMALL_BN, splits);
  kernel<<<grid, SMALL_THREADS, S::BYTES, stream>>>(
      tb, ta, static_cast<const float*>(a), sam, sak,
      static_cast<std::conditional_t<A_F32, float, bf16>*>(c), ws, counters, M, N, K);
  return 0;
}

template <bool BKM, bool A_F32>
int launch_small(const void* a, long long sam, long long sak, const void* b, long long sbk,
                 long long sbn, void* c, float* ws, int* counters, int M, int N, int K,
                 cudaStream_t s) {
#define K5_SMALL(MP) \
  launch_small_mp<MP, BKM, A_F32>(a, sam, sak, b, sbk, sbn, c, ws, counters, M, N, K, s)
  if (M <= 8) return K5_SMALL(8);
  if (M <= 16) return K5_SMALL(16);
  if (M <= 32) return K5_SMALL(32);
  return K5_SMALL(64);
#undef K5_SMALL
}

// The design a call runs (the fixed rule): see the head of this file.
int design_of(const void* a, int a_dtype, long long sam, long long sak, const void* b,
              int b_dtype, long long sbk, long long sbn, int M, int N, int K, bool* ak,
              bool* bk) {
  if (M <= 0 || N <= 0 || K <= 0 || b_dtype != 1) return CUDA_CORE;
  if (!operand_ok(b, sbn, sbk, bk)) return CUDA_CORE;
  if (M <= SMALL_M_MAX) {
    if (a_dtype == 0) return WGMMA_SWAPAB_3XBF16;
    return (a_dtype == 1 && operand_ok(a, sam, sak, ak) && *ak) ? WGMMA_SWAPAB : CUDA_CORE;
  }
  return (a_dtype == 1 && operand_ok(a, sam, sak, ak)) ? WGMMA : CUDA_CORE;
}

}  // namespace

// C (M, N) contiguous in A's dtype = A (M, K) @ B (K, N), A and B read
// through their strides (elements), each of dtype 0 = float32 or
// 1 = bfloat16.  ws and counters: the split-K workspace (splits x M x N
// fp32, matmul_unicast_splits) and one int per 64-column tile, zero before
// the launch and zero after it; both may be null when the design does not
// split K.  The design comes from matmul_unicast_design; a failure to
// build a tensor map or to launch returns its cudaError, and nothing
// retries on another design.
extern "C" int matmul_unicast(const void* a, int a_dtype, long long sam, long long sak,
                              const void* b, int b_dtype, long long sbk, long long sbn,
                              void* c, int M, int N, int K, void* ws, void* counters,
                              void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  int* cnt = static_cast<int*>(counters);
  bool ak = true, bk = true;
  int rc = 0;
  switch (design_of(a, a_dtype, sam, sak, b, b_dtype, sbk, sbn, M, N, K, &ak, &bk)) {
    case WGMMA:
      rc = ak ? (bk ? launch_large<true, true>(a, sam, sak, b, sbk, sbn, c, M, N, K, s)
                    : launch_large<true, false>(a, sam, sak, b, sbk, sbn, c, M, N, K, s))
              : (bk ? launch_large<false, true>(a, sam, sak, b, sbk, sbn, c, M, N, K, s)
                    : launch_large<false, false>(a, sam, sak, b, sbk, sbn, c, M, N, K, s));
      break;
    case WGMMA_SWAPAB:
      rc = bk ? launch_small<true, false>(a, sam, sak, b, sbk, sbn, c, w, cnt, M, N, K, s)
              : launch_small<false, false>(a, sam, sak, b, sbk, sbn, c, w, cnt, M, N, K, s);
      break;
    case WGMMA_SWAPAB_3XBF16:
      rc = bk ? launch_small<true, true>(a, sam, sak, b, sbk, sbn, c, w, cnt, M, N, K, s)
              : launch_small<false, true>(a, sam, sak, b, sbk, sbn, c, w, cnt, M, N, K, s);
      break;
    default:
      rc = launch_cuda_core(a, a_dtype, sam, sak, b, b_dtype, sbk, sbn, c, M, N, K, s);
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// The design matmul_unicast runs for these operands: 0 cuda-core, 1 wgmma,
// 2 wgmma-swapab, 3 wgmma-swapab-3xbf16.
extern "C" int matmul_unicast_design(const void* a, int a_dtype, long long sam, long long sak,
                                     const void* b, int b_dtype, long long sbk, long long sbn,
                                     int M, int N, int K) {
  bool ak, bk;
  return design_of(a, a_dtype, sam, sak, b, b_dtype, sbk, sbn, M, N, K, &ak, &bk);
}

// The K split of the swapab designs at (N, K): the workspace holds this
// many M x N fp32 partials when it exceeds 1.
extern "C" int matmul_unicast_splits(int N, int K) { return splits_of(N, K); }
