// The tensor-core kernels of the port's three matmul schedules, for
// sm_90a, on matmul_hopper.cuh's TMA + wgmma mainloop: K1 (matmul_tiled.cu),
// K4 (matmul_mcast.cu) and K5 (matmul_unicast.cu) instantiate the same two
// kernel bodies, each with
//   * a raster: which 128 x 128 tile of C a CTA of gemm_wgmma computes
//     (K5 row-major, K1 grouped by 8 row blocks, K4 a cluster's rank);
//   * an epilogue: bias(n), the activation (with_act) and the store of an
//     fp32 value at (m, n) as an element of C (K4 and K5: PlainEpilogue, C
//     in A's dtype, no bias, no activation; K1: bias, activation, out
//     dtype).
// The kernel applies them as act(sum + bias(n)), once, to the full K sum.
// with_act hands each store loop the activation as a function object, so
// the loop body holds one activation's code and no switch: a runtime
// switch inlined per element multiplied the unrolled loop's instructions
// and left K1 well behind K5 at the same shapes.
//
// gemm_wgmma, M > 64, bf16 x bf16:
//   * one CTA per 128 x 128 tile of C; 288 threads: two consumer
//     warpgroups of 64 rows, one producer warp whose first thread keeps a
//     4-slot TMA ring of A and B k-tiles (64 deep) full;
//   * A may be K-major (activations) or M-major (a.t(), the dB product of
//     grad(linear)), B N-major (weights) or K-major (b.t(), table.t()):
//     the tensor maps describe the underlying layout, no copy;
//   * one k-tile's wgmmas stay in flight while the next is issued;
//   * CL > 1 (K4): the CL CTAs of a thread-block cluster compute CL row
//     blocks of one column tile.  Each loads its own A k-tile and 1/CL of
//     the B k-tile, which TMA multicasts into the shared memory of all CL
//     (load_slice): B is fetched from global memory once per cluster.
//     Each CTA's full barrier expects its A bytes and all of B's; a slot
//     is refilled once the consumers of all CL CTAs released it.  Cluster
//     barriers after the mbarrier init and before exit keep every peer's
//     barriers and slots alive while a multicast or a remote arrival can
//     reach them.  A CTA whose row block lies past M takes part all the
//     same: its A boxes come back zero-filled and it stores nothing.
// gemm_swapab, M <= 64, bf16 B (decode, short prefill, the tied logits):
//   * C^T = B^T A^T: 64 columns of C fill wgmma's 64 rows and M, padded
//     to MP = 8, 16, 32 or 64, is its N; one consumer warpgroup and one
//     producer warp (160 threads), a 6-slot ring of B (64 x 64) and A (MP
//     x 64) k-tiles; bf16 A must be K-major;
//   * fp32 A (A_F32): each k-tile of A is read by the consumers and split
//     into three bf16 pieces, A = a1 + a2 + a3 to 2^-24, each multiplied
//     by the bf16 B exactly: fp32 arithmetic on the tensor cores;
//   * K is split until the grid has at least 132 CTAs (one per SM): each
//     CTA sums its share of the k-tiles, writes the fp32 partial to a
//     workspace, and the last CTA of its column tile to arrive (a counter
//     per tile, reset by that CTA) sums the partials in split order and
//     runs the epilogue on the sum: one launch, a deterministic sum, the
//     bias added once.  With one split the epilogue runs on the fragment.
//     With a single row block, each k-slice of each B column tile is read
//     by one CTA: B is read once per launch, whatever the schedule.
// Groups (the MoE expert matmuls, kernels.grouped_linear): G independent
// products C_g = A_g B_g in one launch, the group in the grid's z.  A_g
// and B_g sit sag and sbg elements after A_0 and B_0 (the tensor maps'
// third dimension), C is (G, M, N) contiguous, and an epilogue moves to
// its group before it stores (to_group).  K is split over G x the column
// tiles: each group's column tiles have their own counters and their own
// splits x M x N of the workspace, so no two groups share a counter.
// A cluster of K4 lies along x, inside one group.  G = 1 is the plain
// product.
#pragma once

#include <type_traits>

#include "matmul_hopper.cuh"

namespace mm90 {

// The tiles of the two regimes (repro_torch.kernels.matmul kernel_blocks
// reads them).
constexpr int LARGE_BM = 128, LARGE_BN = 128, LARGE_STAGES = 4;
constexpr int SMALL_M_MAX = 64, SMALL_BN = 64, SMALL_STAGES = 6;
constexpr int SMS = 132;  // the H100 SXM's SMs: the split-K target

// The designs a C entry's rule picks (each kernel's Design enum).
enum Design { CUDA_CORE = 0, WGMMA = 1, WGMMA_SWAPAB = 2, WGMMA_SWAPAB_3XBF16 = 3 };

// The rule shared by the three schedules, dtype codes 0 fp32, 1 bf16: a
// bf16 B that TMA reads; up to SMALL_M_MAX rows fp32 A -> 3xbf16, bf16
// K-major A -> swapab; above it bf16 A (M-major only where a_mn_major)
// -> wgmma; anything else -> cuda-core.  ak / bk: the operands' K-major-ness.
// Over G > 1 groups TMA also needs each group stride of a bf16 operand
// it reads to be a positive multiple of 8 elements (16 bytes).
__host__ inline int design_rule(const void* a, int a_dtype, long long sam, long long sak,
                                long long sag, const void* b, int b_dtype, long long sbk,
                                long long sbn, long long sbg, int G, int M, int N, int K,
                                bool a_mn_major, bool* ak, bool* bk) {
  auto group_ok = [G](long long sg) { return G == 1 || (sg > 0 && sg % 8 == 0); };
  if (G <= 0 || M <= 0 || N <= 0 || K <= 0 || b_dtype != 1) return CUDA_CORE;
  if (!operand_ok(b, sbn, sbk, bk) || !group_ok(sbg)) return CUDA_CORE;
  if (M <= SMALL_M_MAX) {
    if (a_dtype == 0) return WGMMA_SWAPAB_3XBF16;
    return (a_dtype == 1 && operand_ok(a, sam, sak, ak) && *ak && group_ok(sag))
               ? WGMMA_SWAPAB
               : CUDA_CORE;
  }
  return (a_dtype == 1 && operand_ok(a, sam, sak, ak) && (*ak || a_mn_major) && group_ok(sag))
             ? WGMMA
             : CUDA_CORE;
}

// ---- epilogues ------------------------------------------------------------

__device__ __forceinline__ void put(bf16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void put2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// C (M x N, row-major) in TO, group after group gs elements apart.  An
// epilogue's bias(n) takes any n, 0 past N.
template <typename TO>
struct Store {
  TO* C;
  int N;
  long long gs;
  // move to group g's C (and, in an epilogue with one, its bias)
  __device__ __forceinline__ void to_group(int g) { C += g * gs; }
  __device__ __forceinline__ void store(int m, int n, float v) const {
    put(C + (long long)m * N + n, v);
  }
  // C[m, n] = v0 and, where n + 1 < N, C[m, n + 1] = v1 (n even)
  __device__ __forceinline__ void store2(int m, int n, float v0, float v1) const {
    TO* p = C + (long long)m * N + n;
    if (N % 2 == 0) {
      put2(p, v0, v1);
    } else {
      put(p, v0);
      if (n + 1 < N) put(p + 1, v1);
    }
  }
};

struct Identity {
  __device__ __forceinline__ float operator()(float x) const { return x; }
};

// The bare product in TO (K4, K5).  x + -0 is x for every x, -0 too, so
// the kernels' `+ bias(n)` folds away.
template <typename TO>
struct PlainEpilogue : Store<TO> {
  __device__ __forceinline__ float bias(int) const { return -0.f; }
  template <typename F>
  __device__ __forceinline__ void with_act(F f) const { f(Identity{}); }
};

// ---- gemm_wgmma: M > 64, 128 x 128 tiles ----------------------------------

constexpr int LARGE_THREADS = 288;  // two consumer warpgroups, one producer warp

struct LargeSmem {
  static constexpr uint32_t A = tile_bytes<LARGE_BM>(), B = tile_bytes<LARGE_BN>();
  static constexpr size_t BYTES = 1024 + LARGE_STAGES * (A + B) + 16 * LARGE_STAGES;
};

template <bool AK, bool BKM, int CL, typename Raster, typename Epi>
__global__ void __launch_bounds__(LARGE_THREADS, 1)
gemm_wgmma(__grid_constant__ const CUtensorMap ta, __grid_constant__ const CUtensorMap tb,
           Raster raster, Epi epi0, int M, int N, int K) {
  using S = LargeSmem;
  const int g = blockIdx.z;  // the group
  Epi epi = epi0;
  epi.to_group(g);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* as = reinterpret_cast<bf16*>(base);                       // STAGES A k-tiles
  bf16* bs = reinterpret_cast<bf16*>(base + LARGE_STAGES * S::A);  // STAGES B k-tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(base + LARGE_STAGES * (S::A + S::B));
  uint64_t* empty = full + LARGE_STAGES;

  int m0, n0;
  raster.tile(M, N, m0, n0);
  const int steps = (K + BK - 1) / BK;
  constexpr int A_EL = LARGE_BM * BK, B_EL = LARGE_BN * BK;

  if (threadIdx.x == 0) {
    ring_init<LARGE_STAGES>(full, empty, 8 * CL);
    bar_init_fence();
  }
  __syncthreads();
  if constexpr (CL > 1) cluster_sync();  // every peer's barriers exist before any remote use

  if (threadIdx.x >= 256) {
    if (threadIdx.x == 256) {
      const int slice = CL > 1 ? (int)cluster_rank() : 0;  // this CTA's share of each B k-tile
      ring_produce<LARGE_STAGES>(full, empty, steps, S::A + S::B, [&](int i, int s, uint64_t* bar) {
        load_tile<AK, LARGE_BM>(as + s * A_EL, &ta, bar, m0, i * BK, g);
        if constexpr (CL == 1)
          load_tile<BKM, LARGE_BN>(bs + s * B_EL, &tb, bar, n0, i * BK, g);
        else
          load_slice<BKM, LARGE_BN, CL>(bs + s * B_EL, &tb, bar, n0, i * BK, g, slice);
      });
    }
  } else {
    const int wr = 64 * (threadIdx.x / 128);  // this warpgroup's rows of the tile
    // bias at this thread's LARGE_BN / 4 columns (frag_col(j) for j % 4 <
    // 2), loaded before the mainloop so the loads overlap it (K4, K5: -0)
    float bv[LARGE_BN / 4];
#pragma unroll
    for (int q = 0; q < LARGE_BN / 4; ++q) bv[q] = epi.bias(n0 + frag_col(q / 2 * 4 + q % 2));
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
      if (i > 0) ring_release<LARGE_STAGES, CL>(empty, i - 1);
    }
    mma_wait_all();
    own(acc);

    epi.with_act([&](auto act) {
#pragma unroll
      for (int j = 0; j < LARGE_BN / 2; j += 2) {
        const int r = m0 + wr + frag_row(j), c = n0 + frag_col(j);
        if (r >= M || c >= N) continue;
        const float v1 = c + 1 < N ? act(acc[j + 1] + bv[j / 4 * 2 + 1]) : 0.f;
        epi.store2(r, c, act(acc[j] + bv[j / 4 * 2]), v1);
      }
    });
  }
  if constexpr (CL > 1) cluster_sync();  // no peer multicasts into or arrives on this CTA now
}

// The launch of gemm_wgmma over `grid` in clusters of CL CTAs along x;
// `cluster` holds the attribute the config points to.
template <int CL>
cudaLaunchConfig_t cluster_config(dim3 grid, cudaStream_t stream, cudaLaunchAttribute* cluster) {
  cluster->id = cudaLaunchAttributeClusterDimension;
  cluster->val.clusterDim.x = CL;
  cluster->val.clusterDim.y = 1;
  cluster->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(LARGE_THREADS);
  cfg.dynamicSmemBytes = LargeSmem::BYTES;
  cfg.stream = stream;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cfg;
}

// Launch gemm_wgmma on the tiles Raster::grid(M, N) numbers, for each of
// G groups (the grid's z); CL > 1 as clusters of CL CTAs along the grid's
// x.  0 or a cudaError.
template <bool AK, bool BKM, int CL, typename Raster, typename Epi>
int launch_large(const void* a, long long sam, long long sak, long long sag, const void* b,
                 long long sbk, long long sbn, long long sbg, const Epi& epi, int G, int M, int N,
                 int K, cudaStream_t stream) {
  auto kernel = gemm_wgmma<AK, BKM, CL, Raster, Epi>;
  CUtensorMap ta, tb;
  int rc = operand_map(&ta, a, AK, M, K, AK ? sam : sak, LARGE_BM, BK, G, G > 1 ? sag : 0);
  if (rc == 0)
    rc = operand_map(&tb, b, BKM, N, K, BKM ? sbn : sbk, LARGE_BN / CL,
                     CL > 1 ? LARGE_BN / CL : BK, G, G > 1 ? sbg : 0);
  if (rc == 0) rc = opt_in_smem(kernel, LargeSmem::BYTES);
  if (rc != 0) return rc;
  dim3 grid = Raster::grid(M, N);
  grid.z = G;
  if constexpr (CL == 1) {
    kernel<<<grid, LARGE_THREADS, LargeSmem::BYTES, stream>>>(ta, tb, Raster{}, epi, M, N, K);
    return 0;
  } else {
    cudaLaunchAttribute cluster;
    const cudaLaunchConfig_t cfg = cluster_config<CL>(grid, stream, &cluster);
    return (int)cudaLaunchKernelEx(&cfg, kernel, ta, tb, Raster{}, epi, M, N, K);
  }
}

// ---- gemm_swapab: M <= 64, C^T = B^T A^T, split K -------------------------

constexpr int SMALL_THREADS = 160;  // one consumer warpgroup, one producer warp

template <int MP, bool A_F32>
struct SmallSmem {
  static constexpr uint32_t B = tile_bytes<SMALL_BN>(), A = tile_bytes<MP>();
  // fp32 A: no A in the ring; the consumers' three bf16 pieces instead
  static constexpr uint32_t SLOT = A_F32 ? B : B + A;
  static constexpr size_t BYTES =
      1024 + SMALL_STAGES * SLOT + (A_F32 ? 3 * A : 0) + 16 * SMALL_STAGES + 16;
};

// The split of K a (M, N, K) call over G groups at M <= 64 runs: at
// least SMS CTAs where the groups' column tiles leave room, at most one
// k-tile each.  Only a grid of fewer than SMS tiles splits, so the
// counters of one split launch number fewer than SMS.
__host__ __device__ inline int splits_of(int N, int K, int G = 1) {
  const int tiles = G * ((N + SMALL_BN - 1) / SMALL_BN), steps = (K + BK - 1) / BK;
  if (tiles >= SMS || steps <= 1) return 1;
  const int want = (SMS + tiles - 1) / tiles;
  return want < steps ? want : steps;
}

// K-major element (r, k) of a 128-byte-swizzled MP x 64 tile
__device__ __forceinline__ int swz(int r, int k) { return r * 64 + (((k / 8) ^ (r % 8)) * 8) + k % 8; }

template <int MP, bool BKM, bool A_F32, typename Epi>
__global__ void __launch_bounds__(SMALL_THREADS)
gemm_swapab(__grid_constant__ const CUtensorMap tb, __grid_constant__ const CUtensorMap ta,
            const float* __restrict__ a32, long long sam, long long sak, long long sag,
            Epi epi0, float* __restrict__ ws, int* __restrict__ counters, int M, int N, int K) {
  using S = SmallSmem<MP, A_F32>;
  // the group: its A (fp32 A is read by address), C, counters and
  // workspace partials
  const int g = blockIdx.z;
  Epi epi = epi0;
  epi.to_group(g);
  a32 += g * sag;
  if (gridDim.y > 1) {
    counters += g * gridDim.x;
    ws += (long long)g * gridDim.y * M * N;
  }
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
        load_tile<BKM, SMALL_BN>(bslot(s), &tb, bar, n0, (kt0 + i) * BK, g);
        if constexpr (!A_F32) load_tile<true, MP>(aslot(s), &ta, bar, 0, (kt0 + i) * BK, g);
      });
    return;
  }

  // fp32 A: each thread reads MP / 2 elements of a k-tile, one step ahead
  constexpr int PER = A_F32 ? MP * BK / 128 : 1;
  float next[PER];
#define MM90_FETCH(KT)                                                        \
  _Pragma("unroll") for (int e = 0; e < PER; ++e) {                           \
    const int idx = threadIdx.x + 128 * e, m = idx / BK, k = (KT) * BK + idx % BK; \
    next[e] = (m < M && k < K) ? a32[m * sam + k * sak] : 0.f;                \
  }
  if constexpr (A_F32) {
    if (steps > 0) { MM90_FETCH(kt0) }
  }

  // bias at this thread's two fragment rows (columns of C), for one split
  const float b_lo = epi.bias(n0 + frag_row(0)), b_hi = epi.bias(n0 + frag_row(2));
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
      if (i + 1 < steps) { MM90_FETCH(kt0 + i + 1) }
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

#undef MM90_FETCH

  // the fragment is C^T: row n0 + frag_row(j) of it is column n of C
  if (splits == 1) {
    epi.with_act([&](auto act) {
#pragma unroll
      for (int j = 0; j < MP / 2; ++j) {
        const int n = n0 + frag_row(j), m = frag_col(j);
        if (m < M && n < N) epi.store(m, n, act(acc[j] + (j & 2 ? b_hi : b_lo)));
      }
    });
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
  epi.with_act([&](auto act) {
    for (int e = threadIdx.x; e < M * SMALL_BN; e += 128) {
      const int m = e / SMALL_BN, n = n0 + e % SMALL_BN;
      if (n >= N) continue;
      float sum = 0.f;
      for (int p = 0; p < splits; ++p) sum += __ldcg(ws + ((long long)p * M + m) * N + n);
      epi.store(m, n, act(sum + epi.bias(n)));
    }
  });
  if (threadIdx.x == 0) counters[blockIdx.x] = 0;  // ready for the next launch
}

template <int MP, bool BKM, bool A_F32, typename Epi>
int launch_small_mp(const void* a, long long sam, long long sak, long long sag, const void* b,
                    long long sbk, long long sbn, long long sbg, const Epi& epi, float* ws,
                    int* counters, int G, int M, int N, int K, cudaStream_t stream) {
  using S = SmallSmem<MP, A_F32>;
  auto kernel = gemm_swapab<MP, BKM, A_F32, Epi>;
  CUtensorMap tb, ta;
  int rc = operand_map(&tb, b, BKM, N, K, BKM ? sbn : sbk, SMALL_BN, BK, G, G > 1 ? sbg : 0);
  if (rc == 0 && !A_F32) rc = operand_map(&ta, a, true, M, K, sam, MP, BK, G, G > 1 ? sag : 0);
  if (rc == 0) rc = opt_in_smem(kernel, S::BYTES);
  if (rc != 0) return rc;
  const int splits = splits_of(N, K, G);
  if (splits > 1 && (ws == nullptr || counters == nullptr)) return (int)cudaErrorInvalidValue;
  dim3 grid((N + SMALL_BN - 1) / SMALL_BN, splits, G);
  kernel<<<grid, SMALL_THREADS, S::BYTES, stream>>>(tb, ta, static_cast<const float*>(a), sam,
                                                     sak, sag, epi, ws, counters, M, N, K);
  return 0;
}

// gemm_swapab at the least MP that holds M; 0 or a cudaError.
template <bool BKM, bool A_F32, typename Epi>
int launch_small(const void* a, long long sam, long long sak, long long sag, const void* b,
                 long long sbk, long long sbn, long long sbg, const Epi& epi, float* ws,
                 int* counters, int G, int M, int N, int K, cudaStream_t s) {
#define MM90_SMALL(MP)                                                                        \
  launch_small_mp<MP, BKM, A_F32>(a, sam, sak, sag, b, sbk, sbn, sbg, epi, ws, counters, G, M, \
                                  N, K, s)
  if (M <= 8) return MM90_SMALL(8);
  if (M <= 16) return MM90_SMALL(16);
  if (M <= 32) return MM90_SMALL(32);
  return MM90_SMALL(64);
#undef MM90_SMALL
}

// gemm_swapab with bf16 (A_F32: fp32) A and B K-major (bk) or N-major,
// epilogue and all, over G groups; 0 or a cudaError.
template <bool A_F32, typename Epi>
int launch_swapab(bool bk, const void* a, long long sam, long long sak, long long sag,
                  const void* b, long long sbk, long long sbn, long long sbg, const Epi& epi,
                  float* ws, int* counters, int G, int M, int N, int K, cudaStream_t s) {
  return bk ? launch_small<true, A_F32>(a, sam, sak, sag, b, sbk, sbn, sbg, epi, ws, counters,
                                        G, M, N, K, s)
            : launch_small<false, A_F32>(a, sam, sak, sag, b, sbk, sbn, sbg, epi, ws, counters,
                                         G, M, N, K, s);
}

}  // namespace mm90
