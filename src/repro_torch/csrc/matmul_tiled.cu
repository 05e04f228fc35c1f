// K1 — tiled (supertile) multicast matmul with a fused epilogue, for sm_90a.
//
// Replaces: src/repro/kernels/matmul/matmul.py : matmul_mcast_tiled
// (the Pallas TPU kernel behind every kernels.linear projection; body
// _tiled_body, grid (M/gm, N/bn, K/bk) with one B tile serving a gm-row
// supertile).
//
// Computes C = act(A @ B + bias) -> out dtype, with fp32 accumulation.
// bias (bf16 or fp32, read in its own dtype and widened in registers:
// exact, so JAX's bias.astype(float32)), the activation and the downcast
// run fused in the epilogue, once, on the full K sum, as in the TPU
// kernel's flush step.
//
// What bounds it on the H100: on the serving path M is tiny (4 decode
// rows, 16-64 prefill rows) against K, N of 1024-151936, so every call is
// bound by the bytes of B it streams (weights, the tied logits table);
// the gradient's products (M of thousands) by the tensor cores' rate.
// Four designs, chosen by a fixed rule (design_of below, the rule of
// matmul_wgmma.cuh shared with K5):
//
// wgmma, M > 64, bf16 x bf16 (A K- or M-major, B N- or K-major): the
//   gemm_wgmma kernel of matmul_wgmma.cuh (128 x 128 tiles, a TMA ring,
//   two consumer warpgroups) with CTAs numbered by a grouped raster of
//   GROUP_M = 8 row blocks: the 8 row blocks of a group (gm = 1024 rows,
//   JAX's default) walk the same column of B tiles back to back, so a B
//   tile fetched from HBM serves the group from L2 — the supertile
//   multicast of the TPU schedule, with L2 in the role of the shared VMEM
//   panel.  Epilogue on the fragment; out bf16 or fp32 (the z recompute
//   of grad(linear)).
// wgmma-swapab, M <= 64, bf16 A (K-major) x bf16 B: gemm_swapab, C^T =
//   B^T A^T with K split until the grid fills the card.  With one split
//   the epilogue runs on the fragment; otherwise in the last CTA's sum of
//   the partials, in split order, so the bias enters once, after the
//   whole K sum, and the activation sees the summed pre-activation.
// wgmma-swapab-3xbf16, M <= 64, fp32 A x bf16 B (the tied logits,
//   linear(x.float(), table) with B = table.t()): as wgmma-swapab with A
//   in three bf16 pieces.
// cuda-core: every other case — fp32 x fp32, bf16 A x fp32 B, mixed dtypes
//   at M > 64, bases or strides TMA cannot read, K = 0: the kernel below,
//   one CTA per (BM, BN) tile with a K loop through shared memory on fp32
//   FMA (exact for bf16 products, true fp32 for fp32 inputs), 16 x 32
//   tiles up to M = 16, else 64 x 64, in the same grouped raster.
//
// Groups (the MoE expert matmuls of kernels.grouped_linear, JAX's vmap of
// the kernel over the expert axis): every design takes G products in one
// launch, the group in the grid's z, each with its own A, B, bias (or one
// bias for all) and C, and the design's rule sees the group strides (see
// matmul_wgmma.cuh).  The grouped raster orders the tiles of one group.
#include "matmul_wgmma.cuh"

namespace {

using namespace mm90;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<bf16>(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16_rn(x); }

// the activations, as function objects
struct Relu {
  __device__ __forceinline__ float operator()(float x) const { return fmaxf(x, 0.f); }
};
struct GeluTanh {  // gelu: the reference's default is the tanh approximation
  __device__ __forceinline__ float operator()(float x) const {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return x * (0.5f * (1.f + tanhf(c * (x + 0.044715f * (x * x * x)))));
  }
};
struct Silu {
  __device__ __forceinline__ float operator()(float x) const { return x * (1.f / (1.f + expf(-x))); }
};
struct Sigmoid {
  __device__ __forceinline__ float operator()(float x) const { return 1.f / (1.f + expf(-x)); }
};

// f(the activation of code act), codes in the order of
// repro_torch.kernels.matmul.matmul.ACT_CODES: none, relu, gelu,
// gelu_tanh, silu, sigmoid
template <typename F>
__device__ __forceinline__ auto with_activation(int act, F f) {
  switch (act) {
    case 1: return f(Relu{});
    case 2:
    case 3: return f(GeluTanh{});
    case 4: return f(Silu{});
    case 5: return f(Sigmoid{});
    default: return f(Identity{});
  }
}

__device__ __forceinline__ float apply_act(float x, int act) {
  return with_activation(act, [x](auto f) { return f(x); });
}

constexpr int GROUP_M = 8;

// bias[n] in its dtype code (0 fp32, 1 bf16), widened
__device__ __forceinline__ float load_bias(const void* bias, int dt, int n) {
  return dt == 1 ? __bfloat162float(static_cast<const bf16*>(bias)[n])
                 : static_cast<const float*>(bias)[n];
}

template <typename TA, typename TB, typename TO, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
matmul_tiled_kernel(const TA* __restrict__ A, long long sam, long long sak, long long sag,
                    const TB* __restrict__ B, long long sbk, long long sbn, long long sbg,
                    const void* __restrict__ bias, int bias_dt, long long sbias_g,
                    TO* __restrict__ C, int M, int N, int K, int act) {
  const int g = blockIdx.z;  // the group
  A += g * sag;
  B += g * sbg;
  C += (long long)g * M * N;
  if (bias != nullptr)
    bias = static_cast<const char*>(bias) + g * sbias_g * (bias_dt == 1 ? 2 : 4);
  constexpr int TX = BN / TN;  // threads along N
  constexpr int NT = (BM / TM) * TX;
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];

  // grouped ("supertile") raster: GROUP_M row blocks walk the same
  // column of B tiles back to back, so each B tile is reused from L2
  const int num_m = (M + BM - 1) / BM;
  const int num_n = (N + BN - 1) / BN;
  const int pid = blockIdx.x;
  const int per_group = GROUP_M * num_n;
  const int first_m = (pid / per_group) * GROUP_M;
  const int group_rows = min(num_m - first_m, GROUP_M);
  const int pid_m = first_m + (pid % per_group) % group_rows;
  const int pid_n = (pid % per_group) / group_rows;
  const int m0 = pid_m * BM, n0 = pid_n * BN;

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const bool a_k_contig = sak == 1;  // coalesce along whichever axis is unit-stride
  const bool b_n_contig = sbn == 1;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll 4
    for (int idx = tid; idx < BM * BK; idx += NT) {
      int m, k;
      if (a_k_contig) { m = idx / BK; k = idx % BK; } else { k = idx / BM; m = idx % BM; }
      const int gm = m0 + m, gk = k0 + k;
      As[k][m] = (gm < M && gk < K) ? to_f32(A[gm * sam + gk * sak]) : 0.f;
    }
#pragma unroll 4
    for (int idx = tid; idx < BK * BN; idx += NT) {
      int k, n;
      if (b_n_contig) { k = idx / BN; n = idx % BN; } else { n = idx / BK; k = idx % BK; }
      const int gk = k0 + k, gn = n0 + n;
      Bs[k][n] = (gk < K && gn < N) ? to_f32(B[gk * sbk + gn * sbn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // fused epilogue: bias + activation + downcast
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn >= N) continue;
      float v = acc[i][j];
      if (bias != nullptr) v += load_bias(bias, bias_dt, gn);
      C[(long long)gm * N + gn] = from_f32<TO>(apply_act(v, act));
    }
  }
}

// The operands of one call: A, B, the bias (or null) and their group
// strides (elements), G groups of (M, N, K).
struct Call {
  const void* a;
  long long sam, sak, sag;
  const void* b;
  long long sbk, sbn, sbg;
  const void* bias;
  int bias_dt;
  long long sbias_g;
  int G, M, N, K;
};

template <typename TA, typename TB, typename TO, int BM, int BN, int BK, int TM, int TN>
void launch(const Call& p, void* c, int act, cudaStream_t stream) {
  const int tiles = ((p.M + BM - 1) / BM) * ((p.N + BN - 1) / BN);
  matmul_tiled_kernel<TA, TB, TO, BM, BN, BK, TM, TN>
      <<<dim3(tiles, 1, p.G), (BM / TM) * (BN / TN), 0, stream>>>(
          static_cast<const TA*>(p.a), p.sam, p.sak, p.sag, static_cast<const TB*>(p.b), p.sbk,
          p.sbn, p.sbg, p.bias, p.bias_dt, p.sbias_g, static_cast<TO*>(c), p.M, p.N, p.K, act);
}

template <int BM, int BN, int BK, int TM, int TN>
int dispatch(const Call& p, int a_dt, int b_dt, void* c, int c_dt, int act, cudaStream_t s) {
  // dtype codes: 0 = float32, 1 = bfloat16
#define K1_CASE(A_, B_, C_, TA, TB, TO)                           \
  if (a_dt == A_ && b_dt == B_ && c_dt == C_) {                   \
    launch<TA, TB, TO, BM, BN, BK, TM, TN>(p, c, act, s);         \
    return 0;                                                     \
  }
  K1_CASE(0, 0, 0, float, float, float)
  K1_CASE(0, 0, 1, float, float, bf16)
  K1_CASE(0, 1, 0, float, bf16, float)
  K1_CASE(0, 1, 1, float, bf16, bf16)
  K1_CASE(1, 0, 0, bf16, float, float)
  K1_CASE(1, 0, 1, bf16, float, bf16)
  K1_CASE(1, 1, 0, bf16, bf16, float)
  K1_CASE(1, 1, 1, bf16, bf16, bf16)
#undef K1_CASE
  return -1;
}


// ---- the tensor-core designs ----------------------------------------------

// The grouped raster over LARGE_BM x LARGE_BN tiles: GROUP_M row blocks
// walk one column of B tiles before the next column.
struct GroupedRaster {
  __device__ __forceinline__ void tile(int M, int N, int& m0, int& n0) const {
    const int num_m = (M + LARGE_BM - 1) / LARGE_BM, num_n = (N + LARGE_BN - 1) / LARGE_BN;
    const int pid = blockIdx.x, per_group = GROUP_M * num_n;
    const int first_m = pid / per_group * GROUP_M;
    const int group_rows = min(num_m - first_m, GROUP_M);
    m0 = (first_m + pid % per_group % group_rows) * LARGE_BM;
    n0 = pid % per_group / group_rows * LARGE_BN;
  }
  static dim3 grid(int M, int N) {
    return dim3(((M + LARGE_BM - 1) / LARGE_BM) * ((N + LARGE_BN - 1) / LARGE_BN));
  }
};

// K1's epilogue: + bias[n] (bf16 or fp32, or none; group g's bias
// bias_gs elements after group 0's, 0 for one bias), the activation, the
// cast to TO.
template <typename TO>
struct FusedEpilogue : Store<TO> {
  const void* bias_;
  int bias_dt, act_;
  long long bias_gs;
  __device__ __forceinline__ void to_group(int g) {
    Store<TO>::to_group(g);
    if (bias_ != nullptr)
      bias_ = static_cast<const char*>(bias_) + g * bias_gs * (bias_dt == 1 ? 2 : 4);
  }
  __device__ __forceinline__ float bias(int n) const {
    return bias_ == nullptr || n >= this->N ? 0.f : load_bias(bias_, bias_dt, n);
  }
  template <typename F>
  __device__ __forceinline__ void with_act(F f) const { with_activation(act_, f); }
};

template <typename TO>
int launch_tensor_core(int design, bool ak, bool bk, const Call& p,
                       const FusedEpilogue<TO>& epi, float* w, int* cnt, cudaStream_t s) {
  if (design == WGMMA_SWAPAB_3XBF16)
    return launch_swapab<true>(bk, p.a, p.sam, p.sak, p.sag, p.b, p.sbk, p.sbn, p.sbg, epi, w,
                               cnt, p.G, p.M, p.N, p.K, s);
  if (design == WGMMA_SWAPAB)
    return launch_swapab<false>(bk, p.a, p.sam, p.sak, p.sag, p.b, p.sbk, p.sbn, p.sbg, epi, w,
                                cnt, p.G, p.M, p.N, p.K, s);
#define K1_LARGE(AK, BKM)                                                                    \
  launch_large<AK, BKM, 1, GroupedRaster>(p.a, p.sam, p.sak, p.sag, p.b, p.sbk, p.sbn, p.sbg, \
                                          epi, p.G, p.M, p.N, p.K, s)
  return ak ? (bk ? K1_LARGE(true, true) : K1_LARGE(true, false))
            : (bk ? K1_LARGE(false, true) : K1_LARGE(false, false));
#undef K1_LARGE
}

// The design a call runs (the fixed rule): see the head of this file.
int design_of(const void* a, int a_dtype, long long sam, long long sak, long long sag,
              const void* b, int b_dtype, long long sbk, long long sbn, long long sbg, int G,
              int M, int N, int K, bool* ak, bool* bk) {
  return design_rule(a, a_dtype, sam, sak, sag, b, b_dtype, sbk, sbn, sbg, G, M, N, K, true, ak,
                     bk);
}

}  // namespace

// C (G, M, N) contiguous in c_dtype: for each group g,
// C[g] = act(A_g (M, K) @ B_g (K, N) + bias_g), A and B read through their
// strides (elements; A_g at a + g sag, B_g at b + g sbg), bias_g at
// bias + g sbias_g (N elements; sbias_g 0: one bias for every group; or
// null); dtype codes 0 = float32, 1 = bfloat16 for A, B, the bias and C;
// activation by its code (repro_torch.kernels.matmul.ACT_CODES).  G = 1
// is one product.  ws and counters: the split-K workspace (splits x G x
// M x N fp32, matmul_tiled_splits) and one int per group and 64-column
// tile, zero before the launch and zero after it; both may be null when
// the design does not split K.  The design comes from
// matmul_tiled_design; a failure to build a tensor map or to launch
// returns its cudaError, and nothing retries on another design.
extern "C" int matmul_tiled(const void* a, int a_dtype, long long sam, long long sak,
                            long long sag, const void* b, int b_dtype, long long sbk,
                            long long sbn, long long sbg, const void* bias, int bias_dtype,
                            long long sbias_g, void* c, int c_dtype, int G, int M, int N, int K,
                            int activation, void* ws, void* counters, void* stream) {
  if (G <= 0 || M <= 0 || N <= 0) return 0;
  if ((c_dtype != 0 && c_dtype != 1) || (bias != nullptr && bias_dtype != 0 && bias_dtype != 1) ||
      G > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  int* cnt = static_cast<int*>(counters);
  const Call p{a, sam, sak, sag, b, sbk, sbn, sbg, bias, bias_dtype, sbias_g, G, M, N, K};
  bool ak = true, bk = true;
  const int design =
      design_of(a, a_dtype, sam, sak, sag, b, b_dtype, sbk, sbn, sbg, G, M, N, K, &ak, &bk);
  int rc;
  if (design == CUDA_CORE) {
    rc = M <= 16 ? dispatch<16, 32, 128, 2, 1>(p, a_dtype, b_dtype, c, c_dtype, activation, s)
                 : dispatch<64, 64, 16, 4, 4>(p, a_dtype, b_dtype, c, c_dtype, activation, s);
    if (rc != 0) return (int)cudaErrorInvalidValue;
  } else if (c_dtype == 0) {
    const FusedEpilogue<float> epi{
        {static_cast<float*>(c), N, (long long)M * N}, bias, bias_dtype, activation, sbias_g};
    rc = launch_tensor_core(design, ak, bk, p, epi, w, cnt, s);
  } else {
    const FusedEpilogue<bf16> epi{
        {static_cast<bf16*>(c), N, (long long)M * N}, bias, bias_dtype, activation, sbias_g};
    rc = launch_tensor_core(design, ak, bk, p, epi, w, cnt, s);
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// The design matmul_tiled runs for these operands: 0 cuda-core, 1 wgmma,
// 2 wgmma-swapab, 3 wgmma-swapab-3xbf16.
extern "C" int matmul_tiled_design(const void* a, int a_dtype, long long sam, long long sak,
                                   long long sag, const void* b, int b_dtype, long long sbk,
                                   long long sbn, long long sbg, int G, int M, int N, int K) {
  bool ak, bk;
  return design_of(a, a_dtype, sam, sak, sag, b, b_dtype, sbk, sbn, sbg, G, M, N, K, &ak, &bk);
}

// The K split of the swapab designs at (N, K) over G groups: the
// workspace holds this many G x M x N fp32 partials when it exceeds 1.
extern "C" int matmul_tiled_splits(int N, int K, int G) { return splits_of(N, K, G); }
