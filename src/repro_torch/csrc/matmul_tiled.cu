// K1 — tiled (supertile) multicast matmul with a fused epilogue, for sm_90a.
//
// Replaces: src/repro/kernels/matmul/matmul.py : matmul_mcast_tiled
// (the Pallas TPU kernel behind every kernels.linear projection).
//
// Computes C = act(A @ B + bias) -> out dtype, with fp32 accumulation.
// bias (fp32), the activation and the downcast run fused in the
// epilogue, as in the TPU kernel's flush step.
//
// What bounds it on the H100: on the serving path M is tiny (4 decode
// rows, 16-64 prefill rows) against K, N of 1024-151936, so every call
// is bound by the bytes of B it streams (weights, the tied logits
// table), not by operations.  Design:
//   * CTA tile (BM, BN), K loop through shared memory, fp32 FMA on the
//     CUDA cores (exact for bf16 products; true fp32 for fp32 inputs —
//     no TF32 anywhere).
//   * Two tile shapes chosen by M: a 16-row tile with a deep K step for
//     decode (more CTAs along N, fewer wasted rows), a 64x64 tile for
//     prefill.
//   * CTAs are rastered in groups of GROUP_M row blocks ("supertiles"),
//     so a B tile fetched from HBM by the first row block of a group is
//     served from L2 to the others: the group-level multicast of the TPU
//     schedule, with L2 in the role of the shared VMEM panel.
//   * A and B are read through strides, and each may be stored as bf16
//     or fp32 independently of the fp32 compute: the tied logits read
//     the (vocab, d) bf16 embedding table as a transposed view and widen
//     it in registers, instead of materialising a 622 MB fp32 copy.
//   * Ragged M/N/K edges are masked on load and store; nothing is padded.
// Later work: wgmma + TMA, and split-K so the decode shapes fill all SMs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<bf16>(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16_rn(x); }

// activation codes: the order of repro_torch.kernels.matmul.matmul.ACT_CODES
__device__ __forceinline__ float apply_act(float x, int act) {
  switch (act) {
    case 1:  // relu
      return fmaxf(x, 0.f);
    case 2:  // gelu: the reference's default is the tanh approximation
    case 3: {  // gelu_tanh
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return x * (0.5f * (1.f + tanhf(c * (x + 0.044715f * (x * x * x)))));
    }
    case 4:  // silu
      return x * (1.f / (1.f + expf(-x)));
    case 5:  // sigmoid
      return 1.f / (1.f + expf(-x));
    default:
      return x;
  }
}

constexpr int GROUP_M = 8;

template <typename TA, typename TB, typename TO, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
matmul_tiled_kernel(const TA* __restrict__ A, long long sam, long long sak,
                    const TB* __restrict__ B, long long sbk, long long sbn,
                    const float* __restrict__ bias, TO* __restrict__ C,
                    int M, int N, int K, int act) {
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

  // fused epilogue: bias (fp32) + activation + downcast
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn >= N) continue;
      float v = acc[i][j];
      if (bias != nullptr) v += bias[gn];
      C[(long long)gm * N + gn] = from_f32<TO>(apply_act(v, act));
    }
  }
}

template <typename TA, typename TB, typename TO, int BM, int BN, int BK, int TM, int TN>
void launch(const void* a, long long sam, long long sak, const void* b, long long sbk,
            long long sbn, const void* bias, void* c, int M, int N, int K, int act,
            cudaStream_t stream) {
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  matmul_tiled_kernel<TA, TB, TO, BM, BN, BK, TM, TN>
      <<<tiles, (BM / TM) * (BN / TN), 0, stream>>>(
          static_cast<const TA*>(a), sam, sak, static_cast<const TB*>(b), sbk, sbn,
          static_cast<const float*>(bias), static_cast<TO*>(c), M, N, K, act);
}

template <int BM, int BN, int BK, int TM, int TN>
int dispatch(const void* a, int a_dt, long long sam, long long sak, const void* b,
             int b_dt, long long sbk, long long sbn, const void* bias, void* c,
             int c_dt, int M, int N, int K, int act, cudaStream_t s) {
  // dtype codes: 0 = float32, 1 = bfloat16
#define K1_CASE(A_, B_, C_, TA, TB, TO)                                              \
  if (a_dt == A_ && b_dt == B_ && c_dt == C_) {                                      \
    launch<TA, TB, TO, BM, BN, BK, TM, TN>(a, sam, sak, b, sbk, sbn, bias, c, M, N, \
                                           K, act, s);                               \
    return 0;                                                                        \
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

}  // namespace

extern "C" int matmul_tiled(const void* a, int a_dtype, long long sam, long long sak,
                            const void* b, int b_dtype, long long sbk, long long sbn,
                            const void* bias, void* c, int c_dtype, int M, int N, int K,
                            int activation, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (M <= 16)
    rc = dispatch<16, 32, 128, 2, 1>(a, a_dtype, sam, sak, b, b_dtype, sbk, sbn, bias, c,
                                     c_dtype, M, N, K, activation, s);
  else
    rc = dispatch<64, 64, 16, 4, 4>(a, a_dtype, sam, sak, b, b_dtype, sbk, sbn, bias, c,
                                    c_dtype, M, N, K, activation, s);
  if (rc != 0) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
