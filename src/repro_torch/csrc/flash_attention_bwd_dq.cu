// K7 — flash attention backward, dQ, for sm_90a.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py :
// flash_attention_bwd_dq (_flash_bwd_dq_body with _bwd_scores; the
// Pallas TPU kernel).
//
// dQ by recompute, never materialising the (sq, sk) probabilities: per
// kv tile, on fp32 upcasts of q, k, v and dO,
//   s  = softcap(q k^T * scale), masked;  p = exp(s - lse)
//   dp = dO v^T;  ds = p (dp - delta) [(1 - tanh^2) under softcap] scale
//   dq += ds k
// with delta = rowsum(dO * O) computed by the caller.  dQ is rounded to
// q's dtype once, at the end.
//
// What bounds it on the H100: operations, three d-long products per
// visible (q, k) pair.  Design (CUDA-core fp32 FMA, as K6):
//   * one CTA per (query tile, batch x query head), q and dO tiles in
//     shared memory, a sequential loop over the kv tiles the rows can
//     see (the same exact skip as K6), K and V staged once per tile;
//   * each thread computes a block of s and dp together in one pass over
//     d, turns them into ds in registers, and after one barrier adds
//     ds k into its 4 x (D / 16) (2 x 16 at d = 256) dQ accumulators.
// Tiles: BQ = BK = 64 up to D = 128, 32 at D = 256.  Dynamic shared
// memory: (2 BQ + 2 BK)(D + 1) + BQ (BK + 1) floats — 49 KB at D = 32,
// 81 KB at 64, 145 KB at 128, 133 KB at 256.
// Later work: tensor cores (wgmma), TMA, one fused dQ/dK/dV pass.
#include "flash_common.cuh"

namespace {

using namespace flash;

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int heads,
                    int kv_heads, int d, Masking mk) {
  constexpr int LD = D + 1, LP = BK + 1;
  constexpr int RM = BQ / 16, CN = BK / 16, DN = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;            // BQ x LD
  float* dos = qs + BQ * LD;   // BQ x LD
  float* ks = dos + BQ * LD;   // BK x LD
  float* vs = ks + BK * LD;    // BK x LD
  float* dss = vs + BK * LD;   // BQ x LP

  const int bh = blockIdx.y, b = bh / heads, hk = (bh % heads) / (heads / kv_heads);
  const int q0 = blockIdx.x * BQ, q_rows = min(BQ, mk.sq - q0);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long row0 = (long long)bh * mk.sq + q0;
  const T* kb = k + ((long long)b * kv_heads + hk) * mk.sk * d;
  const T* vb = v + ((long long)b * kv_heads + hk) * mk.sk * d;

  load_tile<T, D>(qs, q + row0 * d, BQ, q_rows, d);
  load_tile<T, D>(dos, dout + row0 * d, BQ, q_rows, d);
  float lse_r[RM], delta_r[RM], acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty + 16 * i;
    lse_r[i] = r < q_rows ? lse[row0 + r] : 0.f;
    delta_r[i] = r < q_rows ? delta[row0 + r] : 0.f;
#pragma unroll
    for (int c = 0; c < DN; ++c) acc[i][c] = 0.f;
  }
  int lo, hi;
  mk.key_range(q0, q0 + q_rows - 1, lo, hi);

  for (int k0 = lo / BK * BK; k0 < hi; k0 += BK) {
    const int k_rows = min(BK, mk.sk - k0);
    __syncthreads();  // the previous K/V/dS tiles are no longer read
    load_tile<T, D>(ks, kb + (long long)k0 * d, BK, k_rows, d);
    load_tile<T, D>(vs, vb + (long long)k0 * d, BK, k_rows, d);
    __syncthreads();

    float s[RM][CN], dp[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < D; ++dd) {
      float qv[RM], dov[RM], kv[CN], vv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        qv[i] = qs[(ty + 16 * i) * LD + dd];
        dov[i] = dos[(ty + 16 * i) * LD + dd];
      }
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        kv[j] = ks[(tx + 16 * j) * LD + dd];
        vv[j] = vs[(tx + 16 * j) * LD + dd];
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        float th;
        const float sc = mk.score(s[i][j], q0 + r, k0 + tx + 16 * j, &th);
        float ds = expf(sc - lse_r[i]) * (dp[i][j] - delta_r[i]);
        if (mk.softcap > 0.f) ds *= 1.f - th * th;
        dss[r * LP + tx + 16 * j] = ds * mk.scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float kv[DN];
#pragma unroll
      for (int c = 0; c < DN; ++c) kv[c] = ks[j * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float ds = dss[(ty + 16 * i) * LP + j];
#pragma unroll
        for (int c = 0; c < DN; ++c) acc[i][c] = fmaf(ds, kv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty + 16 * i;
    if (r >= q_rows) continue;
#pragma unroll
    for (int c = 0; c < DN; ++c) {
      const int col = tx + 16 * c;
      if (col < d) store(dq + (row0 + r) * d + col, acc[i][c]);
    }
  }
}

template <typename T, int D, int BQ, int BK>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, void* dq, int batch, int heads, int kv_heads, int d,
           Masking mk, cudaStream_t stream) {
  constexpr int LD = D + 1;
  const size_t smem =
      ((size_t)(2 * BQ + 2 * BK) * LD + (size_t)BQ * (BK + 1)) * sizeof(float);
  const int rc = allow_smem(flash_bwd_dq_kernel<T, D, BQ, BK>, smem);
  if (rc != 0) return rc;
  dim3 grid((mk.sq + BQ - 1) / BQ, batch * heads);
  flash_bwd_dq_kernel<T, D, BQ, BK><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), heads, kv_heads, d, mk);
  return 0;
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, const void* dout,
                 const float* lse, const float* delta, void* dq, int batch, int heads,
                 int kv_heads, int d, Masking mk, cudaStream_t s) {
#define K7_ARGS q, k, v, dout, lse, delta, dq, batch, heads, kv_heads, d, mk, s
  if (d <= 32) return launch<T, 32, 64, 64>(K7_ARGS);
  if (d <= 64) return launch<T, 64, 64, 64>(K7_ARGS);
  if (d <= 128) return launch<T, 128, 64, 64>(K7_ARGS);
  return launch<T, 256, 32, 32>(K7_ARGS);
#undef K7_ARGS
}

}  // namespace

// q/dout/dq (batch, heads, sq, d), k/v (batch, kv_heads, sk, d), all
// contiguous, of one dtype: 0 = float32, 1 = bfloat16.  lse and delta
// (batch, heads, sq) fp32.  softcap <= 0 and window <= 0 mean none.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      int dtype, void* dq, int batch, int heads, int kv_heads,
                                      int sq, int sk, int d, float scale, float softcap,
                                      int causal, int window, void* stream) {
  if (batch <= 0 || heads <= 0 || sq <= 0) return 0;
  int rc = check_args(batch, heads, kv_heads, sk, d);
  if (rc != 0) return rc;
  const Masking mk{sq, sk, scale, softcap, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 0)
    rc = launch_typed<float>(q, k, v, dout, l, dl, dq, batch, heads, kv_heads, d, mk, s);
  else if (dtype == 1)
    rc = launch_typed<bf16>(q, k, v, dout, l, dl, dq, batch, heads, kv_heads, d, mk, s);
  else
    return (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
