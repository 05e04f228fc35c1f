// K8 — flash attention backward, dK and dV per query head, for sm_90a.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py :
// flash_attention_bwd_dkv (_flash_bwd_dkv_body with _bwd_scores; the
// Pallas TPU kernel).
//
// For one kv tile of one query head, walking the query tiles in order,
// on fp32 upcasts of q, k, v and dO (p and ds as in K7):
//   dv += p^T dO;   dk += ds^T q
// Both come out per QUERY head, (batch, heads, sk, d), each rounded once
// to the input dtype; under GQA the caller sums each group of heads onto
// its kv head afterwards, as the JAX package does.  A group sum fused in
// here would round once instead of twice and drift from the reference.
//
// What bounds it on the H100: operations, four d-long products per
// visible (q, k) pair.  Design (CUDA-core fp32 FMA, as K6 and K7):
//   * one CTA per (kv tile, batch x query head); the K and V tiles stay
//     in shared memory, the q / dO tiles and their lse / delta rows are
//     staged once per step of the sequential query loop;
//   * the loop covers the query rows that can see the tile's keys, plus
//     the rows that see no key at all (a window past the keys' end):
//     those weigh every key by 1, as in the reference;
//   * each thread computes a block of p and ds, both go to shared memory,
//     and after one barrier it adds p^T dO and ds^T q into its key rows'
//     dV and dK accumulators.
// Tiles: BQ = BK = 64 up to D = 128, 32 at D = 256.  Dynamic shared
// memory: (2 BK + 2 BQ)(D + 1) + 2 BQ (BK + 1) + 2 BQ floats — 66 KB at
// D = 32, 98 KB at 64, 162 KB at 128, 137 KB at 256.
// Later work: tensor cores (wgmma), TMA, one fused dQ/dK/dV pass.
#include "flash_common.cuh"

namespace {

using namespace flash;

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int heads, int kv_heads, int d,
                     Masking mk) {
  constexpr int LD = D + 1, LP = BK + 1;
  constexpr int RM = BQ / 16, CN = BK / 16, RK = BK / 16, DN = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;              // BK x LD
  float* vs = ks + BK * LD;      // BK x LD
  float* qs = vs + BK * LD;      // BQ x LD
  float* dos = qs + BQ * LD;     // BQ x LD
  float* ps = dos + BQ * LD;     // BQ x LP
  float* dss = ps + BQ * LP;     // BQ x LP
  float* lse_s = dss + BQ * LP;  // BQ
  float* delta_s = lse_s + BQ;   // BQ

  const int bh = blockIdx.y, b = bh / heads, hk = (bh % heads) / (heads / kv_heads);
  const int k0 = blockIdx.x * BK, k_rows = min(BK, mk.sk - k0);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long kv_row0 = ((long long)b * kv_heads + hk) * mk.sk + k0;

  load_tile<T, D>(ks, k + kv_row0 * d, BK, k_rows, d);
  load_tile<T, D>(vs, v + kv_row0 * d, BK, k_rows, d);
  float dk_acc[RK][DN], dv_acc[RK][DN];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int c = 0; c < DN; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
  int lo, hi;
  mk.query_range(k0, k0 + k_rows - 1, lo, hi);

  for (int q0 = lo / BQ * BQ; q0 < hi; q0 += BQ) {
    const int q_rows = min(BQ, mk.sq - q0);
    const long long row0 = (long long)bh * mk.sq + q0;
    __syncthreads();  // the previous q/dO/P/dS tiles are no longer read
    load_tile<T, D>(qs, q + row0 * d, BQ, q_rows, d);
    load_tile<T, D>(dos, dout + row0 * d, BQ, q_rows, d);
    for (int r = threadIdx.x; r < BQ; r += THREADS) {
      lse_s[r] = r < q_rows ? lse[row0 + r] : 0.f;
      delta_s[r] = r < q_rows ? delta[row0 + r] : 0.f;
    }
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
        const int c = tx + 16 * j;
        float p = 0.f, ds = 0.f, th;
        if (r < q_rows) {  // rows past the ragged edge add nothing
          const float sc = mk.score(s[i][j], q0 + r, k0 + c, &th);
          p = expf(sc - lse_s[r]);
          ds = p * (dp[i][j] - delta_s[r]);
          if (mk.softcap > 0.f) ds *= 1.f - th * th;
          ds *= mk.scale;
        }
        ps[r * LP + c] = p;
        dss[r * LP + c] = ds;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < BQ; ++r) {
      float qv[DN], dov[DN];
#pragma unroll
      for (int c = 0; c < DN; ++c) {
        qv[c] = qs[r * LD + tx + 16 * c];
        dov[c] = dos[r * LD + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        const float p = ps[r * LP + ty + 16 * i];
        const float ds = dss[r * LP + ty + 16 * i];
#pragma unroll
        for (int c = 0; c < DN; ++c) {
          dv_acc[i][c] = fmaf(p, dov[c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(ds, qv[c], dk_acc[i][c]);
        }
      }
    }
  }

  const long long out_row0 = (long long)bh * mk.sk + k0;
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int kr = ty + 16 * i;
    if (kr >= k_rows) continue;
#pragma unroll
    for (int c = 0; c < DN; ++c) {
      const int col = tx + 16 * c;
      if (col < d) {
        store(dk + (out_row0 + kr) * d + col, dk_acc[i][c]);
        store(dv + (out_row0 + kr) * d + col, dv_acc[i][c]);
      }
    }
  }
}

template <typename T, int D, int BQ, int BK>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, void* dk, void* dv, int batch, int heads, int kv_heads, int d,
           Masking mk, cudaStream_t stream) {
  constexpr int LD = D + 1;
  const size_t smem = ((size_t)(2 * BK + 2 * BQ) * LD + 2 * (size_t)BQ * (BK + 1) + 2 * BQ) *
                      sizeof(float);
  const int rc = allow_smem(flash_bwd_dkv_kernel<T, D, BQ, BK>, smem);
  if (rc != 0) return rc;
  dim3 grid((mk.sk + BK - 1) / BK, batch * heads);
  flash_bwd_dkv_kernel<T, D, BQ, BK><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      heads, kv_heads, d, mk);
  return 0;
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, const void* dout,
                 const float* lse, const float* delta, void* dk, void* dv, int batch,
                 int heads, int kv_heads, int d, Masking mk, cudaStream_t s) {
#define K8_ARGS q, k, v, dout, lse, delta, dk, dv, batch, heads, kv_heads, d, mk, s
  if (d <= 32) return launch<T, 32, 64, 64>(K8_ARGS);
  if (d <= 64) return launch<T, 64, 64, 64>(K8_ARGS);
  if (d <= 128) return launch<T, 128, 64, 64>(K8_ARGS);
  return launch<T, 256, 32, 32>(K8_ARGS);
#undef K8_ARGS
}

}  // namespace

// q/dout (batch, heads, sq, d), k/v (batch, kv_heads, sk, d), dk/dv
// (batch, heads, sk, d), all contiguous, of one dtype: 0 = float32,
// 1 = bfloat16.  lse and delta (batch, heads, sq) fp32.  softcap <= 0 and
// window <= 0 mean none.  With sq = 0 dk and dv are zero.
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       int dtype, void* dk, void* dv, int batch, int heads,
                                       int kv_heads, int sq, int sk, int d, float scale,
                                       float softcap, int causal, int window, void* stream) {
  if (batch <= 0 || heads <= 0) return 0;
  int rc = check_args(batch, heads, kv_heads, sk, d);
  if (rc != 0) return rc;
  const Masking mk{sq, sk, scale, softcap, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 0)
    rc = launch_typed<float>(q, k, v, dout, l, dl, dk, dv, batch, heads, kv_heads, d, mk, s);
  else if (dtype == 1)
    rc = launch_typed<bf16>(q, k, v, dout, l, dl, dk, dv, batch, heads, kv_heads, d, mk, s);
  else
    return (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
