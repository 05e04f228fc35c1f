// K6 — blockwise (flash) attention forward, for sm_90a.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py :
// flash_attention (_flash_body; the Pallas TPU kernel).
//
// O = softmax(mask(softcap(q k^T / sqrt(d)))) v per (batch, query head),
// GQA by index (query head i reads kv head i / (h / kvh), K/V are not
// repeated), with the optional fp32 row log-sum-exp the backward kernels
// rescale with.  The TPU kernel's arithmetic: fp32 scores of the
// storage-dtype operands, fp32 online softmax (m, l, acc), p rounded to
// the V dtype before the PV product while l sums the unrounded p,
// o = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30)).
//
// What bounds it on the H100: operations.  Every (q, k) pair costs two
// d-long products; bytes are q, k, v and o once.  Design of this first
// version (CUDA-core fp32 FMA, no wgmma/TMA yet):
//   * one CTA per (query tile of BQ = 64 rows, batch x query head); the
//     query tile stays in shared memory, and a sequential loop walks the
//     kv tiles (BK = 64 keys, 32 at d = 256) the tile's rows can see,
//     each K/V tile staged once in shared memory for all 64 rows;
//   * each thread holds a 4 x (BK / 16) block of scores and a
//     4 x (D / 16) block of the output accumulator in registers;
//   * tiles wholly outside the rows' causal / window range are skipped
//     (flash_common.cuh says why that is exact).
// Dynamic shared memory: (BQ + 2 BK)(D + 1) + BQ (BK + 1) floats — 41 KB
// at D = 32, 65 KB at 64, 113 KB at 128, 137 KB at 256.
// Later work: tensor-core products (wgmma) fed by TMA, bf16 tiles.
#include "flash_common.cuh"

namespace {

using namespace flash;

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int heads, int kv_heads, int d,
                 Masking mk) {
  constexpr int LD = D + 1, LP = BK + 1;
  constexpr int RM = BQ / 16, CN = BK / 16, DN = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;           // BQ x LD
  float* ks = qs + BQ * LD;   // BK x LD
  float* vs = ks + BK * LD;   // BK x LD
  float* ps = vs + BK * LD;   // BQ x LP: p rounded to the V dtype

  const int bh = blockIdx.y, b = bh / heads, hk = (bh % heads) / (heads / kv_heads);
  const int q0 = blockIdx.x * BQ, q_rows = min(BQ, mk.sq - q0);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* kb = k + ((long long)b * kv_heads + hk) * mk.sk * d;
  const T* vb = v + ((long long)b * kv_heads + hk) * mk.sk * d;

  load_tile<T, D>(qs, q + ((long long)bh * mk.sq + q0) * d, BQ, q_rows, d);
  int lo, hi;
  mk.key_range(q0, q0 + q_rows - 1, lo, hi);

  float m[RM], l[RM], acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DN; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = lo / BK * BK; k0 < hi; k0 += BK) {
    const int k_rows = min(BK, mk.sk - k0);
    __syncthreads();  // the previous K/V/P tiles are no longer read
    load_tile<T, D>(ks, kb + (long long)k0 * d, BK, k_rows, d);
    load_tile<T, D>(vs, vb + (long long)k0 * d, BK, k_rows, d);
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < D; ++dd) {
      float qv[RM], kv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) qv[i] = qs[(ty + 16 * i) * LD + dd];
#pragma unroll
      for (int j = 0; j < CN; ++j) kv[j] = ks[(tx + 16 * j) * LD + dd];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty + 16 * i;
      float mx = -INFINITY, th;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        s[i][j] = mk.score(s[i][j], q0 + r, k0 + tx + 16 * j, &th);
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        ps[r * LP + tx + 16 * j] = round_to(p, v);
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DN; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float vv[DN];
#pragma unroll
      for (int c = 0; c < DN; ++c) vv[c] = vs[j * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float p = ps[(ty + 16 * i) * LP + j];
#pragma unroll
        for (int c = 0; c < DN; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty + 16 * i;
    if (r >= q_rows) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    const long long row = (long long)bh * mk.sq + q0 + r;
#pragma unroll
    for (int c = 0; c < DN; ++c) {
      const int col = tx + 16 * c;
      if (col < d) store(o + row * d + col, acc[i][c] / denom);
    }
    if (lse != nullptr && tx == 0) lse[row] = m[i] + logf(denom);
  }
}

template <typename T, int D, int BQ, int BK>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int batch,
           int heads, int kv_heads, int d, Masking mk, cudaStream_t stream) {
  constexpr int LD = D + 1;
  const size_t smem = ((size_t)(BQ + 2 * BK) * LD + (size_t)BQ * (BK + 1)) * sizeof(float);
  const int rc = allow_smem(flash_fwd_kernel<T, D, BQ, BK>, smem);
  if (rc != 0) return rc;
  dim3 grid((mk.sq + BQ - 1) / BQ, batch * heads);
  flash_fwd_kernel<T, D, BQ, BK><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, heads, kv_heads, d, mk);
  return 0;
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, void* o, float* lse, int batch,
                 int heads, int kv_heads, int d, Masking mk, cudaStream_t s) {
  if (d <= 32) return launch<T, 32, 64, 64>(q, k, v, o, lse, batch, heads, kv_heads, d, mk, s);
  if (d <= 64) return launch<T, 64, 64, 64>(q, k, v, o, lse, batch, heads, kv_heads, d, mk, s);
  if (d <= 128)
    return launch<T, 128, 64, 64>(q, k, v, o, lse, batch, heads, kv_heads, d, mk, s);
  return launch<T, 256, 64, 32>(q, k, v, o, lse, batch, heads, kv_heads, d, mk, s);
}

}  // namespace

// q (batch, heads, sq, d), k/v (batch, kv_heads, sk, d), o like q, all
// contiguous, of one dtype: 0 = float32, 1 = bfloat16.  lse (batch,
// heads, sq) fp32, or null.  softcap <= 0 and window <= 0 mean none.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, int dtype,
                                   void* o, void* lse, int batch, int heads, int kv_heads,
                                   int sq, int sk, int d, float scale, float softcap,
                                   int causal, int window, void* stream) {
  if (batch <= 0 || heads <= 0 || sq <= 0) return 0;
  int rc = check_args(batch, heads, kv_heads, sk, d);
  if (rc != 0) return rc;
  const Masking mk{sq, sk, scale, softcap, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0) rc = launch_typed<float>(q, k, v, o, l, batch, heads, kv_heads, d, mk, s);
  else if (dtype == 1) rc = launch_typed<bf16>(q, k, v, o, l, batch, heads, kv_heads, d, mk, s);
  else return (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
