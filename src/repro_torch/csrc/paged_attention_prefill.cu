// K3 — paged-attention chunked prefill ("supertile"), for sm_90a.
//
// Replaces: src/repro/kernels/paged_attention/paged_attention.py :
// paged_attention_prefill (the Pallas TPU kernel of prefix-hit suffix
// prefills and chunked prefill).
//
// Computes s >= 1 query tokens per sequence at their true positions
// start[b] + t, causal against those positions and masked by
// lengths[b], against K/V pages gathered through block_table[b, :]:
// fp32 online softmax per page (NEG_INF = -2^30, p cast to the V dtype
// before PV, l clamped at 1e-30), optional softcap, GQA.  int8 pools
// are dequantised on gather exactly as the reference does: int8 * scale
// in fp32, rounded to bf16, before both contractions.  Query rows past
// the true suffix length (bucket padding) still produce finite rows.
//
// What bounds it on the H100: bytes of K/V, as for decode, but here one
// K/V page serves qc * group query rows, so the work per byte grows with
// the chunk.  Design:
//   * one CTA per (kv head, query chunk, sequence); qc * group <= 32
//     rows per chunk, spread over the CTA's 8 warps (up to 4 rows each,
//     q and the (m, l, acc) state in registers, head_dim / 32 columns
//     per lane);
//   * each page is fetched from HBM ONCE per CTA into shared memory
//     (dequantised there for int8 pools) and read by every row of the
//     chunk: the TPU kernel's supertile reuse of one page DMA;
//   * the page loop stops at the lesser of the length bound and the
//     causal bound of the chunk's last real row.
// Later work: tensor-core QK^T / PV, double-buffered page loads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float NEG_INF = -1073741824.0f;  // -2**30, the reference's mask value
constexpr int WARPS = 8;
constexpr int RPW = 4;      // query rows per warp
constexpr int MAX_PS = 64;  // page_size limit (two score registers per lane)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16_rn(x); }

// page element -> the value the contractions see (dequant for int8)
__device__ __forceinline__ float load_kv(const float* p, long long i, const bf16*,
                                         long long) {
  return p[i];
}
__device__ __forceinline__ float load_kv(const bf16* p, long long i, const bf16*,
                                         long long) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float load_kv(const int8_t* p, long long i, const bf16* scale,
                                         long long slot) {
  return bf16_round(static_cast<float>(p[i]) * __bfloat162float(scale[slot]));
}
// p.astype(v.dtype): fp32 pools keep p, bf16 and dequantised int8 round it
__device__ __forceinline__ float round_p(float x, const float*) { return x; }
__device__ __forceinline__ float round_p(float x, const bf16*) { return bf16_round(x); }
__device__ __forceinline__ float round_p(float x, const int8_t*) { return bf16_round(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <typename TQ, typename TKV, int NI>
__global__ void __launch_bounds__(WARPS * 32)
paged_prefill_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                     const TKV* __restrict__ vp, const bf16* __restrict__ k_scale,
                     const bf16* __restrict__ v_scale, const int* __restrict__ table,
                     const int* __restrict__ start, const int* __restrict__ lengths,
                     TQ* __restrict__ out, int s_len, int qc, int n_heads, int kv_heads,
                     int num_pages, int ps, int d, int width, float scale, float softcap) {
  extern __shared__ float smem[];
  float* ksh = smem;           // (ps, d) dequantised K page
  float* vsh = smem + ps * d;  // (ps, d) dequantised V page

  const int hk = blockIdx.x, chunk = blockIdx.y, b = blockIdx.z;
  const int group = n_heads / kv_heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int length = lengths[b];
  const int q0 = start[b] + chunk * qc;  // absolute position of the chunk's token 0
  const int t_end = min(s_len, (chunk + 1) * qc);  // one past the chunk's last real token
  const int last_pos = start[b] + t_end - 1;
  int n_pages = length > 0 ? min(width, (length + ps - 1) / ps) : 0;
  n_pages = min(n_pages, last_pos / ps + 1);  // causal bound of the chunk
  const int* row_tbl = table + (long long)b * width;
  const int rows = (t_end - chunk * qc) * group;

  float qr[RPW][NI], acc[RPW][NI], m[RPW], l[RPW];
  int qpos[RPW];
#pragma unroll
  for (int k = 0; k < RPW; ++k) {
    const int r = warp + WARPS * k;  // row r = token (r / group), head (r % group)
    const int t = chunk * qc + r / group;
    const int h = hk * group + r % group;
    qpos[k] = q0 + r / group;
    m[k] = NEG_INF;
    l[k] = 0.f;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int dd = lane + 32 * i;
      qr[k][i] = (r < rows && dd < d)
                     ? to_f32(q[(((long long)b * s_len + t) * n_heads + h) * d + dd]) : 0.f;
      acc[k][i] = 0.f;
    }
  }

  for (int p = 0; p < n_pages; ++p) {
    const long long slot0 = ((long long)hk * num_pages + row_tbl[p]) * ps;
    __syncthreads();  // the previous page is no longer read
    for (int e = threadIdx.x; e < ps * d; e += WARPS * 32) {
      const int j = e / d;
      ksh[e] = load_kv(kp, slot0 * d + e, k_scale, slot0 + j);
      vsh[e] = load_kv(vp, slot0 * d + e, v_scale, slot0 + j);
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < RPW; ++k) {
      if (warp + WARPS * k >= rows) continue;  // warp-uniform
      float s0 = NEG_INF, s1 = NEG_INF;  // lane j % 32 keeps key j's score
      for (int j = 0; j < ps; ++j) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const int dd = lane + 32 * i;
          if (dd < d) part = fmaf(qr[k][i], ksh[j * d + dd], part);
        }
        float sc = warp_sum(part) * scale;
        if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
        const int kpos = p * ps + j;
        sc = (kpos < length && kpos <= qpos[k]) ? sc : NEG_INF;
        if (lane == (j & 31)) {
          if (j < 32) s0 = sc; else s1 = sc;
        }
      }
      const float m_new = fmaxf(m[k], warp_max(fmaxf(s0, s1)));
      const float alpha = expf(m[k] - m_new);
      const float p0 = lane < ps ? expf(s0 - m_new) : 0.f;
      const float p1 = lane + 32 < ps ? expf(s1 - m_new) : 0.f;
      l[k] = l[k] * alpha + warp_sum(p0 + p1);
      m[k] = m_new;
#pragma unroll
      for (int i = 0; i < NI; ++i) acc[k][i] *= alpha;
      for (int j = 0; j < ps; ++j) {
        const float pj = round_p(__shfl_sync(0xffffffffu, j < 32 ? p0 : p1, j & 31), kp);
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const int dd = lane + 32 * i;
          if (dd < d) acc[k][i] = fmaf(pj, vsh[j * d + dd], acc[k][i]);
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < RPW; ++k) {
    const int r = warp + WARPS * k;
    if (r >= rows) continue;
    const int t = chunk * qc + r / group;
    const int h = hk * group + r % group;
    const float denom = fmaxf(l[k], 1e-30f);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int dd = lane + 32 * i;
      if (dd < d)
        store(out + (((long long)b * s_len + t) * n_heads + h) * d + dd, acc[k][i] / denom);
    }
  }
}

template <typename TQ, typename TKV, int NI>
int launch(const void* q, const void* kp, const void* vp, const void* ks, const void* vs,
           const int* table, const int* start, const int* lengths, void* out, int batch,
           int s_len, int qc, int n_heads, int kv_heads, int num_pages, int ps, int d,
           int width, float scale, float softcap, cudaStream_t s) {
  const size_t smem = 2 * (size_t)ps * d * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(paged_prefill_kernel<TQ, TKV, NI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(kv_heads, (s_len + qc - 1) / qc, batch);
  paged_prefill_kernel<TQ, TKV, NI><<<grid, WARPS * 32, smem, s>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kp), static_cast<const TKV*>(vp),
      static_cast<const bf16*>(ks), static_cast<const bf16*>(vs), table, start, lengths,
      static_cast<TQ*>(out), s_len, qc, n_heads, kv_heads, num_pages, ps, d, width, scale,
      softcap);
  return 0;
}

template <typename TQ, typename TKV>
int launch_typed(const void* q, const void* kp, const void* vp, const void* ks,
                 const void* vs, const int* table, const int* start, const int* lengths,
                 void* out, int batch, int s_len, int qc, int n_heads, int kv_heads,
                 int num_pages, int ps, int d, int width, float scale, float softcap,
                 cudaStream_t s) {
#define K3_ARGS q, kp, vp, ks, vs, table, start, lengths, out, batch, s_len, qc, n_heads, \
                kv_heads, num_pages, ps, d, width, scale, softcap, s
  if (d <= 32) return launch<TQ, TKV, 1>(K3_ARGS);
  if (d <= 64) return launch<TQ, TKV, 2>(K3_ARGS);
  if (d <= 128) return launch<TQ, TKV, 4>(K3_ARGS);
  return launch<TQ, TKV, 8>(K3_ARGS);
#undef K3_ARGS
}

}  // namespace

// dtype codes: q and out 0 = float32, 1 = bfloat16; pages 0 = float32,
// 1 = bfloat16, 2 = int8 (then q is bfloat16 and k_scale / v_scale are
// bfloat16 (kv_heads, num_pages, page_size, 1); else they are null).
// softcap <= 0 means none.  qc * (n_heads / kv_heads) must be <= 32.
extern "C" int paged_attention_prefill(const void* q, int q_dtype, const void* k_pages,
                                       const void* v_pages, int kv_dtype, const void* k_scale,
                                       const void* v_scale, const void* table,
                                       const void* start, const void* lengths, void* out,
                                       int batch, int s_len, int qc, int n_heads,
                                       int kv_heads, int num_pages, int page_size,
                                       int head_dim, int width, float scale, float softcap,
                                       void* stream) {
  if (batch <= 0 || s_len <= 0) return 0;
  if (page_size > MAX_PS || head_dim > 256 || n_heads % kv_heads != 0 || qc < 1 ||
      qc * (n_heads / kv_heads) > WARPS * RPW)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(table);
  const int* st = static_cast<const int*>(start);
  const int* ln = static_cast<const int*>(lengths);
  int rc;
#define K3_CALL(TQ, TKV)                                                                \
  launch_typed<TQ, TKV>(q, k_pages, v_pages, k_scale, v_scale, tb, st, ln, out, batch, \
                        s_len, qc, n_heads, kv_heads, num_pages, page_size, head_dim,  \
                        width, scale, softcap, s)
  if (q_dtype == 0 && kv_dtype == 0) rc = K3_CALL(float, float);
  else if (q_dtype == 1 && kv_dtype == 1) rc = K3_CALL(bf16, bf16);
  else if (q_dtype == 1 && kv_dtype == 2) rc = K3_CALL(bf16, int8_t);
  else return (int)cudaErrorInvalidValue;
#undef K3_CALL
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
