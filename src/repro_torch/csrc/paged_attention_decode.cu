// K2 — paged-attention decode (one query token per sequence), for sm_90a.
//
// Replaces: src/repro/kernels/paged_attention/paged_attention.py :
// paged_attention_decode (the Pallas TPU kernel of every decode step).
//
// Computes, for each sequence b and query head, softmax(q k^T * scale)
// v over the key positions kpos < lengths[b] and kpos <= start[b], with
// K/V gathered page by page through block_table[b, :]: an fp32 online
// softmax (NEG_INF = -2^30 for masked keys, probabilities cast to the V
// dtype before the PV product, the denominator clamped at 1e-30), an
// optional logit softcap, and GQA (group = n_heads / kv_heads rows per
// kv head).
//
// What bounds it on the H100: bytes.  Each (sequence, kv head) reads its
// K/V pages once (2 * length * head_dim elements) and does ~4 flops per
// element, far below the card's flop/byte balance; at decode sizes the
// real limit is latency, since one page is 16 x 64 elements.  Design:
//   * one CTA per (kv head, sequence); the CTA reads its block-table row
//     and walks only the pages below ceil(lengths[b] / page_size) — the
//     TPU grid's skipped steps become a shorter loop;
//   * the CTA's four warps take interleaved pages, so four page fetches
//     are in flight at once; each warp keeps its own (m, l, acc) state in
//     registers (a lane holds head_dim / 32 columns) and the four states
//     are merged once at the end, through shared memory;
//   * K and V rows are read straight from HBM into registers, coalesced
//     along head_dim; no shared-memory staging is needed for one query
//     row per kv head.
// Later work: split long sequences over several CTAs, vector loads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float NEG_INF = -1073741824.0f;  // -2**30, the reference's mask value
constexpr int WARPS = 4;
constexpr int KC = 8;       // key rows loaded per batch of loads
constexpr int MAX_PS = 64;  // page_size limit (two score registers per lane)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
// p.astype(v.dtype): rounds to bf16 for bf16 pools, a no-op for fp32 pools
__device__ __forceinline__ float round_like(float x, const float*) { return x; }
__device__ __forceinline__ float round_like(float x, const bf16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16_rn(x); }

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

// NI: head_dim columns per lane (head_dim <= 32 * NI); GB: query rows (GQA
// group members) handled per pass over the pages
template <typename TQ, typename TKV, int NI, int GB>
__global__ void __launch_bounds__(WARPS * 32)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                    const TKV* __restrict__ vp, const int* __restrict__ table,
                    const int* __restrict__ start, const int* __restrict__ lengths,
                    TQ* __restrict__ out, int n_heads, int kv_heads, int num_pages,
                    int ps, int d, int width, float scale, float softcap) {
  __shared__ float sm_m[WARPS][GB];
  __shared__ float sm_l[WARPS][GB];
  __shared__ float sm_acc[WARPS][GB][NI * 32];

  const int hk = blockIdx.x, b = blockIdx.y;
  const int group = n_heads / kv_heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int length = lengths[b];
  const int qpos = start[b];
  const int n_pages = length > 0 ? min(width, (length + ps - 1) / ps) : 0;
  const int* row = table + (long long)b * width;

  for (int g0 = 0; g0 < group; g0 += GB) {
    const int rows = min(GB, group - g0);
    float qr[GB][NI], acc[GB][NI], m[GB], l[GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      m[g] = NEG_INF;
      l[g] = 0.f;
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int dd = lane + 32 * i;
        const long long qi = ((long long)b * n_heads + hk * group + g0 + g) * d + dd;
        qr[g][i] = (g < rows && dd < d) ? to_f32(q[qi]) : 0.f;
        acc[g][i] = 0.f;
      }
    }

    for (int p = warp; p < n_pages; p += WARPS) {
      const long long base = ((long long)hk * num_pages + row[p]) * ps * d;
      // scores of this page: lane j % 32 keeps key j's score in s[j / 32]
      float s[GB][2];
#pragma unroll
      for (int g = 0; g < GB; ++g) s[g][0] = s[g][1] = NEG_INF;
      for (int j0 = 0; j0 < ps; j0 += KC) {
        // issue KC key-row loads before reducing any of them
        float kr[KC][NI];
#pragma unroll
        for (int c = 0; c < KC; ++c)
#pragma unroll
          for (int i = 0; i < NI; ++i) {
            const int dd = lane + 32 * i;
            kr[c][i] = (j0 + c < ps && dd < d)
                           ? to_f32(kp[base + (long long)(j0 + c) * d + dd]) : 0.f;
          }
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          const int j = j0 + c;
          const int kpos = p * ps + j;
          const bool valid = j < ps && kpos < length && kpos <= qpos;
#pragma unroll
          for (int g = 0; g < GB; ++g) {
            float part = 0.f;
#pragma unroll
            for (int i = 0; i < NI; ++i) part = fmaf(qr[g][i], kr[c][i], part);
            float sc = warp_sum(part) * scale;
            if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
            sc = valid ? sc : NEG_INF;
            if (lane == (j & 31)) {
              if (j < 32) s[g][0] = sc; else s[g][1] = sc;
            }
          }
        }
      }
      // online-softmax update over the whole page, as the reference does
      float pr[GB][2], alpha[GB];
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        const float m_new = fmaxf(m[g], warp_max(fmaxf(s[g][0], s[g][1])));
        alpha[g] = expf(m[g] - m_new);
        pr[g][0] = lane < ps ? expf(s[g][0] - m_new) : 0.f;
        pr[g][1] = lane + 32 < ps ? expf(s[g][1] - m_new) : 0.f;
        l[g] = l[g] * alpha[g] + warp_sum(pr[g][0] + pr[g][1]);
        m[g] = m_new;
#pragma unroll
        for (int i = 0; i < NI; ++i) acc[g][i] *= alpha[g];
      }
      for (int j0 = 0; j0 < ps; j0 += KC) {
        float vr[KC][NI];
#pragma unroll
        for (int c = 0; c < KC; ++c)
#pragma unroll
          for (int i = 0; i < NI; ++i) {
            const int dd = lane + 32 * i;
            vr[c][i] = (j0 + c < ps && dd < d)
                           ? to_f32(vp[base + (long long)(j0 + c) * d + dd]) : 0.f;
          }
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          const int j = j0 + c;
#pragma unroll
          for (int g = 0; g < GB; ++g) {
            // lanes past the page hold p = 0, so a ragged chunk adds nothing
            const float pj = round_like(
                __shfl_sync(0xffffffffu, j < 32 ? pr[g][0] : pr[g][1], j & 31), vp);
#pragma unroll
            for (int i = 0; i < NI; ++i) acc[g][i] = fmaf(pj, vr[c][i], acc[g][i]);
          }
        }
      }
    }

    // merge the per-warp softmax states
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < GB; ++g) { sm_m[warp][g] = m[g]; sm_l[warp][g] = l[g]; }
    }
#pragma unroll
    for (int g = 0; g < GB; ++g)
#pragma unroll
      for (int i = 0; i < NI; ++i) sm_acc[warp][g][lane + 32 * i] = acc[g][i];
    __syncthreads();
    for (int t = threadIdx.x; t < rows * d; t += WARPS * 32) {
      const int g = t / d, dd = t % d;
      float mx = NEG_INF;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w][g]);
      float lsum = 0.f, asum = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float f = expf(sm_m[w][g] - mx);
        lsum += sm_l[w][g] * f;
        asum += sm_acc[w][g][dd] * f;
      }
      const long long oi = ((long long)b * n_heads + hk * group + g0 + g) * d + dd;
      store(out + oi, asum / fmaxf(lsum, 1e-30f));
    }
    __syncthreads();
  }
}

template <typename T, int NI, int GB>
void launch(const void* q, const void* kp, const void* vp, const int* table,
            const int* start, const int* lengths, void* out, int batch, int n_heads,
            int kv_heads, int num_pages, int ps, int d, int width, float scale,
            float softcap, cudaStream_t s) {
  paged_decode_kernel<T, T, NI, GB><<<dim3(kv_heads, batch), WARPS * 32, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      table, start, lengths, static_cast<T*>(out), n_heads, kv_heads, num_pages, ps, d,
      width, scale, softcap);
}

template <typename T, int NI>
void launch_ni(bool one_row, const void* q, const void* kp, const void* vp,
               const int* table, const int* start, const int* lengths, void* out,
               int batch, int n_heads, int kv_heads, int num_pages, int ps, int d,
               int width, float scale, float softcap, cudaStream_t s) {
  if (one_row)
    launch<T, NI, 1>(q, kp, vp, table, start, lengths, out, batch, n_heads, kv_heads,
                     num_pages, ps, d, width, scale, softcap, s);
  else
    launch<T, NI, 4>(q, kp, vp, table, start, lengths, out, batch, n_heads, kv_heads,
                     num_pages, ps, d, width, scale, softcap, s);
}

template <typename T>
void launch_typed(const void* q, const void* kp, const void* vp, const int* table,
                  const int* start, const int* lengths, void* out, int batch,
                  int n_heads, int kv_heads, int num_pages, int ps, int d, int width,
                  float scale, float softcap, cudaStream_t s) {
  const bool one_row = n_heads == kv_heads;
#define K2_ARGS one_row, q, kp, vp, table, start, lengths, out, batch, n_heads, kv_heads, \
                num_pages, ps, d, width, scale, softcap, s
  if (d <= 32) launch_ni<T, 1>(K2_ARGS);
  else if (d <= 64) launch_ni<T, 2>(K2_ARGS);
  else if (d <= 128) launch_ni<T, 4>(K2_ARGS);
  else launch_ni<T, 8>(K2_ARGS);
#undef K2_ARGS
}

}  // namespace

// dtype (of q, the pages and the output): 0 = float32, 1 = bfloat16.
// softcap <= 0 means none.
extern "C" int paged_attention_decode(const void* q, const void* k_pages,
                                      const void* v_pages, int dtype, const void* table,
                                      const void* start, const void* lengths, void* out,
                                      int batch, int n_heads, int kv_heads, int num_pages,
                                      int page_size, int head_dim, int width, float scale,
                                      float softcap, void* stream) {
  if (batch <= 0) return 0;
  if (page_size > MAX_PS || head_dim > 256 || n_heads % kv_heads != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(table);
  const int* st = static_cast<const int*>(start);
  const int* ln = static_cast<const int*>(lengths);
  if (dtype == 0)
    launch_typed<float>(q, k_pages, v_pages, tb, st, ln, out, batch, n_heads, kv_heads,
                        num_pages, page_size, head_dim, width, scale, softcap, s);
  else if (dtype == 1)
    launch_typed<bf16>(q, k_pages, v_pages, tb, st, ln, out, batch, n_heads, kv_heads,
                       num_pages, page_size, head_dim, width, scale, softcap, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
