// K2 — paged-attention decode (one query token per sequence), for sm_90a.
//
// Replaces: src/repro/kernels/paged_attention/paged_attention.py :
// paged_attention_decode (_paged_body; the Pallas TPU kernel of every
// decode step).
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
// live K/V pages once (2 * length * head_dim elements) and does ~4 flops
// per element, far below the card's flop/byte balance.  At serving
// contexts (a few pages) the limit is latency; at long contexts HBM.
// Two designs, chosen by a fixed rule in the C entry (use_split_kv):
//
// split-kv (bf16 pools, head_dim 64 or 128, page_size * head_dim / 256 in
// {2, 4, 8}, 16-byte aligned q and pools):
//   * the grid is (kv head, sequence, split): each (kv head, sequence)'s
//     table row is cut into `splits` contiguous runs of pages, the count
//     chosen from batch x kv_heads and the table width alone
//     (decode_splits), so that the grid fills the card whatever the batch
//     while the rule needs nothing the device holds (lengths stay there);
//   * a CTA's four warps take the run's pages in turn (warp w pages w,
//     w + 4, ..., so the four fetch neighbouring pages at once) and walk
//     them through a ring of their own (up to 4 stages): lane 0 copies
//     each K and V page into shared memory with one 1-D cp.async.bulk at
//     the address the block table gives, completing on the stage's
//     mbarrier, `stages` pages ahead of the math.  A (kv head, page) is
//     one contiguous page_size x head_dim block, so the copy needs no
//     tensor map: the host encodes nothing per call (the decode step is
//     host-bound), and the lanes read the rows unswizzled;
//   * scores: head_dim / 8 lanes share a key row, each reading 16 bytes
//     (8 bf16) of it, so one shuffle tree of log2(head_dim / 8) steps
//     reduces 32 / (head_dim / 8) keys at once; every staged page serves
//     all GQA rows of the kv head (up to 8 per walk);
//   * per page, the fp32 online softmax of the reference: the page max
//     and sum by two shuffles each, p rounded to bf16 against the
//     running max, and P V accumulated by the lane that read the key
//     (8 columns each), summed over the warp once at the end;
//   * the four warps' (m, l, acc) merge through shared memory; with one
//     split that is the output, else each CTA writes its (m, l, acc) to an
//     fp32 workspace, and the last CTA of each (kv head, sequence) to
//     arrive (a per-(kv head, sequence) counter, which it resets) merges
//     the partials in split order and writes the output: one launch, no
//     memset.  A split past its sequence's length writes m = NEG_INF,
//     l = 0, acc = 0.
// cuda-core (fp32 pools and every other case): the first version,
// described above its kernel below.
#include <algorithm>

#include "hopper_common.cuh"

namespace {

using namespace ::sm90;
typedef __nv_bfloat16 bf16;

constexpr float NEG_INF = -1073741824.0f;  // -2**30, the reference's mask value

// ---- design 0: cuda-core (the first version) ---------------------------------
//   * one CTA per (kv head, sequence); the CTA reads its block-table row
//     and walks only the pages below ceil(lengths[b] / page_size);
//   * the CTA's four warps take interleaved pages, each keeping its own
//     (m, l, acc) in registers (a lane holds head_dim / 32 columns); the
//     four states merge once at the end, through shared memory;
//   * K and V rows are read straight from HBM into registers, coalesced
//     along head_dim, up to KC rows' loads in flight per warp.
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


// ---- design 1: split-kv ------------------------------------------------------

constexpr int SK_WARPS = 4;
constexpr int SK_TARGET_CTAS = 8 * 132;  // eight CTAs for each of the H100's SMs
constexpr int SK_MAX_SPLITS = 64;
constexpr size_t SK_STAGE_BUDGET = 48 * 1024;  // bytes of ring a CTA aims at
constexpr size_t SK_RING_MAX = 160 * 1024;     // bytes of ring a CTA may have

// Runs of pages per (kv head, sequence): enough CTAs for the card, at
// least one page per warp, at most SK_MAX_SPLITS.
__host__ inline int decode_splits(int batch, int kv_heads, int width) {
  const int pairs = std::max(1, batch * kv_heads);
  int splits = (SK_TARGET_CTAS + pairs - 1) / pairs;
  splits = std::min(splits, std::min(SK_MAX_SPLITS, (width + SK_WARPS - 1) / SK_WARPS));
  if (splits <= 1) return 1;
  const int pps = (width + splits - 1) / splits;
  return (width + pps - 1) / pps;
}

// Ring stages of each warp: two K/V page pairs at least.
__host__ inline int decode_stages(int ps, int d) {
  const size_t per_stage = (size_t)SK_WARPS * 2 * ps * d * sizeof(bf16);
  return (int)std::max((size_t)2, std::min((size_t)4, SK_STAGE_BUDGET / per_stage));
}

__host__ inline bool split_kv_shape(int dtype, int ps, int d) {
  if (dtype != 1 || (d != 64 && d != 128) || ps <= 0) return false;
  const int passes = ps * (d / 8) / 32;  // key rows each lane reads per page
  if (ps * (d / 8) % 32 != 0 || (passes != 2 && passes != 4 && passes != 8)) return false;
  return 2 * (size_t)SK_WARPS * 2 * ps * d * sizeof(bf16) <= SK_RING_MAX;
}

__host__ inline bool use_split_kv(int dtype, int ps, int d, const void* q, const void* kp,
                                  const void* vp) {
  return split_kv_shape(dtype, ps, d) && aligned16(q) && aligned16(kp) && aligned16(vp);
}

__device__ __forceinline__ void unpack8(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// LPR = head_dim / 8 lanes per key row; PASSES key rows per lane per page
// (page_size = PASSES * 32 / LPR); GB query rows (GQA group members) per walk.
template <int LPR, int PASSES, int GB>
__global__ void __launch_bounds__(SK_WARPS * 32)
decode_split_kv(const bf16* __restrict__ q, const bf16* __restrict__ kp,
                const bf16* __restrict__ vp, const int* __restrict__ table,
                const int* __restrict__ start, const int* __restrict__ lengths,
                bf16* __restrict__ out, float* __restrict__ ws, int* __restrict__ counters,
                int n_heads, int kv_heads, int num_pages, int width, int pps, int stages,
                float scale, float softcap) {
  constexpr int D = LPR * 8, KPP = 32 / LPR, PS = PASSES * KPP, PAGE = PS * D;
  __shared__ float sm_m[SK_WARPS][GB], sm_l[SK_WARPS][GB], sm_acc[SK_WARPS][GB][D];
  extern __shared__ __align__(16) uint8_t smem[];

  const int hk = blockIdx.x, b = blockIdx.y, split = blockIdx.z, splits = gridDim.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kr = lane / LPR, c = lane % LPR;  // key row within a pass, 16-byte column chunk
  const int group = n_heads / kv_heads;
  bf16* ring = reinterpret_cast<bf16*>(smem) + (size_t)warp * stages * 2 * PAGE;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + (size_t)SK_WARPS * stages * 2 * PAGE * sizeof(bf16)) +
      warp * stages;

  const int length = lengths[b], qpos = start[b];
  const int n_pages = length > 0 ? min(width, (length + PS - 1) / PS) : 0;
  const int p0 = min(n_pages, split * pps), p1 = min(n_pages, p0 + pps);
  // warp w walks pages p0 + w, p0 + w + 4, ...: the CTA's four warps
  // fetch neighbouring pages at once
  const int wp0 = p0 + warp, cnt = max(0, (p1 - wp0 + SK_WARPS - 1) / SK_WARPS);
  const int* row = table + (long long)b * width;

  if (lane == 0)
    for (int s = 0; s < stages; ++s) bar_init(&full[s], 1);
  bar_init_fence();
  __syncthreads();

  // page wp0 + 4 i of this warp into stage u % stages (u counts every page
  // the warp has staged, over all walks)
  auto issue = [&](int u, int i) {
    const int st = u % stages;
    const long long page = (long long)hk * num_pages + row[wp0 + i * SK_WARPS];
    bf16* dst = ring + (size_t)st * 2 * PAGE;
    bar_expect_tx(&full[st], 2 * PAGE * sizeof(bf16));
    bulk_load(dst, kp + page * PAGE, PAGE * sizeof(bf16), &full[st]);
    bulk_load(dst + PAGE, vp + page * PAGE, PAGE * sizeof(bf16), &full[st]);
  };

  int u0 = 0;
  for (int g0 = 0; g0 < group; g0 += GB) {
    const int rows = min(GB, group - g0);
    float qv[GB][8], acc[GB][8], m[GB], l[GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      m[g] = NEG_INF;
      l[g] = 0.f;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (g < rows)
        raw = *reinterpret_cast<const uint4*>(
            q + ((long long)b * n_heads + hk * group + g0 + g) * D + c * 8);
      unpack8(raw, qv[g]);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
    }

    if (lane == 0)
      for (int i = 0; i < min(stages, cnt); ++i) issue(u0 + i, i);
    for (int i = 0; i < cnt; ++i) {
      const int u = u0 + i, st = u % stages;
      bar_wait(&full[st], (u / stages) & 1);
      const bf16* kpg = ring + (size_t)st * 2 * PAGE;
      const bf16* vpg = kpg + PAGE;
      const int kbase = (wp0 + i * SK_WARPS) * PS;

      // scores: lane (kr, c) holds key pass * KPP + kr's score after the tree
      float sc[GB][PASSES];
#pragma unroll
      for (int pass = 0; pass < PASSES; ++pass) {
        const int j = pass * KPP + kr;
        float kf[8];
        unpack8(*reinterpret_cast<const uint4*>(kpg + j * D + c * 8), kf);
        const int kpos = kbase + j;
        const bool valid = kpos < length && kpos <= qpos;
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) part = fmaf(qv[g][e], kf[e], part);
#pragma unroll
          for (int o = 1; o < LPR; o <<= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
          float x = part * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          sc[g][pass] = valid ? x : NEG_INF;
        }
      }
      // the page's online-softmax update, as the reference does per page
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float mx = sc[g][0];
#pragma unroll
        for (int pass = 1; pass < PASSES; ++pass) mx = fmaxf(mx, sc[g][pass]);
#pragma unroll
        for (int o = LPR; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m[g], mx);
        const float alpha = expf(m[g] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int pass = 0; pass < PASSES; ++pass) {
          sc[g][pass] = expf(sc[g][pass] - m_new);
          sum += sc[g][pass];
        }
#pragma unroll
        for (int o = LPR; o < 32; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        l[g] = l[g] * alpha + sum;
        m[g] = m_new;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] *= alpha;
      }
      // P V: the lane that scored key j multiplies V row j's 8 columns
#pragma unroll
      for (int pass = 0; pass < PASSES; ++pass) {
        const int j = pass * KPP + kr;
        float vf[8];
        unpack8(*reinterpret_cast<const uint4*>(vpg + j * D + c * 8), vf);
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          const float pj = bf16_round(sc[g][pass]);  // p.astype(v.dtype)
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(pj, vf[e], acc[g][e]);
        }
      }
      __syncwarp();
      if (lane == 0 && i + stages < cnt) {
        fence_async_smem();  // the warp's reads of this stage come before the copy
        issue(u + stages, i + stages);
      }
    }
    u0 += cnt;

    // the warp's acc: sum over the lanes that read different key rows
#pragma unroll
    for (int g = 0; g < GB; ++g)
#pragma unroll
      for (int e = 0; e < 8; ++e)
#pragma unroll
        for (int o = LPR; o < 32; o <<= 1)
          acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
    if (kr == 0) {
#pragma unroll
      for (int g = 0; g < GB; ++g) {
#pragma unroll
        for (int e = 0; e < 8; ++e) sm_acc[warp][g][c * 8 + e] = acc[g][e];
        if (c == 0) {
          sm_m[warp][g] = m[g];
          sm_l[warp][g] = l[g];
        }
      }
    }
    __syncthreads();
    // merge the four warps' runs, in warp order
    for (int t = threadIdx.x; t < rows * D; t += SK_WARPS * 32) {
      const int g = t / D, col = t % D;
      float mx = sm_m[0][g];
#pragma unroll
      for (int w = 1; w < SK_WARPS; ++w) mx = fmaxf(mx, sm_m[w][g]);
      float lsum = 0.f, asum = 0.f;
#pragma unroll
      for (int w = 0; w < SK_WARPS; ++w) {
        const float f = expf(sm_m[w][g] - mx);
        lsum += sm_l[w][g] * f;
        asum += sm_acc[w][g][col] * f;
      }
      const long long r = (long long)b * n_heads + hk * group + g0 + g;  // query row
      if (splits == 1) {
        out[r * D + col] = __float2bfloat16_rn(asum / fmaxf(lsum, 1e-30f));
      } else {
        float* part = ws + (r * splits + split) * (D + 2);
        part[2 + col] = asum;
        if (col == 0) {
          part[0] = mx;
          part[1] = lsum;
        }
      }
    }
    __syncthreads();
  }
  if (splits == 1) return;

  // the last CTA of this (kv head, sequence) merges the splits in order
  __shared__ int last;
  __threadfence();
  __syncthreads();
  int* counter = counters + (long long)b * kv_heads + hk;
  if (threadIdx.x == 0) last = atomicAdd(counter, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();  // every other split's partial is visible
  // every (split, row)'s m and l at once into the (now free) ring, then each
  // row's weights in split order, then the acc sums
  float* fac = reinterpret_cast<float*>(smem);  // splits x group: m, then the weight
  float* lsm = fac + splits * group;            // splits x group: l
  float* den = lsm + splits * group;            // group: the merged denominator
  for (int t = threadIdx.x; t < splits * group; t += SK_WARPS * 32) {
    const int j = t / group, g = t % group;
    const float* part = ws + (((long long)b * n_heads + hk * group + g) * splits + j) * (D + 2);
    fac[t] = __ldcg(part);
    lsm[t] = __ldcg(part + 1);
  }
  __syncthreads();
  for (int g = threadIdx.x; g < group; g += SK_WARPS * 32) {
    float mx = NEG_INF;
    for (int j = 0; j < splits; ++j) mx = fmaxf(mx, fac[j * group + g]);
    float lsum = 0.f;
    for (int j = 0; j < splits; ++j) {
      const float f = expf(fac[j * group + g] - mx);
      fac[j * group + g] = f;
      lsum += lsm[j * group + g] * f;
    }
    den[g] = fmaxf(lsum, 1e-30f);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < group * D; t += SK_WARPS * 32) {
    const int g = t / D, col = t % D;
    const long long r = (long long)b * n_heads + hk * group + g;
    const float* part = ws + r * splits * (D + 2) + 2 + col;
    float asum = 0.f;
#pragma unroll 8
    for (int j = 0; j < splits; ++j) asum += __ldcg(part + j * (D + 2)) * fac[j * group + g];
    out[r * D + col] = __float2bfloat16_rn(asum / den[g]);
  }
  if (threadIdx.x == 0) *counter = 0;  // ready for the next launch
}

template <int LPR, int PASSES, int GB>
int launch_split_kv(const void* q, const void* kp, const void* vp, const int* table,
                    const int* start, const int* lengths, void* out, float* ws, int* counters,
                    int batch, int n_heads, int kv_heads, int num_pages, int ps, int width,
                    float scale, float softcap, cudaStream_t s) {
  constexpr int D = LPR * 8;
  const int splits = decode_splits(batch, kv_heads, width);
  if (splits > 1 && (ws == nullptr || counters == nullptr)) return (int)cudaErrorInvalidValue;
  const int stages = decode_stages(ps, D);
  // the ring and its barriers; the last CTA's merge reuses the space
  const size_t smem =
      std::max((size_t)SK_WARPS * stages * (2 * ps * D * sizeof(bf16) + 8),
               (size_t)(2 * splits + 1) * (n_heads / kv_heads) * sizeof(float));
  auto kernel = decode_split_kv<LPR, PASSES, GB>;
  const int rc = opt_in_smem(kernel, smem);
  if (rc != 0) return rc;
  const int pps = (width + splits - 1) / splits;
  kernel<<<dim3(kv_heads, batch, splits), SK_WARPS * 32, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kp), static_cast<const bf16*>(vp),
      table, start, lengths, static_cast<bf16*>(out), ws, counters, n_heads, kv_heads,
      num_pages, width, pps, stages, scale, softcap);
  return 0;
}

template <int LPR, int PASSES>
int launch_split_kv_gb(int group, const void* q, const void* kp, const void* vp,
                       const int* table, const int* start, const int* lengths, void* out,
                       float* ws, int* counters, int batch, int n_heads, int kv_heads,
                       int num_pages, int ps, int width, float scale, float softcap,
                       cudaStream_t s) {
#define K2_SK_ARGS q, kp, vp, table, start, lengths, out, ws, counters, batch, n_heads, \
                   kv_heads, num_pages, ps, width, scale, softcap, s
  // GB x PASSES <= 32 score registers a lane
  if (group == 1) return launch_split_kv<LPR, PASSES, 1>(K2_SK_ARGS);
  if (group == 2) return launch_split_kv<LPR, PASSES, 2>(K2_SK_ARGS);
  if (group <= 4 || PASSES == 8) return launch_split_kv<LPR, PASSES, 4>(K2_SK_ARGS);
  if constexpr (PASSES < 8) return launch_split_kv<LPR, PASSES, 8>(K2_SK_ARGS);
  return (int)cudaErrorInvalidValue;
#undef K2_SK_ARGS
}

template <int LPR>
int launch_split_kv_ps(int group, const void* q, const void* kp, const void* vp,
                       const int* table, const int* start, const int* lengths, void* out,
                       float* ws, int* counters, int batch, int n_heads, int kv_heads,
                       int num_pages, int ps, int width, float scale, float softcap,
                       cudaStream_t s) {
#define K2_SK_ARGS group, q, kp, vp, table, start, lengths, out, ws, counters, batch, \
                   n_heads, kv_heads, num_pages, ps, width, scale, softcap, s
  const int passes = ps * LPR / 32;
  if (passes == 2) return launch_split_kv_gb<LPR, 2>(K2_SK_ARGS);
  if (passes == 4) return launch_split_kv_gb<LPR, 4>(K2_SK_ARGS);
  return launch_split_kv_gb<LPR, 8>(K2_SK_ARGS);
#undef K2_SK_ARGS
}

}  // namespace

// The split count a launch at these arguments uses (1 for the cuda-core
// design): the wrapper sizes its workspace with it.
extern "C" int paged_attention_decode_splits(int dtype, int batch, int kv_heads,
                                             int page_size, int head_dim, int width) {
  if (!split_kv_shape(dtype, page_size, head_dim)) return 1;
  return decode_splits(batch, kv_heads, width);
}

// dtype (of q, the pages and the output): 0 = float32, 1 = bfloat16.
// softcap <= 0 means none.  ws: fp32 workspace of splits x batch x n_heads
// x (head_dim + 2) and counters: batch x kv_heads int32, zero between
// launches (null when the split count is 1).  Returns the code of the
// design that ran (0 cuda-core, 1 split-kv), or minus a cudaError.
extern "C" int paged_attention_decode(const void* q, const void* k_pages,
                                      const void* v_pages, int dtype, const void* table,
                                      const void* start, const void* lengths, void* out,
                                      void* ws, void* counters, int batch, int n_heads,
                                      int kv_heads, int num_pages, int page_size, int head_dim,
                                      int width, float scale, float softcap, void* stream) {
  if (page_size > MAX_PS || head_dim > 256 || n_heads % kv_heads != 0 || dtype < 0 ||
      dtype > 1)
    return -(int)cudaErrorInvalidValue;
  const bool split_kv = use_split_kv(dtype, page_size, head_dim, q, k_pages, v_pages);
  if (batch <= 0) return split_kv ? 1 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(table);
  const int* st = static_cast<const int*>(start);
  const int* ln = static_cast<const int*>(lengths);
  if (split_kv) {
#define K2_SK_ARGS n_heads / kv_heads, q, k_pages, v_pages, tb, st, ln, out, \
                   static_cast<float*>(ws), static_cast<int*>(counters), batch, n_heads, \
                   kv_heads, num_pages, page_size, width, scale, softcap, s
    const int rc = head_dim == 64 ? launch_split_kv_ps<8>(K2_SK_ARGS)
                                  : launch_split_kv_ps<16>(K2_SK_ARGS);
#undef K2_SK_ARGS
    if (rc != 0) return -rc;
  } else if (dtype == 0) {
    launch_typed<float>(q, k_pages, v_pages, tb, st, ln, out, batch, n_heads, kv_heads,
                        num_pages, page_size, head_dim, width, scale, softcap, s);
  } else {
    launch_typed<bf16>(q, k_pages, v_pages, tb, st, ln, out, batch, n_heads, kv_heads,
                       num_pages, page_size, head_dim, width, scale, softcap, s);
  }
  const int err = (int)cudaGetLastError();
  return err != 0 ? -err : (split_kv ? 1 : 0);
}
