// K3 — paged-attention chunked prefill ("supertile"), for sm_90a.
//
// Replaces: src/repro/kernels/paged_attention/paged_attention.py :
// paged_attention_prefill (_prefill_body; the Pallas TPU kernel of
// prefix-hit suffix prefills and chunked prefill).
//
// Computes s >= 1 query tokens per sequence at their true positions
// start[b] + t, causal against those positions and masked by
// lengths[b], against K/V pages gathered through block_table[b, :]:
// fp32 online softmax (NEG_INF = -2^30, p cast to the V dtype before PV,
// l clamped at 1e-30), optional softcap, GQA.  int8 pools are dequantised
// on gather exactly as the reference does: int8 * scale in fp32, rounded
// to bf16, before both contractions.  Query rows past the true suffix
// length (bucket padding) still produce finite rows.
//
// What bounds it on the H100: one K/V page serves qc * group query rows,
// so the work per byte grows with the chunk: a long chunk (512 tokens)
// is bound by the tensor cores, a serving suffix (16 tokens over three
// pages) by latency.  Two designs, chosen by a fixed rule in the C entry
// (use_wgmma):
//
// wgmma (bf16 q with bf16 or int8 pools, head_dim 64, 128 or 256, page
// size 8, 16, 32 or 64, 16-byte aligned operands):
//   * one CTA per (kv head, query chunk of 64 rows = qc tokens x group
//     heads, sequence, split): one consumer warpgroup and one producer
//     warp, whose lane 0 keeps the ring full; the splits cut the
//     chunk's key tiles into contiguous runs when kv_heads x chunks x
//     batch leaves the card idle (prefill_splits: from those and the
//     table width alone), merged as K2's are: each CTA's (m, l, acc) to
//     an fp32 workspace, the last CTA of the chunk (a counter it resets)
//     merges in split order;
//   * a key tile is 64 keys: 64 / page_size consecutive pages of the
//     sequence.  The producer loads the tiles into a ring of stages ahead
//     of the math (a full and an empty mbarrier a stage).  bf16 pages
//     come by TMA, one box (64 columns x page_size rows, 128-byte
//     swizzle) per page and panel from a 2-D tensor map over the pool
//     viewed as (kv_heads x num_pages x page_size, head_dim), at row
//     (kv head x num_pages + table[b, p]) x page_size: wgmma reads its
//     operands in the swizzled panels that only a tensor map writes.
//     int8 pages and their bf16 scales come by 1-D cp.async.bulk copies
//     (a page is one contiguous block): they need a dequantising pass
//     anyway, which writes the swizzled bf16 tile the products read;
//   * S = Q K^T is a wgmma (m64 n64 k16, both operands in shared memory,
//     Q staged once, swizzled by the threads), the online softmax runs on
//     the fp32 fragment per tile (the fast exponential, ex2.approx, as
//     K6 does), and p rounded to bf16 in registers is the A operand of
//     O += P V (V read MN-major): products of bf16 values are exact in
//     fp32, so only the order of the sums departs from JAX;
//   * the tile walk stops at the chunk's causal and length bound; a page
//     slot of the last tile past the last live page repeats that page
//     (masked by position), so no tile reads a page the table does not
//     hold live.
// cuda-core (fp32 pools and every other case): the first version,
// described above its kernel below.
#include <algorithm>

#include "flash_hopper.cuh"

namespace {

using namespace ::sm90;
typedef __nv_bfloat16 bf16;

constexpr float NEG_INF = -1073741824.0f;  // -2**30, the reference's mask value

// ---- design 0: cuda-core (the first version) ---------------------------------
//   * one CTA per (kv head, query chunk, sequence); qc * group <= 64 rows
//     per chunk, spread over the CTA's 8 warps (up to 8 rows each, q and
//     the (m, l, acc) state in registers, head_dim / 32 columns per lane);
//   * each page is fetched from HBM once per CTA into fp32 shared memory
//     (dequantised there for int8 pools) and read by every row of the
//     chunk: the TPU kernel's supertile reuse of one page DMA;
//   * the page loop stops at the lesser of the length bound and the
//     causal bound of the chunk's last real row.
constexpr int WARPS = 8;
constexpr int RPW = 8;      // query rows per warp
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


// ---- design 1: wgmma ---------------------------------------------------------

using flash::hopper::mma_ab;
using flash::hopper::mma_abt;
using flash::hopper::quad_max;
using flash::hopper::quad_sum;
using flash::hopper::to_frag;

constexpr int WG_ROWS = 64;   // query rows a CTA: one warpgroup's wgmma M
constexpr int WG_BK = 64;     // keys a tile
constexpr int WG_THREADS = 128;  // the consumer warpgroup
constexpr int PF_THREADS = WG_THREADS + 32;  // and one producer warp
constexpr int PF_TARGET_CTAS = 2 * 132;
constexpr int PF_MAX_SPLITS = 16;

__host__ inline int prefill_tiles(int width, int ps) {
  const int ppt = WG_BK / ps;
  return (width + ppt - 1) / ppt;
}

// Runs of key tiles per (kv head, chunk, sequence): enough CTAs for the
// card, at most PF_MAX_SPLITS.
__host__ inline int prefill_splits(int batch, int kv_heads, int chunks, int width, int ps) {
  const int units = std::max(1, batch * kv_heads * chunks), tiles = prefill_tiles(width, ps);
  int splits = (PF_TARGET_CTAS + units - 1) / units;
  splits = std::min(splits, std::min(PF_MAX_SPLITS, tiles));
  if (splits <= 1) return 1;
  const int tps = (tiles + splits - 1) / splits;
  return (tiles + tps - 1) / tps;
}

__host__ inline bool wgmma_shape(int q_dtype, int kv_dtype, int ps, int d, int qc, int group) {
  return q_dtype == 1 && (kv_dtype == 1 || kv_dtype == 2) &&
         (d == 64 || d == 128 || d == 256) &&
         (ps == 8 || ps == 16 || ps == 32 || ps == 64) && qc * group <= WG_ROWS;
}

__host__ inline bool use_wgmma(int q_dtype, int kv_dtype, int ps, int d, int qc, int group,
                               const void* q, const void* kp, const void* vp, const void* ks,
                               const void* vs) {
  return wgmma_shape(q_dtype, kv_dtype, ps, d, qc, group) && aligned16(q) && aligned16(kp) &&
         aligned16(vp) && (kv_dtype != 2 || (aligned16(ks) && aligned16(vs)));
}

template <int D, bool QUANT>
struct PfSmem {
  static constexpr int STAGES = D == 256 ? 2 : 3;
  static constexpr int Q = WG_ROWS * D;  // bf16 elements of Q and of one K or V tile
  static constexpr int TILE = WG_BK * D;
  // bf16 pools: STAGES x (K, V) tiles as TMA writes them.  int8: the
  // (K, V) bf16 pair the warpgroup dequantises into, then STAGES x (K, V
  // int8, K, V scales) as the bulk copies write them.
  static constexpr int RAW = 2 * TILE + 2 * WG_BK * 2;  // bytes of an int8 stage
  static constexpr size_t RING = QUANT ? 2 * (size_t)TILE * 2 + (size_t)STAGES * RAW
                                       : (size_t)STAGES * 2 * TILE * 2;
  static constexpr size_t BYTES = 1024 + 2 * (size_t)Q + RING + 2 * 8 * STAGES;
};

__device__ __forceinline__ uint4 dequant8(const int8_t* src, float scale) {
  // 8 int8 -> 8 bf16 of int8 * scale, each rounded once from fp32
  const int2 raw = *reinterpret_cast<const int2*>(src);
  const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
  uint4 out;
  uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = pack_bf16((float)v[2 * i] * scale, (float)v[2 * i + 1] * scale);
  return out;
}

// The byte offset of 16-byte chunk `ch` (of 8 bf16) of row r in a tile of
// `rows` rows stored as TMA's 128-byte swizzle writes it: panel ch / 8,
// chunk ch % 8 XOR r % 8.
__device__ __forceinline__ int swz(int r, int ch, int rows) {
  return (ch / 8) * rows * 128 + r * 128 + (((ch % 8) ^ (r & 7)) * 16);
}

template <int D, bool QUANT>
__global__ void __launch_bounds__(PF_THREADS)
prefill_wgmma(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
              const bf16* __restrict__ q, const int8_t* __restrict__ kq,
              const int8_t* __restrict__ vq, const bf16* __restrict__ k_scale,
              const bf16* __restrict__ v_scale, const int* __restrict__ table,
              const int* __restrict__ start, const int* __restrict__ lengths,
              bf16* __restrict__ out, float* __restrict__ ws, int* __restrict__ counters,
              int s_len, int qc, int n_heads, int kv_heads, int num_pages, int ps, int width,
              int tps, int splits, float scale, float softcap) {
  using S = PfSmem<D, QUANT>;
  constexpr int STAGES = S::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* qs = reinterpret_cast<bf16*>(base);
  uint8_t* ring = base + 2 * S::Q;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S::RING);  // stage loaded
  uint64_t* empty = full + STAGES;  // stage read by the four consumer warps
  // int8: the dequantised (K, V) pair, then the raw stages
  bf16* kop = reinterpret_cast<bf16*>(ring);
  bf16* vop = kop + S::TILE;
  uint8_t* raws = ring + 2 * (size_t)S::TILE * sizeof(bf16);

  const int hk = blockIdx.x, chunk = blockIdx.y;
  const int b = blockIdx.z / splits, split = blockIdx.z % splits;
  const int tid = threadIdx.x;
  const int group = n_heads / kv_heads;
  const int ppt = WG_BK / ps;  // pages a key tile
  const int length = lengths[b];
  const int t0 = chunk * qc, t_end = min(s_len, t0 + qc);
  const int rows = (t_end - t0) * group;  // row r: token t0 + r / group, head r % group
  const int q0 = start[b] + t0;
  int n_pages = length > 0 ? min(width, (length + ps - 1) / ps) : 0;
  n_pages = min(n_pages, (start[b] + t_end - 1) / ps + 1);  // the chunk's causal bound
  const int n_tiles = (n_pages + ppt - 1) / ppt;
  const int tile0 = min(n_tiles, split * tps), cnt = min(n_tiles, tile0 + tps) - tile0;
  const int* row = table + (long long)b * width;

  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      bar_init(&full[st], 1);
      bar_init(&empty[st], 4);
    }
    bar_init_fence();
  }
  __syncthreads();

  // key tile tile0 + i into stage i % STAGES; a page past the last live one
  // repeats it
  auto issue = [&](int i) {
    const int st = i % STAGES, p_first = (tile0 + i) * ppt;
    if constexpr (!QUANT) {
      bf16* kd = reinterpret_cast<bf16*>(ring) + (size_t)st * 2 * S::TILE;
      bf16* vd = kd + S::TILE;
      bar_expect_tx(&full[st], 2 * S::TILE * sizeof(bf16));
      for (int pp = 0; pp < ppt; ++pp) {
        const int srow = (hk * num_pages + row[min(p_first + pp, n_pages - 1)]) * ps;
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load_2d(kd + c * WG_BK * 64 + pp * ps * 64, &tk, &full[st], c * 64, srow);
          tma_load_2d(vd + c * WG_BK * 64 + pp * ps * 64, &tv, &full[st], c * 64, srow);
        }
      }
    } else {
      uint8_t* raw = raws + (size_t)st * S::RAW;
      int8_t* kd = reinterpret_cast<int8_t*>(raw);
      int8_t* vd = kd + S::TILE;
      bf16* ksd = reinterpret_cast<bf16*>(raw + 2 * S::TILE);
      bf16* vsd = ksd + WG_BK;
      bar_expect_tx(&full[st], S::RAW);
      for (int pp = 0; pp < ppt; ++pp) {
        const long long slot =
            ((long long)hk * num_pages + row[min(p_first + pp, n_pages - 1)]) * ps;
        bulk_load(kd + pp * ps * D, kq + slot * D, ps * D, &full[st]);
        bulk_load(vd + pp * ps * D, vq + slot * D, ps * D, &full[st]);
        bulk_load(ksd + pp * ps, k_scale + slot, ps * sizeof(bf16), &full[st]);
        bulk_load(vsd + pp * ps, v_scale + slot, ps * sizeof(bf16), &full[st]);
      }
    }
  };

  if (tid >= WG_THREADS) {  // the producer: one thread keeps the ring full
    if (tid == WG_THREADS)
      for (int i = 0; i < cnt; ++i) {
        bar_wait(&empty[i % STAGES], ((i / STAGES) & 1) ^ 1);
        issue(i);
      }
    return;
  }

  float acc[D / 2], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
  if (cnt > 0) {
    // Q once, swizzled as TMA would write it; rows past the chunk are zero
    for (int e = tid; e < WG_ROWS * D / 8; e += WG_THREADS) {
      const int r = e / (D / 8), ch = e % (D / 8);
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r < rows) {
        const int t = t0 + r / group, h = hk * group + r % group;
        v = *reinterpret_cast<const uint4*>(
            q + (((long long)b * s_len + t) * n_heads + h) * D + ch * 8);
      }
      *reinterpret_cast<uint4*>(reinterpret_cast<uint8_t*>(qs) + swz(r, ch, WG_ROWS)) = v;
    }
    fence_async_smem();
    named_sync(1, WG_THREADS);
  }

  const int qpos[2] = {q0 + frag_row(0) / group, q0 + frag_row(2) / group};
  for (int i = 0; i < cnt; ++i) {
    const int st = i % STAGES;
    bar_wait(&full[st], (i / STAGES) & 1);
    const bf16* kt;
    const bf16* vt;
    if constexpr (QUANT) {  // dequantise the stage into the swizzled bf16 pair
      const uint8_t* raw = raws + (size_t)st * S::RAW;
      const int8_t* kr8 = reinterpret_cast<const int8_t*>(raw);
      const int8_t* vr8 = kr8 + S::TILE;
      const bf16* ksr = reinterpret_cast<const bf16*>(raw + 2 * S::TILE);
      const bf16* vsr = ksr + WG_BK;
      for (int e = tid; e < WG_BK * D / 8; e += WG_THREADS) {
        const int r = e / (D / 8), ch = e % (D / 8);
        *reinterpret_cast<uint4*>(reinterpret_cast<uint8_t*>(kop) + swz(r, ch, WG_BK)) =
            dequant8(kr8 + r * D + ch * 8, __bfloat162float(ksr[r]));
        *reinterpret_cast<uint4*>(reinterpret_cast<uint8_t*>(vop) + swz(r, ch, WG_BK)) =
            dequant8(vr8 + r * D + ch * 8, __bfloat162float(vsr[r]));
      }
      fence_async_smem();
      __syncwarp();
      if (tid % 32 == 0) bar_arrive(&empty[st]);  // the raw stage is read
      named_sync(1, WG_THREADS);
      kt = kop;
      vt = vop;
    } else {
      kt = reinterpret_cast<const bf16*>(ring) + (size_t)st * 2 * S::TILE;
      vt = kt + S::TILE;
    }

    // S = Q K^T on the tensor cores
    float sc[WG_BK / 2];
#pragma unroll
    for (int j = 0; j < WG_BK / 2; ++j) sc[j] = 0.f;
    own(sc);
    mma_fence();
    mma_abt<WG_BK, D>(sc, qs, WG_ROWS * 128, kt, WG_BK * 128);
    mma_commit();
    mma_wait_all();
    own(sc);

    // the tile's online-softmax update on the fragment
    const int kbase = (tile0 + i) * WG_BK;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < WG_BK / 2; ++j) {
      const int hi = (j >> 1) & 1, kpos = kbase + frag_col(j);
      float x = sc[j] * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      sc[j] = (kpos < length && kpos <= qpos[hi]) ? x : NEG_INF;
      mx[hi] = fmaxf(mx[hi], sc[j]);
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = __expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < WG_BK / 2; ++j) {
      sc[j] = __expf(sc[j] - m[(j >> 1) & 1]);
      sum[(j >> 1) & 1] += sc[j];  // l sums p unrounded
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(sum[r]);
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] *= alpha[(j >> 1) & 1];

    // O += P V: p rounded to bf16 in registers, V read MN-major
    uint32_t frag[WG_BK / 16][4];
    to_frag<WG_BK>(sc, frag);
    own(acc);
    mma_fence();
    mma_ab<WG_BK, D>(acc, frag, vt);
    mma_commit();
    mma_wait_all();
    own(acc);
    own(frag);
    if constexpr (QUANT) {
      named_sync(1, WG_THREADS);  // the bf16 pair is free
    } else {
      __syncwarp();
      if (tid % 32 == 0) bar_arrive(&empty[st]);  // the stage is read
    }
  }

  if (splits == 1) {
    const float den[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
#pragma unroll
    for (int j = 0; j < D / 2; j += 2) {
      const int r = frag_row(j), c = frag_col(j), hi = (j >> 1) & 1;
      if (r < rows) {
        const int t = t0 + r / group, h = hk * group + r % group;
        *reinterpret_cast<__nv_bfloat162*>(out + (((long long)b * s_len + t) * n_heads + h) * D +
                                           c) =
            __floats2bfloat162_rn(acc[j] / den[hi], acc[j + 1] / den[hi]);
      }
    }
    return;
  }

  // split-KV: this CTA's (m, l, acc) to the workspace; the chunk's last
  // CTA merges the splits in order
  constexpr int PART = WG_ROWS * (D + 2);  // acc rows, then m, then l
  const long long unit = ((long long)b * kv_heads + hk) * gridDim.y + chunk;
  float* part = ws + (unit * splits + split) * PART;
#pragma unroll
  for (int j = 0; j < D / 2; j += 2)
    *reinterpret_cast<float2*>(part + frag_row(j) * D + frag_col(j)) =
        make_float2(acc[j], acc[j + 1]);
  if (tid % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      part[WG_ROWS * D + frag_row(2 * r)] = m[r];
      part[WG_ROWS * D + WG_ROWS + frag_row(2 * r)] = l[r];
    }
  }
  __shared__ int last;
  __threadfence();
  named_sync(1, WG_THREADS);
  if (tid == 0) last = atomicAdd(&counters[unit], 1) == splits - 1;
  named_sync(1, WG_THREADS);
  if (!last) return;
  __threadfence();  // every other split's partial is visible
  const float* parts = ws + unit * splits * PART;
  // every (split, row)'s m and l at once into the (now free) ring, then each
  // row's weights in split order, then the acc sums
  float* fac = reinterpret_cast<float*>(ring);  // splits x 64: m, then the weight
  float* lsm = fac + PF_MAX_SPLITS * WG_ROWS;   // splits x 64: l
  float* den = lsm + PF_MAX_SPLITS * WG_ROWS;   // 64: the merged denominators
  for (int t = tid; t < splits * WG_ROWS; t += WG_THREADS) {
    const int j = t / WG_ROWS, r = t % WG_ROWS;
    fac[t] = __ldcg(parts + j * PART + WG_ROWS * D + r);
    lsm[t] = __ldcg(parts + j * PART + WG_ROWS * D + WG_ROWS + r);
  }
  named_sync(1, WG_THREADS);
  if (tid < WG_ROWS) {
    float mx = NEG_INF;
    for (int j = 0; j < splits; ++j) mx = fmaxf(mx, fac[j * WG_ROWS + tid]);
    float lsum = 0.f;
    for (int j = 0; j < splits; ++j) {
      const float f = expf(fac[j * WG_ROWS + tid] - mx);
      fac[j * WG_ROWS + tid] = f;
      lsum += lsm[j * WG_ROWS + tid] * f;
    }
    den[tid] = fmaxf(lsum, 1e-30f);
  }
  named_sync(1, WG_THREADS);
  for (int e = tid; e < rows * D; e += WG_THREADS) {
    const int r = e / D, c = e % D;
    float a = 0.f;
#pragma unroll 4
    for (int j = 0; j < splits; ++j) a += __ldcg(parts + j * PART + r * D + c) * fac[j * WG_ROWS + r];
    const int t = t0 + r / group, h = hk * group + r % group;
    out[(((long long)b * s_len + t) * n_heads + h) * D + c] = __float2bfloat16_rn(a / den[r]);
  }
  if (tid == 0) counters[unit] = 0;  // ready for the next launch
}

template <int D, bool QUANT>
int launch_wgmma(const void* q, const void* kp, const void* vp, const void* ks, const void* vs,
                 const int* table, const int* start, const int* lengths, void* out, float* ws,
                 int* counters, int batch, int s_len, int qc, int n_heads, int kv_heads,
                 int num_pages, int ps, int width, float scale, float softcap, cudaStream_t s) {
  using S = PfSmem<D, QUANT>;
  const int chunks = (s_len + qc - 1) / qc;
  const int splits = prefill_splits(batch, kv_heads, chunks, width, ps);
  if (splits > 1 && (ws == nullptr || counters == nullptr)) return (int)cudaErrorInvalidValue;
  CUtensorMap tk{}, tv{};
  if constexpr (!QUANT) {  // the pool as (kv_heads x num_pages x page_size, head_dim)
    const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)kv_heads * num_pages * ps};
    const cuuint64_t strides[1] = {(cuuint64_t)D * sizeof(bf16)};
    const cuuint32_t box[2] = {64, (cuuint32_t)ps};
    int rc = encode_bf16(&tk, kp, 2, dims, strides, box);
    if (rc == 0) rc = encode_bf16(&tv, vp, 2, dims, strides, box);
    if (rc != 0) return rc;
  }
  auto kernel = prefill_wgmma<D, QUANT>;
  const int rc = opt_in_smem(kernel, S::BYTES);
  if (rc != 0) return rc;
  const int tiles = prefill_tiles(width, ps);
  const int tps = (tiles + splits - 1) / splits;
  kernel<<<dim3(kv_heads, chunks, batch * splits), PF_THREADS, S::BYTES, s>>>(
      tk, tv, static_cast<const bf16*>(q), static_cast<const int8_t*>(kp),
      static_cast<const int8_t*>(vp), static_cast<const bf16*>(ks), static_cast<const bf16*>(vs),
      table, start, lengths, static_cast<bf16*>(out), ws, counters, s_len, qc, n_heads,
      kv_heads, num_pages, ps, width, tps, splits, scale, softcap);
  return 0;
}

template <bool QUANT>
int launch_wgmma_d(int d, const void* q, const void* kp, const void* vp, const void* ks,
                   const void* vs, const int* table, const int* start, const int* lengths,
                   void* out, float* ws, int* counters, int batch, int s_len, int qc,
                   int n_heads, int kv_heads, int num_pages, int ps, int width, float scale,
                   float softcap, cudaStream_t s) {
#define K3_WG_ARGS q, kp, vp, ks, vs, table, start, lengths, out, ws, counters, batch, s_len, \
                   qc, n_heads, kv_heads, num_pages, ps, width, scale, softcap, s
  if (d == 64) return launch_wgmma<64, QUANT>(K3_WG_ARGS);
  if (d == 128) return launch_wgmma<128, QUANT>(K3_WG_ARGS);
  return launch_wgmma<256, QUANT>(K3_WG_ARGS);
#undef K3_WG_ARGS
}

}  // namespace

// The split count a launch at these arguments uses (1 for the cuda-core
// design): the wrapper sizes its workspace with it.
extern "C" int paged_attention_prefill_splits(int q_dtype, int kv_dtype, int batch, int s_len,
                                              int qc, int n_heads, int kv_heads,
                                              int page_size, int head_dim, int width) {
  if (qc < 1 || kv_heads < 1 ||
      !wgmma_shape(q_dtype, kv_dtype, page_size, head_dim, qc, n_heads / kv_heads))
    return 1;
  return prefill_splits(batch, kv_heads, (s_len + qc - 1) / qc, width, page_size);
}

// dtype codes: q and out 0 = float32, 1 = bfloat16; pages 0 = float32,
// 1 = bfloat16, 2 = int8 (then q is bfloat16 and k_scale / v_scale are
// bfloat16 (kv_heads, num_pages, page_size, 1); else they are null).
// softcap <= 0 means none.  qc query tokens a CTA, qc * (n_heads /
// kv_heads) <= 64.  ws: fp32 workspace of splits x batch x kv_heads x
// chunks x 64 x (head_dim + 2) and counters: batch x kv_heads x chunks
// int32, zero between launches (null when the split count is 1).
// Returns the code of the design that ran (0 cuda-core, 1 wgmma), or
// minus a cudaError.
extern "C" int paged_attention_prefill(const void* q, int q_dtype, const void* k_pages,
                                       const void* v_pages, int kv_dtype, const void* k_scale,
                                       const void* v_scale, const void* table,
                                       const void* start, const void* lengths, void* out,
                                       void* ws, void* counters, int batch, int s_len, int qc,
                                       int n_heads, int kv_heads, int num_pages, int page_size,
                                       int head_dim, int width, float scale, float softcap,
                                       void* stream) {
  if (page_size > MAX_PS || head_dim > 256 || n_heads % kv_heads != 0 || qc < 1 ||
      qc * (n_heads / kv_heads) > WARPS * RPW)
    return -(int)cudaErrorInvalidValue;
  const bool wgmma = use_wgmma(q_dtype, kv_dtype, page_size, head_dim, qc, n_heads / kv_heads,
                               q, k_pages, v_pages, k_scale, v_scale);
  if (batch <= 0 || s_len <= 0) return wgmma ? 1 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(table);
  const int* st = static_cast<const int*>(start);
  const int* ln = static_cast<const int*>(lengths);
  float* w = static_cast<float*>(ws);
  int* cn = static_cast<int*>(counters);
  int rc;
  if (wgmma) {
#define K3_WG_ARGS head_dim, q, k_pages, v_pages, k_scale, v_scale, tb, st, ln, out, w, cn, \
                   batch, s_len, qc, n_heads, kv_heads, num_pages, page_size, width, scale, \
                   softcap, s
    rc = kv_dtype == 2 ? launch_wgmma_d<true>(K3_WG_ARGS) : launch_wgmma_d<false>(K3_WG_ARGS);
#undef K3_WG_ARGS
  } else {
#define K3_CALL(TQ, TKV)                                                                \
  launch_typed<TQ, TKV>(q, k_pages, v_pages, k_scale, v_scale, tb, st, ln, out, batch, \
                        s_len, qc, n_heads, kv_heads, num_pages, page_size, head_dim,  \
                        width, scale, softcap, s)
    if (q_dtype == 0 && kv_dtype == 0) rc = K3_CALL(float, float);
    else if (q_dtype == 1 && kv_dtype == 1) rc = K3_CALL(bf16, bf16);
    else if (q_dtype == 1 && kv_dtype == 2) rc = K3_CALL(bf16, int8_t);
    else return -(int)cudaErrorInvalidValue;
#undef K3_CALL
  }
  if (rc != 0) return -rc;
  const int err = (int)cudaGetLastError();
  return err != 0 ? -err : (wgmma ? 1 : 0);
}
