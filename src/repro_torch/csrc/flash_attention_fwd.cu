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
// d-long products; bytes are q, k, v and o once.  Two designs, chosen by
// a fixed rule in the C entry (flash_hopper.cuh use_wgmma):
//
// bf16 with d % 8 == 0: the tensor cores, fed by TMA.
//   * one CTA per (128 query rows, batch x query head), the longest
//     causal rows first; 384 threads: two consumer warpgroups of 64 rows
//     each, then a producer warpgroup of which one thread issues every
//     load (setmaxnreg moves registers from it to the consumers);
//   * Q is loaded once; K and V tiles of BK keys stream through a ring
//     of shared-memory stages (TMA, 128-byte swizzle, a 3-D tensor map
//     (d, s, b x heads) so a tile past s is zero-filled and never reads
//     the next head), with a full and an empty mbarrier per stage;
//   * S = Q K^T is a wgmma with both operands in shared memory; the
//     online softmax runs on the fp32 accumulator fragment (a row's
//     values sit in one quad: two shuffles); p, rounded to bf16 in
//     registers, is the A operand of O += P V, V read MN-major;
//   * a tile every row sees whole skips the mask; the tile walk is the
//     exact skip of flash_common.cuh.
// fp32, or bf16 rows of other lengths: the CUDA-core design, the first
// version (fp32 FMA):
//   * one CTA per (query tile of BQ = 64 rows, batch x query head); the
//     query tile stays in shared memory, and a sequential loop walks the
//     kv tiles (BK = 64 keys, 32 at d = 256) the tile's rows can see,
//     each K/V tile staged once in shared memory for all 64 rows;
//   * each thread holds a 4 x (BK / 16) block of scores and a
//     4 x (D / 16) block of the output accumulator in registers;
//   * tiles wholly outside the rows' causal / window range are skipped
//     (flash_common.cuh says why that is exact).
//   Dynamic shared memory: (BQ + 2 BK)(D + 1) + BQ (BK + 1) floats —
//   41 KB at D = 32, 65 KB at 64, 113 KB at 128, 137 KB at 256.
#include "flash_hopper.cuh"

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

// ---- the bf16 design: wgmma fed by TMA ----------------------------------

using namespace flash::hopper;

constexpr int WG_BQ = 128;       // query rows a CTA: two consumer warpgroups of 64
constexpr int WG_THREADS = 384;  // the consumers, then one producer warpgroup

template <int D, int BK, int STAGES>
struct FwdSmem {
  static constexpr int Q = WG_BQ * D, KV = BK * D;  // elements of a Q and a K or V tile
  // 1 KB of alignment slack, Q, STAGES x (K, V), the barriers; at least
  // 116 KB, so that one CTA holds an SM and the consumers' setmaxnreg
  // always finds its registers
  static constexpr size_t BYTES_USED = 1024 + 2 * (Q + 2 * STAGES * KV) + 8 * (2 * STAGES + 1);
  static constexpr size_t BYTES = BYTES_USED > 116 * 1024 ? BYTES_USED : 116 * 1024;
};

template <int D, int BK, int STAGES>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_fwd_wgmma(__grid_constant__ const CUtensorMap tq, __grid_constant__ const CUtensorMap tk,
                __grid_constant__ const CUtensorMap tv, bf16* __restrict__ o,
                float* __restrict__ lse, int heads, int kv_heads, int d, Masking mk) {
  using S = FwdSmem<D, BK, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  bf16* ks = qs + S::Q;              // STAGES K tiles
  bf16* vs = ks + STAGES * S::KV;    // STAGES V tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + STAGES * S::KV);  // stage loaded
  uint64_t* empty = full + STAGES;   // stage read by all eight consumer warps
  uint64_t* qbar = empty + STAGES;   // Q loaded

  const int q0 = (gridDim.x - 1 - blockIdx.x) * WG_BQ;  // the longest causal rows first
  const int bh = blockIdx.y;
  const int kvm = bh / heads * kv_heads + bh % heads / (heads / kv_heads);
  int lo, hi;
  mk.key_range(q0, min(q0 + WG_BQ, mk.sq) - 1, lo, hi);
  const int t0 = lo / BK, t1 = (hi + BK - 1) / BK;  // the kv tiles the rows can see

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 8);
    }
    bar_init(qbar, 1);
    bar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // the producer: one thread keeps the ring full
    regs_dec<24>();
    if (threadIdx.x == 256) {
      bar_expect_tx(qbar, 2 * S::Q);
      tma_tile<D, WG_BQ>(qs, &tq, qbar, q0, bh);
      for (int t = t0; t < t1; ++t) {
        const int i = t - t0, s = i % STAGES;
        bar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        bar_expect_tx(&full[s], 4 * S::KV);
        tma_tile<D, BK>(ks + s * S::KV, &tk, &full[s], t * BK, kvm);
        tma_tile<D, BK>(vs + s * S::KV, &tv, &full[s], t * BK, kvm);
      }
    }
  } else {  // two consumers, 64 query rows each
    regs_inc<240>();
    const int r0 = q0 + 64 * (threadIdx.x / 128);
    const int qr[2] = {r0 + frag_row(0), r0 + frag_row(2)};  // this thread's two rows
    float acc[D / 2], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
    bar_wait(qbar, 0);

    for (int t = t0; t < t1; ++t) {
      const int i = t - t0, s = i % STAGES, k0 = t * BK;
      bar_wait(&full[s], (i / STAGES) & 1);

      // S = Q K^T on the tensor cores
      float sc[BK / 2];
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) sc[j] = 0.f;
      own(sc);
      mma_fence();
      mma_abt<BK, D>(sc, qs + (r0 - q0) * 64, WG_BQ * 128, ks + s * S::KV, BK * 128);
      mma_commit();
      mma_wait_all();
      own(sc);

      // the online softmax over the fragment: row max, p, row sum
      float mx[2] = {-INFINITY, -INFINITY}, th;
      if (mk.sees_all(r0, r0 + 63, k0, k0 + BK - 1)) {
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) sc[j] = mk.cap(sc[j], &th);
      } else {
#pragma unroll
        for (int j = 0; j < BK / 2; ++j)
          sc[j] = mk.score(sc[j], qr[(j >> 1) & 1], k0 + frag_col(j), &th);
      }
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], sc[j]);
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mx[r]));
        alpha[r] = exp2f((m[r] - m_new) * LOG2E);
        m[r] = m_new;
      }
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        sc[j] = exp2f((sc[j] - m[(j >> 1) & 1]) * LOG2E);
        sum[(j >> 1) & 1] += sc[j];  // l sums p unrounded
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(sum[r]);
#pragma unroll
      for (int j = 0; j < D / 2; ++j) acc[j] *= alpha[(j >> 1) & 1];

      // O += P V: p rounded to bf16 in registers, V read MN-major
      uint32_t frag[BK / 16][4];
      to_frag<BK>(sc, frag);
      own(acc);
      mma_fence();
      mma_ab<BK, D>(acc, frag, vs + s * S::KV);
      mma_commit();
      mma_wait_all();
      own(acc);
      own(frag);
      __syncwarp();
      if (threadIdx.x % 32 == 0) bar_arrive(&empty[s]);
    }

    const float den[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
    store_frag<D>(o + (long long)bh * mk.sq * d, acc, r0, mk.sq, d, den);
    if (lse != nullptr && threadIdx.x % 4 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (qr[r] < mk.sq) lse[(long long)bh * mk.sq + qr[r]] = m[r] + logf(den[r]);
    }
  }
}

template <int D, int BK, int STAGES>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, int batch,
                 int heads, int kv_heads, int d, Masking mk, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int rc = make_map(&tq, q, d, mk.sq, batch * heads, WG_BQ);
  if (rc == 0) rc = make_map(&tk, k, d, mk.sk, batch * kv_heads, BK);
  if (rc == 0) rc = make_map(&tv, v, d, mk.sk, batch * kv_heads, BK);
  if (rc == 0) rc = allow_smem(flash_fwd_wgmma<D, BK, STAGES>, FwdSmem<D, BK, STAGES>::BYTES);
  if (rc != 0) return rc;
  dim3 grid((mk.sq + WG_BQ - 1) / WG_BQ, batch * heads);
  flash_fwd_wgmma<D, BK, STAGES><<<grid, WG_THREADS, FwdSmem<D, BK, STAGES>::BYTES, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), lse, heads, kv_heads, d, mk);
  return 0;
}

// Tiles (BK keys, ring stages) per head dim: 128 x 4 at D = 64 (144 KB),
// 128 x 2 at 128 (160 KB), 64 x 2 at 256 (193 KB).  A thread of a
// consumer holds D / 2 + BK / 2 fp32 accumulators and BK / 4 fragment
// registers: 160 at D = 128, 176 at D = 256, of the 240 setmaxnreg gives.
int launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int batch,
                int heads, int kv_heads, int d, Masking mk, cudaStream_t s) {
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
    return (int)cudaErrorMisalignedAddress;
  if (d <= 64) return launch_wgmma<64, 128, 4>(q, k, v, o, lse, batch, heads, kv_heads, d, mk, s);
  if (d <= 128)
    return launch_wgmma<128, 128, 2>(q, k, v, o, lse, batch, heads, kv_heads, d, mk, s);
  return launch_wgmma<256, 64, 2>(q, k, v, o, lse, batch, heads, kv_heads, d, mk, s);
}

}  // namespace

// q (batch, heads, sq, d), k/v (batch, kv_heads, sk, d), o like q, all
// contiguous, of one dtype: 0 = float32, 1 = bfloat16.  lse (batch,
// heads, sq) fp32, or null.  softcap <= 0 and window <= 0 mean none.
// bf16 with d % 8 == 0 runs the wgmma design and needs q, k, v and o
// 16-byte aligned (else cudaErrorMisalignedAddress); everything else
// runs the CUDA-core design.
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
  if (use_wgmma(dtype, d)) rc = launch_bf16(q, k, v, o, l, batch, heads, kv_heads, d, mk, s);
  else if (dtype == 0) rc = launch_typed<float>(q, k, v, o, l, batch, heads, kv_heads, d, mk, s);
  else if (dtype == 1) rc = launch_typed<bf16>(q, k, v, o, l, batch, heads, kv_heads, d, mk, s);
  else return (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// The design flash_attention_fwd runs for (dtype, d): 1 wgmma, 0 CUDA cores.
extern "C" int flash_attention_fwd_design(int dtype, int d) { return use_wgmma(dtype, d); }
