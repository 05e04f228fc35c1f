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
// visible (q, k) pair.  Two designs, chosen as K6's (flash_hopper.cuh
// use_wgmma):
//
// bf16 with d % 8 == 0: K6's tensor-core design (see flash_attention_fwd.cu):
//   * Q and dO loaded once per CTA, K and V through the TMA ring;
//   * S = Q K^T and dP = dO V^T as wgmmas from shared memory, dS on the
//     fp32 fragments, then dQ += dS K with dS rounded to bf16 in
//     registers (the one rounding the JAX kernel does not do: sized in
//     tests/test_torch_flash_rounding.py) and K read MN-major.
// fp32, or bf16 rows of other lengths: the CUDA-core design (fp32 FMA):
//   * one CTA per (query tile, batch x query head), q and dO tiles in
//     shared memory, a sequential loop over the kv tiles the rows can
//     see (the same exact skip as K6), K and V staged once per tile;
//   * each thread computes a block of s and dp together in one pass over
//     d, turns them into ds in registers, and after one barrier adds
//     ds k into its 4 x (D / 16) (2 x 16 at d = 256) dQ accumulators.
//   Tiles: BQ = BK = 64 up to D = 128, 32 at D = 256.  Dynamic shared
//   memory: (2 BQ + 2 BK)(D + 1) + BQ (BK + 1) floats — 49 KB at D = 32,
//   81 KB at 64, 145 KB at 128, 133 KB at 256.
// Later work: one fused dQ/dK/dV pass.
#include "flash_hopper.cuh"

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

// ---- the bf16 design: wgmma fed by TMA ----------------------------------

using namespace flash::hopper;

constexpr int WG_BQ = 128;       // query rows a CTA: two consumer warpgroups of 64
constexpr int WG_THREADS = 384;  // the consumers, then one producer warpgroup

template <int D, int BK, int STAGES>
struct DqSmem {
  static constexpr int Q = WG_BQ * D, KV = BK * D;  // elements of a Q and a K or V tile
  // 1 KB of alignment slack, Q, dO, STAGES x (K, V), the barriers; at
  // least 116 KB, so that one CTA holds an SM and the consumers'
  // setmaxnreg always finds its registers
  static constexpr size_t BYTES_USED =
      1024 + 2 * (2 * Q + 2 * STAGES * KV) + 8 * (2 * STAGES + 1);
  static constexpr size_t BYTES = BYTES_USED > 116 * 1024 ? BYTES_USED : 116 * 1024;
};

// The gradient of one raw score s (masked and capped, tanh th): p (dp -
// delta) [(1 - th^2)] scale with p = exp(s - lse).
__device__ __forceinline__ float dscore(float s, float th, float dp, float lse, float delta,
                                        const Masking& mk) {
  float ds = exp2f((s - lse) * LOG2E) * (dp - delta);
  if (mk.softcap > 0.f) ds *= 1.f - th * th;
  return ds * mk.scale;
}

template <int D, int BK, int STAGES>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bwd_dq_wgmma(__grid_constant__ const CUtensorMap tq, __grid_constant__ const CUtensorMap tdo,
                   __grid_constant__ const CUtensorMap tk, __grid_constant__ const CUtensorMap tv,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   bf16* __restrict__ dq, int heads, int kv_heads, int d, Masking mk) {
  using S = DqSmem<D, BK, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  bf16* dos = qs + S::Q;
  bf16* ks = dos + S::Q;             // STAGES K tiles
  bf16* vs = ks + STAGES * S::KV;    // STAGES V tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + STAGES * S::KV);  // stage loaded
  uint64_t* empty = full + STAGES;   // stage read by all eight consumer warps
  uint64_t* qbar = empty + STAGES;   // Q and dO loaded

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
      bar_expect_tx(qbar, 4 * S::Q);
      tma_tile<D, WG_BQ>(qs, &tq, qbar, q0, bh);
      tma_tile<D, WG_BQ>(dos, &tdo, qbar, q0, bh);
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
    const long long row0 = (long long)bh * mk.sq;
    float lse_r[2], delta_r[2], acc[D / 2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lse_r[r] = qr[r] < mk.sq ? lse[row0 + qr[r]] : 0.f;
      delta_r[r] = qr[r] < mk.sq ? delta[row0 + qr[r]] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
    bar_wait(qbar, 0);

    for (int t = t0; t < t1; ++t) {
      const int i = t - t0, s = i % STAGES, k0 = t * BK;
      bar_wait(&full[s], (i / STAGES) & 1);

      // S = Q K^T and dP = dO V^T on the tensor cores
      float sc[BK / 2], dp[BK / 2];
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) sc[j] = dp[j] = 0.f;
      own(sc);
      own(dp);
      mma_fence();
      mma_abt<BK, D>(sc, qs + (r0 - q0) * 64, WG_BQ * 128, ks + s * S::KV, BK * 128);
      mma_abt<BK, D>(dp, dos + (r0 - q0) * 64, WG_BQ * 128, vs + s * S::KV, BK * 128);
      mma_commit();
      mma_wait_all();
      own(sc);
      own(dp);

      // dS over the fragment, into sc
      float th;
      if (mk.sees_all(r0, r0 + 63, k0, k0 + BK - 1)) {
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) {
          const float x = mk.cap(sc[j], &th);
          sc[j] = dscore(x, th, dp[j], lse_r[(j >> 1) & 1], delta_r[(j >> 1) & 1], mk);
        }
      } else {
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) {
          const int r = (j >> 1) & 1;
          const float x = mk.score(sc[j], qr[r], k0 + frag_col(j), &th);
          sc[j] = dscore(x, th, dp[j], lse_r[r], delta_r[r], mk);
        }
      }

      // dQ += dS K: dS rounded to bf16 in registers, K read MN-major
      uint32_t frag[BK / 16][4];
      to_frag<BK>(sc, frag);
      own(acc);
      mma_fence();
      mma_ab<BK, D>(acc, frag, ks + s * S::KV);
      mma_commit();
      mma_wait_all();
      own(acc);
      own(frag);
      __syncwarp();
      if (threadIdx.x % 32 == 0) bar_arrive(&empty[s]);
    }

    const float one[2] = {1.f, 1.f};
    store_frag<D>(dq + row0 * d, acc, r0, mk.sq, d, one);
  }
}

template <int D, int BK, int STAGES>
int launch_wgmma(const void* q, const void* k, const void* v, const void* dout,
                 const float* lse, const float* delta, void* dq, int batch, int heads,
                 int kv_heads, int d, Masking mk, cudaStream_t stream) {
  CUtensorMap tq, tdo, tk, tv;
  int rc = make_map(&tq, q, d, mk.sq, batch * heads, WG_BQ);
  if (rc == 0) rc = make_map(&tdo, dout, d, mk.sq, batch * heads, WG_BQ);
  if (rc == 0) rc = make_map(&tk, k, d, mk.sk, batch * kv_heads, BK);
  if (rc == 0) rc = make_map(&tv, v, d, mk.sk, batch * kv_heads, BK);
  if (rc == 0)
    rc = allow_smem(flash_bwd_dq_wgmma<D, BK, STAGES>, DqSmem<D, BK, STAGES>::BYTES);
  if (rc != 0) return rc;
  dim3 grid((mk.sq + WG_BQ - 1) / WG_BQ, batch * heads);
  flash_bwd_dq_wgmma<D, BK, STAGES><<<grid, WG_THREADS, DqSmem<D, BK, STAGES>::BYTES, stream>>>(
      tq, tdo, tk, tv, lse, delta, static_cast<bf16*>(dq), heads, kv_heads, d, mk);
  return 0;
}

// Tiles (BK keys, ring stages) per head dim: 64 x 4 at D = 64 (116 KB),
// 64 x 2 at 128 (129 KB), 32 x 2 at 256 (193 KB).  A thread of a consumer
// holds D / 2 + BK fp32 accumulators (dQ, S, dP) and BK / 4 fragment
// registers: 144 at D = 128, 168 at D = 256, of the 240 setmaxnreg gives.
int launch_bf16(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dq, int batch, int heads,
                int kv_heads, int d, Masking mk, cudaStream_t s) {
#define K7_ARGS q, k, v, dout, lse, delta, dq, batch, heads, kv_heads, d, mk, s
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout) || !aligned16(dq))
    return (int)cudaErrorMisalignedAddress;
  if (d <= 64) return launch_wgmma<64, 64, 4>(K7_ARGS);
  if (d <= 128) return launch_wgmma<128, 64, 2>(K7_ARGS);
  return launch_wgmma<256, 32, 2>(K7_ARGS);
#undef K7_ARGS
}

}  // namespace

// q/dout/dq (batch, heads, sq, d), k/v (batch, kv_heads, sk, d), all
// contiguous, of one dtype: 0 = float32, 1 = bfloat16.  lse and delta
// (batch, heads, sq) fp32.  softcap <= 0 and window <= 0 mean none.
// bf16 with d % 8 == 0 runs the wgmma design and needs q, k, v, dout and
// dq 16-byte aligned (else cudaErrorMisalignedAddress); everything else
// runs the CUDA-core design.
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
  if (use_wgmma(dtype, d))
    rc = launch_bf16(q, k, v, dout, l, dl, dq, batch, heads, kv_heads, d, mk, s);
  else if (dtype == 0)
    rc = launch_typed<float>(q, k, v, dout, l, dl, dq, batch, heads, kv_heads, d, mk, s);
  else if (dtype == 1)
    rc = launch_typed<bf16>(q, k, v, dout, l, dl, dq, batch, heads, kv_heads, d, mk, s);
  else
    return (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// The design flash_attention_bwd_dq runs for (dtype, d): 1 wgmma, 0 CUDA cores.
extern "C" int flash_attention_bwd_dq_design(int dtype, int d) { return use_wgmma(dtype, d); }
