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
// The query loop covers the rows that can see the tile's keys (the exact
// skip of flash_common.cuh), plus the rows that see no key at all (a
// window past the keys' end): those weigh every key by 1, as in the
// reference.
//
// What bounds it on the H100: operations, four d-long products per
// visible (q, k) pair.  Two designs, chosen by K6's rule
// (flash_hopper.cuh use_wgmma):
//
// bf16 with d % 8 == 0: the tensor cores, fed by TMA (the FlashAttention-3
// backward layout, keys as the wgmma M dimension):
//   * one CTA per (128 keys, batch x query head), the key tiles that see
//     the most queries launched first; 256 threads, two warpgroups of 64
//     keys each.  K and V are loaded once; warp 0 keeps a ring of Q and
//     dO tiles (BQ rows, TMA, 128-byte swizzle) STAGES - 1 steps ahead,
//     with their lse and delta rows (lse +inf past sq, so those rows
//     weigh 0);
//   * S^T = K Q^T and dP^T = V dO^T are wgmmas from shared memory; P^T =
//     exp(S^T - lse) and dS^T = P^T (dP^T - delta) [(1 - tanh^2)] scale on
//     the fp32 fragment, the softcap and masks of flash_common.cuh;
//   * dV += P^T dO and dK += dS^T Q with P and dS each as a hi/lo pair of
//     bf16s in registers (two wgmmas a product, x = hi + lo to about
//     2^-16), reading B MN-major.  JAX keeps P and dS in fp32; the splits
//     were sized in tests/test_torch_flash_dkv_rounding.py and on the card;
//   * the two dK/dV accumulators of D / 2 fp32 each fit one pass up to
//     D = 128.  At D = 256 (128 registers each) the query tiles are
//     walked twice in one launch: S^T and dV first, then S^T, dP^T and
//     dK (one more S^T product; 192 accumulator and fragment registers).  No
//     producer warp: with eight warps ptxas may give a thread 255
//     registers, with nine it gives 168 and spills.
// fp32, or bf16 rows of other lengths: the CUDA-core design (fp32 FMA):
//   * one CTA per (kv tile, batch x query head); the K and V tiles stay
//     in shared memory, the q / dO tiles and their lse / delta rows are
//     staged once per step of the sequential query loop;
//   * each thread computes a block of p and ds, both go to shared memory,
//     and after one barrier it adds p^T dO and ds^T q into its key rows'
//     dV and dK accumulators.
//   Tiles: BQ = BK = 64 up to D = 128, 32 at D = 256.  Dynamic shared
//   memory: (2 BK + 2 BQ)(D + 1) + 2 BQ (BK + 1) + 2 BQ floats — 66 KB at
//   D = 32, 98 KB at 64, 162 KB at 128, 137 KB at 256.
#include "flash_hopper.cuh"

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

// ---- the bf16 design: wgmma fed by TMA ----------------------------------

using namespace flash::hopper;

constexpr int WG_BKV = 128;      // keys a CTA: two warpgroups of 64
constexpr int WG_THREADS = 256;  // two warpgroups; warp 0 also loads the ring

template <int D, int BQ, int STAGES>
struct DkvSmem {
  static constexpr int KV = WG_BKV * D, Q = BQ * D;  // elements of a K or V and a Q tile
  // 1 KB of alignment slack, K, V, STAGES x (Q, dO, lse, delta), the barriers
  static constexpr size_t BYTES =
      1024 + 2 * (2 * KV) + STAGES * (2 * 2 * Q + 2 * 4 * BQ) + 8 * (2 * STAGES + 1);
};

// The fragment of a 64 x K product as the A fragments of a product over
// K, split into bf16 hi and lo parts: x = hi + lo to about 2^-16.
template <int K>
__device__ __forceinline__ void to_frag_split(const float (&s)[K / 2], uint32_t (&hi)[K / 16][4],
                                              uint32_t (&lo)[K / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float a = s[8 * kk + 2 * j], b = s[8 * kk + 2 * j + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      hi[kk][j] = *reinterpret_cast<const uint32_t*>(&h);
      lo[kk][j] = pack_bf16(a - __low2float(h), b - __high2float(h));
    }
}

// TWO_PASS: the query tiles are walked twice, dV on the first walk and
// dK on the second (D = 256); otherwise once, for both.
template <int D, int BQ, int STAGES, bool TWO_PASS>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bwd_dkv_wgmma(__grid_constant__ const CUtensorMap tq, __grid_constant__ const CUtensorMap tdo,
                    __grid_constant__ const CUtensorMap tk, __grid_constant__ const CUtensorMap tv,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dk, bf16* __restrict__ dv, int heads, int kv_heads, int d,
                    Masking mk) {
  using S = DkvSmem<D, BQ, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  bf16* vs = ks + S::KV;
  bf16* qs = vs + S::KV;              // STAGES Q tiles
  bf16* dos = qs + STAGES * S::Q;     // STAGES dO tiles
  float* lse_s = reinterpret_cast<float*>(dos + STAGES * S::Q);  // STAGES x BQ
  float* delta_s = lse_s + STAGES * BQ;                           // STAGES x BQ
  uint64_t* full = reinterpret_cast<uint64_t*>(delta_s + STAGES * BQ);  // stage loaded
  uint64_t* empty = full + STAGES;    // stage read by all eight warps
  uint64_t* kvbar = empty + STAGES;   // K and V loaded

  const int bh = blockIdx.x, k0 = blockIdx.y * WG_BKV;  // key tile 0 sees the most queries
  const int kvm = bh / heads * kv_heads + bh % heads / (heads / kv_heads);
  const long long row0 = (long long)bh * mk.sq;
  int lo, hi;
  mk.query_range(k0, min(k0 + WG_BKV, mk.sk) - 1, lo, hi);
  const int t0 = lo / BQ, tiles = (hi + BQ - 1) / BQ - t0;  // the query tiles to walk
  const int steps = (TWO_PASS ? 2 : 1) * max(tiles, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(&full[s], 32);
      bar_init(&empty[s], 8);  // the eight warps
    }
    bar_init(kvbar, 1);
    bar_init_fence();
  }
  __syncthreads();

  // Warp 0 loads step i of the ring (the query tile of walk i / tiles) once
  // every warp has released the slot's previous step: lse and delta by its
  // 32 lanes, Q and dO by TMA.  A separate producer warp would leave each
  // thread 168 registers (a quarter of the SM's registers serves three
  // warps); inside the warpgroups it has 255.
  auto produce = [&](int i) {
    const int s = i % STAGES, q0 = (t0 + i % tiles) * BQ, lane = threadIdx.x;
    bar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
    for (int r = lane; r < BQ; r += 32) {  // rows past sq weigh 0
      const bool in = q0 + r < mk.sq;
      lse_s[s * BQ + r] = in ? lse[row0 + q0 + r] : INFINITY;
      delta_s[s * BQ + r] = in ? delta[row0 + q0 + r] : 0.f;
    }
    if (lane == 0) {
      bar_expect_tx(&full[s], 4 * S::Q);
      tma_tile<D, BQ>(qs + s * S::Q, &tq, &full[s], q0, bh);
      tma_tile<D, BQ>(dos + s * S::Q, &tdo, &full[s], q0, bh);
    } else {
      bar_arrive(&full[s]);
    }
  };
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) {
      bar_expect_tx(kvbar, 4 * S::KV);
      tma_tile<D, WG_BKV>(ks, &tk, kvbar, k0, kvm);
      tma_tile<D, WG_BKV>(vs, &tv, kvbar, k0, kvm);
    }
    for (int i = 0; i < min(steps, STAGES - 1); ++i) produce(i);
  }

  {  // two warpgroups, 64 keys each
    const int wk = 64 * (threadIdx.x / 128), kr0 = k0 + wk;
    const bf16* kw = ks + wk * 64;  // this warpgroup's 64 rows of the K and V panels
    const bf16* vw = vs + wk * 64;
    const long long out0 = (long long)bh * mk.sk * d;
    const float one[2] = {1.f, 1.f};
    // dV, then (second walk) dK; with one walk dK has its own registers
    float acc_v[D / 2], acc_k[TWO_PASS ? 1 : D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc_v[j] = 0.f;
#pragma unroll
    for (int j = 0; j < (TWO_PASS ? 1 : D / 2); ++j) acc_k[j] = 0.f;
    bar_wait(kvbar, 0);

    for (int i = 0; i < steps; ++i) {
      const int s = i % STAGES, q0 = (t0 + i % tiles) * BQ;
      const bool want_dv = !TWO_PASS || i < tiles, want_dk = !TWO_PASS || i >= tiles;
      if (threadIdx.x < 32 && i + STAGES - 1 < steps) produce(i + STAGES - 1);
      const bf16* qt = qs + s * S::Q;
      const bf16* dot = dos + s * S::Q;
      const float* lse_t = lse_s + s * BQ;
      const float* delta_t = delta_s + s * BQ;
      if constexpr (TWO_PASS) {
        if (i == tiles) {  // the first walk is done: dV out, dK in
          store_frag<D>(dv + out0, acc_v, kr0, mk.sk, d, one);
#pragma unroll
          for (int j = 0; j < D / 2; ++j) acc_v[j] = 0.f;
        }
      }
      bar_wait(&full[s], (i / STAGES) & 1);

      // S^T = K Q^T and, for dK, dP^T = V dO^T on the tensor cores
      float st[BQ / 2], dpt[BQ / 2];
#pragma unroll
      for (int j = 0; j < BQ / 2; ++j) st[j] = dpt[j] = 0.f;
      own(st);
      own(dpt);
      mma_fence();
      mma_abt<BQ, D>(st, kw, WG_BKV * 128, qt, BQ * 128);
      if (want_dk) mma_abt<BQ, D>(dpt, vw, WG_BKV * 128, dot, BQ * 128);
      mma_commit();
      mma_wait_all();
      own(st);
      own(dpt);

      // P^T and dS^T over the fragment: rows are keys, columns queries
      const bool whole = mk.sees_all(q0, q0 + BQ - 1, kr0, kr0 + 63);
#pragma unroll
      for (int j = 0; j < BQ / 2; ++j) {
        const int c = frag_col(j);
        float th;
        const float x =
            whole ? mk.cap(st[j], &th) : mk.score(st[j], q0 + c, kr0 + frag_row(j), &th);
        const float pv = exp2f((x - lse_t[c]) * LOG2E);
        if (want_dk) {
          float ds = pv * (dpt[j] - delta_t[c]);
          if (mk.softcap > 0.f) ds *= 1.f - th * th;
          dpt[j] = ds * mk.scale;
        }
        st[j] = pv;
      }

      // dV += P^T dO and dK += dS^T Q, P and dS each as hi + lo (rounded
      // once, P took the path's dV at gemma2-9b's local layer to 1.17 of
      // its allowance on an H100; tests/test_torch_flash_dkv_rounding.py)
      uint32_t fp[BQ / 16][4], fpl[BQ / 16][4], fh[BQ / 16][4], fl[BQ / 16][4];
      if (want_dv) to_frag_split<BQ>(st, fp, fpl);
      if (want_dk) to_frag_split<BQ>(dpt, fh, fl);
      own(acc_v);
      own(acc_k);
      mma_fence();
      if (want_dv) {
        mma_ab<BQ, D>(acc_v, fp, dot);
        mma_ab<BQ, D>(acc_v, fpl, dot);
      }
      if (want_dk) {
        if constexpr (TWO_PASS) {
          mma_ab<BQ, D>(acc_v, fh, qt);
          mma_ab<BQ, D>(acc_v, fl, qt);
        } else {
          mma_ab<BQ, D>(acc_k, fh, qt);
          mma_ab<BQ, D>(acc_k, fl, qt);
        }
      }
      mma_commit();
      mma_wait_all();
      own(acc_v);
      own(acc_k);
      own(fp);
      own(fpl);
      own(fh);
      own(fl);
      __syncwarp();
      if (threadIdx.x % 32 == 0) bar_arrive(&empty[s]);
    }

    if constexpr (TWO_PASS) {
      if (steps == 0) store_frag<D>(dv + out0, acc_v, kr0, mk.sk, d, one);  // no query: 0
      store_frag<D>(dk + out0, acc_v, kr0, mk.sk, d, one);
    } else {
      store_frag<D>(dv + out0, acc_v, kr0, mk.sk, d, one);
      store_frag<D>(dk + out0, acc_k, kr0, mk.sk, d, one);
    }
  }
}

template <int D, int BQ, int STAGES, bool TWO_PASS>
int launch_wgmma(const void* q, const void* k, const void* v, const void* dout,
                 const float* lse, const float* delta, void* dk, void* dv, int batch, int heads,
                 int kv_heads, int d, Masking mk, cudaStream_t stream) {
  using S = DkvSmem<D, BQ, STAGES>;
  auto kernel = flash_bwd_dkv_wgmma<D, BQ, STAGES, TWO_PASS>;
  CUtensorMap tq, tdo, tk, tv;
  int rc = make_map(&tq, q, d, mk.sq, batch * heads, BQ);
  if (rc == 0) rc = make_map(&tdo, dout, d, mk.sq, batch * heads, BQ);
  if (rc == 0) rc = make_map(&tk, k, d, mk.sk, batch * kv_heads, WG_BKV);
  if (rc == 0) rc = make_map(&tv, v, d, mk.sk, batch * kv_heads, WG_BKV);
  if (rc == 0) rc = allow_smem(kernel, S::BYTES);
  if (rc != 0) return rc;
  dim3 grid(batch * heads, (mk.sk + WG_BKV - 1) / WG_BKV);
  kernel<<<grid, WG_THREADS, S::BYTES, stream>>>(tq, tdo, tk, tv, lse, delta,
                                                 static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                                                 heads, kv_heads, d, mk);
  return 0;
}

// Tiles (BQ queries, ring stages) per head dim: 64 x 4 at D = 64 (99 KB),
// 32 x 4 at 128 (129 KB), 32 x 2 at 256, two walks (193 KB).  A
// thread holds D (one walk) or D / 2 (two walks) accumulators, BQ fp32
// scores and dP, and BQ fragment registers: at most 192.
int launch_bf16(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dk, void* dv, int batch, int heads,
                int kv_heads, int d, Masking mk, cudaStream_t s) {
#define K8_ARGS q, k, v, dout, lse, delta, dk, dv, batch, heads, kv_heads, d, mk, s
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout) || !aligned16(dk) ||
      !aligned16(dv))
    return (int)cudaErrorMisalignedAddress;
  if (mk.sq == 0) {  // no query: dK = dV = 0, and no tensor map of zero rows
    const size_t bytes = (size_t)batch * heads * mk.sk * d * sizeof(bf16);
    const int rc = (int)cudaMemsetAsync(dk, 0, bytes, s);
    return rc != 0 ? rc : (int)cudaMemsetAsync(dv, 0, bytes, s);
  }
  if (d <= 64) return launch_wgmma<64, 64, 4, false>(K8_ARGS);
  if (d <= 128) return launch_wgmma<128, 32, 4, false>(K8_ARGS);
  return launch_wgmma<256, 32, 2, true>(K8_ARGS);
#undef K8_ARGS
}

}  // namespace

// q/dout (batch, heads, sq, d), k/v (batch, kv_heads, sk, d), dk/dv
// (batch, heads, sk, d), all contiguous, of one dtype: 0 = float32,
// 1 = bfloat16.  lse and delta (batch, heads, sq) fp32.  softcap <= 0 and
// window <= 0 mean none.  With sq = 0 dk and dv are zero.  bf16 with
// d % 8 == 0 runs the wgmma design and needs q, k, v, dout, dk and dv
// 16-byte aligned (else cudaErrorMisalignedAddress); everything else runs
// the CUDA-core design.
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
  if (use_wgmma(dtype, d))
    rc = launch_bf16(q, k, v, dout, l, dl, dk, dv, batch, heads, kv_heads, d, mk, s);
  else if (dtype == 0)
    rc = launch_typed<float>(q, k, v, dout, l, dl, dk, dv, batch, heads, kv_heads, d, mk, s);
  else if (dtype == 1)
    rc = launch_typed<bf16>(q, k, v, dout, l, dl, dk, dv, batch, heads, kv_heads, d, mk, s);
  else
    return (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// The design flash_attention_bwd_dkv runs for (dtype, d): 1 wgmma, 0 CUDA cores.
extern "C" int flash_attention_bwd_dkv_design(int dtype, int d) { return use_wgmma(dtype, d); }
