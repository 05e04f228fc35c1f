// K9 — the Mamba-2 SSD chunked scan, for sm_90a.
//
// Replaces: src/repro/kernels/ssd/ssd.py : ssd_scan (_ssd_body; the
// Pallas TPU kernel, grid (batch, heads, chunks) with the (P, N) state
// carried across chunks in VMEM).
//
//   H_t = exp(l_t) H_{t-1} + xdt_t (x) B_t,   y_t = C_t . H_t
//
// chunk by chunk: with l the inclusive within-chunk cumsum of the
// log-decays (computed outside, as the JAX package does), S = C B^T the
// chunk's scores and M_ij = exp(l_i - l_j) S_ij (j <= i, else 0),
//   y     = M xdt + exp(l) o (C H_c^T)
//   H_c+1 = exp(l_Q) H_c + F_c,   F_c = sum_j exp(l_Q - l_j) xdt_j (x) B_j
// A short last chunk is padded with identity decay and zero input (l
// repeats its last value), which changes no output.
//
// What bounds it on the H100: the recurrence's 4 P N flops a step a head,
// done as fp32-accurate products on the tensor cores (3xTF32: 495 / 3 =
// 165 TFLOP/s), against each input read and each output written once
// (mamba2-780m: 6.4 GFLOP, 0.039 ms, against 106 MB, 0.032 ms).  The TPU
// kernel carries the state because its grid runs in order on one core;
// here blocks run in parallel and in no order, so the scan runs as three
// launches (design "chunk-parallel"):
//   1. per (batch, chunk) the scores S = C B^T, once for every head (B and
//      C are head-shared), into a (batch, nc, Q, Q) buffer read through L2;
//      and per (batch, head, chunk) but the last, F_c into slot c + 1 of
//      the states;
//   2. per (batch, head) and group of 4 state elements, in order over the
//      chunks: H_0 = 0, H_c+1 = exp(l_Q,c) H_c + F_c, in place — nc steps
//      of one FMA an element, the only sequential part;
//   3. per (batch, head, chunk, P tile of 64) y from S and H_c.
// Every product is mma.sync m16n8k8 on TF32 operands split into a big
// part and a remainder (ssd_common.cuh); exp and the decays stay fp32 on
// the CUDA cores.  Tiles of xdt, B, C and the states come by cp.async
// (16-byte copies where P or N is a multiple of 4, else 4-byte ones) into
// swizzled shared memory; N is walked in tiles, so any N runs.  The states
// buffer is (batch, heads, nc, P, N) with or without return_states; every
// slot is written before it is read (H_0 by pass 2).
#include "ssd_common.cuh"

namespace {

using namespace ssd;

constexpr int DESIGN = 1;       // "chunk-parallel"
constexpr int UNROLL = 8;       // pass 2: chunks loaded ahead of the FMA chain

// pass 1: blocks [0, batch nc) the scores, the rest F_c of chunks 0 .. nc-2
__global__ void __launch_bounds__(THREADS, 3)
ssd_fwd_chunks(const float* __restrict__ xdt, const float* __restrict__ bmat,
               const float* __restrict__ cmat, const float* __restrict__ lcum,
               float* __restrict__ st, float* __restrict__ scores, int batch, int heads, int s,
               int p_dim, int n_dim, int nc, int vec_p, int vec_n) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  long long id = blockIdx.x;
  if (id < (long long)batch * nc) {
    const int bb = (int)(id / nc), ci = (int)(id % nc), t0 = ci * Q;
    const long long row = (long long)bb * s + t0;
    scores_role(cmat + row * n_dim, bmat + row * n_dim, scores + id * Q * Q, min(Q, s - t0),
                n_dim, vec_n, smem);
    return;
  }
  id -= (long long)batch * nc;
  const long long bh = id / (nc - 1);
  const int ci = (int)(id % (nc - 1)), t0 = ci * Q, bb = (int)(bh / heads);
  const long long pn = (long long)p_dim * n_dim;
  chunk_role(xdt + (bh * s + t0) * p_dim, bmat + ((long long)bb * s + t0) * n_dim,
             lcum + bh * s + t0, st + (bh * nc + ci + 1) * pn, Q, p_dim, n_dim, vec_p, vec_n,
             true, smem);
}

// pass 2: H_0 = 0, then H_c+1 = exp(l_Q,c) H_c + F_c in place, in order
// over the chunks; a thread owns V elements of one (batch, head)'s state
template <int V>
__global__ void __launch_bounds__(THREADS)
ssd_fwd_states(float* __restrict__ st, const float* __restrict__ lcum, int s, int nc,
               long long pn, long long blocks_per_head) {
  const long long bh = blockIdx.x / blocks_per_head;
  const long long e = ((blockIdx.x % blocks_per_head) * THREADS + threadIdx.x) * V;
  if (e >= pn) return;
  float* base = st + bh * nc * pn + e;
  const float* l = lcum + bh * s;
  Vec<V> h;
#pragma unroll
  for (int k = 0; k < V; ++k) h.v[k] = 0.f;
  store(base, h);
  for (int c0 = 0; c0 + 1 < nc; c0 += UNROLL) {
    Vec<V> f[UNROLL];
    float a[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (c0 + u + 1 < nc) {
        f[u] = load<V>(base + (c0 + u + 1) * pn);
        a[u] = expf(l[min((c0 + u) * Q + Q - 1, s - 1)]);
      }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (c0 + u + 1 < nc) {
        const int c = c0 + u;  // H_c+1 from H_c and F_c
#pragma unroll
        for (int k = 0; k < V; ++k) h.v[k] = fmaf(a[u], h.v[k], f[u].v[k]);
        store(base + (c + 1) * pn, h);
      }
  }
}

// pass 3: y = M xdt + exp(l) o (C H_c^T) for one (batch, head, chunk) and
// P tile of PT columns.  (Copying the next N tile while multiplying this
// one needs a second tile buffer and more registers, two CTAs an SM instead
// of three; tried, it ran slower.)
constexpr int OUT_FLOATS = 2 * Q * PT + Q * KT + PT * KT + Q;

__global__ void __launch_bounds__(THREADS, 3)
ssd_fwd_outputs(const float* __restrict__ xdt, const float* __restrict__ cmat,
                const float* __restrict__ lcum, const float* __restrict__ st,
                const float* __restrict__ scores, float* __restrict__ y, int heads, int s,
                int p_dim, int n_dim, int nc, int vec_p, int vec_n) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Smem<Q> ms{smem};
  const Smem<PT> xs{smem + Q * Q};
  const Smem<KT> cs{smem + Q * Q + Q * PT}, hs{smem + Q * Q + Q * PT + Q * KT};
  float* ls = smem + Q * Q + Q * PT + Q * KT + PT * KT;

  const int tid = threadIdx.x, warp = tid / 32;
  const long long bh = blockIdx.x / nc;
  const int ci = blockIdx.x % nc, bb = (int)(bh / heads), p0 = blockIdx.y * PT;
  const int t0 = ci * Q, rows = min(Q, s - t0), pv = min(PT, p_dim - p0);
  const int m0 = 32 * (warp & 1), n0 = 16 * (warp >> 1);  // (Q, P) block of this warp
  const bool busy = n0 < pv;

  const float* h_in = st + (bh * nc + ci) * (long long)p_dim * n_dim + (long long)p0 * n_dim;
  const float* c_in = cmat + ((long long)bb * s + t0) * n_dim;
  // S, xdt and the first N tile of C and H_c in one round trip (H_0 = 0:
  // chunk 0 has no inter-chunk term)
  if (tid < Q) ls[tid] = lcum[bh * s + t0 + min(tid, rows - 1)];
  stage<Q, Q>(ms, scores + ((long long)bb * nc + ci) * Q * Q, Q, Q, Q, true);
  stage<Q, PT>(xs, xdt + (bh * s + t0) * p_dim + p0, p_dim, rows, pv, vec_p);
  if (ci > 0) {
    stage<Q, KT>(cs, c_in, n_dim, rows, n_dim, vec_n);
    stage<PT, KT>(hs, h_in, n_dim, pv, n_dim, vec_n);
  }
  cp_async_wait();
  __syncthreads();
  for (int e = tid; e < Q * Q; e += THREADS) {  // M = decay o S, masked inside the exp
    const int i = e / Q, j = e % Q;
    ms(i, j) = i >= j ? expf(ls[i] - ls[j]) * ms(i, j) : 0.f;
  }

  float acc[2][2][4];
  zero(acc);
  if (ci > 0) {
    for (int k0 = 0; k0 < n_dim; k0 += KT) {
      if (k0 > 0) {
        __syncthreads();  // the previous N tile is no longer read
        stage<Q, KT>(cs, c_in + k0, n_dim, rows, n_dim - k0, vec_n);
        stage<PT, KT>(hs, h_in + k0, n_dim, pv, n_dim - k0, vec_n);
        cp_async_wait();
        __syncthreads();
      }
      if (busy) gemm<2, 2, false, true>(acc, cs, hs, m0, n0, 0, round8(min(KT, n_dim - k0)));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] *= expf(ls[acc_row(m0, i, e)]);
  }
  __syncthreads();  // M is written
  // M is lower-triangular: rows below m0 + 32 read columns below m0 + 32
  if (busy) gemm<2, 2, false, false>(acc, ms, xs, m0, n0, 0, m0 + 32);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int r = acc_row(m0, i, e), p = acc_col(n0, j, e);
        if (r < rows)
          store_pair(y + (bh * s + t0 + r) * p_dim + p0 + p, acc[i][j][e], acc[i][j][e + 1],
                     p < pv, p + 1 < pv, p_dim % 2 == 0);
      }
}

}  // namespace

// xdt, y (batch, heads, s, P); b, c (batch, s, N); lcum (batch, heads, s);
// st the chunk-initial states (batch, heads, ceil(s / 64), P, N); scores a
// (batch, ceil(s / 64), 64, 64) scratch; all fp32, contiguous.  Returns the
// design's code (1, chunk-parallel), or minus a cudaError.
extern "C" int ssd_scan_fwd(const void* xdt, const void* b, const void* c, const void* lcum,
                            void* y, void* st, void* scores, int batch, int heads, int s, int p,
                            int n, void* stream) {
  if (batch <= 0 || heads <= 0 || s <= 0 || p <= 0) return DESIGN;
  if (n <= 0) return -(int)cudaErrorInvalidValue;
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int nc = (s + Q - 1) / Q;
  const long long bhn = (long long)batch * heads, pn = (long long)p * n;
  const int vec_p = p % 4 == 0 && aligned16(xdt);
  const int vec_n = n % 4 == 0 && aligned16(b) && aligned16(c);
  const float* x = static_cast<const float*>(xdt);
  const float* bm = static_cast<const float*>(b);
  const float* cm = static_cast<const float*>(c);
  const float* l = static_cast<const float*>(lcum);
  float* states = static_cast<float*>(st);
  float* sc = static_cast<float*>(scores);
  int rc = smem_attr((const void*)ssd_fwd_chunks, PASS1_FLOATS);
  if (rc == 0) rc = smem_attr((const void*)ssd_fwd_outputs, OUT_FLOATS);
  if (rc != 0) return -rc;

  const long long blocks1 = (long long)batch * nc + bhn * (nc - 1);
  ssd_fwd_chunks<<<(unsigned)blocks1, THREADS, PASS1_FLOATS * sizeof(float), cs>>>(
      x, bm, cm, l, states, sc, batch, heads, s, p, n, nc, vec_p, vec_n);
  if ((rc = (int)cudaGetLastError()) != 0) return -rc;

  if (pn % 4 == 0) {
    const long long per_head = (pn / 4 + THREADS - 1) / THREADS;
    ssd_fwd_states<4><<<(unsigned)(bhn * per_head), THREADS, 0, cs>>>(states, l, s, nc, pn,
                                                                       per_head);
  } else {
    const long long per_head = (pn + THREADS - 1) / THREADS;
    ssd_fwd_states<1><<<(unsigned)(bhn * per_head), THREADS, 0, cs>>>(states, l, s, nc, pn,
                                                                       per_head);
  }
  if ((rc = (int)cudaGetLastError()) != 0) return -rc;

  const dim3 grid3((unsigned)(bhn * nc), (p + PT - 1) / PT);
  ssd_fwd_outputs<<<grid3, THREADS, OUT_FLOATS * sizeof(float), cs>>>(
      x, cm, l, states, sc, static_cast<float*>(y), heads, s, p, n, nc, vec_p, vec_n);
  if ((rc = (int)cudaGetLastError()) != 0) return -rc;
  return DESIGN;
}
