// K9 — the Mamba-2 SSD chunked scan, for sm_90a.
//
// Replaces: src/repro/kernels/ssd/ssd.py : ssd_scan (_ssd_body; the
// Pallas TPU kernel, grid (batch, heads, chunks) with the (P, N) state
// carried across chunks in VMEM).
//
//   H_t = exp(l_t) H_{t-1} + xdt_t (x) B_t,   y_t = C_t . H_t
//
// chunk by chunk, as the TPU kernel computes it: with l the inclusive
// within-chunk cumsum of the log-decays (computed outside, as the JAX
// package does),
//   y_i  = sum_{j <= i} exp(l_i - l_j) (C_i . B_j) xdt_j + exp(l_i) C_i . H_in
//   H_out = exp(l_Q) H_in + sum_j exp(l_Q - l_j) xdt_j (x) B_j
// with the decay masked inside the exp.  A short last chunk is padded
// with identity decay and zero input (l repeats its last value).
//
// What bounds it on the H100: the recurrence's own work, 4 P N flops a
// step a head, at the fp32 rate (mamba2-780m: 6.4 GFLOP against 106 MB).
// Design of this first version (CUDA-core fp32 FMA, chunk Q = 64):
//   * one CTA per (P tile of 16 columns, head, batch) walks the chunks in
//     order, so that the grid fills the card at mamba2's width (P 64 ->
//     4 tiles x 48 heads x 2 = 384 CTAs, where one CTA per (batch, head)
//     would be 96 for 132 SMs);
//   * each chunk streams C and B through N tiles of 32 columns, so any N
//     runs: the scores C B^T (Q x Q) and the inter-chunk C H_in^T
//     accumulate in registers over the tiles, and each tile of the state
//     is updated as soon as its B tile is in shared memory;
//   * the state lives in global memory, one (P, N) fp32 tile per head
//     (L2-resident), read and rewritten once per chunk: with
//     return_states it is carried through the chunk checkpoints the
//     backward kernel restarts from, else through a scratch tile;
//   * every CTA reads B and C itself (through L2) for every head and P
//     tile — the head-shared operand the paper would fetch once and
//     multicast.  Later work: a thread-block cluster over heads fed by
//     one TMA multicast load per B/C chunk, and tensor-core products.
// Shared memory: 11,152 floats (44.6 KB), static.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int Q = 64;   // chunk
constexpr int PT = 16;  // columns of P per CTA
constexpr int NT = 32;  // columns of N per tile
constexpr int LQ = Q + 1, LN = NT + 1, LP = PT + 1;

__global__ void __launch_bounds__(THREADS)
ssd_fwd_kernel(const float* __restrict__ xdt, const float* __restrict__ bmat,
               const float* __restrict__ cmat, const float* __restrict__ lcum,
               float* __restrict__ y, float* __restrict__ st, int return_states, int heads,
               int s, int p_dim, int n_dim) {
  __shared__ float cs[Q * LN];   // C tile (Q x NT)
  __shared__ float bs[Q * LN];   // B tile (Q x NT)
  __shared__ float hs[PT * LN];  // state tile (PT x NT), chunk-initial
  __shared__ float ms[Q * LQ];   // M = masked decay * scores (Q x Q)
  __shared__ float xs[Q * LP];   // xdt (Q x PT)
  __shared__ float xw[Q * LP];   // xdt_j exp(l_Q - l_j)
  __shared__ float ls[Q];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tx = tid % 16, ty = tid / 16;
  const int p0 = blockIdx.x * PT, hh = blockIdx.y, bb = blockIdx.z;
  const long long bh = (long long)bb * heads + hh;
  const int nc = (s + Q - 1) / Q;
  const long long pn = (long long)p_dim * n_dim;
  float* st_head = st + bh * (return_states ? nc : 1) * pn;

  for (int ci = 0; ci < nc; ++ci) {
    const int t0 = ci * Q, rows = min(Q, s - t0);
    const bool has_state = ci > 0, update = ci + 1 < nc;
    const float* st_in = st_head + (return_states ? ci : 0) * pn;
    float* st_out = st_head + (return_states ? ci + 1 : 0) * pn;

    __syncthreads();  // the previous chunk's tiles are no longer read
    if (tid < Q) ls[tid] = lcum[bh * s + t0 + min(tid, rows - 1)];
    for (int e = tid; e < Q * PT; e += THREADS) {
      const int j = e / PT, p = e % PT;
      xs[j * LP + p] = (j < rows && p0 + p < p_dim)
                           ? xdt[(bh * s + t0 + j) * p_dim + p0 + p] : 0.f;
    }
    __syncthreads();
    const float ltot = ls[Q - 1];
    for (int e = tid; e < Q * PT; e += THREADS) {
      const int j = e / PT, p = e % PT;
      xw[j * LP + p] = xs[j * LP + p] * expf(ltot - ls[j]);
    }

    float sc[4][4], yi[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      yi[a] = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[a][c] = 0.f;
    }

    for (int n0 = 0; n0 < n_dim; n0 += NT) {
      __syncthreads();  // the previous N tile is no longer read
      for (int e = tid; e < Q * NT; e += THREADS) {
        const int i = e / NT, n = e % NT;
        const bool ok = i < rows && n0 + n < n_dim;
        const long long at = ((long long)bb * s + t0 + i) * n_dim + n0 + n;
        cs[i * LN + n] = ok ? cmat[at] : 0.f;
        bs[i * LN + n] = ok ? bmat[at] : 0.f;
      }
      for (int e = tid; e < PT * NT; e += THREADS) {
        const int p = e / NT, n = e % NT;
        const bool ok = has_state && p0 + p < p_dim && n0 + n < n_dim;
        hs[p * LN + n] = ok ? st_in[(long long)(p0 + p) * n_dim + n0 + n] : 0.f;
        if (return_states && ci == 0 && p0 + p < p_dim && n0 + n < n_dim)
          st_head[(long long)(p0 + p) * n_dim + n0 + n] = 0.f;  // chunk 0 starts from 0
      }
      __syncthreads();

      // scores C_i . B_j (rows ty + 16a, columns tx + 16c) and C_i . H_in[p]
#pragma unroll 4
      for (int n = 0; n < NT; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = cs[(ty + 16 * a) * LN + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = bs[(tx + 16 * c) * LN + n];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) sc[a][c] = fmaf(cv[a], bv[c], sc[a][c]);
        if (has_state) {
          const float hv = hs[tx * LN + n];
#pragma unroll
          for (int a = 0; a < 4; ++a) yi[a] = fmaf(cs[(ty + 16 * a) * LN + n], hv, yi[a]);
        }
      }

      // this tile of the next chunk's state: exp(l_Q) H_in + sum_j xw_j (x) B_j
      if (update) {
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int p = warp + 8 * k, n = lane;
          float acc = 0.f;
#pragma unroll 8
          for (int j = 0; j < Q; ++j) acc = fmaf(xw[j * LP + p], bs[j * LN + n], acc);
          if (p0 + p < p_dim && n0 + n < n_dim)
            st_out[(long long)(p0 + p) * n_dim + n0 + n] = expf(ltot) * hs[p * LN + n] + acc;
        }
      }
    }

    // M_ij = exp(l_i - l_j) (C_i . B_j) for j <= i, else 0
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ty + 16 * a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tx + 16 * c;
        ms[i * LQ + j] = i >= j ? expf(ls[i] - ls[j]) * sc[a][c] : 0.f;
      }
    }
    __syncthreads();

    // y_i = sum_{j <= i} M_ij xdt_j + exp(l_i) C_i . H_in
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ty + 16 * a, p = tx;
      float acc = 0.f;
      for (int j = 0; j <= i; ++j) acc = fmaf(ms[i * LQ + j], xs[j * LP + p], acc);
      const float out = acc + expf(ls[i]) * yi[a];
      if (i < rows && p0 + p < p_dim) y[(bh * s + t0 + i) * p_dim + p0 + p] = out;
    }
  }
}

}  // namespace

// xdt, y (batch, heads, s, P); b, c (batch, s, N); lcum (batch, heads, s);
// all fp32, contiguous.  st: with return_states the chunk-initial states
// (batch, heads, ceil(s / 64), P, N), else a (batch, heads, P, N) scratch.
extern "C" int ssd_scan_fwd(const void* xdt, const void* b, const void* c, const void* lcum,
                            void* y, void* st, int return_states, int batch, int heads, int s,
                            int p, int n, void* stream) {
  if (batch <= 0 || heads <= 0 || s <= 0 || p <= 0) return 0;
  if (n <= 0 || batch > 65535 || heads > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((p + PT - 1) / PT, heads, batch);
  ssd_fwd_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xdt), static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<const float*>(lcum), static_cast<float*>(y), static_cast<float*>(st),
      return_states, heads, s, p, n);
  return (int)cudaGetLastError();
}
