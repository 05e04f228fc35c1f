// K10 — the SSD reverse-chunk adjoint, for sm_90a.
//
// Replaces: src/repro/kernels/ssd/ssd.py : ssd_scan_bwd (_ssd_bwd_body;
// the Pallas TPU kernel, whose grid walks the chunks in reverse with the
// adjoint state G = dL/dH carried in VMEM).
//
// Per chunk, last first, from the forward's chunk-initial state H_in and
// G, the adjoint of the chunk's final state (0 for the last chunk), with
// decay_ij = exp(l_i - l_j) (j <= i, else 0), M = decay * (C B^T),
// T = dy xdt^T, w_i = exp(l_i), v_j = exp(l_Q - l_j):
//   dxdt_j = sum_i M_ij dy_i + v_j (B_j . G)
//   dC_i   = sum_j decay_ij T_ij B_j + w_i dy_i H_in
//   dB_j   = sum_i decay_ij T_ij C_i + v_j xdt_j G
//   dl_t   = sum_{j < t <= i} M_ij T_ij            (a)
//          + sum_{i >= t} w_i C_i . (dy_i H_in)    (b)
//          + sum_{j < t} v_j B_j . (xdt_j G)       (c)
//          + exp(l_Q) <H_in, G>                     (d)
//   G     <- exp(l_Q) G + sum_i w_i dy_i (x) C_i
// dB and dC per head (the caller sums them over heads: a fused atomic sum
// would round differently from the JAX package); dl with respect to the
// per-step log-decays.  A short last chunk is padded as in K9.
//
// What bounds it on the H100: operations — the recurrence's adjoint, 12
// P N flops a step a head (the carried G, dxdt, dB, dC, d log a and the
// recomputed state, 2 P N each), at the fp32 rate.  Design of this first
// version (CUDA-core fp32 FMA, chunk Q = 64):
//   * one CTA per (batch, head) walks the chunks in reverse: T, term (a)
//     and the dB / dC sums reduce over all of P, so one CTA owns all of P
//     and no partial sum crosses CTAs (no atomics, no race, nothing
//     dropped).  At mamba2-780m's width that is 96 CTAs for 132 SMs;
//   * per chunk: the scores stream C and B through N tiles of 32
//     columns; T and dxdt's first term stream dy and xdt through P tiles
//     of 16; then for every (N tile, P tile) pair the state tiles H_in and
//     G are staged once and every term that needs them accumulates
//     (dB / dC over P in registers, dxdt over N in global memory, which
//     only this CTA touches), and the tile of G is rewritten in place;
//   * term (a) is a column suffix sum of Z = M T in shared memory, then
//     a row sum below the diagonal; (b) a suffix and (c) an exclusive
//     prefix sum of per-row dot products reduced by warp shuffles;
//   * G lives in a (P, N) fp32 scratch tile per head, L2-resident.
// Dynamic shared memory: 16,168 floats (64.7 KB).
// Later work: split P over a cluster with a DSMEM reduction, tensor-core
// products, and B / C multicast over heads as in K9.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int Q = 64;   // chunk
constexpr int PT = 16;  // P tile
constexpr int NT = 32;  // N tile
constexpr int LQ = Q + 1, LN = NT + 1, LP = PT + 1;
constexpr int SMEM_FLOATS = 2 * Q * LQ + 2 * Q * LN + 2 * Q * LP + 2 * PT * LN + 6 * Q + 8;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(THREADS)
ssd_bwd_kernel(const float* __restrict__ xdt, const float* __restrict__ bmat,
               const float* __restrict__ cmat, const float* __restrict__ lcum,
               const float* __restrict__ states, const float* __restrict__ dy,
               float* __restrict__ dx, float* __restrict__ db, float* __restrict__ dc,
               float* __restrict__ dl, float* __restrict__ carry, int heads, int s,
               int p_dim, int n_dim) {
  extern __shared__ float smem[];
  float* mz = smem;               // M, then Z = M T, then its column suffix sums (Q x Q)
  float* dts = mz + Q * LQ;       // decay * T (Q x Q)
  float* cs = dts + Q * LQ;       // C tile (Q x NT)
  float* bs = cs + Q * LN;        // B tile (Q x NT)
  float* ys = bs + Q * LN;        // dy tile (Q x PT)
  float* xs = ys + Q * LP;        // xdt tile (Q x PT)
  float* gs = xs + Q * LP;        // G tile (PT x NT)
  float* hs = gs + PT * LN;       // H_in tile (PT x NT)
  float* ls = hs + PT * LN;       // l
  float* wv = ls + Q;             // exp(l_i)
  float* vv = wv + Q;             // exp(l_Q - l_j)
  float* us = vv + Q;             // u_i = w_i C_i . (dy_i H_in), term (b)
  float* rs = us + Q;             // r_j = v_j B_j . (xdt_j G), term (c)
  float* ta = rs + Q;             // term (a)
  float* red = ta + Q;            // block reduction of term (d)

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tx = tid % 16, ty = tid / 16;
  const int hh = blockIdx.x, bb = blockIdx.y;
  const long long bh = (long long)bb * heads + hh;
  const int nc = (s + Q - 1) / Q;
  const long long pn = (long long)p_dim * n_dim;
  float* g_head = carry + bh * pn;

  for (int ci = nc - 1; ci >= 0; --ci) {
    const int t0 = ci * Q, rows = min(Q, s - t0);
    const bool first = ci == nc - 1;  // G = 0: nothing follows the last chunk
    const float* h_in = states + (bh * nc + ci) * pn;

    __syncthreads();  // the previous chunk's tiles are no longer read
    if (tid < Q) {
      ls[tid] = lcum[bh * s + t0 + min(tid, rows - 1)];
      us[tid] = 0.f;
      rs[tid] = 0.f;
    }
    __syncthreads();
    const float ltot = ls[Q - 1];
    if (tid < Q) {
      wv[tid] = expf(ls[tid]);
      vv[tid] = expf(ltot - ls[tid]);
    }

    // scores C_i . B_j over N tiles (rows ty + 16a, columns tx + 16c)
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
    for (int n0 = 0; n0 < n_dim; n0 += NT) {
      __syncthreads();
      for (int e = tid; e < Q * NT; e += THREADS) {
        const int i = e / NT, n = e % NT;
        const bool ok = i < rows && n0 + n < n_dim;
        const long long at = ((long long)bb * s + t0 + i) * n_dim + n0 + n;
        cs[i * LN + n] = ok ? cmat[at] : 0.f;
        bs[i * LN + n] = ok ? bmat[at] : 0.f;
      }
      __syncthreads();
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
          for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(cv[a], bv[c], acc[a][c]);
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ty + 16 * a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tx + 16 * c;
        mz[i * LQ + j] = i >= j ? expf(ls[i] - ls[j]) * acc[a][c] : 0.f;
        acc[a][c] = 0.f;  // now T
      }
    }

    // T_ij = dy_i . xdt_j and dxdt_j = sum_i M_ij dy_i, over P tiles
    for (int q0 = 0; q0 < p_dim; q0 += PT) {
      __syncthreads();  // M is written; the previous P tile is no longer read
      for (int e = tid; e < Q * PT; e += THREADS) {
        const int i = e / PT, p = e % PT;
        const bool ok = i < rows && q0 + p < p_dim;
        const long long at = (bh * s + t0 + i) * p_dim + q0 + p;
        ys[i * LP + p] = ok ? dy[at] : 0.f;
        xs[i * LP + p] = ok ? xdt[at] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int p = 0; p < PT; ++p) {
        float yv[4], xv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) yv[a] = ys[(ty + 16 * a) * LP + p];
#pragma unroll
        for (int c = 0; c < 4; ++c) xv[c] = xs[(tx + 16 * c) * LP + p];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(yv[a], xv[c], acc[a][c]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int j = ty + 16 * a, p = tx;
        float sum = 0.f;
        for (int i = j; i < Q; ++i) sum = fmaf(mz[i * LQ + j], ys[i * LP + p], sum);
        if (j < rows && q0 + p < p_dim) dx[(bh * s + t0 + j) * p_dim + q0 + p] = sum;
      }
    }
    __syncthreads();  // every read of M is done

    // decay * T, and Z = M * T in place of M
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ty + 16 * a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tx + 16 * c;
        dts[i * LQ + j] = i >= j ? expf(ls[i] - ls[j]) * acc[a][c] : 0.f;
        mz[i * LQ + j] *= acc[a][c];
      }
    }
    __syncthreads();
    // term (a): P1[t][j] = sum_{i >= t} Z_ij (column suffix sums), then
    // dl_a[t] = sum_{j < t} P1[t][j]
    if (tid < Q) {
      float run = 0.f;
      for (int i = Q - 1; i >= 0; --i) {
        run += mz[i * LQ + tid];
        mz[i * LQ + tid] = run;
      }
    }
    __syncthreads();
    if (tid < Q) {
      float sum = 0.f;
      for (int j = 0; j < tid; ++j) sum += mz[tid * LQ + j];
      ta[tid] = sum;
    }

    // every (N tile, P tile) pair: the terms that read H_in and G
    float d_part = 0.f;  // this thread's share of <H_in, G>
    for (int n0 = 0; n0 < n_dim; n0 += NT) {
      __syncthreads();
      for (int e = tid; e < Q * NT; e += THREADS) {
        const int i = e / NT, n = e % NT;
        const bool ok = i < rows && n0 + n < n_dim;
        const long long at = ((long long)bb * s + t0 + i) * n_dim + n0 + n;
        cs[i * LN + n] = ok ? cmat[at] : 0.f;
        bs[i * LN + n] = ok ? bmat[at] : 0.f;
      }
      float dyh[Q / 8], xg[Q / 8];  // rows warp + 8k, column lane: (dy H_in), (xdt G)
#pragma unroll
      for (int k = 0; k < Q / 8; ++k) dyh[k] = xg[k] = 0.f;

      for (int q0 = 0; q0 < p_dim; q0 += PT) {
        __syncthreads();
        for (int e = tid; e < Q * PT; e += THREADS) {
          const int i = e / PT, p = e % PT;
          const bool ok = i < rows && q0 + p < p_dim;
          const long long at = (bh * s + t0 + i) * p_dim + q0 + p;
          ys[i * LP + p] = ok ? dy[at] : 0.f;
          xs[i * LP + p] = ok ? xdt[at] : 0.f;
        }
        for (int e = tid; e < PT * NT; e += THREADS) {
          const int p = e / NT, n = e % NT;
          const bool ok = q0 + p < p_dim && n0 + n < n_dim;
          const long long at = (long long)(q0 + p) * n_dim + n0 + n;
          hs[p * LN + n] = ok ? h_in[at] : 0.f;
          gs[p * LN + n] = ok && !first ? g_head[at] : 0.f;
        }
        __syncthreads();

#pragma unroll 4
        for (int p = 0; p < PT; ++p) {
          const float hv = hs[p * LN + lane], gv = gs[p * LN + lane];
#pragma unroll
          for (int k = 0; k < Q / 8; ++k) {
            const int i = warp + 8 * k;
            dyh[k] = fmaf(ys[i * LP + p], hv, dyh[k]);
            xg[k] = fmaf(xs[i * LP + p], gv, xg[k]);
          }
        }
        // dxdt_j += v_j (B_j . G_p) over this N tile
        if (!first) {
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int j = ty + 16 * a, p = tx;
            float sum = 0.f;
#pragma unroll 8
            for (int n = 0; n < NT; ++n) sum = fmaf(bs[j * LN + n], gs[p * LN + n], sum);
            if (j < rows && q0 + p < p_dim) dx[(bh * s + t0 + j) * p_dim + q0 + p] += vv[j] * sum;
          }
        }
        // <H_in, G>, and this tile of the previous chunk's G
#pragma unroll
        for (int k = 0; k < PT / 8; ++k) {
          const int p = warp + 8 * k, n = lane;
          const float g = gs[p * LN + n];
          d_part = fmaf(hs[p * LN + n], g, d_part);
          if (ci > 0 && q0 + p < p_dim && n0 + n < n_dim) {
            float sum = 0.f;
#pragma unroll 8
            for (int i = 0; i < Q; ++i) sum = fmaf(ys[i * LP + p] * wv[i], cs[i * LN + n], sum);
            g_head[(long long)(q0 + p) * n_dim + n0 + n] = expf(ltot) * g + sum;
          }
        }
      }

      // dC_i = sum_j decay_ij T_ij B_j + w_i (dy_i H_in); dB_j likewise;
      // the row sums of terms (b) and (c) over this N tile
#pragma unroll
      for (int k = 0; k < Q / 8; ++k) {
        const int i = warp + 8 * k, n = lane;
        const float dc2 = wv[i] * dyh[k], db2 = vv[i] * xg[k];
        const float u = warp_sum(cs[i * LN + n] * dc2);
        const float r = warp_sum(bs[i * LN + n] * db2);
        if (lane == 0) {
          us[i] += u;
          rs[i] += r;
        }
        float sc = 0.f, sb = 0.f;
        for (int j = 0; j <= i; ++j) sc = fmaf(dts[i * LQ + j], bs[j * LN + n], sc);
        for (int j = i; j < Q; ++j) sb = fmaf(dts[j * LQ + i], cs[j * LN + n], sb);
        if (i < rows && n0 + n < n_dim) {
          const long long at = (bh * s + t0 + i) * n_dim + n0 + n;
          dc[at] = sc + dc2;
          db[at] = sb + db2;
        }
      }
    }

    // term (d): <H_in, G> over the block
    d_part = warp_sum(d_part);
    if (lane == 0) red[warp] = d_part;
    __syncthreads();
    if (tid < Q) {
      float d_all = 0.f;
      for (int k = 0; k < THREADS / 32; ++k) d_all += red[k];
      float suffix_u = 0.f, prefix_r = 0.f;
      for (int i = tid; i < Q; ++i) suffix_u += us[i];
      for (int j = 0; j < tid; ++j) prefix_r += rs[j];
      const float total = ta[tid] + suffix_u + prefix_r + expf(ltot) * d_all;
      if (tid < rows) dl[bh * s + t0 + tid] = total;
    }
  }
}

}  // namespace

// xdt, dy, dx (batch, heads, s, P); b, c (batch, s, N); lcum, dl (batch,
// heads, s); states (batch, heads, ceil(s / 64), P, N); db, dc (batch,
// heads, s, N); carry a (batch, heads, P, N) scratch; all fp32, contiguous.
extern "C" int ssd_scan_bwd(const void* xdt, const void* b, const void* c, const void* lcum,
                            const void* states, const void* dy, void* dx, void* db, void* dc,
                            void* dl, void* carry, int batch, int heads, int s, int p, int n,
                            void* stream) {
  if (batch <= 0 || heads <= 0 || s <= 0 || p <= 0) return 0;
  if (n <= 0 || batch > 65535 || heads > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = SMEM_FLOATS * sizeof(float);
  int rc = (int)cudaFuncSetAttribute(ssd_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)smem);
  if (rc != 0) return rc;
  dim3 grid(heads, batch);
  ssd_bwd_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xdt), static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<const float*>(lcum), static_cast<const float*>(states),
      static_cast<const float*>(dy), static_cast<float*>(dx), static_cast<float*>(db),
      static_cast<float*>(dc), static_cast<float*>(dl), static_cast<float*>(carry), heads, s, p,
      n);
  return (int)cudaGetLastError();
}
