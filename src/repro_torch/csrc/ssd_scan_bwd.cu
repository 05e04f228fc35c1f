// K10 — the SSD reverse-chunk adjoint, for sm_90a.
//
// Replaces: src/repro/kernels/ssd/ssd.py : ssd_scan_bwd (_ssd_bwd_body;
// the Pallas TPU kernel, whose grid walks the chunks in reverse with the
// adjoint state G = dL/dH carried in VMEM).
//
// Per chunk c, from the forward's chunk-initial state H_in and G_c, the
// adjoint of the chunk's final state, with decay_ij = exp(l_i - l_j)
// (j <= i, else 0), S = C B^T, M = decay o S, T = dy xdt^T, w_i = exp(l_i),
// v_j = exp(l_Q - l_j):
//   dxdt = M^T dy + (v o B) G^T
//   dC   = (decay o T) B + w o (dy H_in)
//   dB   = (decay o T)^T C + v o (xdt G)
//   dl_t = sum_{j < t <= i} M_ij T_ij            (a)
//        + sum_{i >= t} w_i C_i . (dy_i H_in)    (b)
//        + sum_{j < t} v_j B_j . (xdt_j G)       (c)
//        + exp(l_Q) <H_in, G>                     (d)
//   G_c  = exp(l_Q,c+1) G_c+1 + E_c+1,  E_c = sum_i w_i dy_i (x) C_i,  G_nc-1 = 0
// dB and dC per head (the caller sums them over heads: a fused atomic sum
// would round differently from the JAX package); dl with respect to the
// per-step log-decays.  A short last chunk is padded as in K9.
//
// What bounds it on the H100: bytes — xdt, dy and the states read, dxdt,
// dB and dC (per head) written, 459 MB at mamba2-780m (0.137 ms) against
// 19 GFLOP of fp32-accurate products (3xTF32 at 165 TFLOP/s: 0.117 ms).
// The TPU kernel carries G because its grid runs in order; here the
// adjoint runs as three launches (design "chunk-parallel"), K9's mirror:
//   1. per (batch, chunk) the head-shared scores S = C B^T, once for every
//      head, into a (batch, nc, Q, Q) buffer read through L2; and per
//      (batch, head, chunk) but the first, E_c into slot c - 1 of a
//      (batch, heads, nc, P, N) scratch;
//   2. per (batch, head) and group of 4 elements, in reverse over the
//      chunks: G_nc-1 = 0, G_c = exp(l_Q,c+1) G_c+1 + E_c+1, in place;
//   3. per (batch, head, chunk) the gradients.  One CTA owns all of P, so
//      dB, dC and d log a reduce over P inside it: no atomics, no partial
//      crosses CTAs.  dy and xdt are staged once (P up to 64; wider P is
//      walked in tiles of 64, with T summed over them first and dB, dC
//      finished in place by the CTA that wrote them); N is walked in tiles
//      of 32 with B, C, H_in and G; dxdt accumulates over the N tiles in
//      registers and is written once.  Term (a)'s column suffix sums and
//      (b)'s suffix and (c)'s prefix sums are warp scans.
// Every product is mma.sync m16n8k8 on TF32 operands split into a big
// part and a remainder (ssd_common.cuh); exp, the decays and the scans
// stay fp32 on the CUDA cores.  Tiles come by cp.async into swizzled
// shared memory; every scratch slot is written before it is read.
#include "ssd_common.cuh"

namespace {

using namespace ssd;

constexpr int DESIGN = 1;       // "chunk-parallel"
constexpr int UNROLL = 8;       // pass 2: chunks loaded ahead of the FMA chain
constexpr int NB = 32;          // pass 3: N tile

// pass 1: blocks [0, batch nc) the scores, the rest E_c of chunks 1 .. nc-1
__global__ void __launch_bounds__(THREADS, 3)
ssd_bwd_chunks(const float* __restrict__ dy, const float* __restrict__ bmat,
               const float* __restrict__ cmat, const float* __restrict__ lcum,
               float* __restrict__ gst, float* __restrict__ scores, int batch, int heads, int s,
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
  const int ci = 1 + (int)(id % (nc - 1)), t0 = ci * Q, bb = (int)(bh / heads);
  const long long pn = (long long)p_dim * n_dim;
  chunk_role(dy + (bh * s + t0) * p_dim, cmat + ((long long)bb * s + t0) * n_dim,
             lcum + bh * s + t0, gst + (bh * nc + ci - 1) * pn, min(Q, s - t0), p_dim, n_dim,
             vec_p, vec_n, false, smem);
}

// pass 2: G_nc-1 = 0, then G_c = exp(l_Q,c+1) G_c+1 + E_c+1 in place, in
// reverse over the chunks; a thread owns V elements of one (batch, head)'s G
template <int V>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_adjoints(float* __restrict__ gst, const float* __restrict__ lcum, int s, int nc,
                 long long pn, long long blocks_per_head) {
  const long long bh = blockIdx.x / blocks_per_head;
  const long long e = ((blockIdx.x % blocks_per_head) * THREADS + threadIdx.x) * V;
  if (e >= pn) return;
  float* base = gst + bh * nc * pn + e;
  const float* l = lcum + bh * s;
  Vec<V> g;
#pragma unroll
  for (int k = 0; k < V; ++k) g.v[k] = 0.f;
  store(base + (long long)(nc - 1) * pn, g);
  for (int c0 = nc - 2; c0 >= 0; c0 -= UNROLL) {
    Vec<V> f[UNROLL];
    float a[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (c0 - u >= 0) {
        f[u] = load<V>(base + (c0 - u) * pn);
        a[u] = expf(l[min((c0 - u + 1) * Q + Q - 1, s - 1)]);
      }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (c0 - u >= 0) {
        const int c = c0 - u;  // G_c from G_c+1 and E_c+1
#pragma unroll
        for (int k = 0; k < V; ++k) g.v[k] = fmaf(a[u], g.v[k], f[u].v[k]);
        store(base + c * pn, g);
      }
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// inclusive suffix sum over the lanes: lane l gets sum_{l' >= l} x_l'
__device__ __forceinline__ float warp_suffix(float x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_down_sync(0xffffffffu, x, o);
    if (lane + o < 32) x += y;
  }
  return x;
}

// inclusive prefix sum over the lanes: lane l gets sum_{l' <= l} x_l'
__device__ __forceinline__ float warp_prefix(float x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// pass 3 shared memory, in floats: dy, xdt (Q x PT); M, decay o T (Q x Q);
// the N tiles of B, C (Q x NB), H_in, G (PT x NB) and v o B (Q x NB) — Z =
// M o T lies over the B and C tiles before they are staged; l, w, v; term
// (a)'s partials per warp, (b)'s and (c)'s row sums, (d)'s per warp
constexpr int GRAD_FLOATS = 2 * Q * PT + 2 * Q * Q + 3 * Q * NB + 2 * PT * NB + 3 * Q +
                            8 * Q + 2 * Q + 8;

__global__ void __launch_bounds__(THREADS, 2)
ssd_bwd_grads(const float* __restrict__ xdt, const float* __restrict__ bmat,
              const float* __restrict__ cmat, const float* __restrict__ lcum,
              const float* __restrict__ states, const float* __restrict__ gst,
              const float* __restrict__ scores, const float* __restrict__ dy,
              float* __restrict__ dx, float* __restrict__ db, float* __restrict__ dc,
              float* __restrict__ dl, int heads, int s, int p_dim, int n_dim, int nc, int vec_p,
              int vec_n) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Smem<PT> ys{smem}, xs{smem + Q * PT};
  const Smem<Q> ms{smem + 2 * Q * PT}, dts{smem + 2 * Q * PT + Q * Q};
  float* tiles = smem + 2 * Q * PT + 2 * Q * Q;
  const Smem<NB> bt{tiles}, ct{tiles + Q * NB}, ht{tiles + 2 * Q * NB},
      gt{tiles + 2 * Q * NB + PT * NB}, bv{tiles + 2 * Q * NB + 2 * PT * NB};
  const Smem<Q> zs{tiles};
  float* ls = tiles + 3 * Q * NB + 2 * PT * NB;
  float* ws = ls + Q;
  float* vs = ws + Q;
  float* part = vs + Q;     // [warp][t]: term (a) over the warp's 8 columns
  float* up = part + 8 * Q;  // u_i = w_i C_i . (dy_i H_in)
  float* rp = up + Q;        // r_j = v_j B_j . (xdt_j G)
  float* red = rp + Q;       // [warp]: <H_in, G>

  const int tid = threadIdx.x, lane = tid & 31, warp = tid / 32;
  const long long bh = blockIdx.x / nc;
  const int ci = blockIdx.x % nc, bb = (int)(bh / heads);
  const int t0 = ci * Q, rows = min(Q, s - t0), np = (p_dim + PT - 1) / PT;
  const long long pn = (long long)p_dim * n_dim;
  const float* x_in = xdt + (bh * s + t0) * p_dim;
  const float* dy_in = dy + (bh * s + t0) * p_dim;
  const float* h_in = states + (bh * nc + ci) * pn;
  const float* g_in = gst + (bh * nc + ci) * pn;
  const float* b_in = bmat + ((long long)bb * s + t0) * n_dim;
  const float* c_in = cmat + ((long long)bb * s + t0) * n_dim;
  // warp blocks of the (Q, Q) and (Q, P) products: 32 x 16
  const int m0 = 32 * (warp & 1), n0 = 16 * (warp >> 1);

  if (tid < Q) ls[tid] = lcum[bh * s + t0 + min(tid, rows - 1)];
  stage<Q, Q>(ms, scores + ((long long)bb * nc + ci) * Q * Q, Q, Q, Q, true);

  // T = dy xdt^T over all of P
  float acc_t[2][2][4];
  zero(acc_t);
  for (int pc = 0; pc < np; ++pc) {
    const int pv = min(PT, p_dim - pc * PT);
    if (pc > 0) __syncthreads();  // the previous P tile is no longer read
    stage<Q, PT>(ys, dy_in + pc * PT, p_dim, rows, pv, vec_p);
    stage<Q, PT>(xs, x_in + pc * PT, p_dim, rows, pv, vec_p);
    cp_async_wait();
    __syncthreads();
    gemm<2, 2, false, true>(acc_t, ys, xs, m0, n0, 0, round8(pv));
  }
  const float ltot = ls[Q - 1];
  if (tid < Q) {
    ws[tid] = expf(ls[tid]);
    vs[tid] = expf(ltot - ls[tid]);
  }
  for (int e = tid; e < Q * Q; e += THREADS) {  // M = decay o S, masked inside the exp
    const int i = e / Q, j = e % Q;
    ms(i, j) = i >= j ? expf(ls[i] - ls[j]) * ms(i, j) : 0.f;
  }
  __syncthreads();
  // decay o T, and Z = M o T
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = acc_row(m0, i, e), c = acc_col(n0, j, e);
        const float t = acc_t[i][j][e];
        dts(r, c) = r >= c ? expf(ls[r] - ls[c]) * t : 0.f;
        zs(r, c) = ms(r, c) * t;
      }
  __syncthreads();
  // term (a): each warp's 8 columns j; lane l holds rows 2l and 2l + 1.
  // P1[t][j] = sum_{i >= t} Z_ij by a suffix scan down the column, then
  // dl_a[t] = sum_{j < t} P1[t][j], per warp here and over warps at the end
  {
    float a0 = 0.f, a1 = 0.f;
    for (int jj = 0; jj < 8; ++jj) {
      const int j = 8 * warp + jj;
      const float z0 = zs(2 * lane, j), z1 = zs(2 * lane + 1, j);
      const float p1 = warp_suffix(z0 + z1);  // rows >= 2 lane
      if (j < 2 * lane) a0 += p1;
      if (j < 2 * lane + 1) a1 += p1 - z0;
    }
    part[warp * Q + 2 * lane] = a0;
    part[warp * Q + 2 * lane + 1] = a1;
  }

  // the N tiles: warps 0-3 take dC and u_i, warps 4-7 dB and r_j, 16 rows each
  const bool dc_warp = warp < 4;
  const int mr = 16 * (warp & 3);
  float rowsum[2] = {0.f, 0.f}, dsum = 0.f;  // this thread's rows of u or r; <H_in, G>
  for (int pc = 0; pc < np; ++pc) {
    const int p0 = pc * PT, pv = min(PT, p_dim - p0), kp = round8(pv);
    if (np > 1) {
      __syncthreads();  // the previous P tile is no longer read
      stage<Q, PT>(ys, dy_in + p0, p_dim, rows, pv, vec_p);
      stage<Q, PT>(xs, x_in + p0, p_dim, rows, pv, vec_p);
      cp_async_wait();
      __syncthreads();
    }
    const bool busy = n0 < pv;
    // dxdt = M^T dy + (v o B) G^T, the second term summed over the N tiles
    float acc_dx[2][2][4];
    zero(acc_dx);
    // M^T dy: M is lower-triangular, so row j reads i >= j >= m0
    if (busy) gemm<2, 2, true, false>(acc_dx, ms, ys, m0, n0, m0, Q);
    for (int k0 = 0; k0 < n_dim; k0 += NB) {
      const int nv = min(NB, n_dim - k0), kn = round8(nv);
      __syncthreads();  // Z and the previous N tile are no longer read
      stage<Q, NB>(bt, b_in + k0, n_dim, rows, nv, vec_n);
      stage<Q, NB>(ct, c_in + k0, n_dim, rows, nv, vec_n);
      stage<PT, NB>(ht, h_in + (long long)p0 * n_dim + k0, n_dim, pv, nv, vec_n);
      stage<PT, NB>(gt, g_in + (long long)p0 * n_dim + k0, n_dim, pv, nv, vec_n);
      cp_async_wait();
      __syncthreads();
      for (int e = tid; e < Q * NB; e += THREADS) {
        const int j = e / NB, n = e % NB;
        bv(j, n) = vs[j] * bt(j, n);
      }
      __syncthreads();
      if (busy) gemm<2, 2, false, true>(acc_dx, bv, gt, m0, n0, 0, kn);
      // dC = w o (dy H_in) + (decay o T) B, or dB = v o (xdt G) + (decay o T)^T C;
      // u_i, r_j from the first term
      float acc[1][4][4];
      zero(acc);
      if (dc_warp) {
        gemm<1, 4, false, false>(acc, ys, ht, mr, 0, 0, kp);
      } else {
        gemm<1, 4, false, false>(acc, xs, gt, mr, 0, 0, kp);
      }
      const float* scale = dc_warp ? ws : vs;
      const Smem<NB> other = dc_warp ? ct : bt;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = acc_row(mr, 0, e), c = acc_col(0, j, e);
          acc[0][j][e] *= scale[r];
          rowsum[e >> 1] = fmaf(acc[0][j][e], other(r, c), rowsum[e >> 1]);
        }
      if (pc == 0) {
        if (dc_warp) {
          gemm<1, 4, false, false>(acc, dts, bt, mr, 0, 0, mr + 16);
        } else {  // (decay o T) is lower-triangular: row j reads i >= j >= mr
          gemm<1, 4, true, false>(acc, dts, ct, mr, 0, mr, Q);
        }
      }
      float* grad = dc_warp ? dc : db;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int r = acc_row(mr, 0, e), c = acc_col(0, j, e);
          if (r >= rows) continue;
          float* at = grad + (bh * s + t0 + r) * n_dim + k0 + c;
          if (pc > 0) {  // finish what the first P tile wrote
            if (c < nv) acc[0][j][e] += at[0];
            if (c + 1 < nv) acc[0][j][e + 1] += at[1];
          }
          store_pair(at, acc[0][j][e], acc[0][j][e + 1], c < nv, c + 1 < nv, n_dim % 2 == 0);
        }
      for (int e = tid; e < PT * NB; e += THREADS)  // term (d)
        dsum = fmaf(ht(e / NB, e % NB), gt(e / NB, e % NB), dsum);
    }
    if (busy) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            const int r = acc_row(m0, i, e), p = acc_col(n0, j, e);
            if (r < rows)
              store_pair(dx + (bh * s + t0 + r) * p_dim + p0 + p, acc_dx[i][j][e],
                         acc_dx[i][j][e + 1], p < pv, p + 1 < pv, p_dim % 2 == 0);
          }
    }
  }

  // the row sums of (b) and (c) over the 4 lanes of a row
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) rowsum[k] += __shfl_xor_sync(0xffffffffu, rowsum[k], o);
  if ((lane & 3) == 0) {
    float* dst = dc_warp ? up : rp;
    dst[mr + (lane >> 2)] = rowsum[0];
    dst[mr + (lane >> 2) + 8] = rowsum[1];
  }
  dsum = warp_sum(dsum);
  if (lane == 0) red[warp] = dsum;
  __syncthreads();
  if (warp == 0) {
    const int i0 = 2 * lane, i1 = i0 + 1;
    const float u0 = up[i0], u1 = up[i1], r0 = rp[i0], r1 = rp[i1];
    const float b0 = warp_suffix(u0 + u1), b1 = b0 - u0;      // (b): sum_{i >= t} u_i
    const float c1 = warp_prefix(r0 + r1) - r1, c0 = c1 - r0;  // (c): sum_{j < t} r_j
    float d_all = 0.f, ta0 = 0.f, ta1 = 0.f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) {
      d_all += red[w];
      ta0 += part[w * Q + i0];
      ta1 += part[w * Q + i1];
    }
    const float dterm = expf(ltot) * d_all;
    if (i0 < rows) dl[bh * s + t0 + i0] = ta0 + b0 + c0 + dterm;
    if (i1 < rows) dl[bh * s + t0 + i1] = ta1 + b1 + c1 + dterm;
  }
}

}  // namespace

// xdt, dy, dx (batch, heads, s, P); b, c (batch, s, N); lcum, dl (batch,
// heads, s); states (batch, heads, ceil(s / 64), P, N); db, dc (batch,
// heads, s, N); gst the adjoint states, a scratch shaped like states;
// scores a (batch, ceil(s / 64), 64, 64) scratch; all fp32, contiguous.
// Returns the design's code (1, chunk-parallel), or minus a cudaError.
extern "C" int ssd_scan_bwd(const void* xdt, const void* b, const void* c, const void* lcum,
                            const void* states, const void* dy, void* dx, void* db, void* dc,
                            void* dl, void* gst, void* scores, int batch, int heads, int s,
                            int p, int n, void* stream) {
  if (batch <= 0 || heads <= 0 || s <= 0 || p <= 0) return DESIGN;
  if (n <= 0) return -(int)cudaErrorInvalidValue;
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int nc = (s + Q - 1) / Q;
  const long long bhn = (long long)batch * heads, pn = (long long)p * n;
  const int vec_p = p % 4 == 0 && aligned16(xdt) && aligned16(dy);
  const int vec_n = n % 4 == 0 && aligned16(b) && aligned16(c) && aligned16(states);
  const float* x = static_cast<const float*>(xdt);
  const float* bm = static_cast<const float*>(b);
  const float* cm = static_cast<const float*>(c);
  const float* l = static_cast<const float*>(lcum);
  const float* g_out = static_cast<const float*>(dy);
  float* g = static_cast<float*>(gst);
  float* sc = static_cast<float*>(scores);
  int rc = smem_attr((const void*)ssd_bwd_chunks, PASS1_FLOATS);
  if (rc == 0) rc = smem_attr((const void*)ssd_bwd_grads, GRAD_FLOATS);
  if (rc != 0) return -rc;

  const long long blocks1 = (long long)batch * nc + bhn * (nc - 1);
  ssd_bwd_chunks<<<(unsigned)blocks1, THREADS, PASS1_FLOATS * sizeof(float), cs>>>(
      g_out, bm, cm, l, g, sc, batch, heads, s, p, n, nc, vec_p, vec_n);
  if ((rc = (int)cudaGetLastError()) != 0) return -rc;

  if (pn % 4 == 0) {
    const long long per_head = (pn / 4 + THREADS - 1) / THREADS;
    ssd_bwd_adjoints<4><<<(unsigned)(bhn * per_head), THREADS, 0, cs>>>(g, l, s, nc, pn,
                                                                         per_head);
  } else {
    const long long per_head = (pn + THREADS - 1) / THREADS;
    ssd_bwd_adjoints<1><<<(unsigned)(bhn * per_head), THREADS, 0, cs>>>(g, l, s, nc, pn,
                                                                         per_head);
  }
  if ((rc = (int)cudaGetLastError()) != 0) return -rc;

  ssd_bwd_grads<<<(unsigned)(bhn * nc), THREADS, GRAD_FLOATS * sizeof(float), cs>>>(
      x, bm, cm, l, static_cast<const float*>(states), g, sc, g_out, static_cast<float*>(dx),
      static_cast<float*>(db), static_cast<float*>(dc), static_cast<float*>(dl), heads, s, p, n,
      nc, vec_p, vec_n);
  if ((rc = (int)cudaGetLastError()) != 0) return -rc;
  return DESIGN;
}
