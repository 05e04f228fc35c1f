// What K9 (ssd_scan_fwd.cu) and K10 (ssd_scan_bwd.cu) share: the chunk
// Q, swizzled shared-memory tiles filled by cp.async, fp32-accurate
// products on the tensor cores in 3xTF32 (mma.sync m16n8k8), and the two
// roles of each kernel's first launch — the head-shared scores S = C B^T
// of one (batch, chunk), and one (batch, head, chunk)'s contribution
// (x o scale)^T Z to the state (K9) or the adjoint state (K10) it passes on.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ssd {

constexpr int Q = 64;         // chunk
constexpr int THREADS = 256;  // 8 warps
constexpr int PT = 64;        // P tile: a (Q, P) tile of xdt or dy, a (P, *) tile of a state
constexpr int KT = 64;        // N tile of the first launch's roles and of K9's output pass

__host__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ int round8(int k) { return (k + 7) & ~7; }

// a launch's dynamic shared memory above the 48 KB default
__host__ inline int smem_attr(const void* fn, int floats) {
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   floats * (int)sizeof(float));
}

// V consecutive floats of a state, loaded and stored as one (V 4: 16 bytes)
template <int V>
struct Vec {
  float v[V];
};

template <int V>
__device__ __forceinline__ Vec<V> load(const float* p) {
  Vec<V> r;
  if constexpr (V == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    r.v[0] = x.x, r.v[1] = x.y, r.v[2] = x.z, r.v[3] = x.w;
  } else {
    r.v[0] = *p;
  }
  return r;
}

template <int V>
__device__ __forceinline__ void store(float* p, const Vec<V>& r) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r.v[0], r.v[1], r.v[2], r.v[3]);
  } else {
    *p = r.v[0];
  }
}

// A shared-memory matrix of LD floats a row (LD a multiple of 32); element
// (r, c) lives at r * LD + (c ^ swz(r)), swz(r) = (r & 3) << 3 | (r & 4).
// The XOR moves whole 4-float groups, so 16-byte copies stay whole, and an
// mma.m16n8k8 fragment load — 8 rows x 4 columns, or 4 rows x 8 columns
// when the operand is read transposed — hits 32 distinct banks either way.
template <int LD>
struct Smem {
  static_assert(LD % 32 == 0, "rows of whole bank lines");
  float* p;
  __device__ __forceinline__ float& operator()(int r, int c) const {
    return p[r * LD + (c ^ (((r & 3) << 3) | (r & 4)))];
  }
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying rows [0, R) x columns [0, C) of a row-major matrix at g
// (row stride `stride` floats) into s; what lies outside rows_ok x cols_ok
// is zero-filled (cp.async's source size 0).  vec: 16-byte copies (g and
// stride multiples of 4 floats, cols_ok too unless it is >= C), else
// 4-byte ones.  The caller waits (cp_async_wait) and syncs.
template <int R, int C>
__device__ __forceinline__ void stage(Smem<C> s, const float* g, long long stride, int rows_ok,
                                      int cols_ok, bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < R * (C / 4); e += THREADS) {
      const int r = e / (C / 4), c = e % (C / 4) * 4;
      const bool ok = r < rows_ok && c < cols_ok;
      cp_async16(&s(r, c), ok ? g + r * stride + c : g, ok);
    }
  } else {
    for (int e = threadIdx.x; e < R * C; e += THREADS) {
      const int r = e / C, c = e % C;
      const bool ok = r < rows_ok && c < cols_ok;
      cp_async4(&s(r, c), ok ? g + r * stride + c : g, ok);
    }
  }
}

// TF32 rounding as cvt.rna.tf32.f32 does it for finite values and inf (to
// nearest, ties away from zero): half a TF32 ulp added to the magnitude,
// the 13 low bits cleared.  On a NaN the add can carry the mantissa into
// the exponent and the sign (the card's default NaN 0x7fffffff becomes
// -0.0), so split() keeps NaN out of it.
__device__ __forceinline__ uint32_t tf32(uint32_t bits) { return (bits + 0x1000u) & 0xffffe000u; }

// x = big + small, both TF32; x - big is exact in fp32.  A NaN x stays NaN
// in big, and big.big carries it into every sum it enters, as an fp32
// product would; small needs no test, since it is finite wherever x is.
// (tests/_scan_probe.py times this against no test and against an integer
// test of both parts' exponents, which cost K9 / K10 about 29 % at
// mamba2-780m.)
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = x == x ? tf32(__float_as_uint(x)) : __float_as_uint(x);
  small = tf32(__float_as_uint(x - __uint_as_float(big)));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a b, from a zero accumulator
__device__ __forceinline__ void mma0(float (&d)[4], const uint32_t (&a)[4],
                                     const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// The row and column of acc[i][j][e] in a warp's (16 MT) x (8 NT) block
// at (m0, n0): the accumulator layout of mma.m16n8k8.
__device__ __forceinline__ int acc_row(int m0, int i, int e) {
  return m0 + 16 * i + ((threadIdx.x & 31) >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int acc_col(int n0, int j, int e) {
  return n0 + 8 * j + 2 * (threadIdx.x & 3) + (e & 1);
}

// Where a warp's fragment elements lie in a swizzled Smem<L>, as offsets
// that a k-step moves by one add (the swizzle's XOR touches bits 2-4 of
// the column only, so it splits into a per-thread part and a k part).
// Rows by g: element (R + g, k + t + 4q), R a multiple of 8, lies at
//   o[q] + R L + (k ^ sh),  o[q] = g L + ((t + 4q) ^ (g & 4)),  sh = (g & 3) << 3.
// Rows by t: element (k + t + 4q, C + g), C a multiple of 8, lies at
//   (t + 4q) L + (C ^ (t << 3)) + (g ^ 4q) + k L.
template <int L>
__device__ __forceinline__ int rows_by_g(int q) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  return g * L + ((t + 4 * q) ^ (g & 4));
}
template <int L>
__device__ __forceinline__ int rows_by_t(int q, int c) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  return (t + 4 * q) * L + (c ^ (t << 3)) + (g ^ (4 * q));
}

// One warp: acc[i][j] += sum over k in [k0, k1) of A(m0 + 16 i + .., k)
// B(k, n0 + 8 j + ..), k0, k1, m0 and n0 multiples of 8.  A(r, k) is
// a(r, k), or a(k, r) with TA; B(k, c) is b(k, c), or b(c, k) with TB.
// Each operand is split into a TF32 big part and a TF32 remainder, and
// small.big + big.small + big.big (the small terms first) keeps an fp32
// product's accuracy.  Each k-step's three products start from a zero
// accumulator and are added to acc in fp32: the tensor core aligns a sum
// to its largest addend and drops the bits below, so an accumulator
// carried through the whole product would lose low bits to its own size
// (PERF.md: K10's dB at mamba2-780m read 0.45 of TOL_SCAN's allowance
// with one accumulator carried over 16 k-steps, 0.18 with a fresh one).
template <int MT, int NT, bool TA, bool TB, int LA, int LB>
__device__ __forceinline__ void gemm(float (&acc)[MT][NT][4], Smem<LA> a, Smem<LB> b, int m0,
                                     int n0, int k0, int k1) {
  const int sh = ((threadIdx.x & 31) >> 2 & 3) << 3;
  // the k = 0 offsets: rows by g use two (q) and add (k ^ sh); rows by t
  // use one an element and add k L
  int oa[TA ? MT * 4 : 2], ob[TB ? 2 : NT * 2];
  if (TA) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        oa[TA ? i * 4 + e : 0] = rows_by_t<LA>(e >> 1, m0 + 16 * i + 8 * (e & 1));
  } else {
#pragma unroll
    for (int q = 0; q < 2; ++q) oa[q] = rows_by_g<LA>(q) + m0 * LA;
  }
  if (TB) {
#pragma unroll
    for (int q = 0; q < 2; ++q) ob[q] = rows_by_g<LB>(q) + n0 * LB;
  } else {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) ob[TB ? 0 : j * 2 + e] = rows_by_t<LB>(e, n0 + 8 * j);
  }
#pragma unroll 1
  for (int k = k0; k < k1; k += 8) {
    const int ka = TA ? k * LA : (k ^ sh), kb = TB ? (k ^ sh) : k * LB;
    uint32_t ab[MT][4], as[MT][4], bb[NT][2], bs[NT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* pa = TA ? a.p + oa[TA ? i * 4 + e : 0] + ka
                             : a.p + oa[e >> 1] + (16 * i + 8 * (e & 1)) * LA + ka;
        split(*pa, ab[i][e], as[i][e]);
      }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float* pb =
            TB ? b.p + ob[e] + 8 * j * LB + kb : b.p + ob[TB ? 0 : j * 2 + e] + kb;
        split(*pb, bb[j][e], bs[j][e]);
      }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float part[4];
        mma0(part, as[i], bb[j]);
        mma(part, ab[i], bs[j]);
        mma(part, ab[i], bb[j]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[e];
      }
  }
}

// Store acc[i][j][e], e + 1 (one row, two neighbouring columns) at p: one
// 8-byte store when both are in range and `pair` (the row stride and the
// base even, the column even), else what is in range one by one.
__device__ __forceinline__ void store_pair(float* p, float v0, float v1, bool ok0, bool ok1,
                                           bool pair) {
  if (pair && ok1) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    if (ok0) p[0] = v0;
    if (ok1) p[1] = v1;
  }
}

// Shared memory of the first launch's two roles, in floats
constexpr int SCORES_FLOATS = 2 * Q * KT;
constexpr int CHUNK_FLOATS = Q * PT + 2 * Q * KT + Q;
constexpr int PASS1_FLOATS = SCORES_FLOATS > CHUNK_FLOATS ? SCORES_FLOATS : CHUNK_FLOATS;

// d += a b on the fp64 tensor cores: an 8 x 8 tile over k = 4, a the
// (row g, column t) element of A, b the (row t, column g) element of B, d
// the (row g, columns 2t, 2t + 1) elements of D
__device__ __forceinline__ void dmma(double (&d)[2], double a, double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

// S = C B^T of one (batch, chunk), Q x Q over N tiles of KT, written to
// out (Q x Q, row-major).  c, b: the chunk's first row (row stride n_dim);
// rows past `rows` (a short last chunk) are 0.  S is computed once for
// every head, on the fp64 tensor cores (exact products of the fp32
// operands, fp64 sums, one rounding to fp32): where C_i . B_j cancels to
// a small part of its terms — at a sequence's first step y_0 is that one
// product times xdt_0 — an fp32 sum moves it by more than TOL_SCAN's
// allowance (the plain version, 4.6x against fp64 in tests/_scan_probe.py's
// first_step), and so does 3xTF32's truncation inside each k-step.  Each
// warp owns 8 rows of S.
__device__ void scores_role(const float* cm, const float* bm, float* out, int rows, int n_dim,
                            bool vec_n, float* smem) {
  const Smem<KT> cs{smem}, bs{smem + Q * KT};
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int i0 = 8 * (threadIdx.x / 32);
  double acc[Q / 8][2] = {};
  for (int k0 = 0; k0 < n_dim; k0 += KT) {
    __syncthreads();  // the previous tile is no longer read
    stage<Q, KT>(cs, cm + k0, n_dim, rows, n_dim - k0, vec_n);
    stage<Q, KT>(bs, bm + k0, n_dim, rows, n_dim - k0, vec_n);
    cp_async_wait();
    __syncthreads();
    const int kv = min(KT, n_dim - k0);
#pragma unroll 2
    for (int k = 0; k < kv; k += 4) {
      const double a = cs(i0 + g, k + t);
#pragma unroll
      for (int j = 0; j < Q / 8; ++j) dmma(acc[j], a, bs(8 * j + g, k + t));
    }
  }
#pragma unroll
  for (int j = 0; j < Q / 8; ++j)
    store_pair(out + (i0 + g) * Q + 8 * j + 2 * t, (float)acc[j][0], (float)acc[j][1], true,
               true, true);
}

// One (batch, head, chunk)'s contribution to the state it passes on:
// out (P x N) = sum_j scale_j x_j (x) z_j = (x o scale)^T z, K = Q, with
// scale_j = exp(l_Q - l_j) (K9: x = xdt, z = B) or exp(l_j) (K10: x = dy,
// z = C).  x: the chunk's first row (row stride p_dim); z likewise
// (n_dim); l: the chunk's log-decays (lcum), `rows` of them.  Output tiles
// of PT x KT; the next N tile of z is copied while this one is multiplied.
__device__ void chunk_role(const float* x, const float* z, const float* l, float* out, int rows,
                           int p_dim, int n_dim, bool vec_p, bool vec_n, bool decay_to_end,
                           float* smem) {
  const Smem<PT> xs{smem};
  const Smem<KT> zs[2] = {{smem + Q * PT}, {smem + Q * PT + Q * KT}};
  float* sc = smem + Q * PT + 2 * Q * KT;
  const int tid = threadIdx.x, warp = tid / 32;
  const int m0 = 32 * (warp & 1), n0 = 16 * (warp >> 1);  // (P, N) block of this warp
  const int kq = round8(rows);
  if (tid < Q) {
    const float lq = l[rows - 1], li = l[min(tid, rows - 1)];
    sc[tid] = decay_to_end ? expf(lq - li) : expf(li);
  }
  for (int p0 = 0; p0 < p_dim; p0 += PT) {
    const int pv = min(PT, p_dim - p0);
    __syncthreads();  // the previous P tile is no longer read
    stage<Q, PT>(xs, x + p0, p_dim, rows, pv, vec_p);
    stage<Q, KT>(zs[0], z, n_dim, rows, n_dim, vec_n);
    cp_async_wait();
    __syncthreads();
    for (int e = tid; e < Q * PT; e += THREADS) xs(e / PT, e % PT) *= sc[e / PT];
    __syncthreads();
    int buf = 0;
    for (int f0 = 0; f0 < n_dim; f0 += KT, buf ^= 1) {
      const int nv = min(KT, n_dim - f0);
      if (f0 + KT < n_dim)  // the other buffer was last read before the previous sync
        stage<Q, KT>(zs[buf ^ 1], z + f0 + KT, n_dim, rows, n_dim - f0 - KT, vec_n);
      if (m0 < pv && n0 < nv) {
        float acc[2][2][4];
        zero(acc);
        gemm<2, 2, true, false>(acc, xs, zs[buf], m0, n0, 0, kq);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; e += 2) {
              const int p = acc_row(m0, i, e), n = acc_col(n0, j, e);
              if (p < pv)
                store_pair(out + (long long)(p0 + p) * n_dim + f0 + n, acc[i][j][e],
                           acc[i][j][e + 1], n < nv, n + 1 < nv, n_dim % 2 == 0);
            }
      }
      cp_async_wait();
      __syncthreads();  // the next tile has landed; this one is no longer read
    }
  }
}

}  // namespace ssd
