// What K11 and K12 (the RG-LRU scan and its adjoint) share: the tile, its
// staging by cp.async, the ticket that orders tiles, and the decoupled
// look-back that hands each chunk its carry (design `chunked-lookback`).
//
// A tile is (batch, chunk of T steps, W neighbouring channels), one CTA,
// one thread a channel.  Both recurrences are first-order and linear in
// the carry, so a chunk maps the carry entering it to the carry leaving it
// as x -> A x + L: A the product of the chunk's decays, L what leaves it
// from a zero carry.  A tile stages its inputs into shared memory (each
// input byte read once from device memory).  If its predecessor has
// published its inclusive prefix by then, that is the carry: the tile
// walks its chunk once from it and publishes the walk's last state as its
// own prefix.  Otherwise it walks the chunk from a zero carry for (A, L),
// publishes them, looks back along its column of chunks for its carry
// (Merrill & Garland, "Single-pass parallel prefix scan with decoupled
// look-back", 2016), publishes its prefix A carry + L and walks the chunk
// again from the carry.  Inside a chunk the arithmetic is the sequential
// walk's; only a carry that the look-back composes departs from the
// sequential rounding.  The outputs go to shared memory during the walk,
// over the inputs they replace, and leave by 16-byte stores after the
// tile has published, so that the fence before a flag waits on no output
// store.
//
// Order and progress: a tile takes its position from an atomic ticket, not
// from blockIdx, and positions run chunk-major (every column's chunk k
// before any column's chunk k + 1), so a tile only ever waits on tiles that
// took a smaller ticket and are already running: no deadlock.  A flag per
// tile holds (epoch << 2) | status; the values are written, fenced, and the
// flag set with st.release.gpu; a reader polls with ld.acquire.gpu and
// reads the values past L1.  The epoch is the call's number: the ticket
// and the epoch share one 64-bit counter, taken by one atomic add, and the
// tile that draws the last ticket resets the ticket and advances the
// epoch.  A flag left by an earlier call never reads as published, and the
// scratch needs no clearing between calls.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rglru {

constexpr int T = 64;  // steps a chunk
constexpr int W = 128;  // channels a tile: one thread each, four warps
constexpr int AGGREGATE = 1, PREFIX = 2;  // a flag's low two bits
constexpr unsigned EPOCH_MASK = 0x3fffffff;

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(d), "l"(src) : "memory");
}

// One tile's place: its position along the scan (the chunk for K11, the
// chunk counted from the end for K12), its column (batch, channel block).
struct Tile {
  int pos, col, batch, ch0, epoch;
};

// Take a ticket and the call's epoch (thread 0: the low and high words of
// the counter, zeroed once by the wrapper), shared with the tile.  The
// ticket tiles - 1 is drawn after every other, so its tile leaves the
// counter ready for the next call: ticket 0, the epoch advanced.
__device__ __forceinline__ Tile take_ticket(unsigned long long* counter, int cols, int blocks_d,
                                            int tiles) {
  __shared__ unsigned long long drawn;
  if (threadIdx.x == 0) {
    drawn = atomicAdd(counter, 1ull);
    if (static_cast<int>(drawn & 0xffffffffull) == tiles - 1)
      atomicExch(counter, (((drawn >> 32) + 1) & EPOCH_MASK) << 32);
  }
  __syncthreads();
  const int ticket = static_cast<int>(drawn & 0xffffffffull);
  Tile t;
  t.pos = ticket / cols;
  t.col = ticket % cols;
  t.batch = t.col / blocks_d;
  t.ch0 = t.col % blocks_d * W;
  t.epoch = static_cast<int>(drawn >> 32);
  return t;
}

// Copy rows [0, rows) x channels [0, nch) of each of the N inputs, starting
// at element `base` with row stride d, into s (N x T x W floats), and wait.
// vec: 16-byte copies (d % 4 == 0 and 16-byte aligned bases), else 4-byte
// ones.  What lies past rows or nch is left as it was: no walk stores it.
template <int N, bool VEC>
__device__ __forceinline__ void stage(float* s, const float* const (&in)[N], long long base,
                                      int rows, int nch, int d) {
  if (VEC) {
    for (int e = threadIdx.x; e < rows * (W / 4); e += W) {
      const int r = e / (W / 4), c = e % (W / 4) * 4;
      if (c < nch) {
#pragma unroll
        for (int k = 0; k < N; ++k)
          cp_async16(s + (k * T + r) * W + c, in[k] + base + (long long)r * d + c);
      }
    }
  } else if (threadIdx.x < nch) {  // each thread copies its own channel
    for (int r = 0; r < rows; ++r) {
#pragma unroll
      for (int k = 0; k < N; ++k)
        cp_async4(s + (k * T + r) * W + threadIdx.x, in[k] + base + (long long)r * d + threadIdx.x);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// The way back: rows [0, rows) x channels [0, nch) of each of the N planes
// of s (N x T x W floats) to the outputs, by 16-byte stores where vec.
template <int N, bool VEC>
__device__ __forceinline__ void unstage(const float* s, float* const (&out)[N], long long base,
                                        int rows, int nch, int d) {
  __syncthreads();
  if (VEC) {
    for (int e = threadIdx.x; e < rows * (W / 4); e += W) {
      const int r = e / (W / 4), c = e % (W / 4) * 4;
      if (c < nch) {
#pragma unroll
        for (int k = 0; k < N; ++k)
          *reinterpret_cast<float4*>(out[k] + base + (long long)r * d + c) =
              *reinterpret_cast<const float4*>(s + (k * T + r) * W + c);
      }
    }
  } else if (threadIdx.x < nch) {
    for (int r = 0; r < rows; ++r) {
#pragma unroll
      for (int k = 0; k < N; ++k)
        out[k][base + (long long)r * d + threadIdx.x] = s[(k * T + r) * W + threadIdx.x];
    }
  }
}

// The scratch of one call: a flag per tile and, per tile and channel, the
// aggregate (A, L) and the inclusive prefix, three planes of floats.
struct Scratch {
  int* flags;
  float* vals;
  long long plane;  // floats a plane: positions x cols x W
  int cols;

  // this thread's value of the tile at (pos, col), in any plane
  __device__ __forceinline__ long long at(int pos, int col) const {
    return ((long long)pos * cols + col) * W + threadIdx.x;
  }
  __device__ __forceinline__ int* flag(int pos, int col) const {
    return flags + (long long)pos * cols + col;
  }
};

// Publish this tile's values under `status`: every thread's values are
// written and fenced before thread 0 releases the flag.
__device__ __forceinline__ void publish(const Scratch& sc, const Tile& t, int status,
                                        float v0, float v1) {
  const long long i = sc.at(t.pos, t.col);
  if (status == AGGREGATE) {
    __stcg(sc.vals + i, v0);
    __stcg(sc.vals + sc.plane + i, v1);
  } else {
    __stcg(sc.vals + 2 * sc.plane + i, v0);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    st_release(sc.flag(t.pos, t.col),
               static_cast<int>((static_cast<unsigned>(t.epoch) << 2) | status));
}

// Whether the nearest predecessor (position t.pos - 1) has
// published its inclusive prefix already; if so, every thread's carry is
// that prefix.  One look by thread 0, no wait.
__device__ __forceinline__ bool peek(const Scratch& sc, const Tile& t, float& carry) {
  __shared__ int ready;
  if (threadIdx.x == 0) {
    const int v = ld_acquire(sc.flag(t.pos - 1, t.col));
    ready = static_cast<unsigned>(v) == ((static_cast<unsigned>(t.epoch) << 2) | PREFIX);
  }
  __syncthreads();
  if (!ready) return false;
  carry = __ldcg(sc.vals + 2 * sc.plane + sc.at(t.pos - 1, t.col));
  return true;
}

// The carry entering position t.pos (> 0) of the tile's column.  Warp 0
// polls the 32 nearest predecessors at once until every one from the
// nearest down to the nearest inclusive prefix has published; then each
// thread folds those aggregates for its channel, nearest first — (A, L)
// of chunks j+1 .. pos-1 composed with chunk j's: L' = A L_j + L,
// A' = A A_j — and applies the fold to the prefix.  Without a prefix in
// the window it folds all 32 and moves the window down.  Position 0
// publishes its prefix first of all, so the walk always ends.
__device__ __forceinline__ float look_back(const Scratch& sc, const Tile& t) {
  __shared__ int count, found;
  float acc_a = 1.f, acc_l = 0.f;
  int hi = t.pos - 1;  // the nearest predecessor not yet folded in
  for (;;) {
    if (threadIdx.x < 32) {
      const int j = hi - (int)threadIdx.x;
      unsigned pre, missing;
      int n;
      for (;;) {
        int st = PREFIX;  // below position 0: never reached
        if (j >= 0) {
          const int v = ld_acquire(sc.flag(j, t.col));
          st = static_cast<unsigned>(v) >> 2 == static_cast<unsigned>(t.epoch) ? (v & 3) : 0;
        }
        pre = __ballot_sync(~0u, st == PREFIX);
        missing = __ballot_sync(~0u, st == 0);
        n = pre ? __ffs(pre) - 1 : 32;  // aggregates before the nearest prefix
        if (!(missing & (n == 32 ? ~0u : (1u << n) - 1))) break;
        __nanosleep(64);
      }
      if (threadIdx.x == 0) {
        count = n;
        found = n < 32;
      }
    }
    __syncthreads();
    const int n = count;
    const bool done = found;
    __syncthreads();  // count and found are read before the next round writes them
    for (int i = 0; i < n; ++i) {
      const long long k = sc.at(hi - i, t.col);
      const float a = __ldcg(sc.vals + k), l = __ldcg(sc.vals + sc.plane + k);
      acc_l = __fadd_rn(__fmul_rn(acc_a, l), acc_l);
      acc_a = __fmul_rn(acc_a, a);
    }
    hi -= n;
    if (done) {
      const float p = __ldcg(sc.vals + 2 * sc.plane + sc.at(hi, t.col));
      return __fadd_rn(__fmul_rn(acc_a, p), acc_l);
    }
  }
}

}  // namespace rglru
