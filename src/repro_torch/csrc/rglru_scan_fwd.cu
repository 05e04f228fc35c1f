// K11 — the RG-LRU linear recurrence, for sm_90a.
//
// Replaces: src/repro/kernels/rglru/rglru.py : rglru_scan (_rglru_body;
// the Pallas TPU kernel, grid (batch, d blocks, s blocks) with the state
// carried across sequence blocks in VMEM).
//
// h_t = a_t h_{t-1} + b_t over (batch, seq, d) fp32, h_{-1} = 0, written
// as the TPU kernel writes it: a product, then a sum (no fused
// multiply-add, so the plain version agrees to the bit).
//
// What bounds it on the H100: bytes (a and b read once, h written once:
// 12 bytes a step a channel against 2 flops).  Design of this first
// version: one thread per (batch, channel) walks the whole sequence with
// its state in a register; a warp's 32 channels are neighbours, so every
// load and store is one 128-byte line.  The walk is a chain of dependent
// adds, so each thread loads U = 8 steps of a and b ahead before it
// computes them, to keep loads in flight.  At recurrentgemma-2b's width
// (batch 2, d_rnn 2560) that is 5,120 threads in 40 blocks of 128: a
// third of the SMs, one warp's worth of loads in flight per four
// channels.  Later work: split the sequence (a two-pass chunked scan) so
// the grid fills the card.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int U = 8;  // steps loaded ahead

__global__ void __launch_bounds__(THREADS)
rglru_fwd_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ h, int s, int d) {
  const int ch = blockIdx.x * THREADS + threadIdx.x;
  if (ch >= d) return;
  const long long base = (long long)blockIdx.y * s * d + ch;
  const float* ap = a + base;
  const float* bp = b + base;
  float* hp = h + base;
  float state = 0.f;
  int t = 0;
  for (; t + U <= s; t += U) {
    float av[U], bv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      av[u] = ap[(long long)(t + u) * d];
      bv[u] = bp[(long long)(t + u) * d];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      state = __fadd_rn(__fmul_rn(av[u], state), bv[u]);
      hp[(long long)(t + u) * d] = state;
    }
  }
  for (; t < s; ++t) {
    state = __fadd_rn(__fmul_rn(ap[(long long)t * d], state), bp[(long long)t * d]);
    hp[(long long)t * d] = state;
  }
}

}  // namespace

// a, b, h (batch, seq, d) fp32, contiguous.
extern "C" int rglru_scan_fwd(const void* a, const void* b, void* h, int batch, int s, int d,
                              void* stream) {
  if (batch <= 0 || s <= 0 || d <= 0) return 0;
  if (batch > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((d + THREADS - 1) / THREADS, batch);
  rglru_fwd_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(h), s, d);
  return (int)cudaGetLastError();
}
