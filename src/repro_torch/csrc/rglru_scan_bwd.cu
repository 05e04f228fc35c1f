// K12 — the RG-LRU adjoint scan, for sm_90a.
//
// Replaces: src/repro/kernels/rglru/rglru.py : rglru_scan_bwd
// (_rglru_bwd_body; the Pallas TPU kernel, whose grid walks the sequence
// blocks in reverse with the decayed adjoint carry in VMEM).
//
// Walking t from the end: g_t = dh_t + c, da_t = g_t h_{t-1}, db_t = g_t,
// c = a_t g_t (c starts at 0), over (batch, seq, d) fp32 with h_prev the
// forward's output shifted right one step (zero first) — the TPU
// kernel's order of operations, with no fused multiply-add.
//
// What bounds it on the H100: bytes (a, h_prev and dh read once, da and
// db written once: 20 bytes a step a channel).  Design: the mirror of K11
// — one thread per (batch, channel) walks the sequence backwards with the
// carry in a register, loading U = 8 steps ahead; neighbouring threads
// hold neighbouring channels, so each access is one 128-byte line.  At
// recurrentgemma-2b's width: 5,120 threads in 40 blocks of 128.  Later
// work: a two-pass chunked scan that splits the sequence.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int U = 8;  // steps loaded ahead

__global__ void __launch_bounds__(THREADS)
rglru_bwd_kernel(const float* __restrict__ a, const float* __restrict__ h_prev,
                 const float* __restrict__ dh, float* __restrict__ da, float* __restrict__ db,
                 int s, int d) {
  const int ch = blockIdx.x * THREADS + threadIdx.x;
  if (ch >= d) return;
  const long long base = (long long)blockIdx.y * s * d + ch;
  float carry = 0.f;  // a_{t+1} g_{t+1}
  int t = s;
  for (; t >= U; t -= U) {  // steps t - U .. t - 1, last first
    float av[U], hv[U], gv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = base + (long long)(t - 1 - u) * d;
      av[u] = a[i];
      hv[u] = h_prev[i];
      gv[u] = dh[i];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = base + (long long)(t - 1 - u) * d;
      const float g = __fadd_rn(gv[u], carry);
      da[i] = __fmul_rn(g, hv[u]);
      db[i] = g;
      carry = __fmul_rn(av[u], g);
    }
  }
  for (; t > 0; --t) {
    const long long i = base + (long long)(t - 1) * d;
    const float g = __fadd_rn(dh[i], carry);
    da[i] = __fmul_rn(g, h_prev[i]);
    db[i] = g;
    carry = __fmul_rn(a[i], g);
  }
}

}  // namespace

// a, h_prev, dh, da, db (batch, seq, d) fp32, contiguous.
extern "C" int rglru_scan_bwd(const void* a, const void* h_prev, const void* dh, void* da,
                              void* db, int batch, int s, int d, void* stream) {
  if (batch <= 0 || s <= 0 || d <= 0) return 0;
  if (batch > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((d + THREADS - 1) / THREADS, batch);
  rglru_bwd_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(h_prev),
      static_cast<const float*>(dh), static_cast<float*>(da), static_cast<float*>(db), s, d);
  return (int)cudaGetLastError();
}
