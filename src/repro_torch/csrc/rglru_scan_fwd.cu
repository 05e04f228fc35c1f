// K11 — the RG-LRU linear recurrence, for sm_90a.
//
// Replaces: src/repro/kernels/rglru/rglru.py : rglru_scan (_rglru_body;
// the Pallas TPU kernel, grid (batch, d blocks, s blocks) with the state
// carried across sequence blocks in VMEM).
//
// h_t = a_t h_{t-1} + b_t over (batch, seq, d) fp32, h_{-1} = 0, each step
// written as the TPU kernel writes it: a product, then a sum (no fused
// multiply-add).
//
// What bounds it on the H100: bytes (a and b read once, h written once:
// 12 bytes a step a channel against 2 flops).  The TPU kernel's carry
// through an in-order grid has no counterpart here, where blocks run in
// parallel in no order.  Design `chunked-lookback` (rglru_common.cuh):
// the sequence is cut into chunks of T = 64 steps and the channels into
// blocks of W = 128, and each (batch, chunk, channel block) tile is one
// CTA — 1,280 of them at recurrentgemma-2b's width (batch 2, s 2048,
// d_rnn 2560), three resident on every SM with 64 KB of copies in flight
// each.  A tile stages a and b into shared memory and takes the state
// entering its chunk from the chunk before — its published state if it
// is out, else by decoupled look-back over the chunks' (A = prod a,
// L = the last state from 0), which the tile first walks its chunk for
// and publishes — then walks the chunk from that state, writing h.
// Inside a chunk every step is the sequential one.
#include "rglru_common.cuh"

namespace {

using namespace rglru;

template <bool VEC>
__global__ void __launch_bounds__(W)
rglru_fwd_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ h,
                 int s, int d, int blocks_d, int cols, int* __restrict__ flags,
                 float* __restrict__ vals, unsigned long long* __restrict__ counter) {
  extern __shared__ float smem[];  // a, then b overwritten by h: T x W each
  const Tile t = take_ticket(counter, cols, blocks_d, gridDim.x);
  const Scratch sc{flags, vals, (long long)gridDim.x * W, cols};
  const int t0 = t.pos * T, rows = min(T, s - t0), nch = min(W, d - t.ch0);
  const long long base = ((long long)t.batch * s + t0) * d + t.ch0;
  const float* const in[2] = {a, b};
  stage<2, VEC>(smem, in, base, rows, nch, d);
  const float* sa = smem + threadIdx.x;
  float* sb = smem + T * W + threadIdx.x;

  float carry = 0.f;
  // walked: the carry is known before the walk, whose last state is then
  // the prefix to publish
  const bool walked = t.pos == 0 || peek(sc, t, carry);
  if (!walked) {
    float prod = 1.f, state = 0.f;  // the chunk's aggregate
#pragma unroll 8
    for (int r = 0; r < rows; ++r) {
      prod = __fmul_rn(sa[r * W], prod);
      state = __fadd_rn(__fmul_rn(sa[r * W], state), sb[r * W]);
    }
    publish(sc, t, AGGREGATE, prod, state);
    carry = look_back(sc, t);
    publish(sc, t, PREFIX, __fadd_rn(__fmul_rn(prod, carry), state), 0.f);
  }
  float state = carry;
#pragma unroll 8
  for (int r = 0; r < rows; ++r) {
    state = __fadd_rn(__fmul_rn(sa[r * W], state), sb[r * W]);
    sb[r * W] = state;
  }
  if (walked) publish(sc, t, PREFIX, state, 0.f);
  float* const out[1] = {h};
  unstage<1, VEC>(smem + T * W, out, base, rows, nch, d);
}

template <bool VEC>
cudaError_t launch(const float* a, const float* b, float* h, int* flags, float* vals,
                   unsigned long long* counter, int batch, int s, int d, cudaStream_t stream) {
  const int blocks_d = (d + W - 1) / W, chunks = (s + T - 1) / T;
  const size_t smem = 2 * T * W * sizeof(float);
  cudaFuncSetAttribute(rglru_fwd_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  rglru_fwd_kernel<VEC><<<batch * blocks_d * chunks, W, smem, stream>>>(
      a, b, h, s, d, blocks_d, batch * blocks_d, flags, vals, counter);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// a, b, h (batch, seq, d) fp32, contiguous.  Scratch from the wrapper:
// flags, batch x ceil(d / 128) x ceil(s / 64) int32; vals, three times as
// many x 128 fp32; counter, one 64-bit word — flags and counter zeroed
// before their first call and left for the next.  Returns the design's code (1,
// chunked-lookback), or minus a cudaError.
extern "C" int rglru_scan_fwd(const void* a, const void* b, void* h, void* flags, void* vals,
                              void* counter, int batch, int s, int d, void* stream) {
  if (batch <= 0 || s <= 0 || d <= 0) return 1;
  const long long tiles = (long long)batch * ((d + W - 1) / W) * ((s + T - 1) / T);
  if (batch > 65535 || tiles > 0x7fffffff) return -(int)cudaErrorInvalidValue;
  const bool vec = d % 4 == 0 && aligned16(a) && aligned16(b) && aligned16(h);
  auto* fa = static_cast<const float*>(a);
  auto* fb = static_cast<const float*>(b);
  auto* fh = static_cast<float*>(h);
  auto* fl = static_cast<int*>(flags);
  auto* fv = static_cast<float*>(vals);
  auto* fc = static_cast<unsigned long long*>(counter);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = vec ? launch<true>(fa, fb, fh, fl, fv, fc, batch, s, d, st)
                              : launch<false>(fa, fb, fh, fl, fv, fc, batch, s, d, st);
  return err == cudaSuccess ? 1 : -(int)err;
}
