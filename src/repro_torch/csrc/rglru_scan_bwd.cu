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
// db written once: 20 bytes a step a channel).  Design `chunked-lookback`
// (rglru_common.cuh), the mirror of K11's: tiles of (batch, chunk of
// T = 64 steps, W = 128 channels), one CTA each, two resident on every SM
// with 96 KB of copies in flight each, positions counted from the last
// chunk.  The carry c that leaves a chunk at its first step is A c_in + L
// in the carry c_in entering at its last, with A the product of the
// chunk's decays and L the carry that leaves it from c_in = 0.  A tile
// stages a, h_prev and dh into shared memory, takes c_in from the chunk
// after — its published carry if it is out, else by decoupled look-back
// over the chunks' (A, L), which the tile first walks its chunk backwards
// for and publishes — and walks the chunk from c_in, writing da and db.
#include "rglru_common.cuh"

namespace {

using namespace rglru;

template <bool VEC>
__global__ void __launch_bounds__(W)
rglru_bwd_kernel(const float* __restrict__ a, const float* __restrict__ h_prev,
                 const float* __restrict__ dh, float* __restrict__ da, float* __restrict__ db,
                 int s, int d, int blocks_d, int cols, int* __restrict__ flags,
                 float* __restrict__ vals, unsigned long long* __restrict__ counter) {
  // a, h_prev overwritten by da, dh overwritten by db: T x W each
  extern __shared__ float smem[];
  const Tile t = take_ticket(counter, cols, blocks_d, gridDim.x);
  const Scratch sc{flags, vals, (long long)gridDim.x * W, cols};
  const int chunks = gridDim.x / cols;
  const int t0 = (chunks - 1 - t.pos) * T, rows = min(T, s - t0), nch = min(W, d - t.ch0);
  const long long base = ((long long)t.batch * s + t0) * d + t.ch0;
  const float* const in[3] = {a, h_prev, dh};
  stage<3, VEC>(smem, in, base, rows, nch, d);
  const float* sa = smem + threadIdx.x;
  float* sh = smem + T * W + threadIdx.x;
  float* sg = smem + 2 * T * W + threadIdx.x;

  float carry = 0.f;  // a_{t+1} g_{t+1}
  const bool walked = t.pos == 0 || peek(sc, t, carry);
  if (!walked) {
    float prod = 1.f, leaving = 0.f;  // the chunk's aggregate
#pragma unroll 8
    for (int r = rows - 1; r >= 0; --r) {
      prod = __fmul_rn(sa[r * W], prod);
      leaving = __fmul_rn(sa[r * W], __fadd_rn(sg[r * W], leaving));
    }
    publish(sc, t, AGGREGATE, prod, leaving);
    carry = look_back(sc, t);
    publish(sc, t, PREFIX, __fadd_rn(__fmul_rn(prod, carry), leaving), 0.f);
  }
#pragma unroll 8
  for (int r = rows - 1; r >= 0; --r) {
    const float g = __fadd_rn(sg[r * W], carry);
    sh[r * W] = __fmul_rn(g, sh[r * W]);
    sg[r * W] = g;
    carry = __fmul_rn(sa[r * W], g);
  }
  if (walked) publish(sc, t, PREFIX, carry, 0.f);
  float* const out[2] = {da, db};
  unstage<2, VEC>(smem + T * W, out, base, rows, nch, d);
}

template <bool VEC>
cudaError_t launch(const float* a, const float* h_prev, const float* dh, float* da, float* db,
                   int* flags, float* vals, unsigned long long* counter, int batch, int s,
                   int d, cudaStream_t stream) {
  const int blocks_d = (d + W - 1) / W, chunks = (s + T - 1) / T;
  const size_t smem = 3 * T * W * sizeof(float);
  cudaFuncSetAttribute(rglru_bwd_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  rglru_bwd_kernel<VEC><<<batch * blocks_d * chunks, W, smem, stream>>>(
      a, h_prev, dh, da, db, s, d, blocks_d, batch * blocks_d, flags, vals, counter);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// a, h_prev, dh, da, db (batch, seq, d) fp32, contiguous.  Scratch as K11's
// (rglru_scan_fwd.cu).  Returns the design's code (1, chunked-lookback),
// or minus a cudaError.
extern "C" int rglru_scan_bwd(const void* a, const void* h_prev, const void* dh, void* da,
                              void* db, void* flags, void* vals, void* counter, int batch,
                              int s, int d, void* stream) {
  if (batch <= 0 || s <= 0 || d <= 0) return 1;
  const long long tiles = (long long)batch * ((d + W - 1) / W) * ((s + T - 1) / T);
  if (batch > 65535 || tiles > 0x7fffffff) return -(int)cudaErrorInvalidValue;
  const bool vec = d % 4 == 0 && aligned16(a) && aligned16(h_prev) && aligned16(dh) &&
                   aligned16(da) && aligned16(db);
  auto* fa = static_cast<const float*>(a);
  auto* fh = static_cast<const float*>(h_prev);
  auto* fg = static_cast<const float*>(dh);
  auto* fda = static_cast<float*>(da);
  auto* fdb = static_cast<float*>(db);
  auto* fl = static_cast<int*>(flags);
  auto* fv = static_cast<float*>(vals);
  auto* fc = static_cast<unsigned long long*>(counter);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      vec ? launch<true>(fa, fh, fg, fda, fdb, fl, fv, fc, batch, s, d, st)
          : launch<false>(fa, fh, fg, fda, fdb, fl, fv, fc, batch, s, d, st);
  return err == cudaSuccess ? 1 : -(int)err;
}
