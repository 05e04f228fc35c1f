// The TMA + wgmma GEMM mainloop of the port's matmul kernels, for sm_90a
// (matmul_wgmma.cuh builds K1's, K4's and K5's tensor-core kernels on
// it).  It knows nothing of rasters or epilogues: a caller picks the tile
// coordinate and the K range, runs the producer and the consumers, and
// stores the fp32 accumulator fragment as it likes.
//
//   * Operands are read through their strides with no copy: a 2-D tensor
//     map describes the underlying layout, and the operand's major-ness
//     picks the box and the wgmma transpose bit.  An operand with rows R
//     (its M or N extent) and depth K is
//       K-major  (element (r, k) at r * ld + k): boxes of 64 k x ROWS
//                rows, one 128-byte-swizzled panel a k-tile;
//       MN-major (element (r, k) at k * ld + r): boxes of 64 rows x BK k,
//                ROWS / 64 panels a k-tile.
//     TMA needs a 16-byte-aligned base and ld a multiple of 8 elements;
//     boxes past R or K are zero-filled, so ragged edges add zeros.
//   * Grouped calls (the MoE expert matmuls: G independent products in
//     one launch) add a third map dimension, the group, with its own
//     stride (a multiple of 8 elements); every box is one group deep, so
//     a box past R or K of its group is zero-filled there too and never
//     reads the next group.  One product is the same map with G = 1.
//   * Grouped calls (the MoE expert matmuls: G independent products in
//     one launch) add a third map dimension, the group, with its own
//     stride (a multiple of 8 elements); every box is one group deep, so
//     a box past R or K of its group is zero-filled there too and never
//     reads the next group.  One product is the same map with G = 1.
//   * A ring of STAGES slots in shared memory, each holding one k-tile of
//     every operand, with a full mbarrier (the producer's loads landed)
//     and an empty one (every consumer warp is done with the slot).
//   * One producer thread issues every load; each consumer warpgroup
//     issues wgmma.m64nNk16 over the slots in order.
//   * In a cluster of CL CTAs that share an operand tile (K4), each CTA
//     loads 1/CL of it, multicast into all CL (load_slice), and a slot is
//     empty once every consumer warp of every CTA released it: the empty
//     barrier counts CL x the consumer warps, and each warp arrives on
//     the barrier of every CTA of the cluster.
#pragma once

#include "hopper_common.cuh"

namespace mm90 {

using namespace ::sm90;
typedef __nv_bfloat16 bf16;

constexpr int BK = 64;  // the depth of a k-tile: one 128-byte panel of bf16

// The map of `groups` bf16 operands, each with rows R and depth K (see
// above), gstride elements apart (0: one group, any legal stride), boxes
// of 64 k x box_rows rows (K-major) or 64 rows x box_depth k (MN-major)
// of one group per load.  0 or a cudaError.
__host__ inline int operand_map(CUtensorMap* map, const void* base, bool kmajor, long long rows,
                                long long depth, long long ld, int box_rows, int box_depth,
                                int groups, long long gstride) {
  if (gstride == 0) gstride = (kmajor ? rows : depth) * ld;
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 2, (cuuint64_t)gstride * 2};
  if (kmajor) {
    const cuuint64_t dims[3] = {(cuuint64_t)depth, (cuuint64_t)rows, (cuuint64_t)groups};
    const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
    return encode_bf16(map, base, 3, dims, strides, box);
  }
  const cuuint64_t dims[3] = {(cuuint64_t)rows, (cuuint64_t)depth, (cuuint64_t)groups};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_depth, 1};
  return encode_bf16(map, base, 3, dims, strides, box);
}

// Can TMA read an operand with these strides (its unit stride on one
// axis, the other a multiple of 16 bytes) from this base?  kmajor says
// which axis is the unit one.
__host__ inline bool operand_ok(const void* base, long long s_row, long long s_k, bool* kmajor) {
  if (!aligned16(base)) return false;
  if (s_k == 1 && s_row % 8 == 0 && s_row > 0) {
    *kmajor = true;
    return true;
  }
  if (s_row == 1 && s_k % 8 == 0 && s_k > 0) {
    *kmajor = false;
    return true;
  }
  return false;
}

// Bytes of one k-tile of an operand tile of ROWS rows.
template <int ROWS>
__host__ __device__ constexpr uint32_t tile_bytes() { return ROWS * BK * 2; }

// Load k-tile at depth k0 of operand rows [r0, r0 + ROWS) of group g into dst.
template <bool KMAJOR, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const CUtensorMap* map, uint64_t* bar,
                                          int r0, int k0, int g) {
  if constexpr (KMAJOR) {
    tma_load_3d(dst, map, bar, k0, r0, g);
  } else {
#pragma unroll
    for (int p = 0; p < ROWS / 64; ++p)
      tma_load_3d(dst + p * BK * 64, map, bar, r0 + 64 * p, k0, g);
  }
}

// Slice `slice` of CL of the k-tile load_tile<KMAJOR, ROWS> would load (of group g),
// multicast into dst of every CTA of the cluster.  The k-tile is ROWS
// 128-byte rows of shared memory either way (K-major: the operand rows;
// MN-major: the 64 k rows of each 64-row panel in turn), and the slice
// is ROWS / CL of them, inside one panel: the operand's map has boxes of
// 64 x ROWS / CL (operand_map's box_rows, or box_depth for MN-major).
template <bool KMAJOR, int ROWS, int CL>
__device__ __forceinline__ void load_slice(bf16* dst, const CUtensorMap* map, uint64_t* bar,
                                           int r0, int k0, int g, int slice) {
  constexpr int PER = ROWS / CL;
  static_assert(CL > 1 && PER * CL == ROWS && PER <= BK && PER % 8 == 0,
                "a slice is whole swizzle atoms of one panel");
  const int u0 = slice * PER;
  if constexpr (KMAJOR)
    tma_load_3d_multicast(dst + u0 * 64, map, bar, k0, r0 + u0, g, (1u << CL) - 1);
  else
    tma_load_3d_multicast(dst + u0 * 64, map, bar, r0 + u0 / BK * 64, k0 + u0 % BK, g,
                          (1u << CL) - 1);
}

// The descriptor of k16 step kk of the operand rows starting at r (a
// multiple of 64 for MN-major) of a ROWS-row k-tile.
template <bool KMAJOR, int ROWS>
__device__ __forceinline__ uint64_t operand_desc(const bf16* tile, int r, int kk) {
  if constexpr (KMAJOR) return desc(tile + r * 64 + kk * 16, 16, 1024);
  else return desc(tile + (r / 64) * BK * 64 + kk * 16 * 64, BK * 128, 1024);
}

// acc[64 x N] (+)= A[a_r .. a_r + 64) B[b_r .. b_r + N)^T over one k-tile:
// A_ROWS- and B_ROWS-row k-tiles at a and b.  `first` overwrites acc.
template <int N, bool AK, bool BKM, int A_ROWS, int B_ROWS>
__device__ __forceinline__ void mma_ktile(float (&acc)[N / 2], const bf16* a, int a_r,
                                          const bf16* b, int b_r, bool first) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    mma_ss<N, AK ? 0 : 1, BKM ? 0 : 1>(acc, operand_desc<AK, A_ROWS>(a, a_r, kk),
                                       operand_desc<BKM, B_ROWS>(b, b_r, kk), !first || kk > 0);
}

// ---- the ring -------------------------------------------------------------

// full[s] completes when the loads of slot s land (the producer's one
// arrival and the bytes); empty[s] when all `consumer_warps` warps (of
// every CTA of a cluster) released it.
template <int STAGES>
__device__ __forceinline__ void ring_init(uint64_t* full, uint64_t* empty, int consumer_warps) {
  for (int s = 0; s < STAGES; ++s) {
    bar_init(&full[s], 1);
    bar_init(&empty[s], consumer_warps);
  }
}

// The producer thread: slot i % STAGES of step i, for steps [0, n), once
// the consumers released it; load(i, slot, bar) issues the TMA loads,
// `bytes` in all.
template <int STAGES, typename Load>
__device__ __forceinline__ void ring_produce(uint64_t* full, uint64_t* empty, int n,
                                             uint32_t bytes, Load load) {
  for (int i = 0; i < n; ++i) {
    const int s = i % STAGES;
    bar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
    bar_expect_tx(&full[s], bytes);
    load(i, s, &full[s]);
  }
}

// Wait for slot i % STAGES of step i, and release it.
template <int STAGES>
__device__ __forceinline__ void ring_wait(uint64_t* full, int i) {
  bar_wait(&full[i % STAGES], (i / STAGES) & 1);
}
// In a cluster of CL CTAs the warp releases the slot in every CTA: lane c
// arrives on CTA c's barrier, the CL arrivals issued side by side.
template <int STAGES, int CL = 1>
__device__ __forceinline__ void ring_release(uint64_t* empty, int i) {
  __syncwarp();
  const int lane = threadIdx.x % 32;
  if constexpr (CL == 1) {
    if (lane == 0) bar_arrive(&empty[i % STAGES]);
  } else {
    if (lane < CL) bar_arrive_cluster(&empty[i % STAGES], lane);
  }
}

}  // namespace mm90
