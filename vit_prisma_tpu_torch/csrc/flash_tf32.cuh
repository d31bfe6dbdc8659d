// The float32 route of B13 (flash_attention_fwd.cu, flash_attention_bwd.cu:
// namespace f32tc in each): every float32 product as three TF32 mma.sync
// products (tf32_mma.cuh), for every head width flash_fits takes (a
// multiple of 16 up to 128).  This header holds what the three passes
// share: the shared-memory layout, the chunk sizes and the staging of
// tiles.
//
// Layout.  A staged tile holds rows of S = H + 4 floats (H a multiple of
// 16, so S is 4 mod 8): the 8 rows of an ldmatrix, and the 8 x 4 scalar
// reads of a permuted fragment (pn_chunk), then fall in distinct banks, and
// no read passes column H, so the 4 padding floats are never read.  Each
// pass keeps one pair of operands resident and streams the other pair in
// tiles of kStream rows through a two-deep cp.async ring:
//   forward: K and V streamed (q in registers);
//   dk/dv:   K and V of the block's keys resident, Q and dZ streamed with
//            each query's segment id, -lse log2(e) and D;
//   dq:      Q and dZ of the block's rows resident, K and V streamed with
//            the keys' segment ids.
// The resident rows are A operands, read a k-step at a time by ldmatrix
// (tf32_mma.cuh's Staged): held in registers beside the two gradient
// accumulators they spilled at H 128.
#pragma once

#include "flash_tile.cuh"  // kTile, sae::cp_async16
#include "tf32_mma.cuh"

namespace flash {
namespace f32 {

constexpr int kFwdWarps = 4;  // 16 query rows a warp
constexpr int kBwdWarps = 4;  // 16 keys (dk/dv) or rows (dq) a warp
constexpr int kStream = 32;   // rows of a streamed tile (divides kTile)
// A block's rows are one kTile: Tp, a multiple of kTile, leaves no warp idle.
static_assert(16 * kFwdWarps == kTile && 16 * kBwdWarps == kTile, "a block is one tile");

// Blocks an SM should hold, for ptxas's register budget: three where the
// registers and shared memory of H <= 64 allow it, else as many as they
// allow (one block's 255 registers a thread).
__host__ __device__ constexpr int min_blocks(int hd) { return hd <= 64 ? 3 : 1; }

// 8-row steps a chunk takes in each pass: more steps share each A
// fragment's loads and splits, at the cost of registers (four spilled the
// forward past H 96, and the dk/dv pass past H 96 and, at H 64, unless its
// two gradient products take two 8-column steps at a time: dkv_group).
__host__ __device__ constexpr int fwd_steps(int hd) { return hd <= 96 ? 4 : 2; }
__host__ __device__ constexpr int dkv_steps(int hd) { return hd <= 96 ? 4 : 2; }
__host__ __device__ constexpr int dkv_group(int hd) { return hd <= 96 ? 2 : 8; }
__host__ __device__ constexpr int dq_steps(int) { return 4; }

__host__ __device__ constexpr int stride(int hd) { return hd + 4; }

// Bytes of each pass's shared memory (must match flash_tf32_layout in
// vit_prisma_tpu_torch/ops/attention.py).
__host__ __device__ constexpr int fwd_smem_bytes(int hd) {
  return 4 * (4 * kStream * stride(hd) + 2 * kStream);
}
__host__ __device__ constexpr int dkv_smem_bytes(int hd) {
  return 4 * (2 * 16 * kBwdWarps * stride(hd) + 4 * kStream * stride(hd) + 3 * 2 * kStream);
}
__host__ __device__ constexpr int dq_smem_bytes(int hd) {
  return 4 * (2 * 16 * kBwdWarps * stride(hd) + 4 * kStream * stride(hd) + 2 * kStream);
}

// Copy `rows` rows of HD floats (row r at src + r HD) into dst rows of
// stride(HD) floats with cp.async, 16 bytes a thread at a time; every
// thread of the block takes part.  The caller commits the group.
template <int HD>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int rows) {
  constexpr int C = HD / 4, S = stride(HD);
  for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
    const int r = i / C, c = 4 * (i % C);
    sae::cp_async16(dst + r * S + c, src + static_cast<long long>(r) * HD + c);
  }
}

}  // namespace f32
}  // namespace flash
