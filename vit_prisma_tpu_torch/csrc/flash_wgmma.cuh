// The Hopper pieces of B13's bfloat16 route (flash_attention_fwd.cu and
// flash_attention_bwd.cu), on hopper_gemm.cuh, for head widths 64 and 128.
//
// Every pass is one block of one consumer warpgroup (64 rows, 16 a warp)
// and one producer warp.  The producer loads the block's resident tiles
// (Q in the forward; K and V in the dk/dv pass; Q and dZ in the dq pass)
// once, then streams the other pair of [64 x H] tiles, with up to three
// 64-entry vectors of their rows (segment ids, lse, D), through a ring of
// kStages stages: tiles by TMA from 2-D tensor maps [B N Tp, H] in [64 x 64]
// boxes, 128-byte swizzled (H = 128 takes two boxes a tile, 8 KB apart),
// vectors by 1-D bulk copies, all completing on the stage's mbarrier.
// The consumers run the products as wgmma: scores as mma_ss_kb (both tiles
// K-major, as they lie), the PV-like products as mma_rs with the scores'
// accumulator, masked and rounded to bf16, as their A fragments, and a
// [64 x H] tile as the MN-major B operand.  So every tile in shared memory
// serves both forms, and nothing the consumers compute goes through shared
// memory.  Each consumer warp releases a stage once its products are done.
#pragma once

#include "flash_tile.cuh"
#include "hopper_gemm.cuh"

namespace fw {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;              // rows of a tile
constexpr int kConsumers = 128;        // one warpgroup
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kStages = 2;
constexpr int kVecs = 3;               // vectors a stage can carry
constexpr int kVecBytes = kTile * 4;
constexpr float kLog2e = 1.4426950408889634f;

// Byte offsets from the 1024-aligned base: NRES resident tiles, kStages
// stages of two tiles, kStages x kVecs vectors, then the barriers (res,
// full[kStages], empty[kStages]).
template <int HD, int NRES>
struct Ring {
  static constexpr int tile = kTile * HD * 2;
  static constexpr int stages = NRES * tile;
  static constexpr int vecs = stages + kStages * 2 * tile;
  static constexpr int bars = vecs + kStages * kVecs * kVecBytes;
  static constexpr int bytes = bars + (1 + 2 * kStages) * 8 + hg::kSwizzleAlign;
};

// A [rows, hd] bf16 tensor (hd 64 or 128) in [64 x 64] boxes.
inline cudaError_t make_rows_map(CUtensorMap* map, const void* p, long long rows, int hd) {
  const uint64_t dims[2] = {static_cast<uint64_t>(hd), static_cast<uint64_t>(rows)};
  const uint64_t strides[1] = {static_cast<uint64_t>(hd) * 2};
  const uint32_t box[2] = {hg::kBox, kTile};
  return hg::make_map(map, p, 2, dims, strides, box);
}

__device__ __forceinline__ unsigned char* aligned_base(unsigned char* raw) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + hg::kSwizzleAlign - 1) &
      ~static_cast<uintptr_t>(hg::kSwizzleAlign - 1));
}

// Tile rows [row, row + 64) of `map` into dst, one box a 64 columns.
template <int HD>
__device__ __forceinline__ void load_tile(unsigned char* dst, const CUtensorMap* map,
                                          uint64_t* bar, int row) {
#pragma unroll
  for (int b = 0; b < HD / hg::kBox; ++b)
    hg::tma_load_2d(dst + b * hg::kBoxBytes, map, bar, b * hg::kBox, row);
}

// The producer (one thread): resident tiles of rm0 (and rm1) at row `res`,
// then tiles [first, end) of sm0 and sm1 from row `base`, each stage with
// the vectors vsrc[0 .. nvec) at the same rows.
template <int HD, int NRES>
__device__ __forceinline__ void produce(unsigned char* smem, const CUtensorMap* rm0,
                                        const CUtensorMap* rm1, int res, const CUtensorMap* sm0,
                                        const CUtensorMap* sm1, int base, int first, int end,
                                        const void* const (&vsrc)[kVecs], int nvec) {
  typedef Ring<HD, NRES> L;
  uint64_t* rbar = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* full = rbar + 1;
  uint64_t* empty = full + kStages;
  hg::mbar_expect_tx(rbar, NRES * L::tile);
  load_tile<HD>(smem, rm0, rbar, res);
  if (NRES == 2) load_tile<HD>(smem + L::tile, rm1, rbar, res);
  for (int i = first; i < end; ++i) {
    const int it = i - first, st = it % kStages;
    if (it >= kStages) hg::mbar_wait(&empty[st], (it / kStages - 1) & 1);
    hg::mbar_expect_tx(&full[st], 2 * L::tile + nvec * kVecBytes);
    unsigned char* s = smem + L::stages + st * 2 * L::tile;
    load_tile<HD>(s, sm0, &full[st], base + i * kTile);
    load_tile<HD>(s + L::tile, sm1, &full[st], base + i * kTile);
    for (int v = 0; v < nvec; ++v)
      hg::bulk_load(smem + L::vecs + (st * kVecs + v) * kVecBytes,
                    static_cast<const char*>(vsrc[v]) + static_cast<long long>(i) * kVecBytes,
                    kVecBytes, &full[st]);
  }
}

// Initialize the ring's barriers (thread 0), then sync the block.
template <int HD, int NRES>
__device__ __forceinline__ void init_ring(unsigned char* smem) {
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + Ring<HD, NRES>::bars);
  if (threadIdx.x == 0) {
    hg::mbar_init(bar, 1);
    for (int i = 0; i < kStages; ++i) {
      hg::mbar_init(bar + 1 + i, 1);
      hg::mbar_init(bar + 1 + kStages + i, kConsumers / 32);  // one arrive a consumer warp
    }
    hg::fence_barrier_init();
  }
  __syncthreads();
}

// Descriptor of a K-major [64 x HD] tile at k16 step kk.
__device__ __forceinline__ uint64_t desc_k(const unsigned char* tile, int kk) {
  return hg::desc_a(reinterpret_cast<const bf16*>(tile + (kk >> 2) * hg::kBoxBytes), kk & 3);
}
// Descriptor of a [64 x HD] tile as the MN-major B operand (its rows are
// K) at k16 step kk.
__device__ __forceinline__ uint64_t desc_mn(const unsigned char* tile, int kk) {
  return hg::desc_b(reinterpret_cast<const bf16*>(tile), kk);
}

// d = A B^T over HD: A, B K-major [64 x HD] tiles (d: 64 x 64).
template <int HD>
__device__ __forceinline__ void issue_nt(float (&d)[32], const unsigned char* a,
                                         const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) hg::mma_ss_kb<64>(d, desc_k(a, kk), desc_k(b, kk), kk > 0);
}

// d (+)= P B over 64 rows of B: pa the A fragments of P's four k16 steps.
template <int HD>
__device__ __forceinline__ void issue_pn(float (&d)[HD / 2], const uint32_t (&pa)[4][4],
                                         const unsigned char* b, int accumulate) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) hg::mma_rs<HD>(d, pa[kc], desc_mn(b, kc), accumulate || kc > 0);
}

// A 64 x 64 accumulator, rounded to bf16, as the A fragments of its four
// k16 steps.
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4], const float (&d)[32]) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kc][r] = flash::pack_bf16(d[8 * kc + 2 * r], d[8 * kc + 2 * r + 1]);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Store this thread's rows (16 w + g, + 8) of a [64 x HD] accumulator into
// out (rows of HD from the tile's first row), row h scaled by scale[h].
template <int HD>
__device__ __forceinline__ void store_acc(bf16* __restrict__ out, const float (&d)[HD / 2],
                                          const float (&scale)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, w = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      sae::store2(out + static_cast<long long>(16 * w + g + 8 * h) * HD + 8 * j + 2 * t,
                  d[4 * j + 2 * h] * scale[h], d[4 * j + 2 * h + 1] * scale[h]);
}

}  // namespace fw
