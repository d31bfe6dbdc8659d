// Tile products shared by the bfloat16 mma.sync kernels of B13
// (flash_attention_fwd.cu, flash_attention_bwd.cu) and by B16's bfloat16
// route (attention_block.cu).
//
// A block has 4 warps; each warp owns 16 rows of a 64-row tile.  Tiles of
// 64 rows by HD columns (HD = head width, a multiple of 16) sit in shared
// memory row-major with each row padded by 16 bytes (ldmatrix then falls in
// distinct banks).  Two products:
//   nt:  C[16 x 64]  += A[16 x HD] B[64 x HD]^T   (A, B: shared tiles)
//   pn:  C[16 x HD]  += P[16 x 64] B[64 x HD]     (P: a warp's nt result,
//                                                  rounded to bfloat16; B shared)
// Every accumulator is in the mma.sync m16n8 C-fragment layout:
//   c[j][e], e < 4: row g + 8 (e / 2), column 8 j + 2 t + (e % 2)
// with g = lane / 4, t = lane % 4: mma.sync m16n8k16 with float32
// accumulation, fed by ldmatrix (sae_gemm.cuh's helpers); nt's C fragments
// become pn's A fragments in registers, rounded to bfloat16 on the way.
// The float32 routes of B13 and B16 are 3xTF32 (flash_tf32.cuh,
// hopper_gemm.cuh); the last pointer argument of nt and pn is unused.
#pragma once

#include "sae_gemm.cuh"

namespace flash {

using sae::from_f;
using sae::to_f;

constexpr int kTile = 64;  // rows of a query or key tile
constexpr int kWarps = 4, kThreads = 32 * kWarps;

template <typename T, int HD>
struct Geo {
  static constexpr int stride = HD + 16 / static_cast<int>(sizeof(T));  // elements a row
  static constexpr int tile = kTile * stride;                            // elements a tile
  static constexpr int tile_bytes = tile * static_cast<int>(sizeof(T));
};

// Copy rows [0, 64) of a [*, HD] tile (row r at g + r * HD) into shared
// memory, 16 bytes a thread at a time; kThreads threads.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(T* s, const T* __restrict__ g) {
  constexpr int vec = 16 / sizeof(T);
  constexpr int per_row = HD / vec;
  for (int i = threadIdx.x; i < kTile * per_row; i += kThreads) {
    const int r = i / per_row, c = (i % per_row) * vec;
    sae::cp_async16(s + r * Geo<T, HD>::stride + c, g + static_cast<long long>(r) * HD + c);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
}

// ---- bfloat16: tensor cores ------------------------------------------------

// c[8][4] += A B^T; Aw: the warp's 16 rows, Bs: 64 rows.
template <int HD>
__device__ __forceinline__ void nt(float (&c)[8][4], const __nv_bfloat16* Aw,
                                   const __nv_bfloat16* Bs, float*) {
  constexpr int S = Geo<__nv_bfloat16, HD>::stride;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < HD; kk += 16) {
    uint32_t a[4];
    sae::ldsm_x4(a, Aw + (lane & 15) * S + kk + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t r[4];
      sae::ldsm_x4(r, Bs + (16 * np + (lane & 7) + ((lane >> 4) << 3)) * S + kk +
                          ((lane >> 3) & 1) * 8);
      sae::mma_bf16(c[2 * np], a, r[0], r[1]);
      sae::mma_bf16(c[2 * np + 1], a, r[2], r[3]);
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c[HD/8][4] += P B with P = p rounded to bfloat16; Bs: 64 rows of HD.
template <int HD>
__device__ __forceinline__ void pn(float (&c)[HD / 8][4], const float (&p)[8][4],
                                   const __nv_bfloat16* Bs, float*) {
  constexpr int S = Geo<__nv_bfloat16, HD>::stride;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    uint32_t a[4];
    a[0] = pack_bf16(p[2 * kc][0], p[2 * kc][1]);
    a[1] = pack_bf16(p[2 * kc][2], p[2 * kc][3]);
    a[2] = pack_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1]);
    a[3] = pack_bf16(p[2 * kc + 1][2], p[2 * kc + 1][3]);
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      uint32_t r[4];
      sae::ldsm_x4_t(r, Bs + (16 * kc + (lane & 7) + ((lane >> 3) & 1) * 8) * S + 16 * np +
                            (lane >> 4) * 8);
      sae::mma_bf16(c[2 * np], a, r[0], r[1]);
      sae::mma_bf16(c[2 * np + 1], a, r[2], r[3]);
    }
  }
}

// Shared memory of a kernel holding n_tiles tiles and `extra` bytes of
// per-tile vectors.
template <typename T, int HD>
__host__ __device__ constexpr int smem_bytes(int n_tiles, int extra) {
  return n_tiles * Geo<T, HD>::tile_bytes + extra;
}

// Store a warp's c[HD/8][4] (rows row0 + g, row0 + g + 8) into out rows of HD,
// rounded to T, each row scaled by its inv[0 or 1].
template <typename T, int HD>
__device__ __forceinline__ void store_rows(T* __restrict__ out, const float (&c)[HD / 8][4],
                                           const float (&inv)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      sae::store2(out + static_cast<long long>(g + 8 * h) * HD + 8 * j + 2 * t,
                  c[j][2 * h] * inv[h], c[j][2 * h + 1] * inv[h]);
}

}  // namespace flash
