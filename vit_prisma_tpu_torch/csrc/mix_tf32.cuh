// Attention mix in float32 on the tensor cores: the 3xTF32 route of B1 and
// B15 (the forward below) and of B2 (attention_mix_tnh_bwd.cu, namespace
// f32tc there), for heads up to kMaxHead wide.  Included by
// attention_mix_core.cuh after the bfloat16 kernel, whose Layout, ex2 and
// warp count it shares.
//
// A float32 product on the tensor cores: three TF32 mma.sync products
// (tf32_mma.cuh), so the float32 contract of attention_mix_core.cuh holds:
// float32 scores and softmax, p not rounded, z accumulated in float32.
//
// What bounds it on an H100.  At CLIP ViT-L/14 (B 256, T 257, N 16, H 64)
// the forward forms q K^T twice (the exact two-pass softmax) and p V once:
// 3 x 34.6 GFLOP, each as three TF32 products, 311 GFLOP at 495 TFLOP/s,
// 0.63 ms; it moves 0.54 GB (0.16 ms).  The products, not the bytes, set the
// bound.  Each operand read from shared memory is split on the way (four
// instructions a register), so the instruction slots beside the mma.sync, and the
// mma latency where few warps share an SM (short token axes: a 12-warp
// tuning was 1.5x faster at T 50 but spilled once its scores summed the
// small products apart), are the next limits.
//
// Design (shared by the forward and both backward passes):
//  * a block takes a run of 16-row tiles of one (head, batch item) and
//    stages that head's resident pair (K and V; B2's columns pass Q and dZ)
//    once, as float32 rows of S floats, with cp.async.  S is H rounded up to
//    4 mod 8 where the pair fits (the 8 rows of an ldmatrix, and the 8 x 4
//    scalar reads of a permuted fragment, then hit distinct banks), else H
//    rounded up to 4; rows are zero-padded to a multiple of 8, and 16 zero
//    floats follow the last region: a k-step past S reads the next row's
//    first columns (finite, and multiplied by zero columns of the other
//    operand) or that slack;
//  * a warp's 16 rows (q, or the backward's k, v, dz) go from device memory
//    straight into A-fragment registers: the forward's q split once (H <=
//    64) or held raw and split per use; B2's operands raw (8-row tiles past
//    H 64, whose fragments are half zeros, so that both operands fit);
//  * scores: B fragments of the staged rows by ldmatrix (one x2 load a
//    k-step), split in registers, three mma.sync a k-step (staging
//    them split, as TF32 hi and lo rows, where they fit twice measured 10%
//    slower at T 50 and 77: twice the shared-memory reads);
//  * the products with p (or ds) as A: the m16n8k8 accumulator holds columns
//    2t and 2t + 1 of a thread's rows, the A fragment wants columns t and
//    t + 4, so the k index of each 8-key step is permuted (k = t <-> key 2t,
//    k = t + 4 <-> key 2t + 1) and the B fragment is read with the same
//    permutation (rows 2t and 2t + 1 of the staged operand): no shuffles;
//  * exact two-pass softmax as mix_tc_kernel's: pass 1 each row's max m and
//    sum l (per thread over its columns, rescaled as m grows, then merged
//    over the row's four threads), pass 2 p = exp2(s log2(e) - m log2(e)) / l
//    (one reciprocal a row) into the PV product; no online rescale of z;
//  * where heads x batch items leave the SMs idle (plan, below), a head's
//    tiles are split over blocks, each block computing whole rows (or whole
//    keys): no atomics, no sum split across blocks;
//  * the tensor cores' float32 accumulation truncates at each product: each
//    chunk's p-like product is summed from zero and added in FADDs
//    (pn_chunk; a key loop of T 257 summed on them had twice the error
//    against the plain version), and a score's small products are summed
//    apart from its large ones (a third less error again).
// A row's arithmetic depends on T, H and its own data only: not on the
// layout, the warp, the block split or B; so B1 = B15 and batch
// independence hold to the bit.
//
// Error budget of exp: ex2.approx.ftz.f32 is within 2 ulp of 2^x; its
// argument s log2(e) + nb (one fma, nb = -m log2(e) rounded) carries up to
// ulp(|m| log2(e)) / 2, about |m| 2^-24 log2(e), so each p is within about
// 2^-21 (|m| <= 16) of exp(s - m) / l: inside the kernels' 1e-5.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tf32_mma.cuh"

namespace mix {
namespace tf32 {

constexpr int kMaxHead = 128;
constexpr int kSlack = 16;  // zero floats past the last region

__host__ __device__ constexpr int head_pad(int h) { return (h + 15) & ~15; }
__host__ __device__ constexpr int round8(int x) { return (x + 7) & ~7; }

// Floats of one pass's shared memory at row stride s: two staged operands of
// round8(t) rows, with `stats` each row's three statistics (B2's columns
// pass), and the slack.
__host__ __device__ inline size_t smem_floats(int t, int s, bool stats) {
  return 2 * size_t(round8(t)) * s + (stats ? 3 * size_t(round8(t)) : 0) + kSlack;
}

// The row stride: H rounded up to 4 mod 8 where it fits, else to 4 (must
// match mix_tf32_layout in vit_prisma_tpu_torch/ops/attention.py).
__host__ __device__ inline int row_stride(int t, int h, bool stats) {
  const int padded = round8(h + 4) - 4;
  return sizeof(float) * smem_floats(t, padded, stats) <= kMaxSmemBytes ? padded : (h + 3) & ~3;
}

__host__ __device__ inline size_t smem_bytes(int t, int h, bool stats) {
  return sizeof(float) * smem_floats(t, row_stride(t, h, stats), stats);
}


// -inf where a score's key lies past the tokens or, causal, after its row
// (s[j][e]: row row0 + g + 8 (e / 2), key key0 + 8 j + 2 t + (e % 2)).
template <int NJ>
__device__ __forceinline__ void mask_scores(float (&s)[NJ][4], int key0, int row0, int n_tok,
                                            int causal) {
  if (key0 + kStep * NJ <= n_tok && !(causal && key0 + kStep * NJ - 1 > row0)) return;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + kStep * j + 2 * t + (e & 1);
      if (key >= n_tok || (causal && key > row0 + g + 8 * (e >> 1))) s[j][e] = -INFINITY;
    }
}

// Each thread's running max m and sum l of exp(s - m) over its own columns of
// rows g and g + 8, and with W the sum w of dp exp(s - m), all rescaled as m
// grows (exp2 with log2(e) folded in).
template <int NJ, bool W>
__device__ __forceinline__ void running_stats(float (&m)[2], float (&l)[2], float (&w)[2],
                                              const float (&s)[NJ][4], const float (&dp)[NJ][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = m[h];
#pragma unroll
    for (int j = 0; j < NJ; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
    const float shift = -(mx == -INFINITY ? 0.f : mx) * kLog2e;
    const float a = ex2(fmaf(m[h], kLog2e, shift));  // 0 while m is -inf
    float sum = l[h] * a, ws = W ? w[h] * a : 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float e = ex2(fmaf(s[j][2 * h + c], kLog2e, shift));
        sum += e;
        if (W) ws = fmaf(dp[j][2 * h + c], e, ws);
      }
    m[h] = mx;
    l[h] = sum;
    if (W) w[h] = ws;
  }
}

// A row's final max and sum from its four threads: mx (its max), sum, and
// with W the merged w; nb = -m log2(e) and inv = 1 / l as every pass forms
// them (row_factors).
template <bool W>
__device__ __forceinline__ void merge_stats(float (&mx)[2], float (&sum)[2], float (&ws)[2],
                                            const float (&m)[2], const float (&l)[2],
                                            const float (&w)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float x = m[h];
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    const float a = ex2(fmaf(m[h], kLog2e, -(x == -INFINITY ? 0.f : x) * kLog2e));
    float s = l[h] * a;
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    mx[h] = x;
    sum[h] = s;
    if (W) {
      float v = w[h] * a;
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      ws[h] = v;
    }
  }
}

// nb = -m log2(e) and inv = 1 / l of a row with max m and sum l: one
// function, so that B2's two passes form p from the same bits.
__device__ __forceinline__ void row_factors(float m, float l, float& nb, float& inv) {
  nb = -(m == -INFINITY ? 0.f : m) * kLog2e;
  inv = l > 0.f ? 1.f / l : 0.f;
}

__device__ __forceinline__ float prob(float s, float nb, float inv) {
  return ex2(fmaf(s, kLog2e, nb)) * inv;
}

// Store acc[n] (columns c0 + 8 n + 2 t + (e % 2) of rows row0 + g + 8 (e / 2))
// into one head's rows (row r at p + r * ts), columns below d_head, rows
// below R.
template <int NC, int R = kRows>
__device__ __forceinline__ void store_acc(float* __restrict__ p, const float (&acc)[NC][4],
                                          long long ts, int row0, int c0, int n_tok, int d_head) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < R / 8; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= n_tok) continue;
    float* r = p + (long long)row * ts;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int col = c0 + 8 * n + 2 * t;
      if (col < d_head) r[col] = acc[n][2 * h];
      if (col + 1 < d_head) r[col + 1] = acc[n][2 * h + 1];
    }
  }
}

// ---- staging -------------------------------------------------------------------

// Stage rows [r0, r1) of one head (row r at src + r * ts) into dst rows of S
// floats (row r at dst + r * S) of a region of `rows` rows, as one cp.async
// group: 16 bytes at a time with `vec` (H a multiple of 4, every row 16-byte
// aligned), else one float at a time; rows at or past n_tok and columns at or
// past d_head are zeros.  Where rows around the staged ones stay unwritten,
// the first kSlack floats past row r1 - 1, and (r0 > 0) the region's first
// kSlack floats (where the region before overruns), are zeroed: every read
// past a row's S floats then meets finite values.
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src, long long ts,
                                           int r0, int r1, int rows, int n_tok, int d_head,
                                           int S, bool vec) {
  if (vec) {
    const int C = S / 4;
    for (int i = threadIdx.x; i < (r1 - r0) * C; i += blockDim.x) {
      const int r = r0 + i / C, c = 4 * (i % C);
      float* d = dst + r * S + c;
      if (r < n_tok && c < d_head)
        sae::cp_async16(d, src + r * ts + c);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int i = threadIdx.x; i < (r1 - r0) * S; i += blockDim.x) {
      const int r = r0 + i / S, c = i % S;
      dst[r * S + c] = r < n_tok && c < d_head ? src[r * ts + c] : 0.f;
    }
  }
  if (threadIdx.x < kSlack) {
    if (r0 > 0) dst[threadIdx.x] = 0.f;
    if (r1 < rows) dst[r1 * S + threadIdx.x] = 0.f;
  }
  sae::cp_async_commit();
}

__device__ __forceinline__ void zero_slack(float* p) {
  if (threadIdx.x < kSlack) p[threadIdx.x] = 0.f;
}

// ---- the block split -----------------------------------------------------------

struct Plan {
  int splits, tiles, warps;  // blocks a head, 16-row tiles a block, warps a block
};

// How many blocks take one head's n_tiles tiles.  Without a split while
// `pairs` (heads x batch items) blocks fill the card twice over; else the
// split with the fewest tile rounds, waves x (tiles a block + 1 for the
// staging), counting blocks an SM holds at each block size; the smallest
// such split.  A result does not depend on the split.
template <typename Kernel>
inline Plan plan(Kernel kernel, long long pairs, int n_tiles, size_t smem, int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      sms < 1) {
    cudaGetLastError();
    sms = 1;
  }
  int per_sm_at[kTcMaxWarps + 1] = {};
  Plan best{1, n_tiles, tc_warps(n_tiles)};
  long long best_cost = -1;
  for (int s = 1; s <= n_tiles; ++s) {
    const int tiles = (n_tiles + s - 1) / s;
    if ((n_tiles + tiles - 1) / tiles != s) continue;  // the blocks of a smaller split
    const int warps = tc_warps(tiles);
    int& per_sm = per_sm_at[warps];
    if (per_sm == 0 &&
        (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, warps * 32, smem) !=
             cudaSuccess ||
         per_sm < 1)) {
      cudaGetLastError();
      per_sm = 1;
    }
    const long long slots = (long long)sms * per_sm;
    const long long cost = (pairs * s + slots - 1) / slots * (tiles + 1);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = {s, tiles, warps};
    }
    if (s == 1 && pairs >= 2 * slots) break;
  }
  return best;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              int(cudaSharedmemCarveoutMaxShared));
}

// ---- forward (B1, B15) -----------------------------------------------------------

// 8-key steps a score chunk spans (independent mma chains, and registers),
// and whether a warp holds q split (twice the registers, no split a chunk)
// or raw (split in the loop: split_kept).
__host__ __device__ constexpr int fwd_subs(int hp) { return hp <= 64 ? 4 : 2; }
__host__ __device__ constexpr bool fwd_presplit(int hp) { return hp <= 64; }

// Calls f(std::integral_constant<int, J>(), x) for the chunks of 8-key
// steps from x0 to end (a multiple of 8 past x0): NJ steps a chunk, then a
// chunk of 2 and single steps for the rest, so that short token axes keep
// independent mma chains.  A score's products are summed in one order
// whatever its chunk.
template <int NJ, typename F>
__device__ __forceinline__ void for_chunks(int x0, int end, F&& f) {
#pragma unroll 1
  for (; x0 + NJ * kStep <= end; x0 += NJ * kStep) f(std::integral_constant<int, NJ>(), x0);
  if constexpr (NJ > 2) {
    if (x0 + 2 * kStep <= end) {
      f(std::integral_constant<int, 2>(), x0);
      x0 += 2 * kStep;
    }
  }
  if constexpr (NJ > 1) {
#pragma unroll 1
    for (; x0 < end; x0 += kStep) f(std::integral_constant<int, 1>(), x0);
  }
}

// Pass 1 over one chunk of NJ 8-key steps from key0.
template <int HP, int NJ, typename QA>
__device__ __forceinline__ void fwd_pass1(float (&m)[2], float (&l)[2], const QA (&qa)[HP / 8],
                                          const float* Ks, int S, int key0, int row0, int n_tok,
                                          int causal) {
  float s[NJ][4], unused[2];
  nt_chunk<HP, NJ, true, !fwd_presplit(HP)>(s, qa, Ks, S, key0);
  mask_scores<NJ>(s, key0, row0, n_tok, causal);
  running_stats<NJ, false>(m, l, unused, s, s);
}

// Pass 2 over one chunk: p into acc += p V.
template <int HP, int NJ, typename QA>
__device__ __forceinline__ void fwd_pass2(float (&acc)[HP / 8][4], const float (&nb)[2],
                                          const float (&inv)[2], const QA (&qa)[HP / 8],
                                          const float* Ks, const float* Vs, int S, int key0,
                                          int row0, int n_tok, int causal) {
  float s[NJ][4];
  nt_chunk<HP, NJ, true, !fwd_presplit(HP)>(s, qa, Ks, S, key0);
  mask_scores<NJ>(s, key0, row0, n_tok, causal);
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = prob(s[j][e], nb[e >> 1], inv[e >> 1]);
  pn_chunk<HP / 8>(acc, s, Vs, S, key0, 0);
}

// z for rows [row0, row0 + 16) of one head, q's fragments qa (raw or split).
template <int HP, typename QA>
__device__ __forceinline__ void fwd_rows(const QA (&qa)[HP / 8], const float* Ks,
                                         const float* Vs, int S, float* __restrict__ zh,
                                         long long ts, int row0, int n_tok, int d_head,
                                         int causal, bool sync_v) {
  constexpr int NJ = fwd_subs(HP);
  const int end = round8(causal ? min(n_tok, row0 + kRows) : n_tok);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for_chunks<NJ>(0, end, [&](auto nj, int key0) {
    fwd_pass1<HP, decltype(nj)::value>(m, l, qa, Ks, S, key0, row0, n_tok, causal);
  });
  float mx[2], sum[2], unused[2], nb[2], inv[2];
  merge_stats<false>(mx, sum, unused, m, l, l);
#pragma unroll
  for (int h = 0; h < 2; ++h) row_factors(mx[h], sum[h], nb[h], inv[h]);

  if (sync_v) {
    sae::cp_async_wait<0>();
    __syncthreads();
  }

  float acc[HP / 8][4];
#pragma unroll
  for (int n = 0; n < HP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for_chunks<NJ>(0, end, [&](auto nj, int key0) {
    fwd_pass2<HP, decltype(nj)::value>(acc, nb, inv, qa, Ks, Vs, S, key0, row0, n_tok, causal);
  });
  store_acc<HP / 8>(zh, acc, ts, row0, 0, n_tok, d_head);
}

template <int HP>
__device__ __forceinline__ void fwd_tile(const float* Ks, const float* Vs, int S,
                                         const float* __restrict__ qh, float* __restrict__ zh,
                                         long long ts, int row0, int n_tok, int d_head,
                                         int causal, bool sync_v) {
  float qa[HP / 8][4];
  load_a<HP>(qa, qh, ts, row0, n_tok, d_head);
  if constexpr (fwd_presplit(HP)) {
    Frag qs[HP / 8];
#pragma unroll
    for (int kk = 0; kk < HP / 8; ++kk) split4(qs[kk], qa[kk]);
    fwd_rows<HP>(qs, Ks, Vs, S, zh, ts, row0, n_tok, d_head, causal, sync_v);
  } else {
    fwd_rows<HP>(qa, Ks, Vs, S, zh, ts, row0, n_tok, d_head, causal, sync_v);
  }
}

// Grid (splits, N, B); plan's warps; smem_bytes(T, H, false) of shared
// memory.  Block x takes the 16-row tiles [x * tiles, (x + 1) * tiles) of its
// head and stages the keys those rows see (all of them, or causal up to its
// last row), K as one cp.async group and V as another, so pass 1 runs while
// V arrives.  vec: as stage_rows.
template <int HP>
__global__ void __launch_bounds__(kTcMaxWarps * 32, 1)
    mix_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ z, int n_tok, int d_head,
                    int causal, int S, int tiles, int vec, Layout lay) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rows = round8(n_tok);
  float* Ks = reinterpret_cast<float*>(smem_raw);  // [rows][S]
  float* Vs = Ks + rows * S;                       // [rows][S], then the slack
  const long long ts = lay.tok_stride;
  const long long base =
      (long long)blockIdx.z * lay.batch_stride + (long long)blockIdx.y * lay.head_stride;
  const int n_tiles = (n_tok + kRows - 1) / kRows;
  const int tile0 = blockIdx.x * tiles, tile_end = min(n_tiles, tile0 + tiles);
  const int key_end = round8(causal ? min(n_tok, tile_end * kRows) : n_tok);
  stage_rows(Ks, k + base, ts, 0, key_end, rows, n_tok, d_head, S, vec);
  stage_rows(Vs, v + base, ts, 0, key_end, rows, n_tok, d_head, S, vec);
  zero_slack(Vs + rows * S);
  sae::cp_async_wait<1>();
  __syncthreads();

  // Warp w takes the tiles tile0 + w, + warps, ...; a warp of the last block
  // may have none, and then only meets the others at V's barrier.
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  if (tile0 + warp >= tile_end) {
    sae::cp_async_wait<0>();
    __syncthreads();
  }
  for (int i = tile0 + warp; i < tile_end; i += warps)
    fwd_tile<HP>(Ks, Vs, S, q + base, z + base, ts, i * kRows, n_tok, d_head, causal,
                 i == tile0 + warp);
}

template <int HP>
cudaError_t launch_fwd_hp(const float* q, const float* k, const float* v, float* z, int batch,
                          int n_tok, int n_heads, int d_head, int causal, Layout lay,
                          int device, cudaStream_t stream) {
  const size_t smem = smem_bytes(n_tok, d_head, false);
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  auto kernel = mix_tf32_kernel<HP>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const Plan p = plan(kernel, (long long)batch * n_heads, (n_tok + kRows - 1) / kRows, smem,
                      device);
  const bool vec = d_head % 4 == 0 && (lay.tok_stride | lay.head_stride | lay.batch_stride) % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  kernel<<<dim3(p.splits, n_heads, batch), p.warps * 32, smem, stream>>>(
      q, k, v, z, n_tok, d_head, causal, row_stride(n_tok, d_head, false), p.tiles, int(vec),
      lay);
  return cudaGetLastError();
}

inline cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* z, int batch,
                              int n_tok, int n_heads, int d_head, int causal, Layout lay,
                              int device, cudaStream_t stream) {
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v);
  float* zf = static_cast<float*>(z);
  switch (head_pad(d_head)) {
#define TF32_CASE(HP) \
  case HP:            \
    return launch_fwd_hp<HP>(qf, kf, vf, zf, batch, n_tok, n_heads, d_head, causal, lay, device, stream);
    TF32_CASE(16) TF32_CASE(32) TF32_CASE(48) TF32_CASE(64)
    TF32_CASE(80) TF32_CASE(96) TF32_CASE(112) TF32_CASE(128)
#undef TF32_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace tf32
}  // namespace mix
