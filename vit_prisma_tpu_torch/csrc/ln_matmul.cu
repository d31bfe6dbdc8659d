// LayerNorm -> GEMM: out[s] = normalize(x) @ W[s] + b[s] for a stack of S
// projections sharing one weightless normalize.
//
// Replaces the Pallas TPU kernel `_ln_matmul_kernel`, launched by
// `_ln_matmul_forward` in vit_prisma_tpu/ops/ln_matmul.py (kernel B14 of the
// ROADMAP).  Same contract: x [R, D], W [S, D, C], b [S, C] -> out [S, R, C],
// all of one dtype; the normalize is a float32 island (xc = x - mean(x),
// scale = sqrt(mean(xc^2) + eps), xn = xc / scale) whose result is rounded
// to x's dtype before the float32-accumulated GEMM; the bias is added in
// float32 and the sum rounded to x's dtype.  The output is [S, R, C] so that
// out[0], out[1], out[2] are contiguous q, k, v for the attention mix.  An
// affine LayerNorm folds into W and b before the call (fold_ln_affine in the
// wrapper), so the kernel implements the weightless normalize only.
//
// What bounds it on an H100.  At CLIP ViT-B/32, batch 256 (R = 12,800, D =
// 768) the QKV call (S = 3, C = 768) does 45 GFLOP against 82 MB moved: ~550
// flops per byte, above the ~295 where the bf16 tensor cores, not memory,
// are the limit.  So it is a GEMM first, and the fusion's gain is the LN
// output's round trip through device memory (R x D written and read) plus
// the LN's own unfused elementwise passes.  In float32 each product is three
// TF32 products (3xTF32, below): CLIP L/14-336's MLP-in at the store batch
// of 32 (R = 18,464, D 1024 -> C 4096) is 464 GFLOP of TF32, 0.94 ms at 495
// TFLOP/s, against 0.16 ms of bytes.
//
// Design.  A first pass (ln_stats_kernel) reads each row once, one warp a
// row, and writes its float32 mean and scale (8 bytes a row).  Then the GEMM
// normalizes each landed x tile, (x - mean) / scale rounded to x's dtype
// (the quotient from the row's reciprocal with one Newton correction: a
// division's result but in rare last-bit cases, at a quarter of its
// instructions), before the products read it, so xn never exists in device
// memory.  Both routes are hopper_gemm.cuh's: one producer warp keeps a
// 4-stage ring of x and W tiles filled by TMA, 128-byte swizzled, on
// mbarriers; two consumer warpgroups own 64 rows each of the 128-row tile
// and issue wgmma with float32 accumulators.  TMA zero-fills rows past R
// (and, bf16, columns past D).  By dtype:
//  * bfloat16 (ln_gemm_tc_kernel): [128 x 64] x tiles and [64 x BN] W tiles
//    (BN = 256 where C allows, else 128).  Each consumer normalizes its 64
//    rows of a landed stage in place (a swizzle moves 16-byte chunks only
//    within a row, and the normalize needs only the row's mean and scale,
//    so it ignores the swizzle), fences the writes to the async proxy,
//    meets its own named barrier, and issues wgmma m64nBNk16; one stage's
//    products run while the next stage is normalized (a D that is a
//    multiple of 32 but not of 64 ends in a half-empty stage: W's missing
//    rows are zero, so the normalized zero columns add nothing).  Epilogue:
//    the bias in float32, one rounding, staged swizzled in the ring and
//    stored by TMA (rows < R).
//  * float32 (ln_gemm_tf32_kernel, 3xTF32): tf32 wgmma reads B K-major only,
//    and W lies C-contiguous, so a pre-pass (hopper_gemm.cuh's
//    split_k_major_kernel) writes W's TF32 hi and lo parts K-major, [2, S,
//    C, D], into the wrapper's scratch (W is new every forward: the fold
//    scales it, so nothing can be cached; 2 x 16.8 MB written at L/14-336,
//    against 75.6 MB of x read).  The transposed product (W as register A)
//    would avoid it, but its A fragments would be C-strided reads of every
//    W tile by both warpgroups, and x would then have to be split into hi
//    and lo tiles in shared memory.  A two-CTA cluster that multicasts each
//    W tile to two row tiles halves W's L2 reads but ran 1.4x slower (NVIDIA
//    H100 80GB HBM3, 700 W).  A stage is a [128 x 32] x tile and [128 x 32]
//    W hi and lo tiles (48 KB; 4 stages).  Each consumer thread reads its
//    own x elements of a landed stage (two 16-byte chunks a row, in the K
//    order the pre-pass wrote W in), normalizes and splits them in
//    registers, and issues wgmma m64n128k8 with A from registers: the
//    stage's 32-deep sum from zero (x_lo W_hi, x_hi W_lo, x_hi W_hi),
//    waited for, then added to the float32 total (the tensor cores
//    truncate at each product; a whole K in one accumulator drifts by
//    about half an ulp a k-step).  The two warpgroups' products
//    interleave on the tensor cores while each adds, loads and splits.
//    Epilogue: the bias in float32, stored from the registers (rows < R).
//    No split-K and no atomics: a row's output is summed in one fixed
//    order whatever R or its tile.
//  Grid (C / BN, ceil(R / 128), S); R is any size; C must be a multiple of
//  128 and D of 32, and every pointer 16-byte aligned (the wrapper's gate,
//  ln_matmul_fits).

#include "hopper_gemm.cuh"

#include <math.h>

namespace {

using sae::allow_smem;
using sae::store2;
using sae::to_f;

constexpr int kRowTile = 128, kColTile = 128, kDepthStep = 32;  // the gate's tiles

// One warp a row: mean and scale = sqrt(mean((x - mean)^2) + eps), float32.
template <typename T>
__global__ void ln_stats_kernel(const T* __restrict__ x, float* __restrict__ stats, int R,
                                int D, float eps) {
  const int warps = blockDim.x / 32;
  const int row = blockIdx.x * warps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= R) return;
  const T* xr = x + static_cast<long long>(row) * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s += to_f(xr[d]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const float mean = s / D;
  float q = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float c = to_f(xr[d]) - mean;
    q = fmaf(c, c, q);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
  if (lane == 0) {
    stats[2 * static_cast<long long>(row)] = mean;
    stats[2 * static_cast<long long>(row) + 1] = sqrtf(q / D + eps);
  }
}

// (x - mean) / scale in float32: the quotient from the reciprocal and one
// Newton correction (two FMAs), which equals the reference's division but in
// rare last-bit cases.
__device__ __forceinline__ float norm1(float x, float m, float sc, float inv) {
  const float c = x - m;
  const float q = c * inv;
  return fmaf(fmaf(-q, sc, c), inv, q);
}

// Normalize 16 bytes of landed bf16 x in place, rounded to bf16.
__device__ __forceinline__ void normalize16(__nv_bfloat16* p, float m, float sc, float inv) {
  uint4 u = *reinterpret_cast<uint4*>(p);
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w[i]));
    __nv_bfloat162 r = __floats2bfloat162_rn(norm1(f.x, m, sc, inv), norm1(f.y, m, sc, inv));
    w[i] = *reinterpret_cast<uint32_t*>(&r);
  }
  *reinterpret_cast<uint4*>(p) = u;
}

// ---- bfloat16: TMA, mbarriers and wgmma -------------------------------------

namespace tc {

constexpr int kBM = 128;                 // rows of a block tile, 64 a consumer warpgroup
constexpr int kBK = hg::kBox;            // K a stage
constexpr int kStages = 4;
constexpr int kConsumers = 2;            // warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer's warpgroup
constexpr int kABytes = kBM * kBK * 2;   // one stage's x tile

template <int BN>
struct Layout {
  static constexpr int stage_bytes = kABytes + (BN / hg::kBox) * hg::kBoxBytes;
  static constexpr int bar_offset = kStages * stage_bytes;
  static constexpr int bytes = bar_offset + 2 * kStages * 8 + hg::kSwizzleAlign;
  static_assert(kConsumers * (BN / hg::kBox) * hg::kBoxBytes <= bar_offset, "out staging");
};

// Grid (C / BN, ceil(R / kBM), S), kThreads threads, Layout<BN>::bytes of
// dynamic shared memory.  xmap: x [R, D] in boxes of [kBM rows x 64];
// wmap: W [S, D, C] and omap: out [S, R, C] in boxes of [1 x 64 x 64].
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    ln_gemm_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap wmap,
                      const __grid_constant__ CUtensorMap omap, const float* __restrict__ stats,
                      const __nv_bfloat16* __restrict__ b, int R, int D, int C) {
  typedef Layout<BN> L;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + hg::kSwizzleAlign - 1) &
      ~static_cast<uintptr_t>(hg::kSwizzleAlign - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bar_offset);
  uint64_t* empty = full + kStages;
  const int s = blockIdx.z, m0 = blockIdx.y * kBM, n0 = blockIdx.x * BN;
  const int ktiles = (D + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      hg::mbar_init(&full[i], 1);
      hg::mbar_init(&empty[i], 4 * kConsumers);  // one arrive a consumer warp
    }
    hg::fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {  // the producer: one thread issues every copy
    hg::reg_dealloc<40>();
    if (threadIdx.x == 128 * kConsumers) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int st = kt % kStages, round = kt / kStages;
        if (round > 0) hg::mbar_wait(&empty[st], (round - 1) & 1);
        unsigned char* stage = smem + st * L::stage_bytes;
        hg::mbar_expect_tx(&full[st], L::stage_bytes);
        hg::tma_load_2d(stage, &xmap, &full[st], kt * kBK, m0);
#pragma unroll
        for (int i = 0; i < BN / hg::kBox; ++i)
          hg::tma_load_3d(stage + kABytes + i * hg::kBoxBytes, &wmap, &full[st],
                          n0 + i * hg::kBox, kt * kBK, s);
      }
    }
  } else {  // consumer warpgroup wg: rows m0 + 64 wg .. + 64
    hg::reg_alloc<232>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t & 31, tq = lane & 3;
    // this thread normalizes rows t / 8 + 16 j, j < 4, of the warpgroup's 64
    float mean[4], scale[4], inv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = m0 + 64 * wg + t / 8 + 16 * j;
      mean[j] = row < R ? stats[2 * static_cast<long long>(row)] : 0.f;
      scale[j] = row < R ? stats[2 * static_cast<long long>(row) + 1] : 1.f;
      inv[j] = 1.f / scale[j];
    }
    // this thread's bias column pairs, loaded under the products
    __nv_bfloat162 bias[BN / 8];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      bias[j] = *reinterpret_cast<const __nv_bfloat162*>(b + static_cast<long long>(s) * C + n0 +
                                                          8 * j + 2 * tq);
    float acc[BN / 2];  // the first products overwrite it (scale_d 0)
    for (int kt = 0; kt < ktiles; ++kt) {
      const int st = kt % kStages;
      hg::mbar_wait(&full[st], (kt / kStages) & 1);
      unsigned char* stage = smem + st * L::stage_bytes;
      __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(stage) + 64 * wg * kBK;
      const __nv_bfloat16* Bs = reinterpret_cast<const __nv_bfloat16*>(stage + kABytes);
#pragma unroll
      for (int j = 0; j < 4; ++j)  // chunk t + 128 j: row t / 8 + 16 j, any of its 8 chunks
        normalize16(As + (t + 128 * j) * 8, mean[j], scale[j], inv[j]);
      hg::fence_proxy_async_smem();
      hg::named_sync(1 + wg, 128);
      hg::fence_acc(acc);
      hg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        hg::mma_ss<BN>(acc, hg::desc_a(As, kk), hg::desc_b(Bs, kk), kt > 0 || kk > 0);
      hg::wgmma_commit();
      hg::wgmma_wait<1>();  // the previous stage's products are done
      hg::fence_acc(acc);
      if (kt > 0 && lane == 0) hg::mbar_arrive(&empty[(kt - 1) % kStages]);
    }
    hg::wgmma_wait<0>();
    hg::fence_acc(acc);

    // Epilogue: the bias in float32, one rounding, into this warpgroup's
    // [64 x BN] tile staged 128-byte swizzled in the ring (free once both
    // warpgroups' products are done: every load has been consumed), then
    // stored by TMA, which drops the rows past R.
    hg::named_sync(3, 128 * kConsumers);
    unsigned char* ostage = smem + wg * (BN / hg::kBox) * hg::kBoxBytes;
    const int g = lane >> 2;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float2 b01 = __bfloat1622float2(bias[j]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * warp + g + 8 * h;
        store2(reinterpret_cast<__nv_bfloat16*>(ostage + j / 8 * hg::kBoxBytes +
                                                hg::sw128(row, j % 8) + 4 * tq),
               acc[4 * j + 2 * h] + b01.x, acc[4 * j + 2 * h + 1] + b01.y);
      }
    }
    hg::fence_proxy_async_smem();
    hg::named_sync(1 + wg, 128);
    if (t == 0) {
#pragma unroll
      for (int i = 0; i < BN / hg::kBox; ++i)
        hg::tma_store_3d(&omap, ostage + i * hg::kBoxBytes, n0 + i * hg::kBox, m0 + 64 * wg, s);
      hg::bulk_commit();
      hg::bulk_wait_read();  // the staging outlives the stores' reads
    }
  }
}

template <int BN>
cudaError_t launch(const void* x, const void* W, const void* b, void* out, const float* stats,
                   int R, int S, int D, int C, cudaStream_t stream) {
  CUtensorMap xmap, wmap, omap;
  const uint64_t xdims[2] = {static_cast<uint64_t>(D), static_cast<uint64_t>(R)};
  const uint64_t xstrides[1] = {static_cast<uint64_t>(D) * 2};
  const uint32_t xbox[2] = {kBK, kBM};
  cudaError_t err = hg::make_map(&xmap, x, 2, xdims, xstrides, xbox);
  if (err != cudaSuccess) return err;
  const uint64_t wdims[3] = {static_cast<uint64_t>(C), static_cast<uint64_t>(D),
                             static_cast<uint64_t>(S)};
  const uint64_t wstrides[2] = {static_cast<uint64_t>(C) * 2, static_cast<uint64_t>(D) * C * 2};
  const uint32_t wbox[3] = {hg::kBox, kBK, 1};
  if ((err = hg::make_map(&wmap, W, 3, wdims, wstrides, wbox)) != cudaSuccess) return err;
  const uint64_t odims[3] = {static_cast<uint64_t>(C), static_cast<uint64_t>(R),
                             static_cast<uint64_t>(S)};
  const uint64_t ostrides[2] = {static_cast<uint64_t>(C) * 2, static_cast<uint64_t>(R) * C * 2};
  const uint32_t obox[3] = {hg::kBox, hg::kBox, 1};
  if ((err = hg::make_map(&omap, out, 3, odims, ostrides, obox)) != cudaSuccess) return err;
  auto kernel = ln_gemm_tc_kernel<BN>;
  if ((err = allow_smem(kernel, Layout<BN>::bytes)) != cudaSuccess) return err;
  const dim3 grid(C / BN, (R + kBM - 1) / kBM, S);
  kernel<<<grid, kThreads, Layout<BN>::bytes, stream>>>(
      xmap, wmap, omap, stats, static_cast<const __nv_bfloat16*>(b), R, D, C);
  return cudaGetLastError();
}

}  // namespace tc

template <typename T>
cudaError_t launch_stats(const T* x, float* stats, int R, int D, float eps, cudaStream_t stream) {
  constexpr int kStatsWarps = 8;
  ln_stats_kernel<T><<<(R + kStatsWarps - 1) / kStatsWarps, 32 * kStatsWarps, 0, stream>>>(
      x, stats, R, D, eps);
  return cudaGetLastError();
}

// ---- float32: 3xTF32 on tf32 wgmma ------------------------------------------

namespace tf {

constexpr int kBM = 128;                 // rows of a block tile, 64 a consumer warpgroup
constexpr int kBN = 128;
constexpr int kBK = hg::kF32Box;         // K a stage: one 128-byte row of floats
constexpr int kStages = 4;
constexpr int kConsumers = 2;            // warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer's warpgroup
constexpr int kABytes = kBM * kBK * 4;   // one stage's x tile
constexpr int kBBytes = kBN * kBK * 4;   // one stage's W hi (or lo) tile
constexpr int kStageBytes = kABytes + 2 * kBBytes;
constexpr int kBarOffset = kStages * kStageBytes;
constexpr int kBytes = kBarOffset + 2 * kStages * 8 + hg::kSwizzleAlign;

// Where the split W starts in the scratch, in floats: past the 2 R floats of
// the rows' statistics, 128-byte aligned.
inline long long wt_offset(int R) { return (2LL * R + 31) / 32 * 32; }

// Grid (C / kBN, ceil(R / kBM), S), kThreads threads, kBytes of dynamic
// shared memory.  xmap: x [R, D] in boxes of [kBM rows x 32]; wmap: the
// split W [2 S, C, D] (hi at s, lo at S + s) in boxes of [1 x kBN x 32].
__global__ void __launch_bounds__(kThreads, 1)
    ln_gemm_tf32_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap wmap, const float* __restrict__ stats,
                        const float* __restrict__ b, float* __restrict__ out, int R, int S, int D,
                        int C) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + hg::kSwizzleAlign - 1) &
      ~static_cast<uintptr_t>(hg::kSwizzleAlign - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOffset);
  uint64_t* empty = full + kStages;
  const int s = blockIdx.z, m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int ktiles = D / kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      hg::mbar_init(&full[i], 1);
      hg::mbar_init(&empty[i], 4 * kConsumers);  // one arrive a consumer warp
    }
    hg::fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {  // the producer: one thread issues every copy
    hg::reg_dealloc<40>();
    if (threadIdx.x == 128 * kConsumers) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int st = kt % kStages, round = kt / kStages;
        if (round > 0) hg::mbar_wait(&empty[st], (round - 1) & 1);
        unsigned char* stage = smem + st * kStageBytes;
        hg::mbar_expect_tx(&full[st], kStageBytes);
        hg::tma_load_2d(stage, &xmap, &full[st], kt * kBK, m0);
        hg::tma_load_3d(stage + kABytes, &wmap, &full[st], kt * kBK, n0, s);
        hg::tma_load_3d(stage + kABytes + kBBytes, &wmap, &full[st], kt * kBK, n0, S + s);
      }
    }
  } else {  // consumer warpgroup wg: rows m0 + 64 wg .. + 64
    hg::reg_alloc<232>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t & 31, g = lane >> 2, tq = lane & 3;
    const int row0 = 64 * wg + 16 * warp;  // this warp's rows within the tile
    // this thread's rows m0 + row0 + g + 8 h: x[kk][e] lies in row h = e % 2
    float mean[2], scale[2], inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + row0 + g + 8 * h;
      mean[h] = row < R ? stats[2 * static_cast<long long>(row)] : 0.f;
      scale[h] = row < R ? stats[2 * static_cast<long long>(row) + 1] : 1.f;
      inv[h] = 1.f / scale[h];
    }
    float acc[kBN / 2], c[kBN / 2];  // c: a stage's sum, from zero (scale_d 0)
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < ktiles; ++kt) {
      const int st = kt % kStages;
      hg::mbar_wait(&full[st], (kt / kStages) & 1);
      const unsigned char* stage = smem + st * kStageBytes;
      float x[4][4];
      hg::load_frags(x, reinterpret_cast<const float*>(stage), row0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[kk][e] = norm1(x[kk][e], mean[e & 1], scale[e & 1], inv[e & 1]);
      uint32_t hi[4][4], lo[4][4];
      hg::split_frags(hi, lo, x);
      hg::mma3_stage<kBN>(c, hi, lo, reinterpret_cast<const float*>(stage + kABytes),
                          reinterpret_cast<const float*>(stage + kABytes + kBBytes));
      hg::wgmma_wait<0>();
      hg::fence_acc(c);
      hg::keep_regs(hi);
      hg::keep_regs(lo);
      if (lane == 0) hg::mbar_arrive(&empty[st]);
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) acc[i] += c[i];
    }

    // Epilogue: the bias in float32, stored from the registers (rows < R).
    const float* bs = b + static_cast<long long>(s) * C + n0;
    float* o = out + static_cast<long long>(s) * R * C + n0;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = 8 * j + 2 * tq;
      const float2 b01 = *reinterpret_cast<const float2*>(bs + col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + row0 + g + 8 * h;
        if (row < R)
          store2(o + static_cast<long long>(row) * C + col, acc[4 * j + 2 * h] + b01.x,
                 acc[4 * j + 2 * h + 1] + b01.y);
      }
    }
  }
}

cudaError_t launch(const float* x, const float* W, const float* b, float* out, float* scratch,
                   int R, int S, int D, int C, cudaStream_t stream) {
  float* hi = scratch + wt_offset(R);
  float* lo = hi + static_cast<long long>(S) * C * D;
  hg::split_k_major_kernel<<<dim3(C / 32, D / 32, S), 256, 0, stream>>>(
      W, C, static_cast<long long>(D) * C, hi, lo, D, C, hg::SameCols());
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap xmap, wmap;
  const uint64_t xdims[2] = {static_cast<uint64_t>(D), static_cast<uint64_t>(R)};
  const uint64_t xstrides[1] = {static_cast<uint64_t>(D) * 4};
  const uint32_t xbox[2] = {kBK, kBM};
  if ((err = hg::make_map(&xmap, x, 2, xdims, xstrides, xbox, CU_TENSOR_MAP_DATA_TYPE_FLOAT32)) !=
      cudaSuccess)
    return err;
  const uint64_t wdims[3] = {static_cast<uint64_t>(D), static_cast<uint64_t>(C),
                             2 * static_cast<uint64_t>(S)};
  const uint64_t wstrides[2] = {static_cast<uint64_t>(D) * 4, static_cast<uint64_t>(C) * D * 4};
  const uint32_t wbox[3] = {kBK, kBN, 1};
  if ((err = hg::make_map(&wmap, hi, 3, wdims, wstrides, wbox, CU_TENSOR_MAP_DATA_TYPE_FLOAT32)) !=
      cudaSuccess)
    return err;
  if ((err = allow_smem(ln_gemm_tf32_kernel, kBytes)) != cudaSuccess) return err;
  const dim3 grid(C / kBN, (R + kBM - 1) / kBM, S);
  ln_gemm_tf32_kernel<<<grid, kThreads, kBytes, stream>>>(xmap, wmap, scratch, b, out, R, S,
                                                          D, C);
  return cudaGetLastError();
}

}  // namespace tf

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  scratch: float32, each row's mean
// and scale (2 R floats) and, float32 only, W's split K-major copy (2 S C D
// floats from tf::wt_offset(R); the wrapper's _scratch_floats mirrors it).
// Returns the launches' cudaError_t.
extern "C" int ln_matmul_fwd(const void* x, const void* W, const void* b, void* out,
                             void* scratch, int R, int S, int D, int C, float eps, int dtype,
                             int device, void* stream) {
  if (R <= 0 || S <= 0 || D <= 0 || C <= 0 || D % kDepthStep || C % kColTile ||
      (R + kRowTile - 1) / kRowTile > 65535 || S > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(scratch);
  if (dtype == 0) {
    err = launch_stats(static_cast<const float*>(x), st, R, D, eps, s);
    return err != cudaSuccess ? err
                              : tf::launch(static_cast<const float*>(x), static_cast<const float*>(W),
                                           static_cast<const float*>(b), static_cast<float*>(out),
                                           st, R, S, D, C, s);
  }
  if (dtype == 1) {
    err = launch_stats(static_cast<const __nv_bfloat16*>(x), st, R, D, eps, s);
    if (err != cudaSuccess) return err;
    return C % 256 == 0 ? tc::launch<256>(x, W, b, out, st, R, S, D, C, s)
                        : tc::launch<128>(x, W, b, out, st, R, S, D, C, s);
  }
  return cudaErrorInvalidValue;
}
