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
// the LN's own unfused elementwise passes.
//
// Design.  A first pass (ln_stats_kernel) reads each row once, one warp a
// row, and writes its float32 mean and scale (8 bytes a row).  Then the GEMM
// normalizes each landed x tile in shared memory, (x - mean) / scale rounded
// to x's dtype (the quotient from the row's reciprocal with one Newton
// correction: a division's result but in rare last-bit cases, at a quarter
// of its instructions), before the products read it, so xn never exists in
// device memory.  Two routes, by dtype:
//  * bfloat16 (ln_gemm_tc_kernel, Hopper): hopper_gemm.cuh's pieces.  One
//    producer warp keeps a 4-stage ring of [128 x 64] x tiles and [64 x BN]
//    W tiles (BN = 256 where C allows, else 128) filled by TMA, 128-byte
//    swizzled, on mbarriers; two consumer warpgroups own 64 rows each of
//    the 128-row tile.  Each normalizes its 64 rows of a landed stage in
//    place (a swizzle moves 16-byte chunks only within a row, and the
//    normalize needs only the row's mean and scale, so it ignores the
//    swizzle), fences the writes to the async proxy, meets its own named
//    barrier, and issues wgmma m64nBNk16 with float32 accumulators; one
//    stage's products run while the next stage is normalized.  TMA zero-
//    fills rows past R and columns past D (a D that is a multiple of 32 but
//    not of 64 ends in a half-empty stage: W's missing rows are zero, so the
//    normalized zero columns add nothing).  Epilogue: the bias in float32,
//    one rounding, staged swizzled in the ring and stored by TMA (rows < R).
//  * float32 (ln_gemm_kernel): sae_gemm.cuh's tile loop on the CUDA cores
//    (128 x 128 tiles, BK 32, a 3-stage cp.async ring, FFMA); each landed x
//    tile is normalized in place by the whole block between two barriers.
//  Grid (C / BN, ceil(R / 128), S); R is any size; C must be a multiple of
//  128 and D of 32, and every pointer 16-byte aligned (the wrapper's gate,
//  ln_matmul_fits).

#include "hopper_gemm.cuh"
#include "sae_gemm.cuh"

#include <math.h>

namespace {

using namespace sae;

constexpr size_t kStatsBytes = 3 * BM * sizeof(float);  // the tile's mean, scale, 1 / scale

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

// Normalize the landed x tile As [BM][BK] in place, rounded to T, 16 bytes
// a thread at a time.  stats: the tile's mean, scale and 1 / scale per row.
__device__ __forceinline__ void normalize16(float* p, float m, float sc, float inv) {
  float4 v = *reinterpret_cast<float4*>(p);
  v.x = norm1(v.x, m, sc, inv);
  v.y = norm1(v.y, m, sc, inv);
  v.z = norm1(v.z, m, sc, inv);
  v.w = norm1(v.w, m, sc, inv);
  *reinterpret_cast<float4*>(p) = v;
}
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

template <typename T>
__device__ __forceinline__ void normalize_tile(T* As, const float* stats) {
  typedef Tile<T, true, BM> TA;
  constexpr int per_row = BK * static_cast<int>(sizeof(T)) / 16;
  for (int i = threadIdx.x; i < BM * per_row; i += kThreads) {
    const int r = i / per_row, c = (i % per_row) * (16 / static_cast<int>(sizeof(T)));
    normalize16(As + r * TA::stride + c, stats[r], stats[BM + r], stats[2 * BM + r]);
  }
}

// The float32 route (T = float).  Grid (C / BN, ceil(R / BM), S); dynamic
// shared memory Smem<T, true, false>::bytes + kStatsBytes.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ln_gemm_kernel(const T* __restrict__ x, const float* __restrict__ stats,
                   const T* __restrict__ W, const T* __restrict__ b, T* __restrict__ out, int R,
                   int D, int C) {
  typedef Smem<T, true, false> SM;
  typedef typename SM::TA TA;
  typedef typename SM::TB TB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  float* st = reinterpret_cast<float*>(smem_raw + SM::bytes);  // [3][BM]
  const int s = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const T* Ws = W + static_cast<long long>(s) * D * C;

  for (int r = threadIdx.x; r < BM; r += kThreads) {
    const long long row = min(m0 + r, R - 1);
    st[r] = stats[2 * row];
    st[BM + r] = stats[2 * row + 1];
    st[2 * BM + r] = 1.f / stats[2 * row + 1];
  }

  constexpr int vec = 16 / sizeof(T);
  constexpr int a_per_row = BK / vec;
  const int ktiles = D / BK;
  auto load = [&](int stage, int kt) {
    T* As = smem + stage * SM::stage_elems;
    T* Bs = As + TA::elems;
    const int k0 = kt * BK;
    for (int i = threadIdx.x; i < BM * a_per_row; i += kThreads) {
      const int r = i / a_per_row, c = (i % a_per_row) * vec;
      const long long row = min(m0 + r, R - 1);  // the ragged edge re-reads row R-1
      cp_async16(As + r * TA::stride + c, x + row * D + k0 + c);
    }
    load_tile<T, TB::rows, TB::cols, TB::stride>(Bs, Ws + static_cast<long long>(k0) * C + n0, C);
  };

  Acc acc;
  zero(acc);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < ktiles) load(i, i);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt landed; every thread is past tile kt-1's products
    const int next = kt + kStages - 1;
    if (next < ktiles) load(next % kStages, next);
    cp_async_commit();
    T* As = smem + (kt % kStages) * SM::stage_elems;
    normalize_tile<T>(As, st);
    __syncthreads();
    compute_stage<true, false>(acc, As, As + TA::elems);
  }
  cp_async_wait<0>();

  const T* bs = b + static_cast<long long>(s) * C;
  T* o = out + static_cast<long long>(s) * R * C;
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
    const int col = n0 + acc_col(ni, 0);
    const float b0 = to_f(bs[col]), b1 = to_f(bs[col + 1]);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + acc_row(mi, 2 * h);
        if (row < R)
          store2(o + static_cast<long long>(row) * C + col, acc[mi][ni][2 * h] + b0,
                 acc[mi][ni][2 * h + 1] + b1);
      }
  }
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

cudaError_t launch_f32(const void* x, const void* W, const void* b, void* out, float* stats,
                       int R, int S, int D, int C, cudaStream_t stream) {
  const int bytes = Smem<float, true, false>::bytes + static_cast<int>(kStatsBytes);
  cudaError_t err = allow_smem(ln_gemm_kernel<float>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(C / BN, (R + BM - 1) / BM, S);
  ln_gemm_kernel<float><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(x), stats, static_cast<const float*>(W),
      static_cast<const float*>(b), static_cast<float*>(out), R, D, C);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  stats: float32 scratch of 2 R floats
// (each row's mean and scale).  Returns the launches' cudaError_t.
extern "C" int ln_matmul_fwd(const void* x, const void* W, const void* b, void* out,
                             void* stats, int R, int S, int D, int C, float eps, int dtype,
                             int device, void* stream) {
  if (R <= 0 || S <= 0 || D <= 0 || C <= 0 || D % sae::BK || C % sae::BN ||
      (R + sae::BM - 1) / sae::BM > 65535 || S > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  if (dtype == 0) {
    err = launch_stats(static_cast<const float*>(x), st, R, D, eps, s);
    return err != cudaSuccess ? err : launch_f32(x, W, b, out, st, R, S, D, C, s);
  }
  if (dtype == 1) {
    err = launch_stats(static_cast<const __nv_bfloat16*>(x), st, R, D, eps, s);
    if (err != cudaSuccess) return err;
    return C % 256 == 0 ? tc::launch<256>(x, W, b, out, st, R, S, D, C, s)
                        : tc::launch<128>(x, W, b, out, st, R, S, D, C, s);
  }
  return cudaErrorInvalidValue;
}
