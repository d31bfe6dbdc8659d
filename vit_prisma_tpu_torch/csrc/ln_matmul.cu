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
// Design:
//  * a first pass (ln_stats_kernel) reads each row once, one warp a row, and
//    writes its float32 mean and scale (8 bytes a row);
//  * the GEMM is sae_gemm.cuh's tile loop (128 x 128 tiles, BK 32, a
//    3-stage cp.async ring, mma.sync m16n8k16 in bf16 and FFMA in float32)
//    with one change: when an x tile has landed in shared memory, the block
//    normalizes it in place, (x - mean) / scale rounded to x's dtype, before
//    the products read it (16 bytes a thread; the quotient from the row's
//    reciprocal with one Newton correction: a division's result but in rare
//    last-bit cases, at a quarter of its instructions).  So xn never exists
//    in device memory;
//  * grid (C / 128, ceil(R / 128), S): a ragged last row tile reads row R-1
//    again in place of the missing rows and does not store them, so R is any
//    size; C must be a multiple of 128 and D of 32, and every pointer 16-byte
//    aligned (the wrapper's gate, ln_matmul_fits).

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

// Grid (C / BN, ceil(R / BM), S); dynamic shared memory Smem<T, true,
// false>::bytes + kStatsBytes.
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

template <typename T>
cudaError_t launch(const void* x, const void* W, const void* b, void* out, float* stats,
                   int R, int S, int D, int C, float eps, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  constexpr int kStatsWarps = 8;
  ln_stats_kernel<T><<<(R + kStatsWarps - 1) / kStatsWarps, 32 * kStatsWarps, 0, stream>>>(
      xt, stats, R, D, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int bytes = Smem<T, true, false>::bytes + static_cast<int>(kStatsBytes);
  err = allow_smem(ln_gemm_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(C / BN, (R + BM - 1) / BM, S);
  ln_gemm_kernel<T><<<grid, kThreads, bytes, stream>>>(
      xt, stats, static_cast<const T*>(W), static_cast<const T*>(b), static_cast<T*>(out), R, D,
      C);
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
  if (dtype == 0) return launch<float>(x, W, b, out, st, R, S, D, C, eps, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, W, b, out, st, R, S, D, C, eps, s);
  return cudaErrorInvalidValue;
}
