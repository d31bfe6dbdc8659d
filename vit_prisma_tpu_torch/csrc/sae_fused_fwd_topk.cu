// Fused TopK SAE forward over L stacked SAEs (kernel B8).
//
// Replaces the Pallas TPU kernel `_fwd_kernel_topk` (with its threshold
// search `_row_kth_threshold`), launched by `_fused_forward_topk` in
// vit_prisma_tpu/ops/sae_step.py.  For x [L, B, d_in], W_enc [L, d_in, d_sae],
// b_enc [L, d_sae], W_dec [L, d_sae, d_in], b_dec [L, d_in], all in the
// compute type c (float32 or bfloat16), and k:
//     xc        = x - b_dec                                   (in c)
//     hp        = (xc W_enc + b_enc) rounded to c   (float32 accumulation;
//                 rounded before anything compares it, so the mask matches
//                 the unfused path in c)
//     t[l, b]   = k-th largest of max(float(hp), 0) over the row
//     active    = (float(hp) >= t) & (float(hp) > 0)    (ties keep >= k)
//     h         = active ? hp : 0                         (in c)
//     y         = b_dec + h W_dec                         (float32, then c)
//     l1[l]     = sum of float(h);  nact[l, j] = active rows of feature j
// the cast points of `_fwd_kernel_topk` and of the plain version
// `sae_fused_forward_topk_reference` (vit_prisma_tpu_torch/ops/sae_step.py).
//
// Design.  The TPU kernel keeps a [rows, d_sae] pre-activation block in
// VMEM (512 x 12,288 bf16 is 12 MB) and runs encoder tiles, the search and
// decoder tiles in one sequential grid.  A Hopper block has 227 KB of shared
// memory, so this version stages through device memory, five launches each
// batched over L:
//   1. center: xc = x - b_dec;
//   2. encoder: the tile GEMM of sae_gemm.cuh; its epilogue adds b_enc and
//      writes hp in c;
//   3. threshold: one block per row (topk_search.cuh), the row staged in
//      shared memory where it fits; 31 passes from bit 30 in float32, 15 in
//      bfloat16 (non-negative patterns order as integers, so the sign bit is
//      never searched).  It writes t and zeroes the inactive entries of hp in
//      place, which leaves h;
//   4. counts: per 128-row block and feature, the active count (h > 0
//      exactly on the active set), and per 128 x 128 tile the sum of h:
//      partials summed by the wrapper in a fixed order, no atomics, so nact
//      is exact and l1 the same from run to run;
//   5. decoder: the tile GEMM over h, its accumulator started at b_dec.
// h is [L, B, d_sae] in c in device memory (100 MB at the bf16 slice shape,
// 1 x 4096 x 12,288; 1.6 GB at the 24-layer sweep shape); it is the
// stored-acts backward's input (B6 applies as it is, since h > 0 is the
// active set) or, for the remat backward (B9), freed after the decoder.
//
// What bounds it on an H100.  The two products are 2 x 2 x L x B x d_in x
// d_sae: 155 GFLOP at the bf16 slice shape, 0.16 ms at the 989 TFLOP/s
// dense bf16 peak, against about 150 MB of traffic (x, the weights, y, h):
// the tensor cores bound it, as they bound B4.  The threshold pass adds 15
// compares per pre-activation (0.75 G, 11 us at 67 T/s) and two passes over
// h.  mma.sync tiles reach about a quarter of the peak (B4, PERF.md); the
// measured time is in PERF.md.

#include "sae_gemm.cuh"
#include "topk_search.cuh"

namespace {

using namespace sae;

// hp = (xc W_enc + b_enc) rounded to T.  Grid (S/BN, B/BM, L).
template <typename T>
__global__ void __launch_bounds__(kThreads)
encoder_topk_kernel(const T* __restrict__ xc, const T* __restrict__ We,
                    const T* __restrict__ be, T* __restrict__ hp, int B, int D, int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int l = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const long long BD = static_cast<long long>(B) * D, DS = static_cast<long long>(D) * S;
  const long long BS = static_cast<long long>(B) * S;
  Acc acc;
  zero(acc);
  mainloop<T, true, false>(acc, xc + l * BD, D, We + l * DS, S, D, m0, n0, smem);
  T* out = hp + l * BS;
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
    const int c = n0 + acc_col(ni, 0);
    const float b0 = to_f(be[static_cast<long long>(l) * S + c]);
    const float b1 = to_f(be[static_cast<long long>(l) * S + c + 1]);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store2(out + static_cast<long long>(m0 + acc_row(mi, 2 * h)) * S + c,
               acc[mi][ni][2 * h] + b0, acc[mi][ni][2 * h + 1] + b1);
  }
}

// One block per row of hp [L * B, S]: the row's threshold into t, and the
// inactive entries of the row zeroed in place.
template <typename T>
__global__ void __launch_bounds__(topk::kThreads)
threshold_kernel(T* h, float* __restrict__ t, int S, int k, int staged) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ unsigned red[2 * topk::kWarps];
  T* hrow = h + static_cast<long long>(blockIdx.x) * S;
  const T* row = topk::stage_row<T>(hrow, S, staged != 0, reinterpret_cast<T*>(smem_raw));
  constexpr int bits = 8 * sizeof(T);
  const unsigned acc = topk::search_row<true>(row, S, k, bits - 2, 0, red);
  const float tf = __uint_as_float(acc << (32 - bits));
  // every read of the search is behind its last barrier: writing in place
  // cannot race with another thread's count
  const T zero_t = from_f<T>(0.f);
  for (int i = threadIdx.x; i < S; i += topk::kThreads) {
    const T v = row[i];
    const float f = to_f(v);
    hrow[i] = (f > 0.f && f >= tf) ? v : zero_t;
  }
  if (threadIdx.x == 0) t[blockIdx.x] = tf;
}

__device__ __forceinline__ void load2(const float* p, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float& a, float& b) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  a = __low2float(v);
  b = __high2float(v);
}

constexpr int kCountThreads = BN / 2;  // two features a thread

// Per 128-row block: nact_part[l, rb, j] = rows with h > 0 in feature j, and
// l1_part[l, rb, cb] = sum of h over the 128 x 128 tile, each summed in a
// fixed order.  Grid (S/BN, B/BM, L).
template <typename T>
__global__ void __launch_bounds__(kCountThreads)
count_kernel(const T* __restrict__ h, float* __restrict__ nact_part,
             float* __restrict__ l1_part, int B, int S) {
  const int l = blockIdx.z, rb = blockIdx.y, cb = blockIdx.x;
  const int c = cb * BN + 2 * threadIdx.x;
  const T* p = h + (static_cast<long long>(l) * B + static_cast<long long>(rb) * BM) * S + c;
  float n0 = 0.f, n1 = 0.f, s = 0.f;
  for (int r = 0; r < BM; ++r) {
    float a, b;
    load2(p + static_cast<long long>(r) * S, a, b);
    n0 += a > 0.f ? 1.f : 0.f;
    n1 += b > 0.f ? 1.f : 0.f;
    s += a + b;
  }
  float* out = nact_part + (static_cast<long long>(l) * gridDim.y + rb) * S + c;
  out[0] = n0;
  out[1] = n1;
  __shared__ float red[kCountThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x / 32] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kCountThreads / 32; ++w) total += red[w];
    l1_part[(static_cast<long long>(l) * gridDim.y + rb) * gridDim.x + cb] = total;
  }
}

template <typename T>
cudaError_t forward(const void* x, const void* We, const void* be, const void* Wd,
                    const void* bd, void* xc, void* h, void* y, void* t, void* nact_part,
                    void* l1_part, int L, int B, int D, int S, int k, cudaStream_t s) {
  const T *tx = static_cast<const T*>(x), *tWe = static_cast<const T*>(We);
  const T *tbe = static_cast<const T*>(be), *tWd = static_cast<const T*>(Wd);
  const T* tbd = static_cast<const T*>(bd);
  T *txc = static_cast<T*>(xc), *th = static_cast<T*>(h), *ty = static_cast<T*>(y);
  cudaError_t err = center<T>(tx, tbd, txc, L, B, D, s);
  if (err != cudaSuccess) return err;

  constexpr int smem = Smem<T, true, false>::bytes;
  if ((err = allow_smem(encoder_topk_kernel<T>, smem)) != cudaSuccess) return err;
  if ((err = allow_smem(decoder_kernel<T>, smem)) != cudaSuccess) return err;
  if ((err = topk::allow_stage(threshold_kernel<T>)) != cudaSuccess) return err;
  encoder_topk_kernel<T><<<dim3(S / BN, B / BM, L), kThreads, smem, s>>>(txc, tWe, tbe, th, B,
                                                                          D, S);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const bool staged = topk::stages(S, sizeof(T));
  threshold_kernel<T><<<static_cast<unsigned int>(static_cast<long long>(L) * B), topk::kThreads,
                        staged ? static_cast<size_t>(S) * sizeof(T) : 0, s>>>(
      th, static_cast<float*>(t), S, k, staged);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  count_kernel<T><<<dim3(S / BN, B / BM, L), kCountThreads, 0, s>>>(
      th, static_cast<float*>(nact_part), static_cast<float*>(l1_part), B, S);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  decoder_kernel<T><<<dim3(D / BN, B / BM, L), kThreads, smem, s>>>(th, tWd, tbd, ty, B, D, S);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; 1 <= k <= S.  Outputs: xc [L, B, D]
// (scratch), h [L, B, S] (the masked activations), y [L, B, D] in the
// compute type; t [L, B], nact_part [L, B/128, S] and l1_part
// [L, B/128, S/128] float32.  Returns the launches' cudaError_t.
extern "C" int sae_fused_fwd_topk(const void* x, const void* We, const void* be,
                                  const void* Wd, const void* bd, void* xc, void* h, void* y,
                                  void* t, void* nact_part, void* l1_part, int L, int B, int D,
                                  int S, int k, int dtype, int device, void* stream) {
  if (!sae::shapes_ok(L, B, D, S) || k < 1 || k > S ||
      static_cast<long long>(L) * B > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return forward<float>(x, We, be, Wd, bd, xc, h, y, t, nact_part, l1_part, L, B, D, S, k, s);
  if (dtype == 1)
    return forward<__nv_bfloat16>(x, We, be, Wd, bd, xc, h, y, t, nact_part, l1_part, L, B, D,
                                  S, k, s);
  return cudaErrorInvalidValue;
}
