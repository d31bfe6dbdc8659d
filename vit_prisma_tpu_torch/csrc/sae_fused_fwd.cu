// Fused standard-ReLU SAE forward over L stacked SAEs (kernel B4): the bf16
// shapes that sae_fused_tc.cu's Hopper route does not take (float32 runs
// sae_fused_tf32.cu).  The tile GEMM below is generic in T; the entry
// instantiates bf16 alone.
//
// Replaces the Pallas TPU kernel `_fwd_kernel`, launched by `_fused_forward`
// in vit_prisma_tpu/ops/sae_step.py.  For x [L, B, d_in], W_enc
// [L, d_in, d_sae], b_enc [L, d_sae], W_dec [L, d_sae, d_in], b_dec
// [L, d_in], all in the compute type c (float32 or bfloat16):
//     xc        = x - b_dec                          (in c)
//     hpre      = xc W_enc + b_enc                   (float32 accumulation)
//     h         = relu(hpre);  hc = h rounded to c
//     y         = b_dec + hc W_dec                   (float32, then c)
//     l1[l]     = sum of the float32 h
//     nact[l,j] = number of rows with hpre > 0
// the cast points of `_fwd_kernel` and of the plain version
// `sae_fused_forward_reference` (vit_prisma_tpu_torch/ops/sae_step.py).
//
// Design.  The TPU kernel keeps h in VMEM and carries the [rows, d_in] y
// accumulator across its sequential feature sweep.  Hopper blocks run in
// parallel and a y accumulator of [rows, 1024] float32 does not fit one
// block's shared memory at a useful row count, so this first version is
// three launches, each batched over L in the grid:
//   1. center: xc = x - b_dec, written once (0.2 GB bf16 at the sweep shape);
//   2. encoder: the tile GEMM of sae_gemm.cuh, whose epilogue adds b_enc,
//      applies the ReLU, writes hc, and writes per-tile partial sums of
//      nact (per column) and l1 (per tile) -- fixed-order sums, no atomics,
//      so the result does not change from run to run;
//   3. decoder: the tile GEMM over hc, its accumulator started at b_dec.
// hc goes through device memory: [L, B, d_sae] in c, 1.6 GB at the bf16
// sweep shape (24 x 4096 x 8192).  With the remat backward (B5) it is freed
// once the decoder has read it; with the stored-acts backward (B6) it is the
// saved activation.  Keeping h on chip, as the TPU kernel does, is the next
// version's redesign.  The wrapper sums the partials (the JAX package sums
// its per-row-block partials outside the kernel too).
//
// What bounds it on an H100.  At the bf16 sweep shape the two products are
// 2 x 2 x 24 x 4096 x 1024 x 8192 = 3.3 TFLOP against about 4 GB of traffic
// (x, W_enc, W_dec, hc written and read): some 800 flops per byte, far above
// the ~295 where the tensor cores, and not device memory, are the limit.  So
// the kernel is bound by tensor-core issue (in bf16 at d_in and d_sae
// multiples of 256, sae_fused_tc.cu's wgmma/TMA route runs instead).
// Measured on an NVIDIA H100
// 80GB HBM3 (700 W): 12.99 ms, 254 TFLOP/s, 26% of the 989 TFLOP/s dense
// bf16 peak (the plain version: 79.7 ms).  mma.sync tiles fed by cp.async
// reach that fraction; wgmma with TMA-fed tiles is what a later version
// buys.  float32 runs sae_fused_tf32.cu (3xTF32 on tf32 wgmma) at every
// shape; this file keeps the bf16 shapes the Hopper route does not take.

#include "sae_gemm.cuh"

namespace {

using namespace sae;

// hc = relu(xc W_enc + b_enc), nact and l1 partials.  Grid (S/BN, B/BM, L).
template <typename T>
__global__ void __launch_bounds__(kThreads)
encoder_kernel(const T* __restrict__ xc, const T* __restrict__ We, const T* __restrict__ be,
               T* __restrict__ hc, float* __restrict__ nact_part,
               float* __restrict__ l1_part, int B, int D, int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int l = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const long long BD = static_cast<long long>(B) * D, DS = static_cast<long long>(D) * S;
  const long long BS = static_cast<long long>(B) * S;
  Acc acc;
  zero(acc);
  mainloop<T, true, false>(acc, xc + l * BD, D, We + l * DS, S, D, m0, n0, smem);

  float cnt[NI][2], l1 = 0.f;
  T* out = hc + l * BS;
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
    const int c = n0 + acc_col(ni, 0);
    const float b0 = to_f(be[static_cast<long long>(l) * S + c]);
    const float b1 = to_f(be[static_cast<long long>(l) * S + c + 1]);
    cnt[ni][0] = cnt[ni][1] = 0.f;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float p0 = acc[mi][ni][2 * h] + b0, p1 = acc[mi][ni][2 * h + 1] + b1;
        const float h0 = p0 > 0.f ? p0 : 0.f, h1 = p1 > 0.f ? p1 : 0.f;
        cnt[ni][0] += p0 > 0.f ? 1.f : 0.f;
        cnt[ni][1] += p1 > 0.f ? 1.f : 0.f;
        l1 += h0 + h1;
        store2(out + static_cast<long long>(m0 + acc_row(mi, 2 * h)) * S + c, h0, h1);
      }
  }
  float* red = reinterpret_cast<float*>(smem_raw);
  block_col_sums(cnt, red,
                 nact_part + (static_cast<long long>(l) * gridDim.y + blockIdx.y) * S + n0);
  const float s = block_sum(l1, red + kWarpsM * BN);
  if (threadIdx.x == 0)
    l1_part[(static_cast<long long>(l) * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = s;
}

template <typename T>
cudaError_t forward(const void* x, const void* We, const void* be, const void* Wd,
                    const void* bd, void* xc, void* hc, void* y, void* nact_part,
                    void* l1_part, int L, int B, int D, int S, cudaStream_t s) {
  const T *tx = static_cast<const T*>(x), *tWe = static_cast<const T*>(We);
  const T *tbe = static_cast<const T*>(be), *tWd = static_cast<const T*>(Wd);
  const T* tbd = static_cast<const T*>(bd);
  T *txc = static_cast<T*>(xc), *thc = static_cast<T*>(hc), *ty = static_cast<T*>(y);
  cudaError_t err = center<T>(tx, tbd, txc, L, B, D, s);
  if (err != cudaSuccess) return err;

  constexpr int smem = Smem<T, true, false>::bytes;
  if ((err = allow_smem(encoder_kernel<T>, smem)) != cudaSuccess) return err;
  if ((err = allow_smem(decoder_kernel<T>, smem)) != cudaSuccess) return err;
  encoder_kernel<T><<<dim3(S / BN, B / BM, L), kThreads, smem, s>>>(
      txc, tWe, tbe, thc, static_cast<float*>(nact_part), static_cast<float*>(l1_part), B, D, S);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  decoder_kernel<T><<<dim3(D / BN, B / BM, L), kThreads, smem, s>>>(thc, tWd, tbd, ty, B, D, S);
  return cudaGetLastError();
}

}  // namespace

// dtype: 1 = bfloat16 (float32, 0, is sae_fused_tf32.cu's and is refused
// here).  Outputs: xc [L, B, D] (scratch), hc [L, B, S], y [L, B, D] in
// bf16; nact_part [L, B/128, S] and l1_part [L, B/128, S/128] float32.
// Returns the launches' cudaError_t.
extern "C" int sae_fused_fwd(const void* x, const void* We, const void* be, const void* Wd,
                             const void* bd, void* xc, void* hc, void* y, void* nact_part,
                             void* l1_part, int L, int B, int D, int S, int dtype, int device,
                             void* stream) {
  if (!sae::shapes_ok(L, B, D, S)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return forward<__nv_bfloat16>(x, We, be, Wd, bd, xc, hc, y, nact_part, l1_part, L, B, D,
                                  S, s);
  return cudaErrorInvalidValue;
}
