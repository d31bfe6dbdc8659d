// Fused gated-SAE forward over L stacked SAEs (kernel B11).
//
// Replaces the Pallas TPU kernel `_fwd_kernel_gated` (with `_gated_pre`),
// launched by `_fused_forward_gated` in vit_prisma_tpu/ops/sae_step.py.
// For x [L, B, d_in], W_enc [L, d_in, d_sae], b_gate, b_mag [L, d_sae],
// W_dec [L, d_sae, d_in], b_dec [L, d_in], all in the compute type c
// (float32 or bfloat16), and the float32 e = exp(r_mag) and decoder row
// norms wdn [L, d_sae] (hoisted out of the kernel, as the JAX package
// hoists them):
//     xc        = x - b_dec                             (in c)
//     g         = xc W_enc                              (float32; ONE product
//                 serves both paths: exp(r_mag) scales columns of W_enc)
//     hg        = (g + b_gate) rounded to c;  hm = (g e + b_mag) rounded to c
//     h         = hg > 0 ? max(hm, 0) : 0;   hga = max(hg, 0)
//     y         = b_dec + c(h) W_dec;         via = b_dec + c(hga) W_dec
//     l1[l]     = sum of hga wdn                        (float32)
//     nact[l,j] = number of rows with h > 0
// the cast points of `_fwd_kernel_gated` and of the plain version
// `sae_gated_fused_forward_reference` (vit_prisma_tpu_torch/ops/sae_step.py).
// hg and hm are rounded to c before any compare, as `_gated_pre` rounds
// them: the backward (B12) recomputes the same masks from the same values.
// g e + b_mag is a rounded product then a rounded sum (no FMA contraction),
// as the plain version computes it.
//
// Design.  The TPU kernel carries its y and via accumulators in VMEM across
// a sequential sweep over feature blocks.  Hopper blocks run in parallel,
// so, as B4 (sae_fused_fwd.cu), this first version is launches of the tile
// GEMM of sae_gemm.cuh, each batched over L in the grid:
//   1. center: xc = x - b_dec;
//   2. encoder: g per (row tile, feature tile); the epilogue reads e and
//      wdn, forms hg, hm, h and hga, writes c(h) and c(hga) to device
//      memory and per-tile partials of nact (per column) and l1 (per tile),
//      summed by the wrapper in a fixed order -- no atomics;
//   3. the decoder products, y from c(h) and via from c(hga), each started
//      at b_dec: one launch of sae_gemm.cuh's decoder_kernel over each
//      layer's c(h) and c(hga) rows stacked as [L, 2B, d_sae], giving y and
//      via stacked as [L, 2B, d_in].  At the slice shape one decoder's grid
//      is 6 x 32 = 192 blocks, not two full waves of the 132 SMs at two
//      blocks an SM; the stacked launch's 384 blocks fill them better.
// c(h) and c(hga) go through device memory: [L, B, d_sae] in c each, 2 x
// 100 MB in bf16 at the slice shape (1 x 4096, 768 -> 12,288), freed once
// the decoders have read them.  Keeping them on chip is a later redesign.
//
// What bounds it on an H100.  Three products, 3 x 2 L B d_in d_sae: at the
// slice shape 231.9 GFLOP against about 57 MB of inputs and outputs, so it
// is bound by operations: 0.234 ms at the 989 TFLOP/s dense bf16 peak,
// 3.46 ms in float32 (FFMA tiles, 67 TFLOP/s).  Measured on an NVIDIA H100
// 80GB HBM3 (700 W): 1.40 ms in bf16, 165 TFLOP/s (the plain version: 7.70
// ms), of which the encoder takes 0.57 ms (its two outputs and heavier
// epilogue against B8's 0.36) and the stacked decoder 0.64; 6.41 ms in
// float32.  wgmma with TMA-fed tiles, and h kept on chip, are what a later
// version buys.

#include "sae_gemm.cuh"

namespace {

using namespace sae;

// acts [L, 2B, S]: c(h) in rows [0, B), c(hga) in rows [B, 2B) of each
// layer; nact and l1 partials.  Grid (S/BN, B/BM, L).
template <typename T>
__global__ void __launch_bounds__(kThreads)
gated_encoder_kernel(const T* __restrict__ xc, const T* __restrict__ We,
                     const T* __restrict__ bg, const float* __restrict__ e,
                     const T* __restrict__ bm, const float* __restrict__ wdn,
                     T* __restrict__ acts, float* __restrict__ nact_part,
                     float* __restrict__ l1_part, int B, int D, int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int l = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const long long BD = static_cast<long long>(B) * D, DS = static_cast<long long>(D) * S;
  const long long BS = static_cast<long long>(B) * S, LS = static_cast<long long>(l) * S;
  Acc acc;
  zero(acc);
  mainloop<T, true, false>(acc, xc + l * BD, D, We + l * DS, S, D, m0, n0, smem);

  float cnt[NI][2], l1 = 0.f;
  T* h_out = acts + 2 * l * BS;
  T* hga_out = h_out + BS;
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
    const int c = n0 + acc_col(ni, 0);
    float vbg[2], ve[2], vbm[2], vwdn[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      vbg[j] = to_f(bg[LS + c + j]);
      ve[j] = e[LS + c + j];
      vbm[j] = to_f(bm[LS + c + j]);
      vwdn[j] = wdn[LS + c + j];
    }
    cnt[ni][0] = cnt[ni][1] = 0.f;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float hv[2], hgav[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float g = acc[mi][ni][2 * h + j];
          const float hg = to_f(from_f<T>(__fadd_rn(g, vbg[j])));
          const float hm = to_f(from_f<T>(__fadd_rn(__fmul_rn(g, ve[j]), vbm[j])));
          const bool on = hg > 0.f && hm > 0.f;
          hv[j] = on ? hm : 0.f;
          hgav[j] = hg > 0.f ? hg : 0.f;
          cnt[ni][j] += on ? 1.f : 0.f;
          l1 += hgav[j] * vwdn[j];
        }
        const long long off = static_cast<long long>(m0 + acc_row(mi, 2 * h)) * S + c;
        store2(h_out + off, hv[0], hv[1]);
        store2(hga_out + off, hgav[0], hgav[1]);
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
cudaError_t forward(const void* x, const void* We, const void* bg, const void* e,
                    const void* bm, const void* Wd, const void* bd, const void* wdn, void* xc,
                    void* h, void* y, void* nact_part, void* l1_part, int L, int B, int D, int S,
                    cudaStream_t s) {
  const T *tx = static_cast<const T*>(x), *tWe = static_cast<const T*>(We);
  const T *tbg = static_cast<const T*>(bg), *tbm = static_cast<const T*>(bm);
  const T *tWd = static_cast<const T*>(Wd), *tbd = static_cast<const T*>(bd);
  T *txc = static_cast<T*>(xc), *th = static_cast<T*>(h);
  cudaError_t err = center<T>(tx, tbd, txc, L, B, D, s);
  if (err != cudaSuccess) return err;

  constexpr int smem = Smem<T, true, false>::bytes;
  if ((err = allow_smem(gated_encoder_kernel<T>, smem)) != cudaSuccess) return err;
  if ((err = allow_smem(decoder_kernel<T>, smem)) != cudaSuccess) return err;
  gated_encoder_kernel<T><<<dim3(S / BN, B / BM, L), kThreads, smem, s>>>(
      txc, tWe, tbg, static_cast<const float*>(e), tbm, static_cast<const float*>(wdn), th,
      static_cast<float*>(nact_part), static_cast<float*>(l1_part), B, D, S);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  decoder_kernel<T><<<dim3(D / BN, 2 * B / BM, L), kThreads, smem, s>>>(
      th, tWd, tbd, static_cast<T*>(y), 2 * B, D, S);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x, W_enc, b_gate, b_mag, W_dec, b_dec,
// xc (scratch), h ([L, 2B, S]: c(h), then c(hga) in each layer) and y
// ([L, 2B, D]: y, then via) in the compute type; e and wdn [L, S],
// nact_part [L, B/128, S] and l1_part [L, B/128, S/128] float32.  Returns
// the launches' cudaError_t.
extern "C" int sae_fused_fwd_gated(const void* x, const void* We, const void* bg,
                                   const void* e, const void* bm, const void* Wd,
                                   const void* bd, const void* wdn, void* xc, void* h, void* y,
                                   void* nact_part, void* l1_part, int L, int B, int D, int S,
                                   int dtype, int device, void* stream) {
  if (!sae::shapes_ok(L, B, D, S) || 2 * B / sae::BM > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return forward<float>(x, We, bg, e, bm, Wd, bd, wdn, xc, h, y, nact_part, l1_part, L, B,
                          D, S, s);
  if (dtype == 1)
    return forward<__nv_bfloat16>(x, We, bg, e, bm, Wd, bd, wdn, xc, h, y, nact_part, l1_part,
                                  L, B, D, S, s);
  return cudaErrorInvalidValue;
}
