// Fused SAE backward over L stacked SAEs: the standard-ReLU remat VJP
// (kernel B5), the stored-activations VJP (kernel B6) and the TopK remat
// VJP (kernel B9), three mask modes of one kernel set, at the bf16 shapes
// that sae_fused_tc.cu's Hopper route does not take.
//
// Replaces the Pallas TPU kernels `_bwd_kernel` (launched by
// `_fused_backward`), `_bwd_kernel_stored` (launched by
// `_fused_backward_stored`) and `_bwd_kernel_topk` (launched by
// `_fused_backward_topk`) in vit_prisma_tpu/ops/sae_step.py.  From x, the
// weights, dy [L, B, d_in] (in the compute type c) and dl1 [L]:
//     xc     = x - b_dec                                  (in c)
//     B5:    hpre = xc W_enc + b_enc (float32); mask = hpre > 0;
//            hc = relu(hpre) rounded to c
//     B9:    hp = (xc W_enc + b_enc) rounded to c FIRST, as the TopK forward
//            (B8) rounded it; mask = (float(hp) >= t[l, b]) & (float(hp) > 0)
//            with B8's stored float32 thresholds t, so the active set is
//            B8's bit for bit; hc = mask ? hp : 0
//     B6:    hc is the forward's stored activation (B4's hc or B8's masked
//            h); mask = float(hc) > 0
//     dh     = mask ? dy W_dec^T + dl1[l] : 0             (float32)
//     dhc    = dh rounded to c
//     dW_enc = xc^T dhc,  dW_dec = hc^T dy                (float32)
//     db_enc = sum over rows of the float32 dh
// the cast points of the TPU kernels and of the plain versions
// `sae_fused_backward_reference`, `sae_fused_backward_topk_reference` and
// `sae_fused_backward_stored_reference` (vit_prisma_tpu_torch/ops/sae_step.py).
// db_dec = sum(dy) - W_enc db_enc and the casts to the parameters' dtypes
// stay in PyTorch, as the JAX package leaves them to XLA.
//
// Design.  The TPU kernels carry their dW accumulators in VMEM across a
// sequential sweep over row blocks.  Hopper blocks run in parallel, so the
// backward is split into launches of the tile GEMM of sae_gemm.cuh, each
// batched over L in the grid:
//   1. center: xc = x - b_dec;
//   2. dh: one block per (row tile, feature tile).  B5 and B9 first run
//      the encoder product of its tile (the recompute), keep the mask as
//      bits in registers and write hc; all three then run dy W_dec^T, apply
//      the mask and dl1, write dhc and a per-tile partial column sum of dh (the
//      wrapper sums the partials: fixed order, no atomics);
//   3. dW_enc = xc^T dhc and 4. dW_dec = hc^T dy: tile GEMMs that reduce
//      over the B rows inside the block, so no partial sums are needed.
// dhc (and, for B5 and B9, hc) go through device memory: 1.6 GB each in
// bf16 at the sweep shape, held only until the weight-gradient products
// have read them.  B9 is B5 with a different mask: four products, bound by
// tensor-core issue like B5; its time at the TopK slice shape is in PERF.md.
//
// What bounds it on an H100.  At the bf16 sweep shape (24 x 4096 rows,
// 1024 -> 8192) B6 is three products, 4.9 TFLOP, and B5 four, 6.6 TFLOP,
// against a few GB of traffic: several hundred flops per byte, above the
// ~295 of the bf16 ridge point, so both are bound by tensor-core issue.
// Measured on an NVIDIA H100 80GB HBM3 (700 W): B6 20.30 ms, 244 TFLOP/s,
// and B5 27.97 ms, 236 TFLOP/s, about a quarter of the 989 TFLOP/s dense
// bf16 peak (the plain versions: 112.5 and 149.3 ms); in float32 the FFMA
// tiles ran at 36-39 TFLOP/s.  B5 pays one more product than B6 and, as it
// writes hc in its own backward, saves no peak memory: `sae_fused_apply`
// keeps hc (B6) unless it is asked to recompute it (B5).  In bf16 at d_in
// and d_sae multiples of 256 (the wrapper's `sae_gemm_route`) B5, B6 and
// B9 all run sae_fused_tc.cu's wgmma/TMA route instead of this file; in
// float32 all three run sae_fused_tf32.cu (3xTF32).  This file keeps the
// other bf16 shapes.

#include "sae_gemm.cuh"

namespace {

using namespace sae;

// The mask modes (the `mode` argument of sae_fused_bwd).
constexpr int kStored = 0, kReluRemat = 1, kTopkRemat = 2;

// dh tile, B6 (kStored: stored hc), B5 (kReluRemat) or B9 (kTopkRemat):
// the remat modes recompute the pre-activations and write hc.  Grid (S/BN,
// B/BM, L).
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
dh_kernel(const T* __restrict__ xc, const T* __restrict__ We, const T* __restrict__ be,
          const T* __restrict__ Wd, const T* __restrict__ dy, const float* __restrict__ dl1,
          const float* __restrict__ t, T* __restrict__ hc, T* __restrict__ dhc,
          float* __restrict__ dbe_part, int B, int D, int S) {
  constexpr bool REMAT = MODE != kStored;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int l = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const long long BD = static_cast<long long>(B) * D, DS = static_cast<long long>(D) * S;
  const long long BS = static_cast<long long>(B) * S;
  T* hc_l = hc + l * BS;
  Acc acc;
  // mask bit (mi, ni, e) at bit 4 * (NI * mi + ni) + e of mask[(...) / 32]
  uint32_t mask[(MI * NI * 4 + 31) / 32] = {};
  if (REMAT) {
    zero(acc);
    mainloop<T, true, false>(acc, xc + l * BD, D, We + l * DS, S, D, m0, n0, smem);
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int c = n0 + acc_col(ni, 0);
      const float b0 = to_f(be[static_cast<long long>(l) * S + c]);
      const float b1 = to_f(be[static_cast<long long>(l) * S + c + 1]);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + acc_row(mi, 2 * h);
          float p0 = acc[mi][ni][2 * h] + b0, p1 = acc[mi][ni][2 * h + 1] + b1;
          bool on0 = p0 > 0.f, on1 = p1 > 0.f;
          if (MODE == kTopkRemat) {
            // round to c first, then compare with B8's threshold
            p0 = to_f(from_f<T>(p0));
            p1 = to_f(from_f<T>(p1));
            const float tr = t[static_cast<long long>(l) * B + row];
            on0 = p0 > 0.f && p0 >= tr;
            on1 = p1 > 0.f && p1 >= tr;
          }
          const int bit = 4 * (NI * mi + ni) + 2 * h;
          if (on0) mask[bit / 32] |= 1u << (bit % 32);
          if (on1) mask[bit / 32] |= 1u << ((bit + 1) % 32);
          store2(hc_l + static_cast<long long>(row) * S + c, on0 ? p0 : 0.f, on1 ? p1 : 0.f);
        }
    }
  }
  zero(acc);
  // dy W_dec^T: B(k = d, n = s) = W_dec[s, d], K contiguous
  mainloop<T, true, true>(acc, dy + l * BD, D, Wd + l * DS, D, D, m0, n0, smem);

  const float g1 = dl1[l];
  float colsum[NI][2];
  T* dhc_l = dhc + l * BS;
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
    const int c = n0 + acc_col(ni, 0);
    colsum[ni][0] = colsum[ni][1] = 0.f;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long off = static_cast<long long>(m0 + acc_row(mi, 2 * h)) * S + c;
        bool on0, on1;
        if (REMAT) {
          const int bit = 4 * (NI * mi + ni) + 2 * h;
          on0 = (mask[bit / 32] >> (bit % 32)) & 1u;
          on1 = (mask[bit / 32] >> ((bit + 1) % 32)) & 1u;
        } else {
          on0 = to_f(hc_l[off]) > 0.f;
          on1 = to_f(hc_l[off + 1]) > 0.f;
        }
        const float d0 = on0 ? acc[mi][ni][2 * h] + g1 : 0.f;
        const float d1 = on1 ? acc[mi][ni][2 * h + 1] + g1 : 0.f;
        colsum[ni][0] += d0;
        colsum[ni][1] += d1;
        store2(dhc_l + off, d0, d1);
      }
  }
  float* red = reinterpret_cast<float*>(smem_raw);
  block_col_sums(colsum, red,
                 dbe_part + (static_cast<long long>(l) * gridDim.y + blockIdx.y) * S + n0);
}

template <typename T>
cudaError_t backward(const void* x, const void* We, const void* be, const void* Wd,
                     const void* bd, const void* dy, const void* dl1, const void* t, void* hc,
                     void* xc, void* dhc, void* dWe, void* dWd, void* dbe_part, int L, int B,
                     int D, int S, int mode, cudaStream_t s) {
  const T *tx = static_cast<const T*>(x), *tWe = static_cast<const T*>(We);
  const T *tbe = static_cast<const T*>(be), *tWd = static_cast<const T*>(Wd);
  const T *tbd = static_cast<const T*>(bd), *tdy = static_cast<const T*>(dy);
  T *thc = static_cast<T*>(hc), *txc = static_cast<T*>(xc), *tdhc = static_cast<T*>(dhc);
  const float *tdl1 = static_cast<const float*>(dl1), *tt = static_cast<const float*>(t);
  cudaError_t err = center<T>(tx, tbd, txc, L, B, D, s);
  if (err != cudaSuccess) return err;

  const dim3 grid_dh(S / BN, B / BM, L);
  float* tdbe = static_cast<float*>(dbe_part);
  // the recompute's operands and dy W_dec^T's share the ring; size it for both
  constexpr int a = Smem<T, true, false>::bytes, b = Smem<T, true, true>::bytes;
  constexpr int smem_remat = a > b ? a : b;
  if (mode == kReluRemat) {
    if ((err = allow_smem(dh_kernel<T, kReluRemat>, smem_remat)) != cudaSuccess) return err;
    dh_kernel<T, kReluRemat><<<grid_dh, kThreads, smem_remat, s>>>(
        txc, tWe, tbe, tWd, tdy, tdl1, tt, thc, tdhc, tdbe, B, D, S);
  } else if (mode == kTopkRemat) {
    if ((err = allow_smem(dh_kernel<T, kTopkRemat>, smem_remat)) != cudaSuccess) return err;
    dh_kernel<T, kTopkRemat><<<grid_dh, kThreads, smem_remat, s>>>(
        txc, tWe, tbe, tWd, tdy, tdl1, tt, thc, tdhc, tdbe, B, D, S);
  } else {
    if ((err = allow_smem(dh_kernel<T, kStored>, b)) != cudaSuccess) return err;
    dh_kernel<T, kStored><<<grid_dh, kThreads, b, s>>>(txc, tWe, tbe, tWd, tdy, tdl1, tt, thc,
                                                       tdhc, tdbe, B, D, S);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  constexpr int smem_w = Smem<T, false, false>::bytes;
  if ((err = allow_smem(wgrad_kernel<T>, smem_w)) != cudaSuccess) return err;
  // dW_enc [D, S] = xc^T dhc
  wgrad_kernel<T><<<dim3(S / BN, D / BM, L), kThreads, smem_w, s>>>(
      txc, tdhc, static_cast<float*>(dWe), D, S, B);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // dW_dec [S, D] = hc^T dy
  wgrad_kernel<T><<<dim3(D / BN, S / BM, L), kThreads, smem_w, s>>>(
      thc, tdy, static_cast<float*>(dWd), S, D, B);
  return cudaGetLastError();
}

}  // namespace

// dtype: 1 = bfloat16 (float32, 0, is refused: sae_fused_tf32.cu's);
// mode: 0 = B6 (hc is the forward's stored activation, read), 1 = B5 and 2
// = B9 (hc is written; B9 reads the thresholds t [L, B] float32, which the
// other modes ignore).  x, the weights, dy, hc, xc (scratch) and dhc
// (scratch) are bf16; dl1 [L], dWe [L, D, S], dWd [L, S, D] and dbe_part
// [L, B/128, S] are float32.  Returns the launches' cudaError_t.
extern "C" int sae_fused_bwd(const void* x, const void* We, const void* be, const void* Wd,
                             const void* bd, const void* dy, const void* dl1, const void* t,
                             void* hc, void* xc, void* dhc, void* dWe, void* dWd,
                             void* dbe_part, int L, int B, int D, int S, int dtype, int mode,
                             int device, void* stream) {
  if (!sae::shapes_ok(L, B, D, S) || mode < 0 || mode > 2 || (mode == 2 && t == nullptr))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return backward<__nv_bfloat16>(x, We, be, Wd, bd, dy, dl1, t, hc, xc, dhc, dWe, dWd,
                                   dbe_part, L, B, D, S, mode, s);
  return cudaErrorInvalidValue;
}
