// Fused gated-SAE backward over L stacked SAEs: the remat VJP (kernel B12),
// bfloat16 at the shapes that sae_fused_tc.cu's Hopper route does not take
// (d_in or d_sae not a multiple of 256).  Float32 runs sae_fused_tf32.cu
// (3xTF32 on tf32 wgmma) at every shape.
//
// Replaces the Pallas TPU kernel `_bwd_kernel_gated` (with `_gated_pre`),
// launched by `_fused_backward_gated` in vit_prisma_tpu/ops/sae_step.py.
// From x, the weights (as B11, sae_fused_fwd_gated.cu, with the hoisted
// float32 e = exp(r_mag) and decoder row norms wdn), dy and dvia
// [L, B, d_in] in the compute type c and the float32 dl1 [L]:
//     xc, g, hg, hm        recomputed as B11 computes them (hg and hm rounded
//                          to c, so the masks are B11's bit for bit)
//     gate = hg > 0;  mag = gate & (hm > 0)
//     dhm    = mag  ? dy W_dec^T : 0                        (float32)
//     dhg    = gate ? dvia W_dec^T + dl1 wdn : 0            (float32)
//     dg     = dhg + dhm e, rounded to c
//     dW_enc = xc^T c(dg)
//     dW_dec = c(h)^T dy + c(hga)^T dvia
//              + (dl1 colsum(max(hg, 0)) / max(wdn, 1e-30)) W_dec   (per row)
//     db_gate = sum dhg,  db_mag = sum dhm,  dr_mag = sum(dhm g) e
// all float32 out, the cast points of `_bwd_kernel_gated` and of the plain
// version `sae_gated_fused_backward_reference`
// (vit_prisma_tpu_torch/ops/sae_step.py).  dr_mag multiplies by the
// unrounded float32 product g, not by hm.  db_dec and the casts to the
// parameters' dtypes stay in PyTorch, as the JAX package leaves them to XLA.
//
// Design.  The TPU kernel carries five accumulators in VMEM across a
// sequential sweep over row blocks.  Hopper blocks run in parallel, so the
// backward is launches of the tile GEMM of sae_gemm.cuh, batched over L:
//   1. center: xc = x - b_dec;
//   2. dg: one block per (row tile, feature tile), three products in turn
//      into ONE register accumulator:
//      (a) g = xc W_enc: the gate and magnitude masks kept as bits, c(h)
//          and c(hga) written, partial column sums of max(hg, 0); g parked
//          in shared memory;
//      (b) dy W_dec^T: dhm, partial column sums of dhm and of dhm g (g read
//          back), then dhm e parked where g was;
//      (c) dvia W_dec^T: dhg, dg = dhg + dhm e written as c(dg), partial
//          column sums of dhg.
//      A second 128 x 128 float32 register accumulator, as in the TPU
//      kernel's formulation, would hold 128 accumulator registers a thread
//      beside the mainloop's fragments and risk spills at 256 threads; the
//      parked tile takes 64 KB of shared memory instead, in a per-thread
//      layout (element i of thread t at i * 256 + t, so a warp's accesses
//      are consecutive words and never conflict), beside the copy ring:
//      128 KB a block.  Each thread reads and
//      writes only its own slots, so the parked tile needs no barrier.
//   3. the partial column sums summed in a fixed order (no atomics), so the
//      result does not change from run to run;
//   4. dW_enc = xc^T c(dg) (sae_gemm.cuh's wgrad_kernel);
//   5. dW_dec: one tile GEMM whose K loop runs over both pairs, c(h)^T dy
//      then c(hga)^T dvia, into one accumulator; its epilogue adds the
//      decoder-norm term from the summed colsum(max(hg, 0)) and wdn.
// c(h), c(hga) and c(dg) go through device memory: [L, B, d_sae] in c each,
// 3 x 100 MB in bf16 at the slice shape (1 x 4096, 768 -> 12,288), held
// until the weight-gradient products have read them.
//
// What bounds it on an H100.  Six products, 6 x 2 L B d_in d_sae: at the
// slice shape 463.9 GFLOP against well under 0.5 GB of traffic, so it is
// bound by operations: 0.469 ms at the 989 TFLOP/s dense bf16 peak.
// Measured on an NVIDIA H100 80GB HBM3 (700 W): 2.78 ms in bf16, 167
// TFLOP/s (the plain version: 13.75 ms): the dg kernel 1.61 ms (144 TFLOP/s
// at one block an SM), the dW_dec GEMM 0.66, dW_enc 0.34.  ptxas gives the
// dg kernel 184 registers and spills none, so the 128-wide tile stays;
// without the second argument of __launch_bounds__ it held bf16 to 128
// registers and spilled 8 bytes.

#include "sae_gemm.cuh"

namespace {

using namespace sae;

constexpr int kParked = BM * BN;                   // floats of the parked tile
constexpr int kParkedBytes = kParked * 4;
constexpr int kRedFloats = kWarpsM * BN;           // one block_col_sums scratch
// The four partial column sums of the dg kernel, in this order in `part`
// and `sums`: colsum(max(hg, 0)), db_gate, db_mag, sum(dhm g).
constexpr int kHga = 0, kDbg = 1, kDbm = 2, kDrm = 3, kParts = 4;

// The dg kernel's shared memory: the copy ring (sized for both operand
// layouts it loads), then the parked tile, then the kParts reduction regions.
template <typename T>
struct DgSmem {
  static constexpr int a = Smem<T, true, false>::bytes, b = Smem<T, true, true>::bytes;
  static constexpr int ring = a > b ? a : b;
  static constexpr int bytes = ring + kParkedBytes + kParts * kRedFloats * 4;
};

__device__ __forceinline__ int acc_index(int mi, int ni, int e) {
  return (mi * NI + ni) * 4 + e;
}

// The dg tile.  Grid (S/BN, B/BM, L).  part: [kParts, L, B/BM, S].
// One block an SM: its shared memory allows no second one, so ptxas may
// give each thread up to 255 registers rather than spill to fit two.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
dg_kernel(const T* __restrict__ xc, const T* __restrict__ We, const T* __restrict__ bg,
          const float* __restrict__ e, const T* __restrict__ bm, const T* __restrict__ Wd,
          const float* __restrict__ wdn, const T* __restrict__ dy, const T* __restrict__ dvia,
          const float* __restrict__ dl1, T* __restrict__ hc, T* __restrict__ hgac,
          T* __restrict__ dgc, float* __restrict__ part, int L, int B, int D, int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  float* parked = reinterpret_cast<float*>(smem_raw + DgSmem<T>::ring);
  float* red = parked + kParked;  // kParts regions, each written once
  const int l = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const long long BD = static_cast<long long>(B) * D, DS = static_cast<long long>(D) * S;
  const long long BS = static_cast<long long>(B) * S, LS = static_cast<long long>(l) * S;
  const long long nB = gridDim.y;
  auto part_out = [&](int which) {
    return part + ((static_cast<long long>(which) * L + l) * nB + blockIdx.y) * S + n0;
  };
  // gate bit (mi, ni, e) at bit acc_index of gate[... / 32]; mag likewise
  constexpr int kWords = (MI * NI * 4 + 31) / 32;
  uint32_t gate[kWords] = {}, mag[kWords] = {};
  float sum0[NI][2], sum1[NI][2];
  Acc acc;

  // (a) g = xc W_enc; masks, c(h), c(hga), colsum(max(hg, 0)); park g
  zero(acc);
  mainloop<T, true, false>(acc, xc + l * BD, D, We + l * DS, S, D, m0, n0, smem);
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
    const int c = n0 + acc_col(ni, 0);
    float vbg[2], ve[2], vbm[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      vbg[j] = to_f(bg[LS + c + j]);
      ve[j] = e[LS + c + j];
      vbm[j] = to_f(bm[LS + c + j]);
      sum0[ni][j] = 0.f;
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float hv[2], hgav[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int i = acc_index(mi, ni, 2 * h + j);
          const float g = acc[mi][ni][2 * h + j];
          const float hg = to_f(from_f<T>(__fadd_rn(g, vbg[j])));
          const float hm = to_f(from_f<T>(__fadd_rn(__fmul_rn(g, ve[j]), vbm[j])));
          const bool on_g = hg > 0.f, on_m = on_g && hm > 0.f;
          if (on_g) gate[i / 32] |= 1u << (i % 32);
          if (on_m) mag[i / 32] |= 1u << (i % 32);
          hv[j] = on_m ? hm : 0.f;
          hgav[j] = on_g ? hg : 0.f;
          sum0[ni][j] += hgav[j];
          parked[i * kThreads + tid] = g;
        }
        const long long off = static_cast<long long>(m0 + acc_row(mi, 2 * h)) * S + c;
        store2(hc + l * BS + off, hv[0], hv[1]);
        store2(hgac + l * BS + off, hgav[0], hgav[1]);
      }
  }
  block_col_sums(sum0, red + kHga * kRedFloats, part_out(kHga));

  // (b) dy W_dec^T: dhm, its column sums and those of dhm g; park dhm e
  zero(acc);
  mainloop<T, true, true>(acc, dy + l * BD, D, Wd + l * DS, D, D, m0, n0, smem);
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
    const int c = n0 + acc_col(ni, 0);
    float ve[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      ve[j] = e[LS + c + j];
      sum0[ni][j] = sum1[ni][j] = 0.f;
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = acc_index(mi, ni, k);
        const float dhm = (mag[i / 32] >> (i % 32)) & 1u ? acc[mi][ni][k] : 0.f;
        sum0[ni][k % 2] += dhm;
        sum1[ni][k % 2] += dhm * parked[i * kThreads + tid];
        parked[i * kThreads + tid] = __fmul_rn(dhm, ve[k % 2]);
      }
  }
  block_col_sums(sum0, red + kDbm * kRedFloats, part_out(kDbm));
  block_col_sums(sum1, red + kDrm * kRedFloats, part_out(kDrm));

  // (c) dvia W_dec^T: dhg, c(dg) = c(dhg + dhm e), column sums of dhg
  zero(acc);
  mainloop<T, true, true>(acc, dvia + l * BD, D, Wd + l * DS, D, D, m0, n0, smem);
  const float g1 = dl1[l];
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
    const int c = n0 + acc_col(ni, 0);
    float vterm[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      vterm[j] = __fmul_rn(g1, wdn[LS + c + j]);
      sum0[ni][j] = 0.f;
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float dg[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int i = acc_index(mi, ni, 2 * h + j);
          const float dhg =
              (gate[i / 32] >> (i % 32)) & 1u ? __fadd_rn(acc[mi][ni][2 * h + j], vterm[j]) : 0.f;
          sum0[ni][j] += dhg;
          dg[j] = __fadd_rn(dhg, parked[i * kThreads + tid]);
        }
        store2(dgc + l * BS + static_cast<long long>(m0 + acc_row(mi, 2 * h)) * S + c, dg[0],
               dg[1]);
      }
  }
  block_col_sums(sum0, red + kDbg * kRedFloats, part_out(kDbg));
}

// dW_dec [S, D] = c(h)^T dy + c(hga)^T dvia + coef[s] W_dec[s, :], with
// coef = dl1 colsum(max(hg, 0)) / max(wdn, 1e-30).  Grid (D/BN, S/BM, L).
template <typename T>
__global__ void __launch_bounds__(kThreads)
wdec_kernel(const T* __restrict__ hc, const T* __restrict__ dy, const T* __restrict__ hgac,
            const T* __restrict__ dvia, const T* __restrict__ Wd,
            const float* __restrict__ hga_sum, const float* __restrict__ wdn,
            const float* __restrict__ dl1, float* __restrict__ dWd, int B, int D, int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int l = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const long long BS = static_cast<long long>(B) * S, BD = static_cast<long long>(B) * D;
  const long long SD = static_cast<long long>(S) * D, LS = static_cast<long long>(l) * S;
  Acc acc;
  zero(acc);
  mainloop<T, false, false>(acc, hc + l * BS, S, dy + l * BD, D, B, m0, n0, smem);
  mainloop<T, false, false>(acc, hgac + l * BS, S, dvia + l * BD, D, B, m0, n0, smem);
  const float g1 = dl1[l];
  const T* wd = Wd + l * SD;
  float* out = dWd + l * SD;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + acc_row(mi, 2 * h);
      const float coef = __fdiv_rn(__fmul_rn(g1, hga_sum[LS + r]), fmaxf(wdn[LS + r], 1e-30f));
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const long long off = static_cast<long long>(r) * D + n0 + acc_col(ni, 0);
        store2(out + off, acc[mi][ni][2 * h] + coef * to_f(wd[off]),
               acc[mi][ni][2 * h + 1] + coef * to_f(wd[off + 1]));
      }
    }
}

template <typename T>
cudaError_t backward(const void* x, const void* We, const void* bg, const void* e,
                     const void* bm, const void* Wd, const void* bd, const void* wdn,
                     const void* dy, const void* dvia, const void* dl1, void* xc, void* hc,
                     void* hgac, void* dgc, void* part, void* sums, void* dWe, void* dWd, int L,
                     int B, int D, int S, cudaStream_t s) {
  const T *tx = static_cast<const T*>(x), *tWe = static_cast<const T*>(We);
  const T *tbg = static_cast<const T*>(bg), *tbm = static_cast<const T*>(bm);
  const T *tWd = static_cast<const T*>(Wd), *tbd = static_cast<const T*>(bd);
  const T *tdy = static_cast<const T*>(dy), *tdvia = static_cast<const T*>(dvia);
  const float *te = static_cast<const float*>(e), *twdn = static_cast<const float*>(wdn);
  const float* tdl1 = static_cast<const float*>(dl1);
  T *txc = static_cast<T*>(xc), *thc = static_cast<T*>(hc), *thgac = static_cast<T*>(hgac);
  T* tdgc = static_cast<T*>(dgc);
  float *tpart = static_cast<float*>(part), *tsums = static_cast<float*>(sums);
  cudaError_t err = center<T>(tx, tbd, txc, L, B, D, s);
  if (err != cudaSuccess) return err;

  constexpr int smem_dg = DgSmem<T>::bytes;
  if ((err = allow_smem(dg_kernel<T>, smem_dg)) != cudaSuccess) return err;
  dg_kernel<T><<<dim3(S / BN, B / BM, L), kThreads, smem_dg, s>>>(
      txc, tWe, tbg, te, tbm, tWd, twdn, tdy, tdvia, tdl1, thc, thgac, tdgc, tpart, L, B, D, S);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if ((err = partial_sums(tpart, tsums, kParts * L, B / BM, S, s)) != cudaSuccess) return err;

  constexpr int smem_w = Smem<T, false, false>::bytes;
  if ((err = allow_smem(wgrad_kernel<T>, smem_w)) != cudaSuccess) return err;
  if ((err = allow_smem(wdec_kernel<T>, smem_w)) != cudaSuccess) return err;
  // dW_enc [D, S] = xc^T c(dg)
  wgrad_kernel<T><<<dim3(S / BN, D / BM, L), kThreads, smem_w, s>>>(
      txc, tdgc, static_cast<float*>(dWe), D, S, B);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  wdec_kernel<T><<<dim3(D / BN, S / BM, L), kThreads, smem_w, s>>>(
      thc, tdy, thgac, tdvia, tWd, tsums + static_cast<long long>(kHga) * L * S, twdn, tdl1,
      static_cast<float*>(dWd), B, D, S);
  return cudaGetLastError();
}

}  // namespace

// dtype: 1 = bfloat16 (float32, 0, is refused: sae_fused_tf32.cu's).  x,
// W_enc, b_gate, b_mag, W_dec, b_dec,
// dy, dvia, xc (scratch), hc, hgac and dgc (scratch, [L, B, S]) in the
// compute type; e and wdn [L, S], dl1 [L], part (scratch, [4, L, B/128, S]),
// sums [4, L, S] (colsum(max(hg, 0)), db_gate, db_mag, sum(dhm g)), dWe
// [L, D, S] and dWd [L, S, D] float32.  Returns the launches' cudaError_t.
extern "C" int sae_fused_bwd_gated(const void* x, const void* We, const void* bg,
                                   const void* e, const void* bm, const void* Wd,
                                   const void* bd, const void* wdn, const void* dy,
                                   const void* dvia, const void* dl1, void* xc, void* hc,
                                   void* hgac, void* dgc, void* part, void* sums, void* dWe,
                                   void* dWd, int L, int B, int D, int S, int dtype, int device,
                                   void* stream) {
  if (!sae::shapes_ok(L, B, D, S)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return backward<__nv_bfloat16>(x, We, bg, e, bm, Wd, bd, wdn, dy, dvia, dl1, xc, hc, hgac,
                                   dgc, part, sums, dWe, dWd, L, B, D, S, s);
  return cudaErrorInvalidValue;
}
