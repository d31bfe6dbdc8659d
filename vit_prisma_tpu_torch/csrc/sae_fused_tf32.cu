// The float32 route of the fused standard-ReLU SAE forward (kernel B4), its
// stored-activations backward (B6) and its remat backward (B5), of the fused
// TopK SAE forward (B8) and its remat backward (B9), and of the fused gated
// SAE forward (B11) and its remat backward (B12), over L stacked SAEs: each
// float32 product as three TF32 products (3xTF32) on tf32 wgmma, on
// hopper_gemm.cuh's float32 pieces.  sm_90a only.
//
// Replaces, for float32, the Pallas TPU kernels `_fwd_kernel` (launched by
// `_fused_forward`, vit_prisma_tpu/ops/sae_step.py:148), `_bwd_kernel_stored`
// (`_fused_backward_stored`, :389), `_bwd_kernel` (`_fused_backward`, :250),
// `_fwd_kernel_topk` (`_fused_forward_topk`, :656, with its threshold
// search `_row_kth_threshold`), `_bwd_kernel_topk` (`_fused_backward_topk`,
// :763), `_fwd_kernel_gated` (`_fused_forward_gated`, :1001) and
// `_bwd_kernel_gated` (`_fused_backward_gated`, :1116).  The functions and
// cast points are those of the plain versions `sae_fused_forward_reference`,
// `sae_fused_backward_stored_reference`, `sae_fused_backward_reference`,
// `sae_fused_forward_topk_reference`, `sae_fused_backward_topk_reference`,
// `sae_gated_fused_forward_reference` and `sae_gated_fused_backward_reference`
// (vit_prisma_tpu_torch/ops/sae_step.py), float32 throughout:
//   B4: xc = x - b_dec; hpre = xc W_enc + b_enc; hc = relu(hpre);
//       y = b_dec + hc W_dec; l1[l] = sum of hc; nact[l, j] = rows with hpre > 0;
//   B6: dh = hc > 0 ? dy W_dec^T + dl1 : 0 (dhc = dh); dW_enc = xc^T dhc,
//       dW_dec = hc^T dy; db_enc = column sums of dh;
//   B5: B4's encoder again, the same kernel on the same tiles with no
//       reductions, so hc is B4's to the bit; relu(hpre) > 0 iff hpre > 0
//       in float32, so B6 on it is B5 (its grads are B6's on B4's hc);
//   B8: the TopK encoder stores max(hpre, 0) (+0 where hpre <= 0, never -0);
//       radix_select.cuh's select (B10's kernel) takes each row's k-th
//       largest t, bitwise the bitwise search's on such rows, and masks the
//       row in place: h = (hp > 0 && hp >= t) ? hp : +0 (ties keep >= k);
//       nact and l1 from h (sae_gemm.cuh's active_counts); y = b_dec + h W_dec;
//   B9: the remat encoder, B8's TopK encoder on the same tiles masked against
//       the stored t, so h is B8's to the bit; then B6 on it (h > 0 exactly
//       on the active set), so its grads are B6's on B8's h.
//   B11 (e = exp(r_mag) and the W_dec row norms wdn hoisted by the wrapper):
//       g = xc W_enc; hg = g + b_gate, hm = g e + b_mag; h = hg > 0 && hm > 0
//       ? hm : 0, hga = max(hg, 0), stored stacked [L, 2B, S]; y and via =
//       b_dec + [h; hga] W_dec in one decoder launch over the 2B rows; l1 =
//       sum of hga wdn; nact = rows with h > 0;
//   B12: B11's encoder again (h, hga and so both masks B11's to the bit, g
//       kept unrounded); dhm = h > 0 ? dy W_dec^T : 0, dhg = hga > 0 ? dvia
//       W_dec^T + dl1 wdn : 0, dg = dhg + dhm e; dW_enc = xc^T dg, dW_dec =
//       [h; hga]^T [dy; dvia] + (dl1 colsum(hga) / max(wdn, 1e-30)) W_dec;
//       db_gate, db_mag and sum(dhm g) column sums (dr_mag = e times the last,
//       in the wrapper).
// Every partial sum is taken in a fixed order without atomics (the wrapper
// sums the per-tile partials), so two calls give the same bits.
//
// Arithmetic (hopper_gemm.cuh's float32 section): a b = a_lo b_hi + a_hi
// b_lo + a_hi b_hi with hi = x rounded to TF32 and lo = (x - hi) rounded;
// each 32-deep stage is summed from zero on the tensor cores (the small
// products first) and added to the float32 total in FADDs, which round to
// nearest (the tensor cores truncate at each product: one accumulator over
// the whole K drifts by about half an ulp a k-step).
//
// Operand layouts.  tf32 wgmma reads B from shared memory K-major only (the
// transpose bits exist for 16-bit types alone); A comes from registers, so
// each consumer thread reads its own elements of a landed A tile in the
// layout it lies in.  Per product (C [M, N] = A [M, K] B [K, N] a layer):
//   encoder hpre = xc W_enc: A xc [B, D] K-major (hg::load_frags, two 16-byte
//     chunks a row); B = W_enc [D, S] lies N-contiguous: a pre-pass
//     (split_t_kernel) writes its hi and lo parts K-major, [2L, S, D];
//   decoder y = hc W_dec: A hc [B, S] K-major; B = W_dec [S, D]: split
//     copy [2L, D, S] (split_t_kernel);
//   dh = dy W_dec^T: A dy [B, D] K-major; B(k = d, n = s) = W_dec[s, d] is
//     K-major as it lies: split in place of order, [2L, S, D]
//     (split_rows_kernel);
//   dW_enc^T = dhc^T xc and dW_dec = hc^T dy, both [S, D] with K = B, in
//     one launch: A = dhc, hc [B, S] lie M-contiguous (load_frags_mn:
//     scalar reads, conflict-free in the swizzle); B = xc, dy [B, D] as
//     B(k = b, n = d): transposed split copies [2L, D, B] (xc's formed from
//     x and b_dec in the same pass, so B6 writes no xc); dW_enc^T's epilogue
//     stores it transposed into dW_enc [L, D, S].  The large [B, S]
//     operands are the register A, so only the [B, D] ones are copied.
// K order of the split copies, inside each 32-deep stage: position j holds
// source row k_phys(j) (hg::k_phys: thread t's elements are then its 16-byte
// chunks 2t and 2t + 1 of a K-major A row) for the first three products,
// and k_mn(j) = 8 (j / 8) + 2 (j % 4) + j % 8 / 4 for the weight gradients
// (thread t's elements of a k8 step are then A's rows 2t and 2t + 1, and a
// warp's 32 scalar reads of an M-contiguous tile hit 32 banks).  A product
// does not depend on the order of its terms beyond rounding, and the order
// is fixed: one row's output depends on its own data alone.
//
// Scratch (the wrapper's, `_tf32_scratch_floats`): the forwards (B4, B8,
// B11) L * 2 S D floats (W_enc's split copy, then W_dec's in the same
// place); the backwards (B5, B6, B9) L * max(2 S D, 4 D B) (W_dec's, then
// xc's and dy's transposed copies), B12 L * max(2 S D, 6 D B) (xc's [2L, D,
// B] and [dy; dvia]'s [2L, D, 2B]).  At the sweep's shape (24 x 4096 rows,
// 1024 -> 8192) 1.6 GB, rewritten every call: the weights change every
// step.
//
// Design: ln_matmul.cu's float32 kernel (B14), generalized to the SAE's
// operands and epilogues.  A grid of 128 x 128 output tiles (consecutive
// blocks walk the axis with fewer tiles, so the blocks running together
// share the other operand's panel), one block an SM: one producer warp
// keeps a 4-stage ring of a [128 x 32] A tile (four [32 x 32] boxes where A
// is M-contiguous) and B's hi and lo [128 x 32] tiles filled by TMA
// (48 KB a stage); two consumer warpgroups of 64 rows each load, split and
// issue wgmma m64n128k8 with A from registers, one stage's sum from zero a
// commit group, waited for, then added to the total; the two warpgroups'
// products interleave on the tensor cores.  Epilogues from the registers:
//   encoder: b_enc, ReLU, hc stored; nact column counts from ballots and the
//     l1 sum of the tile, in a fixed order (B4; none in B5);
//   TopK encoder (B8) and remat encoder (B9): b_enc, max(hpre, 0) stored,
//     B9's masked against its row's t; no reductions;
//   decoder: b_dec, y stored;
//   dh: the stored hc read at the same places, the mask, dl1, dhc stored;
//     db_enc column partials of the tile in a fixed order;
//   wgrad: dW_enc transposed (32 bytes a group of 8 rows), dW_dec as it lies;
//   gated encoder (B11): b_gate, e, b_mag, h and hga stored into the stacked
//     rows, nact from ballots of h > 0 and the l1 partial of hga wdn;
//   gated remat encoder (B12): the same h and hga, the float32 g, colsum(hga)
//     partials;
//   gated dg (B12), two launches of one mode on the dh mainloop: the dy pass
//     masks by h, stores dhm e into dg and the partials of dhm and dhm g (a
//     second partial row set in the ring's first stage, once both consumer
//     warpgroups are past the mainloop); the dvia pass masks by hga, adds dl1
//     wdn, reads back dhm e where the same thread stored it and stores dg =
//     dhg + dhm e, with the partials of dhg.  Two passes, not two live
//     accumulators: a second m64n128 product with its stage sum from zero
//     would need ~256 registers a thread against the 168 this kernel holds;
//     the price is dg's float32 tile written, read and written again (0.6 GB
//     at the gated slice, ~0.2 ms at 3.35 TB/s);
//   gated wgrad (B12): dW_enc as wgrad's, then dW_dec over K = 2 B (the
//     stacked [h; hga] against [dy; dvia]'s split copy, each row dy's B
//     columns then dvia's) + coef W_dec.
//
// What bounds it on an H100.  At the sweep's shape B4's two products are
// 3.3 TFLOP of float32, 9.9 TFLOP of TF32 as three products each: 20.0 ms at
// the 495 TFLOP/s TF32 peak, against ~10 GB of traffic (3 ms at 3.35 TB/s,
// the pre-passes included); B6's three 30.0 ms.  So the tensor cores bound
// them; the FFMA tiles this route replaces ran at 36-39 TFLOP/s (~90 and
// ~130 ms).  B14's kernel of the same design reached 66-71% of its 3xTF32
// bound.  Measured times are in PERF.md.
//
// B8 adds to its two products the select (4 digit passes over each 48 KB
// row at the TopK slice, staged in shared memory: one read of h and one
// write) and the counts pass (one more read of h).  B11's three products at
// the gated slice (1 x 4096, 768 -> 12,288) are 1.406 ms at the 3xTF32
// bound, B12's six 2.811 ms; their [B, S] float32 tiles (h, hga, g, dg)
// move ~0.8 GB (B11) and ~1.8 GB (B12) once each, 0.24 and 0.54 ms at 3.35
// TB/s.
//
// Shapes: B, d_in and d_sae multiples of 128 (every shape the fused step's
// gate admits); every pointer 16-byte aligned.

#include "hopper_gemm.cuh"
#include "radix_select.cuh"
#include "sae_gemm.cuh"

namespace {

namespace st {

constexpr int kBM = 128;                          // block tile rows, 64 a consumer warpgroup
constexpr int kBN = 128;                          // block tile columns: m64n128k8's N
constexpr int kBK = hg::kF32Box;                  // K a stage: one 128-byte row of floats
constexpr int kStages = 4;
constexpr int kConsumers = 2;                     // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer's warpgroup
constexpr int kABytes = kBM * kBK * 4;            // one stage's A tile, 16 KB
constexpr int kBBytes = kBN * kBK * 4;            // B's hi (or lo) tile, 16 KB
constexpr int kStageBytes = kABytes + 2 * kBBytes;
constexpr int kMnBoxBytes = kBK * kBK * 4;        // an M-contiguous A box [32 K x 32 M]
constexpr int kRedOffset = kStages * kStageBytes;  // column partials: a row a consumer warp
constexpr int kL1Offset = kRedOffset + 4 * kConsumers * kBN * 4;
constexpr int kBarOffset = kL1Offset + 4 * kConsumers * 4;
constexpr int kBytes = kBarOffset + 2 * kStages * 8 + hg::kSwizzleAlign;
static_assert(kBytes <= 232448, "shared memory");

enum Mode {
  kEncoder = 0, kDecoder = 1, kDh = 2, kWgrad = 3, kTopkEncoder = 4, kTopkRemat = 5,
  kGatedEncoder = 6, kGatedRemat = 7, kGatedDg = 8, kGatedWgrad = 9
};
enum Order { kOrderK = 0, kOrderMn = 1 };  // the split copies' K order

// Position j of a 32-deep stage of a weight-gradient split copy holds
// source row k_mn(j).
__host__ __device__ constexpr int k_mn(int j) { return 8 * (j / 8) + 2 * (j % 4) + j % 8 / 4; }

struct Params {
  int L, M, N, K;        // C [L, M, N] = A [L, M, K] B [L, K, N]
  int K2;                // the weight gradients' second product's K (B6: B; B12: 2 B)
  int tm, tn;            // M / 128, N / 128
  int m_fast;            // consecutive blocks walk M tiles first
  int gate_pass;         // gated dg: 0 the dy pass, 1 the dvia pass
  const float* bias;     // b_enc (encoder), b_dec (decoder), b_gate (gated encoder) [L, N]
  const float* bias2;    // b_mag (gated encoder) [L, N]
  const float* e;        // exp(r_mag) [L, N] (gated encoder, dg)
  const float* wdn;      // W_dec's row norms [L, S] (gated encoder, dg, gated wgrad)
  const float* hc;       // the stored hc [L, M, N] (dh's mask); gated dg: h and hga [L, 2M, N]
  const float* t;        // B8's thresholds [L, M] (the remat encoder's mask)
  const float* dl1;      // [L] (dh, gated dg, gated wgrad)
  const float* wd;       // W_dec [L, M, N] (gated wgrad)
  const float* hsum;     // colsum(max(hg, 0)) [L, M] (gated wgrad)
  float* g;              // the float32 g [L, M, N]: gated remat encoder out, dg's dy pass in
  float* out;            // hc (h), y, dhc, dg [L, M, N]; gated encoders: h, hga [L, 2M, N];
                         // wgrad: dW_enc [L, N, M]
  float* out2;           // wgrad: dW_dec [L, M, N]
  float* part;           // [L, M / 128, N]: nact (encoders; null in B5), db_enc (dh),
                         // colsum(max(hg, 0)) (gated remat), db_mag, db_gate (dg passes)
  float* part2;          // [L, M / 128, N]: sum(dhm g) (dg's dy pass)
  float* l1_part;        // [L, M / 128, N / 128] (encoders; null in B5)
};

// Thread (warp w, lane) of a consumer warpgroup: the raw A elements of one
// stage for rows row0 + g and row0 + g + 8 of an M-contiguous A tile (four
// [32 K rows x 32 M] boxes landed 128-byte swizzled, box i holding M
// 32 i .. 32 i + 31), in fragment order: x[kk][e] is A(m = row0 + g + 8 (e %
// 2), k = 8 kk + 2 t + e / 2), k_mn's order (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void load_frags_mn(float (&x)[4][4], const unsigned char* tile,
                                              int row0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    // K row 8 kk + r of the box: the swizzle reads r alone (r < 8), so the
    // k8 steps lie 1024 bytes apart
    const int m = row0 + g + 8 * (e & 1), r = 2 * t + (e >> 1);
    const unsigned char* p =
        tile + (m >> 5) * kMnBoxBytes + hg::sw128(r, (m & 31) >> 2) + (m & 3) * 4;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) x[kk][e] = *reinterpret_cast<const float*>(p + 1024 * kk);
  }
}

// A consumer warp's column partials v0, v1 (columns 8 j + 2 t, + 1, over
// the thread's two rows) summed over the warp's 16 rows, into its row of
// `red` (kBN floats).
__device__ __forceinline__ void col_partial(float v0, float v1, float* red_row, int j,
                                            int lane) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    v0 += __shfl_xor_sync(0xffffffffu, v0, o);
    v1 += __shfl_xor_sync(0xffffffffu, v1, o);
  }
  if (lane < 4) *reinterpret_cast<float2*>(red_row + 8 * j + 2 * lane) = make_float2(v0, v1);
}

// Grid: (tm, tn, Z) with m_fast, else (tn, tm, Z); Z = L (wgrad: 2 L, the
// dW_enc tiles of every layer, then dW_dec's).  kThreads threads, kBytes of
// dynamic shared memory.  a0, b0 (a1, b1: wgrad's second product): A
// [L, M, K] in boxes of [128 x 32] (K-major) or [L, K, M] in boxes of
// [32 x 32] (wgrad: M-contiguous), and B's split copy [2 L, N, K] (hi at
// layer l, lo at L + l) in boxes of [128 x 32].
template <int MODE>
__global__ void __launch_bounds__(kThreads, 1)
    sae_tf32_kernel(const __grid_constant__ CUtensorMap a0, const __grid_constant__ CUtensorMap b0,
                    const __grid_constant__ CUtensorMap a1, const __grid_constant__ CUtensorMap b1,
                    const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + hg::kSwizzleAlign - 1) &
      ~static_cast<uintptr_t>(hg::kSwizzleAlign - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOffset);
  uint64_t* empty = full + kStages;
  const int mt = p.m_fast ? blockIdx.x : blockIdx.y;
  const int nt = p.m_fast ? blockIdx.y : blockIdx.x;
  const int m0 = mt * kBM, n0 = nt * kBN;
  constexpr bool kMn = MODE == kWgrad || MODE == kGatedWgrad;  // A M-contiguous
  const bool second = kMn && static_cast<int>(blockIdx.z) >= p.L;
  const int l = static_cast<int>(blockIdx.z) - (second ? p.L : 0);
  const int ktiles = (second ? p.K2 : p.K) / kBK;
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
      const CUtensorMap* am = second ? &a1 : &a0;
      const CUtensorMap* bm = second ? &b1 : &b0;
      for (int kt = 0; kt < ktiles; ++kt) {
        const int st = kt % kStages, round = kt / kStages;
        if (round > 0) hg::mbar_wait(&empty[st], (round - 1) & 1);
        unsigned char* stage = smem + st * kStageBytes;
        hg::mbar_expect_tx(&full[st], kStageBytes);
        if (kMn) {
#pragma unroll
          for (int i = 0; i < kBM / kBK; ++i)
            hg::tma_load_3d(stage + i * kMnBoxBytes, am, &full[st], m0 + kBK * i, kt * kBK, l);
        } else {
          hg::tma_load_3d(stage, am, &full[st], kt * kBK, m0, l);
        }
        hg::tma_load_3d(stage + kABytes, bm, &full[st], kt * kBK, n0, l);
        hg::tma_load_3d(stage + kABytes + kBBytes, bm, &full[st], kt * kBK, n0, p.L + l);
      }
    }
    return;
  }

  // consumer warpgroup wg: rows m0 + 64 wg .. + 64 of the tile
  hg::reg_alloc<232>();
  const int t = threadIdx.x % 128, warp = t / 32, lane = t & 31, g = lane >> 2, tq = lane & 3;
  const int row0 = 64 * wg + 16 * warp;  // this warp's rows within the tile
  const int cw = 4 * wg + warp;          // this warp's row of the column partials
  float acc[kBN / 2], c[kBN / 2];        // c: a stage's sum, from zero (scale-d 0)
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int st = kt % kStages;
    hg::mbar_wait(&full[st], (kt / kStages) & 1);
    const unsigned char* stage = smem + st * kStageBytes;
    float x[4][4];
    if constexpr (kMn)
      load_frags_mn(x, stage, row0);
    else
      hg::load_frags(x, reinterpret_cast<const float*>(stage), row0);
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

  // Epilogue, from the registers: acc[4 j + 2 h + e] is row row0 + g + 8 h,
  // column 8 j + 2 tq + e of the tile.
  float* red = reinterpret_cast<float*>(smem + kRedOffset);
  float* l1red = reinterpret_cast<float*>(smem + kL1Offset);
  const long long row = static_cast<long long>(l) * p.M + m0 + row0 + g;  // [L, M, .] rows
  const long long prow = static_cast<long long>(l) * p.tm + mt;          // partials' row
  if constexpr (MODE == kDecoder) {
    const float* bias = p.bias + static_cast<long long>(l) * p.N + n0;
    float* out = p.out + row * p.N + n0;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = 8 * j + 2 * tq;
      const float2 b = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        sae::store2(out + static_cast<long long>(8 * h) * p.N + col, b.x + acc[4 * j + 2 * h],
                    b.y + acc[4 * j + 2 * h + 1]);
    }
  } else if constexpr (MODE == kEncoder) {
    const float* bias = p.bias + static_cast<long long>(l) * p.N + n0;
    float* out = p.out + row * p.N + n0;
    float l1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = 8 * j + 2 * tq;
      const float2 b = *reinterpret_cast<const float2*>(bias + col);
      // nact: the warp's rows with hpre > 0 in each column, counted from
      // ballots (lanes 4 g + tq hold column 8 j + 2 tq + e), exact
      const unsigned same_col = 0x11111111u << tq;
      int c0 = 0, c1 = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float p0 = acc[4 * j + 2 * h] + b.x, p1 = acc[4 * j + 2 * h + 1] + b.y;
        const float h0 = p0 > 0.f ? p0 : 0.f, h1 = p1 > 0.f ? p1 : 0.f;
        c0 += __popc(__ballot_sync(0xffffffffu, p0 > 0.f) & same_col);
        c1 += __popc(__ballot_sync(0xffffffffu, p1 > 0.f) & same_col);
        l1 += h0 + h1;
        sae::store2(out + static_cast<long long>(8 * h) * p.N + col, h0, h1);
      }
      if (lane < 4)
        *reinterpret_cast<float2*>(red + cw * kBN + 8 * j + 2 * lane) =
            make_float2(static_cast<float>(c0), static_cast<float>(c1));
    }
    if (p.part != nullptr) {  // B4's reductions (B5 has none), warps in order
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) l1 += __shfl_xor_sync(0xffffffffu, l1, o);
      if (lane == 0) l1red[cw] = l1;
      hg::named_sync(1, 128 * kConsumers);
      const int c = 128 * wg + t;
      if (c < kBN) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < 4 * kConsumers; ++w) s += red[w * kBN + c];
        p.part[prow * p.N + n0 + c] = s;
      }
      if (c == 0) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < 4 * kConsumers; ++w) s += l1red[w];
        p.l1_part[prow * p.tn + nt] = s;
      }
    }
  } else if constexpr (MODE == kTopkEncoder || MODE == kTopkRemat) {
    // B8: max(hpre, 0), +0 where hpre <= 0 (the select's rows); B9: that
    // value where it is at least the row's t, else +0 (B8's h, to the bit)
    const float* bias = p.bias + static_cast<long long>(l) * p.N + n0;
    float* out = p.out + row * p.N + n0;
    float tr[2] = {0.f, 0.f};
    if constexpr (MODE == kTopkRemat) {
      tr[0] = p.t[row];
      tr[1] = p.t[row + 8];
    }
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = 8 * j + 2 * tq;
      const float2 b = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float p0 = acc[4 * j + 2 * h] + b.x, p1 = acc[4 * j + 2 * h + 1] + b.y;
        sae::store2(out + static_cast<long long>(8 * h) * p.N + col,
                    p0 > 0.f && p0 >= tr[h] ? p0 : 0.f, p1 > 0.f && p1 >= tr[h] ? p1 : 0.f);
      }
    }
  } else if constexpr (MODE == kGatedEncoder || MODE == kGatedRemat) {
    // g = xc W_enc; hg = g + b_gate and hm = g e + b_mag, each rounded once
    // (no contraction: the plain version's); h = hg > 0 && hm > 0 ? hm : 0
    // into rows [0, M) of the layer's stacked [2M, N], hga = max(hg, 0) into
    // rows [M, 2M).  B11: nact from ballots of h > 0, l1 from hga wdn; B12:
    // the same h and hga (one function of the same accumulators), the
    // unrounded g and colsum(hga) partials
    const long long cb = static_cast<long long>(l) * p.N + n0;  // [L, N] vectors
    float* hout = p.out + (2LL * l * p.M + m0 + row0 + g) * p.N + n0;
    float* aout = hout + static_cast<long long>(p.M) * p.N;
    float* gout = MODE == kGatedRemat ? p.g + row * p.N + n0 : nullptr;
    float l1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = 8 * j + 2 * tq;
      const float2 bg = *reinterpret_cast<const float2*>(p.bias + cb + col);
      const float2 ev = *reinterpret_cast<const float2*>(p.e + cb + col);
      const float2 bm = *reinterpret_cast<const float2*>(p.bias2 + cb + col);
      const float2 wn = MODE == kGatedEncoder
                            ? *reinterpret_cast<const float2*>(p.wdn + cb + col)
                            : make_float2(0.f, 0.f);
      const unsigned same_col = 0x11111111u << tq;
      int c0 = 0, c1 = 0;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long off = static_cast<long long>(8 * h) * p.N + col;
        float hv[2], av[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const float v = acc[4 * j + 2 * h + k];
          const float pg = __fadd_rn(v, k ? bg.y : bg.x);  // hg
          const float pm = __fadd_rn(__fmul_rn(v, k ? ev.y : ev.x), k ? bm.y : bm.x);  // hm
          hv[k] = pg > 0.f && pm > 0.f ? pm : 0.f;
          av[k] = pg > 0.f ? pg : 0.f;
        }
        sae::store2(hout + off, hv[0], hv[1]);
        sae::store2(aout + off, av[0], av[1]);
        if constexpr (MODE == kGatedEncoder) {
          c0 += __popc(__ballot_sync(0xffffffffu, hv[0] > 0.f) & same_col);
          c1 += __popc(__ballot_sync(0xffffffffu, hv[1] > 0.f) & same_col);
          l1 += av[0] * wn.x + av[1] * wn.y;
        } else {
          s0 += av[0];
          s1 += av[1];
          sae::store2(gout + off, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
      if constexpr (MODE == kGatedEncoder) {
        if (lane < 4)
          *reinterpret_cast<float2*>(red + cw * kBN + 8 * j + 2 * lane) =
              make_float2(static_cast<float>(c0), static_cast<float>(c1));
      } else {
        col_partial(s0, s1, red + cw * kBN, j, lane);
      }
    }
    if constexpr (MODE == kGatedEncoder) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) l1 += __shfl_xor_sync(0xffffffffu, l1, o);
      if (lane == 0) l1red[cw] = l1;
    }
    hg::named_sync(1, 128 * kConsumers);
    const int c = 128 * wg + t;
    if (c < kBN) {  // nact (B11) or colsum(hga) (B12) of the tile, warps in order
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < 4 * kConsumers; ++w) s += red[w * kBN + c];
      p.part[prow * p.N + n0 + c] = s;
    }
    if (MODE == kGatedEncoder && c == 0) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < 4 * kConsumers; ++w) s += l1red[w];
      p.l1_part[prow * p.tn + nt] = s;
    }
  } else if constexpr (MODE == kGatedDg) {
    // A = dy (gate_pass 0) or dvia (1), B = W_dec^T: the products dy W_dec^T
    // and dvia W_dec^T of B12.  The dy pass: dhm = h > 0 ? acc : 0, dg <-
    // dhm e, column partials of dhm and dhm g; the dvia pass: dhg = hga > 0
    // ? acc + dl1 wdn : 0, dg <- dhg + dg (the dy pass's, read back where
    // this thread wrote it), column partials of dhg
    const long long cb = static_cast<long long>(l) * p.N + n0;
    const float* mask = p.hc + ((2LL * l + p.gate_pass) * p.M + m0 + row0 + g) * p.N + n0;
    float* out = p.out + row * p.N + n0;
    if (p.gate_pass == 0) {
      const float* gin = p.g + row * p.N + n0;
      // the second set of partials in the ring's first stage, free once
      // both consumer warpgroups have left the mainloop
      float* red2 = reinterpret_cast<float*>(smem);
      hg::named_sync(1, 128 * kConsumers);
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = 8 * j + 2 * tq;
        const float2 ev = *reinterpret_cast<const float2*>(p.e + cb + col);
        float s0 = 0.f, s1 = 0.f, u0 = 0.f, u1 = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long off = static_cast<long long>(8 * h) * p.N + col;
          const float2 mv = *reinterpret_cast<const float2*>(mask + off);
          const float2 gv = *reinterpret_cast<const float2*>(gin + off);
          const float d0 = mv.x > 0.f ? acc[4 * j + 2 * h] : 0.f;
          const float d1 = mv.y > 0.f ? acc[4 * j + 2 * h + 1] : 0.f;
          s0 += d0;
          s1 += d1;
          u0 += d0 * gv.x;
          u1 += d1 * gv.y;
          sae::store2(out + off, __fmul_rn(d0, ev.x), __fmul_rn(d1, ev.y));
        }
        col_partial(s0, s1, red + cw * kBN, j, lane);
        col_partial(u0, u1, red2 + cw * kBN, j, lane);
      }
      hg::named_sync(1, 128 * kConsumers);
      const int c = 128 * wg + t;
      if (c < kBN) {  // the tile's column sums of dhm and of dhm g, warps in order
        float s = 0.f, u = 0.f;
#pragma unroll
        for (int w = 0; w < 4 * kConsumers; ++w) {
          s += red[w * kBN + c];
          u += red2[w * kBN + c];
        }
        p.part[prow * p.N + n0 + c] = s;
        p.part2[prow * p.N + n0 + c] = u;
      }
    } else {
      const float gl = p.dl1[l];
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = 8 * j + 2 * tq;
        const float2 wn = *reinterpret_cast<const float2*>(p.wdn + cb + col);
        const float v0 = __fmul_rn(gl, wn.x), v1 = __fmul_rn(gl, wn.y);
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long off = static_cast<long long>(8 * h) * p.N + col;
          const float2 mv = *reinterpret_cast<const float2*>(mask + off);
          const float2 dv = *reinterpret_cast<const float2*>(out + off);
          const float d0 = mv.x > 0.f ? __fadd_rn(acc[4 * j + 2 * h], v0) : 0.f;
          const float d1 = mv.y > 0.f ? __fadd_rn(acc[4 * j + 2 * h + 1], v1) : 0.f;
          s0 += d0;
          s1 += d1;
          sae::store2(out + off, __fadd_rn(d0, dv.x), __fadd_rn(d1, dv.y));
        }
        col_partial(s0, s1, red + cw * kBN, j, lane);
      }
      hg::named_sync(1, 128 * kConsumers);
      const int c = 128 * wg + t;
      if (c < kBN) {  // the tile's column sums of dhg, warps in order
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < 4 * kConsumers; ++w) s += red[w * kBN + c];
        p.part[prow * p.N + n0 + c] = s;
      }
    }
  } else if constexpr (MODE == kDh) {  // the mask from the stored hc, dl1, dhc
    const float gl = p.dl1[l];
    const float* hc = p.hc + row * p.N + n0;
    float* out = p.out + row * p.N + n0;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = 8 * j + 2 * tq;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long off = static_cast<long long>(8 * h) * p.N + col;
        const float2 hv = *reinterpret_cast<const float2*>(hc + off);
        const float d0 = hv.x > 0.f ? acc[4 * j + 2 * h] + gl : 0.f;
        const float d1 = hv.y > 0.f ? acc[4 * j + 2 * h + 1] + gl : 0.f;
        s0 += d0;
        s1 += d1;
        sae::store2(out + off, d0, d1);
      }
      col_partial(s0, s1, red + cw * kBN, j, lane);
    }
    hg::named_sync(1, 128 * kConsumers);
    const int c = 128 * wg + t;
    if (c < kBN) {  // the tile's column sums of dh, warps in order
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < 4 * kConsumers; ++w) s += red[w * kBN + c];
      p.part[prow * p.N + n0 + c] = s;
    }
  } else {  // wgrad: [S, D] tiles
    if (!second) {  // dW_enc [L, D, S]: element (s, d) of dW_enc^T at [l][d][s]
      float* out = p.out + static_cast<long long>(l) * p.N * p.M + m0 + row0 + g;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float* o = out + static_cast<long long>(n0 + 8 * j + 2 * tq + e) * p.M;
          o[0] = acc[4 * j + e];
          o[8] = acc[4 * j + 2 + e];
        }
    } else if constexpr (MODE == kWgrad) {  // dW_dec [L, S, D], as it lies
      float* out = p.out2 + row * p.N + n0;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          sae::store2(out + static_cast<long long>(8 * h) * p.N + 8 * j + 2 * tq,
                      acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    } else {  // B12's dW_dec [L, S, D]: + coef[s] W_dec[s, :], coef = dl1
              // colsum(max(hg, 0)) / max(wdn, 1e-30)
      float* out = p.out2 + row * p.N + n0;
      const float* wd = p.wd + row * p.N + n0;
      const float gl = p.dl1[l];
      float coef[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        coef[h] = __fdiv_rn(__fmul_rn(gl, p.hsum[row + 8 * h]), fmaxf(p.wdn[row + 8 * h], 1e-30f));
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long off = static_cast<long long>(8 * h) * p.N + 8 * j + 2 * tq;
          const float2 w = *reinterpret_cast<const float2*>(wd + off);
          sae::store2(out + off, __fadd_rn(acc[4 * j + 2 * h], __fmul_rn(coef[h], w.x)),
                      __fadd_rn(acc[4 * j + 2 * h + 1], __fmul_rn(coef[h], w.y)));
        }
    }
  }
}

// hi[z][n][k], lo[z][n][k] (row stride ldk >= K) from src[z] [K, N] (N contiguous),
// less bias[z][n] where a bias is given (x - b_dec, one rounding, as the
// center rounds): hi = tf32(v), lo = tf32(v - hi) of v = src[z][k0 +
// ORDER(k - k0)][n] - bias[z][n], k0 the 32-deep stage of k.  Grid (N / 32,
// K / 32, Z), 256 threads; a 32 x 32 tile through shared memory, read along
// n and written along k.
template <int ORDER>
__global__ void __launch_bounds__(256)
    split_t_kernel(const float* __restrict__ src, const float* __restrict__ bias,
                   float* __restrict__ hi, float* __restrict__ lo, int K, int N, int ldk) {
  __shared__ float tile[32][33];
  const int lane = threadIdx.x & 31, wy = threadIdx.x / 32;
  const int n0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
  const long long z = blockIdx.z;
  const float* s = src + z * K * N;
  const float b = bias != nullptr ? bias[z * N + n0 + lane] : 0.f;
#pragma unroll
  for (int i = wy; i < 32; i += 8) {
    const float v = s[static_cast<long long>(k0 + i) * N + n0 + lane];
    tile[i][lane] = bias != nullptr ? __fsub_rn(v, b) : v;
  }
  __syncthreads();
  const int kp = ORDER == kOrderK ? hg::k_phys(lane) : k_mn(lane);
#pragma unroll
  for (int i = wy; i < 32; i += 8) {
    const float v = tile[kp][i];
    const float h = hg::tf32_round(v);
    const long long o = (z * N + n0 + i) * static_cast<long long>(ldk) + k0 + lane;
    hi[o] = h;
    lo[o] = hg::tf32_round(v - h);
  }
}

// hi[i], lo[i] from W [rows, K] (K contiguous), K in k_phys's order: position
// k0 + j holds W[.., k0 + k_phys(j)] (a lane takes it from the lane that read
// it).  n = rows * K, a multiple of 32; 256 threads a block.
__global__ void __launch_bounds__(256)
    split_rows_kernel(const float* __restrict__ W, float* __restrict__ hi,
                      float* __restrict__ lo, long long n) {
  const int src = hg::k_phys(threadIdx.x & 31);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  // a warp's 32 indices are one stage's, so the whole warp runs each pass
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float w = __shfl_sync(0xffffffffu, W[i], src);
    const float h = hg::tf32_round(w);
    hi[i] = h;
    lo[i] = hg::tf32_round(w - h);
  }
}

// ---- host ---------------------------------------------------------------------

// A float32 tensor [Z, rows, cols] (cols contiguous) in boxes of [box_rows x 32].
cudaError_t map_f32(CUtensorMap* map, const void* ptr, int Z, int rows, int cols,
                    int box_rows) {
  const uint64_t dims[3] = {static_cast<uint64_t>(cols), static_cast<uint64_t>(rows),
                            static_cast<uint64_t>(Z)};
  const uint64_t strides[2] = {static_cast<uint64_t>(cols) * 4,
                               static_cast<uint64_t>(rows) * cols * 4};
  const uint32_t box[3] = {static_cast<uint32_t>(kBK), static_cast<uint32_t>(box_rows), 1};
  return hg::make_map(map, ptr, 3, dims, strides, box, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}

template <int MODE>
cudaError_t launch(const CUtensorMap (&m)[4], Params p, cudaStream_t s) {
  auto kernel = sae_tf32_kernel<MODE>;
  cudaError_t err = sae::allow_smem(kernel, kBytes);
  if (err != cudaSuccess) return err;
  p.tm = p.M / kBM;
  p.tn = p.N / kBN;
  p.m_fast = p.tm < p.tn;
  const dim3 grid(p.m_fast ? p.tm : p.tn, p.m_fast ? p.tn : p.tm,
                  MODE == kWgrad || MODE == kGatedWgrad ? 2 * p.L : p.L);
  kernel<<<grid, kThreads, kBytes, s>>>(m[0], m[1], m[2], m[3], p);
  return cudaGetLastError();
}

// W [L, K, N] (N contiguous, less bias [L, N] where given) split K-major
// into hi = split, lo = split + L N ldk (rows of ldk floats, K by default:
// B12 writes dy's and dvia's copies side by side in rows of 2 B), in
// ORDER's K order.
template <int ORDER>
cudaError_t split_t(const void* W, const void* bias, float* split, int L, int K, int N,
                    cudaStream_t s, int ldk = 0) {
  if (ldk == 0) ldk = K;
  split_t_kernel<ORDER><<<dim3(N / 32, K / 32, L), 256, 0, s>>>(
      static_cast<const float*>(W), static_cast<const float*>(bias), split,
      split + static_cast<long long>(L) * N * ldk, K, N, ldk);
  return cudaGetLastError();
}

// C [L, M, N] = A [L, M, K] B with B's split copy at `split` ([2 L, N, K]).
template <int MODE>
cudaError_t product(const void* A, const float* split, Params p, cudaStream_t s) {
  CUtensorMap m[4];
  cudaError_t err;
  if ((err = map_f32(&m[0], A, p.L, p.M, p.K, kBM)) != cudaSuccess ||
      (err = map_f32(&m[1], split, 2 * p.L, p.N, p.K, kBN)) != cudaSuccess)
    return err;
  m[2] = m[0];
  m[3] = m[1];
  return launch<MODE>(m, p, s);
}

// hc [L, B, S] = relu(xc W_enc + b_enc) (MODE kEncoder: with nact_part and
// l1_part, B4, the counts and l1 partials; without, B5, none), B8's
// max(hpre, 0) (kTopkEncoder) or B8's h from its thresholds t (kTopkRemat).
template <int MODE>
cudaError_t encoder(const void* xc, const void* We, const void* be, const void* t, void* hc,
                    void* nact_part, void* l1_part, float* split, int L, int B, int D, int S,
                    cudaStream_t s) {
  cudaError_t err = split_t<kOrderK>(We, nullptr, split, L, D, S, s);
  if (err != cudaSuccess) return err;
  Params p = {};
  p.L = L, p.M = B, p.N = S, p.K = D;
  p.bias = static_cast<const float*>(be);
  p.t = static_cast<const float*>(t);
  p.out = static_cast<float*>(hc);
  p.part = static_cast<float*>(nact_part);
  p.l1_part = static_cast<float*>(l1_part);
  return product<MODE>(xc, split, p, s);
}

// y [L, B, D] = b_dec + hc W_dec: W_dec split K-major, then the decoder.
cudaError_t decoder(const void* hc, const void* Wd, const void* bd, void* y, float* split, int L,
                    int B, int D, int S, cudaStream_t s) {
  cudaError_t err = split_t<kOrderK>(Wd, nullptr, split, L, S, D, s);
  if (err != cudaSuccess) return err;
  Params p = {};
  p.L = L, p.M = B, p.N = D, p.K = S;
  p.bias = static_cast<const float*>(bd);
  p.out = static_cast<float*>(y);
  return product<kDecoder>(hc, split, p, s);
}

// W_dec [L, S, D] split in its own layout (the K-major B of dy W_dec^T).
cudaError_t split_rows(const void* Wd, float* split, int L, int D, int S, cudaStream_t s) {
  const long long sd = static_cast<long long>(L) * S * D;
  const long long blocks = (sd + 255) / 256;
  split_rows_kernel<<<static_cast<unsigned int>(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
      static_cast<const float*>(Wd), split, split + sd, sd);
  return cudaGetLastError();
}

// B6's launches from x and the stored hc: W_dec split in its own layout,
// dh; then x - b_dec and dy split transposed, and both weight gradients in
// one launch.
cudaError_t backward_stored(const void* x, const void* hc, const void* Wd, const void* bd,
                            const void* dy, const void* dl1, void* dhc, void* dWe, void* dWd,
                            void* dbe_part, float* split, int L, int B, int D, int S,
                            cudaStream_t s) {
  // dh [L, B, S] = dy [L, B, D] W_dec^T: W_dec [L, S, D] is the K-major B
  cudaError_t err = split_rows(Wd, split, L, D, S, s);
  if (err != cudaSuccess) return err;
  Params p = {};
  p.L = L, p.M = B, p.N = S, p.K = D;
  p.hc = static_cast<const float*>(hc);
  p.dl1 = static_cast<const float*>(dl1);
  p.out = static_cast<float*>(dhc);
  p.part = static_cast<float*>(dbe_part);
  if ((err = product<kDh>(dy, split, p, s)) != cudaSuccess) return err;

  // dW_enc^T [L, S, D] = dhc^T xc and dW_dec [L, S, D] = hc^T dy (K = B):
  // dhc and hc the M-contiguous A, xc and dy as B from their transposed
  // split copies [2 L, D, B] (xc's from x and b_dec)
  float* xt = split;
  float* yt = split + 2LL * L * D * B;
  CUtensorMap m[4];
  if ((err = split_t<kOrderMn>(x, bd, xt, L, B, D, s)) != cudaSuccess ||
      (err = split_t<kOrderMn>(dy, nullptr, yt, L, B, D, s)) != cudaSuccess ||
      (err = map_f32(&m[0], dhc, L, B, S, kBK)) != cudaSuccess ||
      (err = map_f32(&m[1], xt, 2 * L, D, B, kBN)) != cudaSuccess ||
      (err = map_f32(&m[2], hc, L, B, S, kBK)) != cudaSuccess ||
      (err = map_f32(&m[3], yt, 2 * L, D, B, kBN)) != cudaSuccess)
    return err;
  p = Params{};
  p.L = L, p.M = S, p.N = D, p.K = p.K2 = B;
  p.out = static_cast<float*>(dWe);
  p.out2 = static_cast<float*>(dWd);
  return launch<kWgrad>(m, p, s);
}

// A remat backward (B5: MODE kEncoder, t null; B9: kTopkRemat): center, the
// forward's encoder again without reductions, then B6's launches on its hc.
template <int MODE>
cudaError_t remat(const void* x, const void* We, const void* be, const void* Wd, const void* bd,
                  const void* dy, const void* dl1, const void* t, void* xc, void* hc, void* dhc,
                  float* split, void* dWe, void* dWd, void* dbe_part, int L, int B, int D, int S,
                  cudaStream_t s) {
  cudaError_t err;
  if ((err = sae::center<float>(static_cast<const float*>(x), static_cast<const float*>(bd),
                                static_cast<float*>(xc), L, B, D, s)) != cudaSuccess ||
      (err = encoder<MODE>(xc, We, be, t, hc, nullptr, nullptr, split, L, B, D, S, s)) !=
          cudaSuccess)
    return err;
  return backward_stored(x, hc, Wd, bd, dy, dl1, dhc, dWe, dWd, dbe_part, split, L, B, D, S, s);
}

// B11's and B12's encoder (MODE kGatedEncoder: nact_part and l1_part;
// kGatedRemat: g and colsum(max(hg, 0)) partials into part): W_enc's split,
// then h and hga into the stacked [L, 2B, S].
template <int MODE>
cudaError_t gated_encoder(const void* xc, const void* We, const void* bg, const void* e,
                          const void* bm, const void* wdn, void* h, void* g, void* part,
                          void* l1_part, float* split, int L, int B, int D, int S,
                          cudaStream_t s) {
  cudaError_t err = split_t<kOrderK>(We, nullptr, split, L, D, S, s);
  if (err != cudaSuccess) return err;
  Params p = {};
  p.L = L, p.M = B, p.N = S, p.K = D;
  p.bias = static_cast<const float*>(bg);
  p.bias2 = static_cast<const float*>(bm);
  p.e = static_cast<const float*>(e);
  p.wdn = static_cast<const float*>(wdn);
  p.out = static_cast<float*>(h);
  p.g = static_cast<float*>(g);
  p.part = static_cast<float*>(part);
  p.l1_part = static_cast<float*>(l1_part);
  return product<MODE>(xc, split, p, s);
}

// The order of B12's column partials in part [4, L, B/128, S] and sums [4,
// L, S]: colsum(max(hg, 0)), db_gate, db_mag, sum(dhm g).
enum GatedSum { kHga = 0, kDbg = 1, kDbm = 2, kDrm = 3 };

// B12 after its center: the remat encoder (h, hga, g, colsum(hga)); W_dec
// split in its own layout and dg in two passes (dy's, then dvia's); the
// column partials summed; x - b_dec transposed and [dy; dvia] transposed
// (dy's rows, then dvia's, in each row of the copy) split, and both weight
// gradients in one launch (dW_dec's K = 2 B).
cudaError_t gated_backward(const void* x, const void* xc, const void* We, const void* bg,
                           const void* e, const void* bm, const void* Wd, const void* bd,
                           const void* wdn, const void* dy, const void* dvia, const void* dl1,
                           void* h, void* g, void* dg, float* part, float* sums, void* dWe,
                           void* dWd, float* split, int L, int B, int D, int S, cudaStream_t s) {
  const long long plane = static_cast<long long>(L) * (B / kBM) * S;  // one partial set
  cudaError_t err;
  if ((err = gated_encoder<kGatedRemat>(xc, We, bg, e, bm, nullptr, h, g, part + kHga * plane,
                                        nullptr, split, L, B, D, S, s)) != cudaSuccess ||
      (err = split_rows(Wd, split, L, D, S, s)) != cudaSuccess)
    return err;
  Params p = {};
  p.L = L, p.M = B, p.N = S, p.K = D;
  p.hc = static_cast<const float*>(h);
  p.g = static_cast<float*>(g);
  p.e = static_cast<const float*>(e);
  p.wdn = static_cast<const float*>(wdn);
  p.dl1 = static_cast<const float*>(dl1);
  p.out = static_cast<float*>(dg);
  p.part = part + kDbm * plane;
  p.part2 = part + kDrm * plane;
  if ((err = product<kGatedDg>(dy, split, p, s)) != cudaSuccess) return err;
  p.gate_pass = 1;
  p.part = part + kDbg * plane;
  p.part2 = nullptr;
  if ((err = product<kGatedDg>(dvia, split, p, s)) != cudaSuccess ||
      (err = sae::partial_sums(part, sums, 4 * L, B / kBM, S, s)) != cudaSuccess)
    return err;

  // dW_enc^T [L, S, D] = dg^T xc (K = B) and dW_dec [L, S, D] = [h; hga]^T
  // [dy; dvia] (K = 2 B): dg and the stacked h the M-contiguous A, xc and
  // [dy; dvia] as B from their transposed split copies [2 L, D, B] and
  // [2 L, D, 2 B]
  float* xt = split;
  float* yt = split + 2LL * L * D * B;
  CUtensorMap m[4];
  if ((err = split_t<kOrderMn>(x, bd, xt, L, B, D, s)) != cudaSuccess ||
      (err = split_t<kOrderMn>(dy, nullptr, yt, L, B, D, s, 2 * B)) != cudaSuccess ||
      (err = split_t<kOrderMn>(dvia, nullptr, yt + B, L, B, D, s, 2 * B)) != cudaSuccess ||
      (err = map_f32(&m[0], dg, L, B, S, kBK)) != cudaSuccess ||
      (err = map_f32(&m[1], xt, 2 * L, D, B, kBN)) != cudaSuccess ||
      (err = map_f32(&m[2], h, L, 2 * B, S, kBK)) != cudaSuccess ||
      (err = map_f32(&m[3], yt, 2 * L, D, 2 * B, kBN)) != cudaSuccess)
    return err;
  p = Params{};
  p.L = L, p.M = S, p.N = D, p.K = B, p.K2 = 2 * B;
  p.wd = static_cast<const float*>(Wd);
  p.hsum = sums + kHga * static_cast<long long>(L) * S;
  p.wdn = static_cast<const float*>(wdn);
  p.dl1 = static_cast<const float*>(dl1);
  p.out = static_cast<float*>(dWe);
  p.out2 = static_cast<float*>(dWd);
  return launch<kGatedWgrad>(m, p, s);
}

bool fits(int L, int B, int D, int S) {
  return L > 0 && B > 0 && D > 0 && S > 0 && B % kBM == 0 && D % kBM == 0 && S % kBM == 0 &&
         2LL * L <= 65535 && B / 32 <= 65535 && S / 32 <= 65535;
}

}  // namespace st

}  // namespace

// B4, float32: x, the weights, xc (scratch), hc, y; nact_part [L, B/128, S],
// l1_part [L, B/128, S/128]; split (scratch, L * 2 S D floats).  Launches:
// center, W_enc's split, the encoder, W_dec's split, the decoder.  Returns
// the launches' cudaError_t.
extern "C" int sae_fused_fwd_tf32(const void* x, const void* We, const void* be, const void* Wd,
                                  const void* bd, void* xc, void* hc, void* y, void* nact_part,
                                  void* l1_part, void* split, int L, int B, int D, int S,
                                  int device, void* stream) {
  if (!st::fits(L, B, D, S)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sp = static_cast<float*>(split);
  if ((err = sae::center<float>(static_cast<const float*>(x), static_cast<const float*>(bd),
                                static_cast<float*>(xc), L, B, D, s)) != cudaSuccess ||
      (err = st::encoder<st::kEncoder>(xc, We, be, nullptr, hc, nact_part, l1_part, sp, L, B, D,
                                       S, s)) != cudaSuccess)
    return err;
  return st::decoder(hc, Wd, bd, y, sp, L, B, D, S, s);
}

// B6, float32: x, hc (the stored activations), W_dec, b_dec, dy, dl1 [L],
// dhc (scratch), dWe [L, D, S], dWd [L, S, D], dbe_part [L, B/128, S]; split
// (scratch, L * max(2 S D, 4 D B) floats).  Launches: W_dec's split, dh,
// x - b_dec's and dy's transposed splits, the weight gradients.  Returns the
// launches' cudaError_t.
extern "C" int sae_fused_bwd_stored_tf32(const void* x, const void* hc, const void* Wd,
                                         const void* bd, const void* dy, const void* dl1,
                                         void* dhc, void* split, void* dWe, void* dWd,
                                         void* dbe_part, int L, int B, int D, int S, int device,
                                         void* stream) {
  if (!st::fits(L, B, D, S)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return st::backward_stored(x, hc, Wd, bd, dy, dl1, dhc, dWe, dWd, dbe_part,
                             static_cast<float*>(split), L, B, D, S,
                             static_cast<cudaStream_t>(stream));
}

// B5, float32: x, the weights, dy, dl1, xc (scratch), hc (scratch: B4's hc
// again), dhc (scratch), split (scratch, as B6's), dWe, dWd, dbe_part.
// Launches: center, W_enc's split, B4's encoder without its reductions, then
// B6's launches on that hc.  Returns the launches' cudaError_t.
extern "C" int sae_fused_bwd_remat_tf32(const void* x, const void* We, const void* be,
                                        const void* Wd, const void* bd, const void* dy,
                                        const void* dl1, void* xc, void* hc, void* dhc,
                                        void* split, void* dWe, void* dWd, void* dbe_part, int L,
                                        int B, int D, int S, int device, void* stream) {
  if (!st::fits(L, B, D, S)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return st::remat<st::kEncoder>(x, We, be, Wd, bd, dy, dl1, nullptr, xc, hc, dhc,
                                 static_cast<float*>(split), dWe, dWd, dbe_part, L, B, D, S,
                                 static_cast<cudaStream_t>(stream));
}

// B8, float32: x, the weights, xc (scratch), h (the masked activations), y;
// t [L, B], nact_part [L, B/128, S], l1_part [L, B/128, S/128]; split
// (scratch, L * 2 S D floats); 1 <= k <= S.  Launches: center, W_enc's
// split, the TopK encoder (max(hpre, 0) into h), the select on each row of h
// (t, and the row masked in place), the counts, W_dec's split, the decoder
// over h.  Returns the launches' cudaError_t.
extern "C" int sae_fused_fwd_topk_tf32(const void* x, const void* We, const void* be,
                                       const void* Wd, const void* bd, void* xc, void* h, void* y,
                                       void* t, void* nact_part, void* l1_part, void* split, int L,
                                       int B, int D, int S, int k, int device, void* stream) {
  if (!st::fits(L, B, D, S) || k < 1 || k > S || static_cast<long long>(L) * B > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sp = static_cast<float*>(split);
  float* hf = static_cast<float*>(h);
  if ((err = sae::center<float>(static_cast<const float*>(x), static_cast<const float*>(bd),
                                static_cast<float*>(xc), L, B, D, s)) != cudaSuccess ||
      (err = st::encoder<st::kTopkEncoder>(xc, We, be, nullptr, h, nullptr, nullptr, sp, L, B, D,
                                           S, s)) != cudaSuccess ||
      (err = rsel::select_rows<float, true>(hf, static_cast<float*>(t), hf,
                                            static_cast<long long>(L) * B, S, k, s)) !=
          cudaSuccess ||
      (err = sae::active_counts<float>(hf, static_cast<float*>(nact_part),
                                       static_cast<float*>(l1_part), L, B, S, s)) != cudaSuccess)
    return err;
  return st::decoder(h, Wd, bd, y, sp, L, B, D, S, s);
}

// B9, float32: x, the weights, dy, dl1 [L], B8's thresholds t [L, B], xc
// (scratch), h (scratch: B8's h again), dhc (scratch), split (scratch, as
// B6's), dWe, dWd, dbe_part.  Launches: center, W_enc's split, the remat
// encoder (B8's TopK encoder masked against t), then B6's launches on h.
// Returns the launches' cudaError_t.
extern "C" int sae_fused_bwd_topk_tf32(const void* x, const void* We, const void* be,
                                       const void* Wd, const void* bd, const void* dy,
                                       const void* dl1, const void* t, void* xc, void* h,
                                       void* dhc, void* split, void* dWe, void* dWd,
                                       void* dbe_part, int L, int B, int D, int S, int device,
                                       void* stream) {
  if (!st::fits(L, B, D, S) || t == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return st::remat<st::kTopkRemat>(x, We, be, Wd, bd, dy, dl1, t, xc, h, dhc,
                                   static_cast<float*>(split), dWe, dWd, dbe_part, L, B, D, S,
                                   static_cast<cudaStream_t>(stream));
}

// B11, float32: x, W_enc, b_gate, b_mag, W_dec, b_dec, xc (scratch), h ([L,
// 2B, S]: h, then hga in each layer) and y ([L, 2B, D]: y, then via); e and
// wdn [L, S], nact_part [L, B/128, S], l1_part [L, B/128, S/128]; split
// (scratch, L * 2 S D floats).  Launches: center, W_enc's split, the gated
// encoder, W_dec's split, the decoder over the 2B stacked rows.  Returns the
// launches' cudaError_t.
extern "C" int sae_gated_fwd_tf32(const void* x, const void* We, const void* bg, const void* e,
                                  const void* bm, const void* Wd, const void* bd,
                                  const void* wdn, void* xc, void* h, void* y, void* nact_part,
                                  void* l1_part, void* split, int L, int B, int D, int S,
                                  int device, void* stream) {
  if (!st::fits(L, B, D, S)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sp = static_cast<float*>(split);
  if ((err = sae::center<float>(static_cast<const float*>(x), static_cast<const float*>(bd),
                                static_cast<float*>(xc), L, B, D, s)) != cudaSuccess ||
      (err = st::gated_encoder<st::kGatedEncoder>(xc, We, bg, e, bm, wdn, h, nullptr, nact_part,
                                                  l1_part, sp, L, B, D, S, s)) != cudaSuccess)
    return err;
  return st::decoder(h, Wd, bd, y, sp, L, 2 * B, D, S, s);
}

// B12, float32: x, W_enc, b_gate, b_mag, W_dec, b_dec, dy, dvia, xc
// (scratch), h (scratch, [L, 2B, S]: h and hga, B11's to the bit), g
// (scratch, [L, B, S]) and dg (scratch, [L, B, S]); e and wdn [L, S], dl1
// [L], part (scratch, [4, L, B/128, S]), sums [4, L, S] (colsum(max(hg,
// 0)), db_gate, db_mag, sum(dhm g)), dWe [L, D, S], dWd [L, S, D]; split
// (scratch, L * max(2 S D, 6 D B) floats).  Launches: center, W_enc's
// split, the gated remat encoder, W_dec's split, dg's dy and dvia passes,
// the partial sums, three transposed splits, the weight gradients.  Returns
// the launches' cudaError_t.
extern "C" int sae_gated_bwd_tf32(const void* x, const void* We, const void* bg, const void* e,
                                  const void* bm, const void* Wd, const void* bd,
                                  const void* wdn, const void* dy, const void* dvia,
                                  const void* dl1, void* xc, void* h, void* g, void* dg,
                                  void* part, void* sums, void* dWe, void* dWd, void* split,
                                  int L, int B, int D, int S, int device, void* stream) {
  if (!st::fits(L, B, D, S)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((err = sae::center<float>(static_cast<const float*>(x), static_cast<const float*>(bd),
                                static_cast<float*>(xc), L, B, D, s)) != cudaSuccess)
    return err;
  return st::gated_backward(x, xc, We, bg, e, bm, Wd, bd, wdn, dy, dvia, dl1, h, g, dg,
                            static_cast<float*>(part), static_cast<float*>(sums), dWe, dWd,
                            static_cast<float*>(split), L, B, D, S, s);
}
