// The bfloat16 Hopper route of the fused standard-ReLU SAE forward (kernel
// B4), its remat and stored-activations backwards (B5, B6), the TopK SAE's
// forward and remat backward (B8, B9), and the gated SAE's forward (B11)
// and remat backward (B12), over L stacked SAEs, on sae_wgmma.cuh's
// persistent warp-specialized wgmma/TMA GEMM.
//
// Replaces, with sae_fused_fwd.cu, sae_fused_bwd.cu, sae_fused_fwd_topk.cu,
// sae_fused_fwd_gated.cu and sae_fused_bwd_gated.cu (which keep the float32
// route and the bf16 shapes this route does not take), the Pallas TPU
// kernels `_fwd_kernel` (launched by `_fused_forward`), `_bwd_kernel`
// (`_fused_backward`), `_bwd_kernel_stored` (`_fused_backward_stored`),
// `_fwd_kernel_topk` (`_fused_forward_topk`, its search
// `_row_kth_threshold`), `_bwd_kernel_topk` (`_fused_backward_topk`),
// `_fwd_kernel_gated` (`_fused_forward_gated`) and `_bwd_kernel_gated`
// (`_fused_backward_gated`) in vit_prisma_tpu/ops/sae_step.py.  The
// functions and cast points are those of the mma.sync kernels and of the
// plain versions `sae_fused_forward_reference`,
// `sae_fused_backward_reference`, `sae_fused_backward_stored_reference`,
// `sae_fused_forward_topk_reference`, `sae_fused_backward_topk_reference`,
// `sae_gated_fused_forward_reference` and
// `sae_gated_fused_backward_reference` (vit_prisma_tpu_torch/ops/sae_step.py):
//   B4: xc = x - b_dec (bf16); hpre = xc W_enc + b_enc (float32);
//       hc = bf16(relu(hpre)); y = bf16(b_dec + hc W_dec);
//       l1[l] = sum of the float32 relu(hpre); nact[l, j] = rows with hpre > 0;
//   B6: mask = float(hc) > 0 on the stored hc; dh = mask ? dy W_dec^T + dl1 : 0
//       (float32); dhc = bf16(dh); dW_enc = xc^T dhc, dW_dec = hc^T dy
//       (float32); db_enc = column sums of the float32 dh;
//   B5: B4's hpre again; mask = hpre > 0 (float32), else as B6;
//   B8: hp = bf16(hpre); t = k-th largest of max(float(hp), 0) over the row;
//       h = (hp > 0 && hp >= t) ? hp : 0; y = bf16(b_dec + h W_dec);
//       l1 = sum of h; nact = rows with h > 0;
//   B9: B8's h again from hpre and the stored t, then B6 on it;
//   B11: g = xc W_enc (float32); hg = bf16(g + b_gate), hm = bf16(g e + b_mag)
//       (a rounded product, then a rounded sum: no FMA); h = hg > 0 ?
//       max(hm, 0) : 0, hga = max(hg, 0); y, via = bf16(b_dec + h W_dec),
//       bf16(b_dec + hga W_dec); l1 = sum hga wdn; nact = rows with h > 0;
//   B12: g, hg, hm again; gate = hg > 0, mag = gate & hm > 0; dhm = mag ?
//       dy W_dec^T : 0, dhg = gate ? dvia W_dec^T + dl1 wdn : 0 (float32);
//       dg = bf16(dhg + dhm e); dW_enc = xc^T dg; dW_dec = h^T dy + hga^T dvia
//       + coef W_dec (coef = dl1 colsum(hga) / max(wdn, 1e-30), per row);
//       db_gate, db_mag = column sums of dhg, dhm; sum(dhm g) (times e in
//       the wrapper: dr_mag), g the unrounded float32 product.
// Every partial sum is taken in a fixed order without atomics (the wrapper
// or partial_sums sums the per-tile partials), so two calls give the same
// bits.
//
// Launches, each batched over L through the tile schedule:
//   B4: center (sae_gemm.cuh's, 16 bytes a thread), the encoder GEMM
//       (epilogue: b_enc, ReLU, hc by TMA store, nact column counts from
//       ballots and the l1 sum of each 128 x 256 tile), the decoder GEMM
//       (epilogue: b_dec, y by TMA store);
//   B6: center, the dh GEMM (dy W_dec^T with W_dec K-major; its epilogue
//       loads the stored hc tile by TMA into the staging buffer, masks, adds
//       dl1, writes dhc in place over hc, stores it by TMA and writes the
//       db_enc column sums of the tile), then dW_enc and dW_dec in ONE
//       launch, a schedule over both products' tiles (the same K = B), so
//       neither leaves a tail; their float32 tiles go straight from the
//       accumulators to device memory;
//   B5: center; B4's encoder again, the same mainloop (so hpre is B4's to
//       the bit) with a lighter epilogue: b_enc, ReLU and the hc store, no
//       reductions, and hc's bits 0x8000 (-0, which B4 never writes) where
//       hpre > 0 rounds to +0 in bf16 (below 2^-134), so that the mask
//       travels in hc; then B6's launches, the dh GEMM reading its mask as
//       "hc's bits != 0" (kDhMarked);
//   B8: center; B5's encoder without the marks (hc = c(max(hpre, 0)), +0
//       where hpre <= 0, which equals max(float(bf16(hpre)), 0) entry by
//       entry, since rounding keeps the sign); radix_select.cuh's select on
//       each row of hc, which writes t and rewrites the row in place as h
//       (B10's radix select, one block a row staging it, two 8-bit digit
//       passes: bitwise the search's t on rows of +0s and positives); the
//       counts (sae::active_counts: nact and l1 per 128-row block); the
//       decoder over h, on 192-wide tiles where they fill the waves better;
//   B9: center; B8's encoder again masked against the stored t (no select),
//       so its h is B8's to the bit; then B6's launches;
//   B11: center, the gated encoder GEMM (its epilogue takes the tile in
//       four chunks of 64 columns, staging each chunk's c(h) and c(hga) in
//       two of four swizzled boxes for TMA stores to rows [0, B) and [B, 2B)
//       of [L, 2B, S], so a chunk waits only for the stores of the chunk two
//       back; nact from ballots of the magnitude mask, l1 per tile), then
//       B4's decoder over the 2B stacked rows: y and via, stacked as [L, 2B,
//       D], in one launch;
//   B12: center; the gated encoder again, the same mode of the same kernel
//       but for its epilogue's outputs, so g, and with it every mask, is
//       B11's to the bit (c(h), c(hga) as B11's, the unrounded float32 g
//       from the accumulators, column partials of max(hg, 0)); the dg GEMM
//       (128 x 128 tiles: each stage holds the dy and dvia row tiles and one
//       K-major W_dec tile, and a consumer keeps two m64n128 accumulators;
//       the producer loads the tile's float32 g by TMA into shared memory
//       while the products run; the epilogue recomputes both masks from it,
//       stores c(dg) from the registers and writes column partials of dhg,
//       dhm and dhm g); partial_sums; then dW_enc = xc^T c(dg) and
//       dW_dec = [c(h); c(hga)]^T [dy; dvia] (K = 2B: the producer reads
//       dvia's tiles for the second half) in ONE launch, the coef W_dec row
//       term in dW_dec's epilogue.
//
// What bounds it on an H100.  At the bf16 sweep shape (24 x 4096 rows, 1024
// -> 8192) B4 is 3.3 TFLOP and B6 4.9 TFLOP against a few GB of traffic,
// far past the ~295 flops a byte where the bf16 tensor cores and not device
// memory are the limit: both are bound by tensor-core issue (bounds 3.34 and
// 5.00 ms at 989 TFLOP/s); at the gated slice (1 x 4096, 768 -> 12,288)
// B11's three products (232 GFLOP) and B12's six (464 GFLOP) likewise
// (bounds 0.234 and 0.469 ms), B12's float32 g adding 0.4 GB of traffic;
// B5's four products at the sweep shape (6.6 TFLOP, 6.67 ms) and B8's two
// at the TopK slice (155 GFLOP, 0.157 ms; its select reads and writes h,
// 201 MB, 0.06 ms at 3.35 TB/s) likewise.
// The mma.sync tiles they replace ran at 144-254 TFLOP/s; this route issues
// wgmmas from two consumer warpgroups on a TMA-fed ring, the form that
// reached 385-489 TFLOP/s in B14 (ln_matmul.cu).  Measured on an NVIDIA H100
// 80GB HBM3 (700 W) at the sweep shape: B4 6.59-6.82 ms and B6 8.01-8.20
// (484-618 TFLOP/s; the mma.sync tiles took 13.1 and 20.7), 1.2-1.6x the
// time of cuBLAS's products alone; the epilogues, which the tensor cores
// wait for, hold them (PERF.md section 6, where B11's and B12's times are).
//
// Shapes: B a multiple of 128, d_in and d_sae multiples of 256 (the wrapper's
// `sae_gemm_route` picks them; the entries return cudaErrorInvalidValue for
// others); every pointer 16-byte aligned.

#include "radix_select.cuh"
#include "sae_wgmma.cuh"

namespace {

using namespace sw;

enum Mode {
  kEncoder = 0,        // B4: hc, nact, l1
  kDecoder = 1,        // B4, B11: y = b_dec + hc W_dec
  kDh = 2,             // B6: dhc from dy W_dec^T and the stored hc
  kWgrad = 3,          // B6: dW_enc = xc^T dhc, dW_dec = hc^T dy
  kGatedEncoder = 4,   // B11: c(h), c(hga), nact, l1
  kGatedRemat = 5,     // B12: c(h), c(hga), the float32 g, colsum(max(hg, 0))
  kDg = 6,             // B12: c(dg), column partials of dhg, dhm, dhm g
  kGatedWgrad = 7,     // B12: dW_enc = xc^T c(dg), dW_dec = h^T [dy; dvia] + coef W_dec
  kDecoder192 = 8,     // B11, B8: kDecoder on 192-wide tiles, where they fill the waves better
  kReluRemat = 9,      // B5: hc = c(relu(hpre)), -0 where hpre > 0 rounds to +0
  kTopkEncoder = 10,   // B8: hc = c(max(hpre, 0)), +0 where hpre <= 0
  kTopkRemat = 11,     // B9: B8's h, hc masked against the stored t
  kDhMarked = 12,      // B5: kDh with the mask "hc's bits != 0" (kReluRemat's marks)
};

// Per mode: operand layouts, ring depth, tile width, and what the epilogue
// needs.
template <int MODE>
struct Cfg {
  static constexpr bool kGated = MODE == kGatedEncoder || MODE == kGatedRemat;
  static constexpr bool kWgradLike = MODE == kWgrad || MODE == kGatedWgrad;
  static constexpr bool kDhLike = MODE == kDh || MODE == kDhMarked;
  // the encoders of B5, B8 and B9: hc alone, no reductions
  static constexpr bool kPlainEncoder =
      MODE == kReluRemat || MODE == kTopkEncoder || MODE == kTopkRemat;
  static constexpr int AM = kWgradLike ? kMNMajor : kKMajor;
  static constexpr int BM = kDhLike || MODE == kDg ? kKMajor : kMNMajor;
  static constexpr bool kStaging = !kWgradLike && MODE != kDg;  // a bf16 C tile by TMA store
  static constexpr bool kRed = MODE == kEncoder || kDhLike || kGated || MODE == kDg;
  // a tile loaded by TMA into the warpgroup's buffer: the stored hc (dh), g (dg)
  static constexpr bool kLoadC = kDhLike || MODE == kDg;
  static constexpr int kTileN = MODE == kDg ? 128 : MODE == kDecoder192 ? 192 : kBN;
  // a stage: A and B tiles (dg: dy, dvia and W_dec tiles)
  static constexpr int kStageBytes = MODE == kDg ? kDgStageBytes : stage_bytes<kTileN>();
  static constexpr int kStages = (kStaging || kLoadC) && MODE != kDecoder192 ? 3 : 4;
  // a warpgroup's buffer: its staged bf16 C tile [64 x 256] (or [64 x 192])
  // or its float32 g tile [64 x 128], in [64 x 64]-bf16 boxes
  static constexpr int kOut = MODE == kDecoder192 ? 64 * 192 * 2 : 32768;
  // column partials: a row a consumer warp for each sum (three in dg, whose
  // one buffer leaves room for the g tiles; the others alternate two by tile)
  static constexpr int kRedFloats = (MODE == kDg ? 3 : 1) * 4 * kConsumers * kTileN;
  static constexpr int kRedBufs = MODE == kDg ? 1 : 2;
};

// Byte offsets from the 1024-aligned base: the ring, the two warpgroups'
// buffers (staged C tiles, or loaded hc or g tiles), the buffers of column
// partials and of l1 partials, then the barriers: full[kStages],
// empty[kStages], cfull[2] (a loaded tile landed), cempty[2] (it has been
// read: by the dhc store, or by the dg epilogue).
template <int MODE>
struct Layout {
  typedef Cfg<MODE> C;
  static constexpr int staging = C::kStages * C::kStageBytes;
  static constexpr int red = staging + (C::kStaging || C::kLoadC ? kConsumers * C::kOut : 0);
  static constexpr int l1 = red + (C::kRed ? C::kRedBufs * C::kRedFloats * 4 : 0);
  static constexpr int bars = l1 + (C::kRed ? 2 * 4 * kConsumers * 4 : 0);
  static constexpr int bytes = bars + (2 * C::kStages + 2 * kConsumers) * 8 + hg::kSwizzleAlign;
  static_assert(bytes <= kMaxSmem, "shared memory");
};

struct Params {
  Grid g0, g1;          // the tiles of the product (and of the wgrad's second one)
  int total, tiles0;    // all tiles; the first product's
  int ktiles, ktiles1;  // K / 64 of the first and the second product
  int kswitch;          // gated wgrad: the second product's K steps from here read dvia
  const bf16* bias;     // b_enc (encoder), b_dec (decoder), b_gate (gated encoders, dg)
  const bf16* bmag;     // b_mag (gated encoders, dg)
  const float* e;       // exp(r_mag) [L, S] (gated encoders, dg)
  const float* wdn;     // decoder row norms [L, S] (B11's encoder, dg, gated wgrad)
  const float* dl1;     // [L] (dh, dg, gated wgrad)
  const float* t;       // B8's thresholds [L, B] (B9's encoder)
  float* g;             // the float32 g [L, B, S]: kGatedRemat writes it (kDg loads it by x0)
  bf16* out;            // c(dg) [L, B, S] (dg: stored from the registers)
  float* part;          // [L, B / 128, S]: nact (encoders), db_enc (dh), colsum(max(hg,
                        // 0)) (remat); dg: [4, L, B / 128, S], its sums at 1 .. 3
  float* l1_part;       // [L, B / 128, S / 256] (encoders)
  const float* hga_sum; // colsum(max(hg, 0)) [L, S] (gated wgrad)
  const bf16* wd;       // W_dec [L, S, D] (gated wgrad)
  float* c0;            // dW_enc [L, D, S] (wgrads)
  float* c1;            // dW_dec [L, S, D] (wgrads)
};

__device__ __forceinline__ float2 bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 f2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// The gated pre-activations from the float32 product g, rounded to bf16 as
// `_gated_pre` rounds them: one rounding each, no FMA contraction.
__device__ __forceinline__ void gated_pre(float g, float bg, float e, float bm, float& hg,
                                          float& hm) {
  hg = __bfloat162float(__float2bfloat16_rn(__fadd_rn(g, bg)));
  hm = __bfloat162float(__float2bfloat16_rn(__fadd_rn(__fmul_rn(g, e), bm)));
}

// One element of B12's dg: from g, dy W_dec^T (ady) and dvia W_dec^T (adv),
// dg = dhg + dhm e before its rounding to bf16; adds dhg, dhm and dhm g to
// the column partials.
__device__ __forceinline__ float dg_elem(float g, float ady, float adv, float bg, float e,
                                         float bm, float vt, float& sg, float& sm, float& sx) {
  float hg, hm;
  gated_pre(g, bg, e, bm, hg, hm);
  const bool gate = hg > 0.f;
  const float dhm = gate && hm > 0.f ? ady : 0.f;
  const float dhg = gate ? __fadd_rn(adv, vt) : 0.f;
  sg += dhg;
  sm += dhm;
  sx += dhm * g;
  return __fadd_rn(dhg, __fmul_rn(dhm, e));
}

// The warpgroup's staging buffer is free: the stores that read it are done.
__device__ __forceinline__ void staging_free(int t, int wg) {
  if (t == 0) hg::bulk_wait_read();
  hg::named_sync(1 + wg, 128);
}

// The warpgroup's staged tile (NB [64 x 64] boxes) to rows [row, row + 64)
// and columns [n0, n0 + 64 NB) of layer l.
template <int NB>
__device__ __forceinline__ void store_staged(const CUtensorMap* map, unsigned char* stg, int n0,
                                             int row, int l, int t, int wg) {
  hg::fence_proxy_async_smem();
  hg::named_sync(1 + wg, 128);
  if (t == 0) {
#pragma unroll
    for (int b = 0; b < NB; ++b)
      hg::tma_store_3d(map, stg + b * hg::kBoxBytes, n0 + b * hg::kBox, row, l);
    hg::bulk_commit();
  }
}

// Grid: min(tiles, SMs) blocks of kThreads; Layout<MODE>::bytes of dynamic
// shared memory.  a0, b0 (a1, b1): the operands of the first (second)
// product (dg: a0 dy, a1 dvia, b0 W_dec); x0: the stored hc (dh), g as
// bf16 pairs (dg), the second product's B from K step kswitch on (gated
// wgrad: dvia); cout: the bf16 C tensor (hc, y, dhc; [c(h); c(hga)]).
template <int MODE>
__global__ void __launch_bounds__(kThreads, 1)
    sae_tc_kernel(const __grid_constant__ CUtensorMap a0, const __grid_constant__ CUtensorMap b0,
                  const __grid_constant__ CUtensorMap a1, const __grid_constant__ CUtensorMap b1,
                  const __grid_constant__ CUtensorMap x0,
                  const __grid_constant__ CUtensorMap cout, const Params p) {
  typedef Cfg<MODE> C;
  typedef Layout<MODE> Lay;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = aligned_base(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + Lay::bars);
  const Ring<C::kStages, C::kStageBytes> ring{smem, bars, bars + C::kStages};
  uint64_t* cfull = bars + 2 * C::kStages;
  uint64_t* cempty = cfull + kConsumers;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < C::kStages; ++i) {
      hg::mbar_init(&ring.full[i], 1);
      hg::mbar_init(&ring.empty[i], 4 * kConsumers);  // one arrive a consumer warp
    }
    for (int w = 0; w < kConsumers; ++w) {
      hg::mbar_init(&cfull[w], 1);
      hg::mbar_init(&cempty[w], 1);
    }
    hg::fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {  // the producer: one thread issues every copy
    hg::reg_dealloc<40>();
    if (threadIdx.x == 128 * kConsumers) {
      uint32_t it = 0;
      int i = 0;
      for (int t = blockIdx.x; t < p.total; t += gridDim.x, ++i) {
        const bool second = t >= p.tiles0;
        const Tile x = tile_at(second ? p.g1 : p.g0, second ? t - p.tiles0 : t);
        // the tile's loaded C-side tiles (dh: hc; dg: g), once the last tile's
        // have been read
        auto load_c = [&]() {
          for (int w = 0; w < kConsumers; ++w) {
            unsigned char* buf = smem + Lay::staging + w * C::kOut;
            if (i > 0) hg::mbar_wait(&cempty[w], (i - 1) & 1);
            hg::mbar_expect_tx(&cfull[w], C::kOut);
#pragma unroll
            for (int b = 0; b < C::kOut / hg::kBoxBytes; ++b)
              hg::tma_load_3d(buf + b * hg::kBoxBytes, &x0, &cfull[w],
                              (MODE == kDg ? 2 * x.n0 : x.n0) + b * hg::kBox, x.m0 + 64 * w,
                              x.l);
          }
        };
        if constexpr (MODE == kDg) {
          // g is asked for once the ring holds the tile's first stages, so
          // that it lands while the tile's products run
          const int k0 = p.ktiles < C::kStages ? p.ktiles : C::kStages;
          produce_tile_dg<C::kStages>(ring, it, &a0, &a1, &b0, 0, k0, x.l, x.m0, x.n0);
          load_c();
          produce_tile_dg<C::kStages>(ring, it, &a0, &a1, &b0, k0, p.ktiles, x.l, x.m0, x.n0);
        } else {
          const int kts = second ? p.ktiles1 : p.ktiles;
          const CUtensorMap* bm = second ? &b1 : &b0;
          produce_tile<C::kStages, C::AM, C::BM, C::kTileN>(
              ring, it, second ? &a1 : &a0, bm, MODE == kGatedWgrad ? &x0 : bm,
              MODE == kGatedWgrad && second ? p.kswitch : kts, kts, x.l, x.m0, x.n0);
        }
        if (C::kDhLike) load_c();
      }
    }
    return;
  }

  // consumer warpgroup wg: rows 64 wg .. 64 wg + 63 of each tile
  hg::reg_alloc<232>();
  const int t = threadIdx.x % 128, warp = t / 32, lane = t & 31, g = lane >> 2, tq = lane & 3;
  const int cw = 4 * wg + warp;  // this warp's row of the column partials
  unsigned char* stg = smem + Lay::staging + wg * C::kOut;
  uint32_t it = 0;
  int i = 0;
  for (int tt = blockIdx.x; tt < p.total; tt += gridDim.x, ++i) {
    const bool second = tt >= p.tiles0;
    const Tile x = tile_at(second ? p.g1 : p.g0, second ? tt - p.tiles0 : tt);
    float* red = reinterpret_cast<float*>(smem + Lay::red) + (i % C::kRedBufs) * C::kRedFloats;
    float* l1red = reinterpret_cast<float*>(smem + Lay::l1) + (i & 1) * 4 * kConsumers;
    const long long prow = static_cast<long long>(x.l) * p.g0.tm + x.mt;  // partials' row
    const int ncols = p.g0.tn * p.g0.bn;
    const long long lcol = static_cast<long long>(x.l) * ncols + x.n0;  // [L, S] vectors

    if constexpr (MODE == kDg) {
      float ady[64], adv[64];  // the tile's first products overwrite them (scale-d 0)
      consume_tile_dg<C::kStages>(ady, adv, ring, it, p.ktiles, wg, lane);
      hg::mbar_wait(&cfull[wg], i & 1);  // the tile's g landed in the buffer
      consumers_sync();                  // the last tile's column sums have read red
      const float gl = p.dl1[x.l];
      bf16* out = p.out +
                  (static_cast<long long>(x.l) * p.g0.tm * kBM + x.m0 + 64 * wg + 16 * warp +
                   g) * ncols + x.n0 + 2 * tq;
#pragma unroll
      for (int j = 0; j < C::kTileN / 8; ++j) {
        const int c = 8 * j + 2 * tq;
        const float2 bg = bf2(p.bias + lcol + c), bm = bf2(p.bmag + lcol + c);
        const float2 e = f2(p.e + lcol + c), w = f2(p.wdn + lcol + c);
        const float vt0 = __fmul_rn(gl, w.x), vt1 = __fmul_rn(gl, w.y);
        float sg0 = 0.f, sg1 = 0.f, sm0 = 0.f, sm1 = 0.f, sx0 = 0.f, sx1 = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // g's columns c, c + 1 of row r: box c / 32 of the float32 tile,
          // 16-byte chunk (c % 32) / 4 of the swizzled row
          const int r = 16 * warp + g + 8 * h;
          const float2 gv = *reinterpret_cast<const float2*>(
              stg + (j >> 2) * hg::kBoxBytes + hg::sw128(r, 2 * (j & 3) + (tq >> 1)) +
              (tq & 1) * 8);
          const int k = 4 * j + 2 * h;
          const float d0 = dg_elem(gv.x, ady[k], adv[k], bg.x, e.x, bm.x, vt0, sg0, sm0, sx0);
          const float d1 =
              dg_elem(gv.y, ady[k + 1], adv[k + 1], bg.y, e.y, bm.y, vt1, sg1, sm1, sx1);
          sae::store2(out + static_cast<long long>(8 * h) * ncols + 8 * j, d0, d1);
        }
        col_partial(sg0, sg1, red + (0 * 4 * kConsumers + cw) * C::kTileN, j, lane);
        col_partial(sm0, sm1, red + (1 * 4 * kConsumers + cw) * C::kTileN, j, lane);
        col_partial(sx0, sx1, red + (2 * 4 * kConsumers + cw) * C::kTileN, j, lane);
      }
      // the tile's column sums of dhg, dhm and dhm g (db_gate, db_mag, sum(dhm g)), in
      // a fixed order, once every warp has written its partials (and read its g)
      consumers_sync();
      if (t == 0) hg::mbar_arrive(&cempty[wg]);  // the producer may load the next g tile
      const long long groups = static_cast<long long>(p.g0.L) * p.g0.tm;
      for (int c = 128 * wg + t; c < 3 * C::kTileN; c += 128 * kConsumers) {
        const int q = c / C::kTileN, col = c % C::kTileN;
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < 4 * kConsumers; ++w)
          s += red[(q * 4 * kConsumers + w) * C::kTileN + col];
        p.part[((q + 1) * groups + prow) * ncols + x.n0 + col] = s;
      }
      continue;
    } else {
      float acc[C::kTileN / 2];  // the first products of a tile overwrite it (scale-d 0)
      consume_tile<C::kStages, C::AM, C::BM, C::kTileN>(acc, ring, it,
                                                        second ? p.ktiles1 : p.ktiles, wg, lane);

      if constexpr (C::kWgradLike) {  // float32 straight to device memory, 32 bytes a quad
        const Grid& gr = second ? p.g1 : p.g0;
        const int N = gr.tn * kBN;
        const long long row0 =
            static_cast<long long>(x.l) * gr.tm * kBM + x.m0 + 64 * wg + 16 * warp + g;
        float* c = (second ? p.c1 : p.c0) + row0 * N + x.n0 + 2 * tq;
        if (MODE == kGatedWgrad && second) {  // dW_dec: + coef[s] W_dec[s, :] per row s
          const bf16* wd = p.wd + row0 * N + x.n0 + 2 * tq;
          const float gl = p.dl1[x.l];
          float coef[2];
#pragma unroll
          for (int h = 0; h < 2; ++h)
            coef[h] = __fdiv_rn(__fmul_rn(gl, p.hga_sum[row0 + 8 * h]),
                                fmaxf(p.wdn[row0 + 8 * h], 1e-30f));
#pragma unroll
          for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float2 w = bf2(wd + static_cast<long long>(8 * h) * N + 8 * j);
              sae::store2(c + static_cast<long long>(8 * h) * N + 8 * j,
                          acc[4 * j + 2 * h] + coef[h] * w.x,
                          acc[4 * j + 2 * h + 1] + coef[h] * w.y);
            }
        } else {
#pragma unroll
          for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              sae::store2(c + static_cast<long long>(8 * h) * N + 8 * j, acc[4 * j + 2 * h],
                          acc[4 * j + 2 * h + 1]);
        }
        continue;
      }

      if (C::kDhLike) {
        hg::mbar_wait(&cfull[wg], i & 1);  // the stored hc tile is in the staging
      } else if (!C::kGated) {
        staging_free(t, wg);  // the last tile's store has read the staging
      }
      if constexpr (C::kGated) {
        const int B = p.g0.tm * kBM;
        if (MODE == kGatedRemat) {  // the float32 g for B12's dg tiles
          float* go = p.g +
                      (static_cast<long long>(x.l) * B + x.m0 + 64 * wg + 16 * warp + g) * ncols +
                      x.n0 + 2 * tq;
#pragma unroll
          for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              sae::store2(go + static_cast<long long>(8 * h) * ncols + 8 * j, acc[4 * j + 2 * h],
                          acc[4 * j + 2 * h + 1]);
        }
        // One pass over the tile in four chunks of 64 columns: a chunk's c(h)
        // (the magnitude path where the gate is open) and c(hga) = max(hg,
        // 0) go into two of the warpgroup's four staged boxes and out by TMA
        // to rows [0, B) and [B, 2B), so a chunk waits only for the stores of
        // the chunk two back, issued a chunk's work earlier.  B11 counts the
        // rows with h > 0 of each column (nact) from ballots, as B4 does, and
        // sums hga wdn (l1); B12 sums the columns of hga.
        float l1 = 0.f;
#pragma unroll
        for (int q = 0; q < kBN / hg::kBox; ++q) {
          unsigned char* hb = stg + (2 * q % 4) * hg::kBoxBytes;
          unsigned char* ab = hb + hg::kBoxBytes;
          if (t == 0) bulk_wait_read_but<1>();  // chunk q - 2's stores have read hb, ab
          hg::named_sync(1 + wg, 128);
#pragma unroll
          for (int jj = 0; jj < hg::kBox / 8; ++jj) {
            const int j = hg::kBox / 8 * q + jj, c = 8 * j + 2 * tq;
            const float2 bg = bf2(p.bias + lcol + c), bm = bf2(p.bmag + lcol + c);
            const float2 e = f2(p.e + lcol + c);
            const float2 w = MODE == kGatedEncoder ? f2(p.wdn + lcol + c) : make_float2(0.f, 0.f);
            const unsigned same_col = 0x11111111u << tq;
            int c0 = 0, c1 = 0;
            float s0 = 0.f, s1 = 0.f;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float hg0, hm0, hg1, hm1;
              gated_pre(acc[4 * j + 2 * h], bg.x, e.x, bm.x, hg0, hm0);
              gated_pre(acc[4 * j + 2 * h + 1], bg.y, e.y, bm.y, hg1, hm1);
              const bool on0 = hg0 > 0.f && hm0 > 0.f, on1 = hg1 > 0.f && hm1 > 0.f;
              const float a0 = hg0 > 0.f ? hg0 : 0.f, a1 = hg1 > 0.f ? hg1 : 0.f;
              if (MODE == kGatedEncoder) {
                c0 += __popc(__ballot_sync(0xffffffffu, on0) & same_col);
                c1 += __popc(__ballot_sync(0xffffffffu, on1) & same_col);
                l1 += a0 * w.x + a1 * w.y;
              }
              s0 += a0;
              s1 += a1;
              const int off = hg::sw128(16 * warp + g + 8 * h, jj) + 4 * tq;
              sae::store2(reinterpret_cast<bf16*>(hb + off), on0 ? hm0 : 0.f, on1 ? hm1 : 0.f);
              sae::store2(reinterpret_cast<bf16*>(ab + off), a0, a1);
            }
            if (MODE == kGatedEncoder && lane < 4)
              *reinterpret_cast<float2*>(red + cw * kBN + 8 * j + 2 * lane) =
                  make_float2(static_cast<float>(c0), static_cast<float>(c1));
            if (MODE == kGatedRemat) col_partial(s0, s1, red + cw * kBN, j, lane);
          }
          hg::fence_proxy_async_smem();
          hg::named_sync(1 + wg, 128);
          if (t == 0) {
            const int n = x.n0 + q * hg::kBox;
            hg::tma_store_3d(&cout, hb, n, x.m0 + 64 * wg, x.l);
            hg::tma_store_3d(&cout, ab, n, B + x.m0 + 64 * wg, x.l);
            hg::bulk_commit();
          }
        }
        if (MODE == kGatedEncoder) {
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) l1 += __shfl_xor_sync(0xffffffffu, l1, o);
          if (lane == 0) l1red[cw] = l1;
        }
      } else if constexpr (MODE == kEncoder) {
        const bf16* be = p.bias + lcol;
        float l1 = 0.f;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          const float2 b = bf2(be + 8 * j + 2 * tq);
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
            sae::store2(reinterpret_cast<bf16*>(stg + stage_off(16 * warp + g + 8 * h, j, tq)),
                        h0, h1);
          }
          if (lane < 4)
            *reinterpret_cast<float2*>(red + cw * kBN + 8 * j + 2 * lane) =
                make_float2(static_cast<float>(c0), static_cast<float>(c1));
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) l1 += __shfl_xor_sync(0xffffffffu, l1, o);
        if (lane == 0) l1red[cw] = l1;
      } else if constexpr (C::kPlainEncoder) {
        // b_enc, then hc = c(max(hpre, 0)) staged as B4's encoder stages it
        // (the same mainloop: the same float32 hpre), with no reductions.
        // B5 marks with -0 (bits 0x8000, which B4 never writes) each entry
        // whose hpre > 0 rounds to +0, so that its dh mask, bits != 0, is
        // B5's hpre > 0; -0 adds nothing to dW_dec = hc^T dy.  B9 keeps the
        // entries of hc above 0 and at least the row's t (B8's h).
        const bf16* be = p.bias + lcol;
        float tr[2] = {0.f, 0.f};  // B9: the thread's two rows' thresholds
        if (MODE == kTopkRemat) {
          const long long row =
              static_cast<long long>(x.l) * p.g0.tm * kBM + x.m0 + 64 * wg + 16 * warp + g;
          tr[0] = p.t[row];
          tr[1] = p.t[row + 8];
        }
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          const float2 b = bf2(be + 8 * j + 2 * tq);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float p0 = acc[4 * j + 2 * h] + b.x, p1 = acc[4 * j + 2 * h + 1] + b.y;
            const __nv_bfloat162 v = __floats2bfloat162_rn(p0 > 0.f ? p0 : 0.f,
                                                           p1 > 0.f ? p1 : 0.f);
            unsigned w = *reinterpret_cast<const unsigned*>(&v);
            if (MODE == kReluRemat) {
              if (p0 > 0.f && (w & 0xffffu) == 0u) w |= 0x8000u;
              if (p1 > 0.f && (w >> 16) == 0u) w |= 0x80000000u;
            } else if (MODE == kTopkRemat) {
              const float2 f = __bfloat1622float2(v);
              if (!(f.x > 0.f && f.x >= tr[h])) w &= 0xffff0000u;
              if (!(f.y > 0.f && f.y >= tr[h])) w &= 0x0000ffffu;
            }
            *reinterpret_cast<unsigned*>(stg + stage_off(16 * warp + g + 8 * h, j, tq)) = w;
          }
        }
      } else if constexpr (MODE == kDecoder || MODE == kDecoder192) {
        const bf16* bd = p.bias + lcol;
#pragma unroll
        for (int j = 0; j < C::kTileN / 8; ++j) {
          const float2 b = bf2(bd + 8 * j + 2 * tq);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            sae::store2(reinterpret_cast<bf16*>(stg + stage_off(16 * warp + g + 8 * h, j, tq)),
                        b.x + acc[4 * j + 2 * h], b.y + acc[4 * j + 2 * h + 1]);
        }
      } else if constexpr (C::kDhLike) {  // mask from the stored hc, dl1, dhc in place of hc
        const float g1 = p.dl1[x.l];
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          float s0 = 0.f, s1 = 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            __nv_bfloat162* q =
                reinterpret_cast<__nv_bfloat162*>(stg + stage_off(16 * warp + g + 8 * h, j, tq));
            // B6: float(hc) > 0; B5 (kDhMarked): hc's bits != 0, its marks included
            bool on0, on1;
            if (MODE == kDhMarked) {
              const unsigned w = *reinterpret_cast<const unsigned*>(q);
              on0 = (w & 0xffffu) != 0u;
              on1 = (w >> 16) != 0u;
            } else {
              const float2 hv = __bfloat1622float2(*q);
              on0 = hv.x > 0.f;
              on1 = hv.y > 0.f;
            }
            const float d0 = on0 ? acc[4 * j + 2 * h] + g1 : 0.f;
            const float d1 = on1 ? acc[4 * j + 2 * h + 1] + g1 : 0.f;
            s0 += d0;
            s1 += d1;
            *q = __floats2bfloat162_rn(d0, d1);
          }
          col_partial(s0, s1, red + cw * kBN, j, lane);
        }
      }

      if (!C::kGated) {  // the warpgroup's staged tile to device memory
        store_staged<C::kTileN / hg::kBox>(&cout, stg, x.n0, x.m0 + 64 * wg, x.l, t, wg);
        if (C::kDhLike && t == 0) {  // the producer may load the next hc tile here
          hg::bulk_wait_read();
          hg::mbar_arrive(&cempty[wg]);
        }
      }
      if (C::kRed) {  // the tile's column sums (and l1), in a fixed order
        consumers_sync();
        col_sums(red, p.part + prow * ncols + x.n0, 128 * wg + t);
        if ((MODE == kEncoder || MODE == kGatedEncoder) && wg == 0 && t == 0) {
          float s = 0.f;
          for (int w = 0; w < 4 * kConsumers; ++w) s += l1red[w];
          p.l1_part[prow * p.g0.tn + x.n0 / kBN] = s;
        }
      }
    }
  }
  if (C::kStaging && t == 0) hg::bulk_wait_read();  // the staging outlives the last store
}

template <int MODE>
cudaError_t launch(const CUtensorMap (&m)[6], const Params& p, int device, cudaStream_t s) {
  auto kernel = sae_tc_kernel<MODE>;
  cudaError_t err = sae::allow_smem(kernel, Layout<MODE>::bytes);
  if (err != cudaSuccess) return err;
  const int sms = sm_count(device);
  if (sms <= 0) return cudaErrorInvalidDevice;
  const int grid = p.total < sms ? p.total : sms;
  kernel<<<grid, kThreads, Layout<MODE>::bytes, s>>>(m[0], m[1], m[2], m[3], m[4], m[5], p);
  return cudaGetLastError();
}

// The maps of one product C [L, M, N] = A B: A lies as [L, a_rows, a_cols]
// and B as [L, b_rows, b_cols] in their layouts.
cudaError_t product_maps(CUtensorMap* am, CUtensorMap* bm, const void* a, int a_rows, int a_cols,
                         int a_major, const void* b, int b_rows, int b_cols, int b_major,
                         int L) {
  cudaError_t err = operand_map(am, a, L, a_rows, a_cols, a_major, true);
  return err != cudaSuccess ? err : operand_map(bm, b, L, b_rows, b_cols, b_major, false);
}

bool fits(int L, int B, int D, int S) {
  return L > 0 && B > 0 && D > 0 && S > 0 && B % kBM == 0 && D % kBN == 0 && S % kBN == 0;
}

// y [L, M, D] = b_dec + hc [L, M, S] W_dec [L, S, D]: B4's decoder (M = B)
// and B11's (M = 2B: h and hga stacked).  With fill_waves (B11), 192-wide
// tiles where they leave fewer SMs idle in the last wave: at the gated
// slice 256 tiles (1.94 waves of 132) against 192 256-wide ones (1.45
// waves, the second 45% full).  B4's decoder keeps its 256-wide tile.
cudaError_t decoder(const void* hc, const void* Wd, const void* bd, void* y, int L, int M,
                    int D, int S, int device, cudaStream_t s, bool fill_waves = false) {
  CUtensorMap m[6];
  cudaError_t err;
  if ((err = product_maps(&m[0], &m[1], hc, M, S, kKMajor, Wd, S, D, kMNMajor, L)) != cudaSuccess ||
      (err = map3(&m[5], y, L, M, D, hg::kBox)) != cudaSuccess)
    return err;
  m[2] = m[0];
  m[3] = m[1];
  m[4] = m[5];
  Params p = {};
  p.ktiles = p.ktiles1 = S / kBK;
  p.bias = static_cast<const bf16*>(bd);
  const int sms = sm_count(device);
  const long long rows = static_cast<long long>(L) * (M / kBM);
  // the time of a launch in tile columns a block: ceil(tiles / SMs) * width
  auto waves = [&](int bn) { return (rows * (D / bn) + sms - 1) / sms * bn; };
  if (fill_waves && sms > 0 && D % 192 == 0 && waves(192) < waves(kBN)) {
    p.g0 = p.g1 = make_grid(L, M, D, 192);
    p.total = p.tiles0 = tiles(p.g0);
    return launch<kDecoder192>(m, p, device, s);
  }
  p.g0 = p.g1 = make_grid(L, M, D);
  p.total = p.tiles0 = tiles(p.g0);
  return launch<kDecoder>(m, p, device, s);
}

// The gated encoder of B11 (MODE kGatedEncoder: nact and l1 partials) and
// of B12 (kGatedRemat: the float32 g and colsum(max(hg, 0)) partials): h
// [L, 2B, S] holds c(h) in rows [0, B) and c(hga) in rows [B, 2B).
template <int MODE>
cudaError_t gated_encoder(const void* xc, const void* We, const void* bg, const void* e,
                          const void* bm, const void* wdn, void* h, float* g, float* part,
                          float* l1_part, int L, int B, int D, int S, int device,
                          cudaStream_t s) {
  CUtensorMap m[6];
  cudaError_t err;
  if ((err = product_maps(&m[0], &m[1], xc, B, D, kKMajor, We, D, S, kMNMajor, L)) != cudaSuccess ||
      (err = map3(&m[5], h, L, 2 * B, S, hg::kBox)) != cudaSuccess)
    return err;
  m[2] = m[0];
  m[3] = m[1];
  m[4] = m[5];
  Params p = {};
  p.g0 = p.g1 = make_grid(L, B, S);
  p.total = p.tiles0 = tiles(p.g0);
  p.ktiles = p.ktiles1 = D / kBK;
  p.bias = static_cast<const bf16*>(bg);
  p.bmag = static_cast<const bf16*>(bm);
  p.e = static_cast<const float*>(e);
  p.wdn = static_cast<const float*>(wdn);
  p.g = g;
  p.part = part;
  p.l1_part = l1_part;
  return launch<MODE>(m, p, device, s);
}

cudaError_t center(const void* x, const void* bd, void* xc, int L, int B, int D,
                   cudaStream_t s) {
  return sae::center<bf16>(static_cast<const bf16*>(x), static_cast<const bf16*>(bd),
                           static_cast<bf16*>(xc), L, B, D, s);
}

// The encoder of B5, B8 or B9 (MODE kReluRemat, kTopkEncoder, kTopkRemat):
// hc [L, B, S] from xc [L, B, D], W_enc [L, D, S] and b_enc (B9: masked
// against t [L, B]), on B4's encoder's tiles and mainloop.
template <int MODE>
cudaError_t plain_encoder(const void* xc, const void* We, const void* be, const void* t,
                          void* hc, int L, int B, int D, int S, int device, cudaStream_t s) {
  CUtensorMap m[6];
  cudaError_t err;
  if ((err = product_maps(&m[0], &m[1], xc, B, D, kKMajor, We, D, S, kMNMajor, L)) != cudaSuccess ||
      (err = map3(&m[5], hc, L, B, S, hg::kBox)) != cudaSuccess)
    return err;
  m[2] = m[0];
  m[3] = m[1];
  m[4] = m[5];
  Params p = {};
  p.g0 = p.g1 = make_grid(L, B, S);
  p.total = p.tiles0 = tiles(p.g0);
  p.ktiles = p.ktiles1 = D / kBK;
  p.bias = static_cast<const bf16*>(be);
  p.t = static_cast<const float*>(t);
  return launch<MODE>(m, p, device, s);
}

// B6's launches after the center, which B5 and B9 share: the dh GEMM (DH
// kDh: mask float(hc) > 0; kDhMarked: hc's bits != 0), then dW_enc and
// dW_dec in one launch.
template <int DH>
cudaError_t backward_from_hc(const void* xc, const void* hc, const void* Wd, const void* dy,
                             const void* dl1, void* dhc, void* dWe, void* dWd, void* dbe_part,
                             int L, int B, int D, int S, int device, cudaStream_t s) {
  // dh [L, B, S] = dy [L, B, D] W_dec^T, W_dec [L, S, D] as the K-major B
  CUtensorMap m[6];
  cudaError_t err;
  if ((err = product_maps(&m[0], &m[1], dy, B, D, kKMajor, Wd, S, D, kKMajor, L)) != cudaSuccess ||
      (err = map3(&m[4], hc, L, B, S, hg::kBox)) != cudaSuccess ||
      (err = map3(&m[5], dhc, L, B, S, hg::kBox)) != cudaSuccess)
    return err;
  m[2] = m[0];
  m[3] = m[1];
  Params p = {};
  p.g0 = p.g1 = make_grid(L, B, S);
  p.total = p.tiles0 = tiles(p.g0);
  p.ktiles = p.ktiles1 = D / kBK;
  p.dl1 = static_cast<const float*>(dl1);
  p.part = static_cast<float*>(dbe_part);
  if ((err = launch<DH>(m, p, device, s)) != cudaSuccess) return err;

  // dW_enc [L, D, S] = xc^T dhc and dW_dec [L, S, D] = hc^T dy, reduced over
  // the B rows, in one launch: xc, hc ([L, B, .], M contiguous) as MN-major
  // A, dhc and dy as MN-major B
  if ((err = product_maps(&m[0], &m[1], xc, B, D, kMNMajor, dhc, B, S, kMNMajor, L)) !=
          cudaSuccess ||
      (err = product_maps(&m[2], &m[3], hc, B, S, kMNMajor, dy, B, D, kMNMajor, L)) != cudaSuccess)
    return err;
  m[4] = m[5] = m[0];
  p = Params{};
  p.g0 = make_grid(L, D, S);
  p.g1 = make_grid(L, S, D);
  p.tiles0 = tiles(p.g0);
  p.total = p.tiles0 + tiles(p.g1);
  p.ktiles = p.ktiles1 = B / kBK;
  p.c0 = static_cast<float*>(dWe);
  p.c1 = static_cast<float*>(dWd);
  return launch<kWgrad>(m, p, device, s);
}

// B8's decoder on 192-wide tiles where they fill the waves better
// (decoder's fill_waves): at the TopK slice 128 tiles of 192 columns
// against 96 of 256 on 132 SMs.
constexpr bool kTopkFillWaves = true;

}  // namespace

// B4, bf16: x, the weights, xc (scratch), hc and y in bf16; nact_part
// [L, B/128, S] and l1_part [L, B/128, S/256] float32.  Returns the
// launches' cudaError_t.
extern "C" int sae_fused_fwd_tc(const void* x, const void* We, const void* be, const void* Wd,
                                const void* bd, void* xc, void* hc, void* y, void* nact_part,
                                void* l1_part, int L, int B, int D, int S, int device,
                                void* stream) {
  if (!fits(L, B, D, S)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((err = center(x, bd, xc, L, B, D, s)) != cudaSuccess) return err;

  // encoder: hc [L, B, S] = relu(xc [L, B, D] W_enc [L, D, S] + b_enc)
  CUtensorMap m[6];
  if ((err = product_maps(&m[0], &m[1], xc, B, D, kKMajor, We, D, S, kMNMajor, L)) != cudaSuccess ||
      (err = map3(&m[5], hc, L, B, S, hg::kBox)) != cudaSuccess)
    return err;
  m[2] = m[0];
  m[3] = m[1];
  m[4] = m[5];
  Params p = {};
  p.g0 = p.g1 = make_grid(L, B, S);
  p.total = p.tiles0 = tiles(p.g0);
  p.ktiles = p.ktiles1 = D / kBK;
  p.bias = static_cast<const bf16*>(be);
  p.part = static_cast<float*>(nact_part);
  p.l1_part = static_cast<float*>(l1_part);
  if ((err = launch<kEncoder>(m, p, device, s)) != cudaSuccess) return err;
  return decoder(hc, Wd, bd, y, L, B, D, S, device, s);
}

// B6, bf16: x, hc, W_dec, b_dec, dy, xc (scratch) and dhc (scratch) in bf16;
// dl1 [L], dWe [L, D, S], dWd [L, S, D] and dbe_part [L, B/128, S] float32.
// Returns the launches' cudaError_t.
extern "C" int sae_fused_bwd_stored_tc(const void* x, const void* hc, const void* Wd,
                                       const void* bd, const void* dy, const void* dl1, void* xc,
                                       void* dhc, void* dWe, void* dWd, void* dbe_part, int L,
                                       int B, int D, int S, int device, void* stream) {
  if (!fits(L, B, D, S)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((err = center(x, bd, xc, L, B, D, s)) != cudaSuccess) return err;
  return backward_from_hc<kDh>(xc, hc, Wd, dy, dl1, dhc, dWe, dWd, dbe_part, L, B, D, S, device,
                               s);
}

// B5, bf16: x, the weights, dy, xc (scratch), hc (scratch: B4's hc with -0
// marks) and dhc (scratch) in bf16; dl1 [L], dWe [L, D, S], dWd [L, S, D]
// and dbe_part [L, B/128, S] float32.  Returns the launches' cudaError_t.
extern "C" int sae_fused_bwd_remat_tc(const void* x, const void* We, const void* be,
                                      const void* Wd, const void* bd, const void* dy,
                                      const void* dl1, void* xc, void* hc, void* dhc, void* dWe,
                                      void* dWd, void* dbe_part, int L, int B, int D, int S,
                                      int device, void* stream) {
  if (!fits(L, B, D, S)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((err = center(x, bd, xc, L, B, D, s)) != cudaSuccess ||
      (err = plain_encoder<kReluRemat>(xc, We, be, nullptr, hc, L, B, D, S, device, s)) !=
          cudaSuccess)
    return err;
  return backward_from_hc<kDhMarked>(xc, hc, Wd, dy, dl1, dhc, dWe, dWd, dbe_part, L, B, D, S,
                                     device, s);
}

// B8, bf16: x, the weights, xc (scratch), h (the masked activations) and y
// in bf16; t [L, B], nact_part [L, B/128, S] and l1_part [L, B/128, S/128]
// float32; 1 <= k <= S.  Launches: center; the TopK encoder (hc = c(max(hpre,
// 0)) into h); radix_select.cuh's select on each row of h, which writes t and
// masks the row in place; the counts (sae::active_counts); the decoder over
// h.  Returns the launches' cudaError_t.
extern "C" int sae_fused_fwd_topk_tc(const void* x, const void* We, const void* be,
                                     const void* Wd, const void* bd, void* xc, void* h, void* y,
                                     void* t, void* nact_part, void* l1_part, int L, int B, int D,
                                     int S, int k, int device, void* stream) {
  if (!fits(L, B, D, S) || !sae::shapes_ok(L, B, D, S) || k < 1 || k > S ||
      static_cast<long long>(L) * B > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* hb = static_cast<bf16*>(h);
  if ((err = center(x, bd, xc, L, B, D, s)) != cudaSuccess ||
      (err = plain_encoder<kTopkEncoder>(xc, We, be, nullptr, h, L, B, D, S, device, s)) !=
          cudaSuccess ||
      (err = rsel::select_rows<bf16, true>(hb, static_cast<float*>(t), hb,
                                           static_cast<long long>(L) * B, S, k, s)) !=
          cudaSuccess ||
      (err = sae::active_counts<bf16>(hb, static_cast<float*>(nact_part),
                                      static_cast<float*>(l1_part), L, B, S, s)) != cudaSuccess)
    return err;
  return decoder(h, Wd, bd, y, L, B, D, S, device, s, kTopkFillWaves);
}

// B9, bf16: x, the weights, dy, xc (scratch), h (scratch: B8's h again,
// from B8's encoder mode masked against t) and dhc (scratch) in bf16; dl1
// [L] and B8's thresholds t [L, B], dWe [L, D, S], dWd [L, S, D] and
// dbe_part [L, B/128, S] float32.  Returns the launches' cudaError_t.
extern "C" int sae_fused_bwd_topk_tc(const void* x, const void* We, const void* be,
                                     const void* Wd, const void* bd, const void* dy,
                                     const void* dl1, const void* t, void* xc, void* h,
                                     void* dhc, void* dWe, void* dWd, void* dbe_part, int L,
                                     int B, int D, int S, int device, void* stream) {
  if (!fits(L, B, D, S) || t == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((err = center(x, bd, xc, L, B, D, s)) != cudaSuccess ||
      (err = plain_encoder<kTopkRemat>(xc, We, be, t, h, L, B, D, S, device, s)) != cudaSuccess)
    return err;
  return backward_from_hc<kDh>(xc, h, Wd, dy, dl1, dhc, dWe, dWd, dbe_part, L, B, D, S, device,
                               s);
}

// B11, bf16: x, W_enc, b_gate, b_mag, W_dec, b_dec, xc (scratch), h ([L, 2B,
// S]: c(h), then c(hga) in each layer) and y ([L, 2B, D]: y, then via) in
// bf16; e and wdn [L, S], nact_part [L, B/128, S] and l1_part [L, B/128,
// S/256] float32.  Returns the launches' cudaError_t.
extern "C" int sae_gated_fwd_tc(const void* x, const void* We, const void* bg, const void* e,
                                const void* bm, const void* Wd, const void* bd, const void* wdn,
                                void* xc, void* h, void* y, void* nact_part, void* l1_part,
                                int L, int B, int D, int S, int device, void* stream) {
  if (!fits(L, B, D, S)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((err = center(x, bd, xc, L, B, D, s)) != cudaSuccess ||
      (err = gated_encoder<kGatedEncoder>(xc, We, bg, e, bm, wdn, h, nullptr,
                                          static_cast<float*>(nact_part),
                                          static_cast<float*>(l1_part), L, B, D, S, device, s)) !=
          cudaSuccess)
    return err;
  return decoder(h, Wd, bd, y, L, 2 * B, D, S, device, s, true);
}

// B12, bf16: x, W_enc, b_gate, b_mag, W_dec, b_dec, dy, dvia, xc (scratch),
// h (scratch, [L, 2B, S]: c(h) and c(hga), as B11's) and dgc (scratch, [L,
// B, S]) in bf16; e and wdn [L, S], dl1 [L], g (scratch, [L, B, S]), part
// (scratch, [4, L, B/128, S]), sums [4, L, S] (colsum(max(hg, 0)), db_gate,
// db_mag, sum(dhm g)), dWe [L, D, S] and dWd [L, S, D] float32.  Returns the
// launches' cudaError_t.
extern "C" int sae_gated_bwd_tc(const void* x, const void* We, const void* bg, const void* e,
                                const void* bm, const void* Wd, const void* bd, const void* wdn,
                                const void* dy, const void* dvia, const void* dl1, void* xc,
                                void* h, void* g, void* dgc, void* part, void* sums, void* dWe,
                                void* dWd, int L, int B, int D, int S, int device,
                                void* stream) {
  if (!fits(L, B, D, S)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* fpart = static_cast<float*>(part);
  if ((err = center(x, bd, xc, L, B, D, s)) != cudaSuccess ||
      (err = gated_encoder<kGatedRemat>(xc, We, bg, e, bm, wdn, h, static_cast<float*>(g), fpart,
                                        nullptr, L, B, D, S, device, s)) != cudaSuccess)
    return err;

  // dg [L, B, S] in 128 x 128 tiles from dy and dvia [L, B, D] (K-major A
  // boxes of 128 rows) and W_dec [L, S, D] (the K-major B, 128 rows); the
  // float32 g [L, B, S] loaded as bf16 pairs, [L, B, 2S]
  CUtensorMap m[6];
  if ((err = map3(&m[0], dy, L, B, D, kBM)) != cudaSuccess ||
      (err = map3(&m[2], dvia, L, B, D, kBM)) != cudaSuccess ||
      (err = map3(&m[1], Wd, L, S, D, kBM)) != cudaSuccess ||
      (err = map3(&m[4], g, L, B, 2 * S, hg::kBox)) != cudaSuccess)
    return err;
  m[3] = m[1];
  m[5] = m[0];
  Params p = {};
  p.g0 = p.g1 = make_grid(L, B, S, 128);
  p.total = p.tiles0 = tiles(p.g0);
  p.ktiles = p.ktiles1 = D / kBK;
  p.bias = static_cast<const bf16*>(bg);
  p.bmag = static_cast<const bf16*>(bm);
  p.e = static_cast<const float*>(e);
  p.wdn = static_cast<const float*>(wdn);
  p.dl1 = static_cast<const float*>(dl1);
  p.out = static_cast<bf16*>(dgc);
  p.part = fpart;
  if ((err = launch<kDg>(m, p, device, s)) != cudaSuccess) return err;
  float* fsums = static_cast<float*>(sums);
  if ((err = sae::partial_sums(fpart, fsums, 4 * L, B / kBM, S, s)) != cudaSuccess) return err;

  // dW_enc [L, D, S] = xc^T c(dg) (K = B) and dW_dec [L, S, D] = [c(h);
  // c(hga)]^T [dy; dvia] + coef W_dec (K = 2B: dvia's tiles from K step
  // B / 64 on) in one launch, every operand MN-major
  if ((err = product_maps(&m[0], &m[1], xc, B, D, kMNMajor, dgc, B, S, kMNMajor, L)) !=
          cudaSuccess ||
      (err = product_maps(&m[2], &m[3], h, 2 * B, S, kMNMajor, dy, B, D, kMNMajor, L)) !=
          cudaSuccess ||
      (err = operand_map(&m[4], dvia, L, B, D, kMNMajor, false)) != cudaSuccess)
    return err;
  m[5] = m[0];
  p = Params{};
  p.g0 = make_grid(L, D, S);
  p.g1 = make_grid(L, S, D);
  p.tiles0 = tiles(p.g0);
  p.total = p.tiles0 + tiles(p.g1);
  p.ktiles = B / kBK;
  p.ktiles1 = 2 * B / kBK;
  p.kswitch = B / kBK;
  p.dl1 = static_cast<const float*>(dl1);
  p.wdn = static_cast<const float*>(wdn);
  p.hga_sum = fsums;  // sums[0]: colsum(max(hg, 0))
  p.wd = static_cast<const bf16*>(Wd);
  p.c0 = static_cast<float*>(dWe);
  p.c1 = static_cast<float*>(dWd);
  return launch<kGatedWgrad>(m, p, device, s);
}
