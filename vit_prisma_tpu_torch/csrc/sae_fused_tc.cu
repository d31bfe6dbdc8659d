// The bfloat16 Hopper route of the fused standard-ReLU SAE forward (kernel
// B4) and of its stored-activations backward (kernel B6), over L stacked
// SAEs, on sae_wgmma.cuh's persistent warp-specialized wgmma/TMA GEMM.
//
// Replaces, with sae_fused_fwd.cu and sae_fused_bwd.cu (which keep the
// float32 route, the bf16 shapes this route does not take, and B5 and B9),
// the Pallas TPU kernels `_fwd_kernel` (launched by `_fused_forward`) and
// `_bwd_kernel_stored` (launched by `_fused_backward_stored`) in
// vit_prisma_tpu/ops/sae_step.py.  The functions and cast points are those
// of sae_fused_fwd.cu and sae_fused_bwd.cu and of the plain versions
// `sae_fused_forward_reference` and `sae_fused_backward_stored_reference`
// (vit_prisma_tpu_torch/ops/sae_step.py):
//   B4: xc = x - b_dec (bf16); hpre = xc W_enc + b_enc (float32);
//       hc = bf16(relu(hpre)); y = bf16(b_dec + hc W_dec);
//       l1[l] = sum of the float32 relu(hpre); nact[l, j] = rows with hpre > 0;
//   B6: mask = float(hc) > 0 on the stored hc; dh = mask ? dy W_dec^T + dl1 : 0
//       (float32); dhc = bf16(dh); dW_enc = xc^T dhc, dW_dec = hc^T dy
//       (float32); db_enc = column sums of the float32 dh.
// Every partial sum is taken in a fixed order without atomics (the wrapper
// sums the per-tile partials), so two calls give the same bits.
//
// Launches, each batched over L through the tile schedule:
//   B4: center (xc in bf16, 16 bytes a thread: 0.13 ms at the sweep shape
//       on an H100 80GB HBM3, where sae::center's one element a thread
//       took 0.53), the encoder GEMM (epilogue: b_enc, ReLU, hc by TMA
//       store, nact column counts from ballots and the l1 sum of each
//       128 x 256 tile), the decoder GEMM (epilogue: b_dec, y by TMA
//       store);
//   B6: center, the dh GEMM (dy W_dec^T with W_dec K-major; its epilogue
//       loads the stored hc tile by TMA into the staging buffer, masks, adds
//       dl1, writes dhc in place over hc, stores it by TMA and writes the
//       db_enc column sums of the tile), then dW_enc and dW_dec in ONE
//       launch, a schedule over both products' tiles (the same K = B), so
//       neither leaves a tail; their float32 tiles go straight from the
//       accumulators to device memory.
//
// What bounds it on an H100.  At the bf16 sweep shape (24 x 4096 rows, 1024
// -> 8192) B4 is 3.3 TFLOP and B6 4.9 TFLOP against a few GB of traffic,
// far past the ~295 flops a byte where the bf16 tensor cores and not device
// memory are the limit: both are bound by tensor-core issue (bounds 3.34 and
// 5.00 ms at 989 TFLOP/s).  The mma.sync tiles they replace ran at 244-254
// TFLOP/s; this route issues m64n256k16 wgmmas from two consumer
// warpgroups on a TMA-fed ring, the form that reached 385-489 TFLOP/s in B14
// (ln_matmul.cu).  Measured on an NVIDIA H100 80GB HBM3 (700 W) at the sweep
// shape: B4 6.59-6.82 ms and B6 8.01-8.20 (484-618 TFLOP/s; the mma.sync
// tiles took 13.1 and 20.7), 1.2-1.6x the time of cuBLAS's products alone;
// the epilogues, which the tensor cores wait for, hold them (PERF.md
// section 6).
//
// Shapes: B a multiple of 128, d_in and d_sae multiples of 256 (the wrapper's
// `sae_gemm_route` picks them; the entries return cudaErrorInvalidValue for
// others); every pointer 16-byte aligned.

#include "sae_wgmma.cuh"

namespace {

using namespace sw;

enum Mode { kEncoder = 0, kDecoder = 1, kDh = 2, kWgrad = 3 };

// Per mode: operand layouts, ring depth, and what the epilogue needs.
template <int MODE>
struct Cfg {
  static constexpr int AM = MODE == kWgrad ? kMNMajor : kKMajor;
  static constexpr int BM = MODE == kDh ? kKMajor : kMNMajor;
  static constexpr bool kStaging = MODE != kWgrad;             // a bf16 C tile by TMA store
  static constexpr bool kRed = MODE == kEncoder || MODE == kDh;  // column sums
  static constexpr bool kLoadC = MODE == kDh;                  // the stored hc tile
  static constexpr int kStages = kStaging ? 3 : 4;
};

// Byte offsets from the 1024-aligned base: the ring, the two warpgroups'
// staged C tiles, two buffers of column partials (alternating by tile) and
// of l1 partials, then the barriers: full[kStages], empty[kStages],
// cfull[2] (the staged hc tile landed), cempty[2] (its store has read it).
template <int MODE>
struct Layout {
  typedef Cfg<MODE> C;
  static constexpr int staging = C::kStages * kStageBytes;
  static constexpr int red = staging + (C::kStaging ? kConsumers * kOutBytes : 0);
  static constexpr int l1 = red + (C::kRed ? 2 * kRedFloats * 4 : 0);
  static constexpr int bars = l1 + (C::kRed ? 2 * 4 * kConsumers * 4 : 0);
  static constexpr int bytes = bars + (2 * C::kStages + 2 * kConsumers) * 8 + hg::kSwizzleAlign;
  static_assert(bytes <= kMaxSmem, "shared memory");
};

struct Params {
  Grid g0, g1;        // the tiles of the product (and of the wgrad's second one)
  int total, tiles0;  // all tiles; the first product's
  int ktiles;         // K / 64, the same for both wgrad products
  const bf16* bias;   // b_enc [L, S] (encoder), b_dec [L, D] (decoder)
  const float* dl1;   // [L] (dh)
  float* part;        // [L, B / 128, S]: nact (encoder), db_enc (dh)
  float* l1_part;     // [L, B / 128, S / 256] (encoder)
  float* c0;          // dW_enc [L, D, S] (wgrad)
  float* c1;          // dW_dec [L, S, D] (wgrad)
};

// Grid: min(tiles, SMs) blocks of kThreads; Layout<MODE>::bytes of dynamic
// shared memory.  a0, b0 (a1, b1): the operands of the first (second)
// product; cin: the stored hc (dh); cout: the bf16 C tensor (hc, y, dhc).
template <int MODE>
__global__ void __launch_bounds__(kThreads, 1)
    sae_tc_kernel(const __grid_constant__ CUtensorMap a0, const __grid_constant__ CUtensorMap b0,
                  const __grid_constant__ CUtensorMap a1, const __grid_constant__ CUtensorMap b1,
                  const __grid_constant__ CUtensorMap cin,
                  const __grid_constant__ CUtensorMap cout, const Params p) {
  typedef Cfg<MODE> C;
  typedef Layout<MODE> Lay;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = aligned_base(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + Lay::bars);
  const Ring<C::kStages> ring{smem, bars, bars + C::kStages};
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
        produce_tile<C::kStages, C::AM, C::BM>(ring, it, second ? &a1 : &a0,
                                               second ? &b1 : &b0, p.ktiles, x.l, x.m0, x.n0);
        if (C::kLoadC) {  // the tile's stored hc, once the last tile's dhc store has read it
          for (int w = 0; w < kConsumers; ++w) {
            unsigned char* stg = smem + Lay::staging + w * kOutBytes;
            if (i > 0) hg::mbar_wait(&cempty[w], (i - 1) & 1);
            hg::mbar_expect_tx(&cfull[w], kOutBytes);
#pragma unroll
            for (int b = 0; b < kBN / hg::kBox; ++b)
              hg::tma_load_3d(stg + b * hg::kBoxBytes, &cin, &cfull[w], x.n0 + b * hg::kBox,
                              x.m0 + 64 * w, x.l);
          }
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: rows 64 wg .. 64 wg + 63 of each tile
  hg::reg_alloc<232>();
  const int t = threadIdx.x % 128, warp = t / 32, lane = t & 31, g = lane >> 2, tq = lane & 3;
  const int cw = 4 * wg + warp;  // this warp's row of the column partials
  unsigned char* stg = smem + Lay::staging + wg * kOutBytes;
  float acc[kBN / 2];  // the first products of a tile overwrite it (scale-d 0)
  uint32_t it = 0;
  int i = 0;
  for (int tt = blockIdx.x; tt < p.total; tt += gridDim.x, ++i) {
    const bool second = tt >= p.tiles0;
    const Tile x = tile_at(second ? p.g1 : p.g0, second ? tt - p.tiles0 : tt);
    consume_tile<C::kStages, C::AM, C::BM>(acc, ring, it, p.ktiles, wg, lane);

    if (MODE == kWgrad) {  // float32 straight to device memory, 32 bytes a row a quad
      const Grid& gr = second ? p.g1 : p.g0;
      const int N = gr.tn * kBN;
      float* c = (second ? p.c1 : p.c0) +
                 (static_cast<long long>(x.l) * gr.tm * kBM + x.m0 + 64 * wg) * N + x.n0;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          sae::store2(c + static_cast<long long>(16 * warp + g + 8 * h) * N + 8 * j + 2 * tq,
                      acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      continue;
    }

    float* red = reinterpret_cast<float*>(smem + Lay::red) + (i & 1) * kRedFloats;
    float* l1red = reinterpret_cast<float*>(smem + Lay::l1) + (i & 1) * 4 * kConsumers;
    if (MODE == kDh) {
      hg::mbar_wait(&cfull[wg], i & 1);  // the stored hc tile is in the staging
    } else {
      if (t == 0) hg::bulk_wait_read();  // the last tile's store has read the staging
      hg::named_sync(1 + wg, 128);
    }
    const long long prow = static_cast<long long>(x.l) * p.g0.tm + x.mt;  // partials' row
    const int ncols = p.g0.tn * kBN;
    if (MODE == kEncoder) {
      const bf16* be = p.bias + static_cast<long long>(x.l) * ncols + x.n0;
      float l1 = 0.f;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const float2 b =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(be + 8 * j + 2 * tq));
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
          sae::store2(reinterpret_cast<bf16*>(stg + stage_off(16 * warp + g + 8 * h, j, tq)), h0,
                      h1);
        }
        if (lane < 4)
          *reinterpret_cast<float2*>(red + cw * kBN + 8 * j + 2 * lane) =
              make_float2(static_cast<float>(c0), static_cast<float>(c1));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) l1 += __shfl_xor_sync(0xffffffffu, l1, o);
      if (lane == 0) l1red[cw] = l1;
    } else if (MODE == kDecoder) {
      const bf16* bd = p.bias + static_cast<long long>(x.l) * ncols + x.n0;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const float2 b =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bd + 8 * j + 2 * tq));
#pragma unroll
        for (int h = 0; h < 2; ++h)
          sae::store2(reinterpret_cast<bf16*>(stg + stage_off(16 * warp + g + 8 * h, j, tq)),
                      b.x + acc[4 * j + 2 * h], b.y + acc[4 * j + 2 * h + 1]);
      }
    } else {  // kDh: mask from the stored hc, dl1, dhc in place of hc
      const float g1 = p.dl1[x.l];
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          __nv_bfloat162* q =
              reinterpret_cast<__nv_bfloat162*>(stg + stage_off(16 * warp + g + 8 * h, j, tq));
          const float2 hv = __bfloat1622float2(*q);
          const float d0 = hv.x > 0.f ? acc[4 * j + 2 * h] + g1 : 0.f;
          const float d1 = hv.y > 0.f ? acc[4 * j + 2 * h + 1] + g1 : 0.f;
          s0 += d0;
          s1 += d1;
          *q = __floats2bfloat162_rn(d0, d1);
        }
        col_partial(s0, s1, red + cw * kBN, j, lane);
      }
    }

    // the warpgroup's staged tile to device memory
    hg::fence_proxy_async_smem();
    hg::named_sync(1 + wg, 128);
    if (t == 0) {
#pragma unroll
      for (int b = 0; b < kBN / hg::kBox; ++b)
        hg::tma_store_3d(&cout, stg + b * hg::kBoxBytes, x.n0 + b * hg::kBox, x.m0 + 64 * wg,
                         x.l);
      hg::bulk_commit();
      if (MODE == kDh) {  // the producer may load the next hc tile here
        hg::bulk_wait_read();
        hg::mbar_arrive(&cempty[wg]);
      }
    }
    if (C::kRed) {  // the tile's column sums (and l1), in a fixed order
      consumers_sync();
      col_sums(red, p.part + prow * ncols + x.n0, 128 * wg + t);
      if (MODE == kEncoder && wg == 0 && t == 0) {
        float s = 0.f;
        for (int w = 0; w < 4 * kConsumers; ++w) s += l1red[w];
        p.l1_part[prow * p.g0.tn + x.n0 / kBN] = s;
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
  if ((err = center16(static_cast<const bf16*>(x), static_cast<const bf16*>(bd),
                      static_cast<bf16*>(xc), L, B, D, s)) != cudaSuccess)
    return err;

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
  p.ktiles = D / kBK;
  p.bias = static_cast<const bf16*>(be);
  p.part = static_cast<float*>(nact_part);
  p.l1_part = static_cast<float*>(l1_part);
  if ((err = launch<kEncoder>(m, p, device, s)) != cudaSuccess) return err;

  // decoder: y [L, B, D] = b_dec + hc [L, B, S] W_dec [L, S, D]
  if ((err = product_maps(&m[0], &m[1], hc, B, S, kKMajor, Wd, S, D, kMNMajor, L)) != cudaSuccess ||
      (err = map3(&m[5], y, L, B, D, hg::kBox)) != cudaSuccess)
    return err;
  m[2] = m[0];
  m[3] = m[1];
  m[4] = m[5];
  p = Params{};
  p.g0 = p.g1 = make_grid(L, B, D);
  p.total = p.tiles0 = tiles(p.g0);
  p.ktiles = S / kBK;
  p.bias = static_cast<const bf16*>(bd);
  return launch<kDecoder>(m, p, device, s);
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
  if ((err = center16(static_cast<const bf16*>(x), static_cast<const bf16*>(bd),
                      static_cast<bf16*>(xc), L, B, D, s)) != cudaSuccess)
    return err;

  // dh [L, B, S] = dy [L, B, D] W_dec^T, W_dec [L, S, D] as the K-major B
  CUtensorMap m[6];
  if ((err = product_maps(&m[0], &m[1], dy, B, D, kKMajor, Wd, S, D, kKMajor, L)) != cudaSuccess ||
      (err = map3(&m[4], hc, L, B, S, hg::kBox)) != cudaSuccess ||
      (err = map3(&m[5], dhc, L, B, S, hg::kBox)) != cudaSuccess)
    return err;
  m[2] = m[0];
  m[3] = m[1];
  Params p = {};
  p.g0 = p.g1 = make_grid(L, B, S);
  p.total = p.tiles0 = tiles(p.g0);
  p.ktiles = D / kBK;
  p.dl1 = static_cast<const float*>(dl1);
  p.part = static_cast<float*>(dbe_part);
  if ((err = launch<kDh>(m, p, device, s)) != cudaSuccess) return err;

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
  p.ktiles = B / kBK;
  p.c0 = static_cast<float*>(dWe);
  p.c1 = static_cast<float*>(dWd);
  return launch<kWgrad>(m, p, device, s);
}
