// Fused attention block, forward: the QKV projection, the per-head softmax
// mix and the output projection of one ViT attention layer in one kernel.
//
// Replaces the Pallas TPU kernel `_attn_block_kernel`, launched by
// `_attn_block_forward` in vit_prisma_tpu/ops/attention.py (kernel B16 of the
// ROADMAP, entry `fused_attention_block`).  x is [B, T, D] (already
// LayerNorm'd), Wqkv [D, 3*N*H] with q, k and v packed along the columns
// (head n of q at columns n*H .. n*H + H, of k at N*H + n*H, of v at
// 2*N*H + n*H), bqkv [3*N*H], Wo [N*H, D]; out is [B, T, D], without the
// output bias.  Rounding points, as the Pallas kernel's:
//   qkv = round(x Wqkv + bqkv)       float32 accumulation, the bias added in
//                                    float32, one rounding to x's dtype;
//   q   = round(q * inv_scale)       inv_scale already in x's dtype;
//   s   = q k^T in float32, p = exp(s - max) / sum, rounded to v's dtype;
//   z_n = round(p v)                 float32 accumulation;
//   out = round(concat_n(z_n) Wo)    float32 accumulation over all N*H.
// All three products are here, in two routes by dtype.
//
// bfloat16 (block_tc_kernel, Hopper).  What bounds it: at CLIP ViT-B/32,
// batch 256, the products are ~62 GFLOP (0.064 ms on the tensor cores), but
// every image needs all of Wqkv (3.5 MB) and Wo (1.2 MB), and each head's
// softmax mix runs between two products.  Design:
//  * one block of three warpgroups takes two images: a producer warp fills
//    a 4-stage ring by TMA (hopper_gemm.cuh; 128-byte swizzled, mbarriers)
//    and two consumer warpgroups each own one image, padded to 64 rows.  A
//    stage holds both images' [64 x 64] A tiles and one [64 x 192] weight
//    tile that both consume, so the weights stream once per two images.  x
//    and z come through 3-D tensor maps [B, rows, cols] whose boxes zero-
//    fill rows past T (finite padding rows, no neighbouring image);
//  * for each head: qkv = x Wqkv[:, head's q, k, v columns] as wgmma
//    m64n192k16 with float32 accumulators (one stage's products in flight
//    while the next is waited for), the bias (loaded under the products)
//    added in float32, one rounding, q scaled and rounded again, into the
//    image's q, k, v tiles (flash_tile.cuh's padded layout); then each of
//    the warpgroup's 4 warps takes 16 query rows through flash_tile.cuh's
//    mma.sync s = q k^T and p v fragments (padding keys masked to -inf;
//    p = exp(s - m) / l as B1's bf16 kernel takes it, ex2 on the SFUs and
//    one reciprocal a row, rounded to bf16 before p v), and the image's
//    z_n, rounded and staged 128-byte swizzled in the k tile's place,
//    leaves by TMA store for a [B, 64, N*H] scratch in device memory (it
//    stays in L2).  The producer loads the next head's stages meanwhile;
//  * out = z Wo in 192-column tiles over K = N*H, wgmma again, once each
//    slot's z stores are complete (an mbarrier the producer waits on before
//    its first z load), each tile stored by TMA (rows past T dropped).
//  A lone image (odd batch) leaves the second slot empty: nothing is
//  loaded into its tiles, it runs the same instructions on them (a branch
//  around the wgmma would make ptxas serialize them), and its TMA stores
//  fall outside the tensors and are dropped.  Both slots run the same
//  instructions on their own image, so an image's output does not depend
//  on its batch or its slot.  Two-block clusters that multicast each
//  weight tile halve the weights' L2 reads but took 1.8x the time.
//
// float32 (block_tf32_kernel, 3xTF32 on tf32 wgmma: hopper_gemm.cuh's
// float32 pieces, as B14's float32 route).  At B/32 the three products are
// 187 GFLOP of TF32 (0.378 ms at 495 TFLOP/s); float32 weights are 9.4 MB,
// and their split hi and lo copies 18.9 MB, streamed once per block from
// L2.  Design:
//  * the two weights are written K-major and split into TF32 hi and lo
//    parts by a pre-pass (split_k_major_kernel) into the wrapper's scratch
//    beside z: Wqkv^T [2, 3 NH, D] with each head's columns in the order k,
//    v, q, and Wo^T [2, D, NH] (each call: the weights may change);
//  * one block of three warpgroups takes two images, as block_tc_kernel: a
//    producer warp fills a 3-stage ring by TMA, each stage both images'
//    [64 x 32] x (or z) tiles and one 32-deep weight tile's hi and lo (48
//    KB), so the weights stream once per two images; each consumer
//    warpgroup owns one image (rows past T zero-filled by TMA);
//  * for each head, two passes of wgmma m64n96k8 over K = D (k and half of
//    v, then the other half of v and q: 96 columns keep a pass's running
//    total, its stage sum and the A fragments in registers), A from
//    registers as B14's float32 route reads it (each thread's elements of
//    the landed tile, split), each 32-deep stage summed from zero and added
//    in FADDs; the bias in float32; k and v into the image's [64 x 68]
//    tiles, q scaled in registers and turned into the mix's A fragments by
//    quad shuffles;
//  * the mix is B1's float32 device code (mix_tf32.cuh fwd_rows, 3xTF32
//    mma.sync, exact two-pass softmax; each warp 16 query rows), z stored
//    for the image's rows < T into the [B, 64, NH] scratch;
//  * once the image's z is in device memory (each thread's stores fenced
//    to the async proxy, then an mbarrier the producer waits on), out = z
//    Wo in 128-column passes (m64n128k8, z by TMA like x), stored from the
//    registers (rows < T).
//  A lone image (odd batch) leaves the second slot empty: nothing is loaded
//  into its tiles, it runs the same wgmma instructions on them, and it
//  stores nothing (its token count taken as 0).
//
// Every element of out is summed by one thread in a fixed order: no
// atomics, so the result does not depend on scheduling, the batch or the
// slot.  Shared memory: bfloat16 220,232 bytes (4 stages of 40 KB, both
// images' q, k, v tiles, the barriers and the swizzle's alignment), float32
// 218,168 (3 stages of 48 KB, both images' k and v tiles, the barriers and
// the alignment); one block an SM either way.  The gate
// (vit_prisma_tpu_torch/ops/attention.py, attn_block_fits_smem) takes T <=
// 64, H = 64, D a multiple of 128: CLIP ViT-B/32 (T 50, D 768, N 12) in
// both dtypes; CLIP L/14 (T 257) is past it.

#include "attention_mix_core.cuh"  // mix::tf32::fwd_rows, B1's float32 mix
#include "flash_tile.cuh"
#include "hopper_gemm.cuh"

namespace {

using sae::from_f;
using sae::store2;
using sae::to_f;

constexpr int kHead = 64;   // head width
constexpr int kRows = 64;   // token rows a block holds
constexpr int kQkvCols = 3 * kHead;  // one head's q, k and v columns
constexpr size_t kMaxSmemBytes = 232448;

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// ---- float32: 3xTF32 on tf32 wgmma -------------------------------------------

namespace tf {

constexpr int kSlots = 2;                  // images a block, one consumer warpgroup each
constexpr int kStages = 3;
constexpr int kBK = hg::kF32Box;           // K a stage
constexpr int kQkvN = 96;                  // columns of a QKV pass: two passes a head
constexpr int kOutN = 128;                 // columns of out a pass
constexpr int kThreads = 128 * (kSlots + 1);  // + the producer's warpgroup
constexpr int kABytes = kRows * kBK * 4;   // one image's [64 x 32] x or z tile
constexpr int kBBytes = kOutN * kBK * 4;   // room for a weight tile's hi (or lo)
constexpr int kStageBytes = kSlots * kABytes + 2 * kBBytes;
constexpr int kS = 68;                     // k and v rows: H + 4 floats (mix_tf32's row_stride)
constexpr int kTileFloats = kRows * kS;
constexpr int kTilesOffset = kStages * kStageBytes;
constexpr int kBarOffset = kTilesOffset + kSlots * 2 * kTileFloats * 4;
constexpr int kBytes = kBarOffset + (2 * kStages + 1) * 8 + hg::kSwizzleAlign;
static_assert(kBytes <= static_cast<int>(kMaxSmemBytes), "shared memory");
static_assert(kS == mix::tf32::round8(kHead + 4) - 4, "the mix's row stride");

// Wqkv^T's rows in the split copy: head n's k, v, then q columns.
struct QkvCols {
  int nh;
  __device__ int operator()(int r) const {
    const int n = r / kQkvCols, i = r % kQkvCols;
    return i < 2 * kHead ? (1 + i / kHead) * nh + n * kHead + i % kHead : n * kHead + i - 2 * kHead;
  }
};

// acc = A B over nk stages of the ring (it counts the stages taken): A this
// slot's tile, B the stage's split weight tile of N rows; each stage summed
// from zero, then added.
template <int N>
__device__ __forceinline__ void gemm(float (&acc)[N / 2], int nk, int& it, unsigned char* smem,
                                     uint64_t* full, uint64_t* empty, int slot) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x % 128) / 32;
  float c[N / 2];  // a stage's sum, from zero (scale_d 0)
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt, ++it) {
    const int st = it % kStages;
    hg::mbar_wait(&full[st], (it / kStages) & 1);
    const unsigned char* stage = smem + st * kStageBytes;
    float x[4][4];
    hg::load_frags(x, reinterpret_cast<const float*>(stage + slot * kABytes), 16 * warp);
    uint32_t hi[4][4], lo[4][4];
    hg::split_frags(hi, lo, x);
    hg::mma3_stage<N>(c, hi, lo, reinterpret_cast<const float*>(stage + kSlots * kABytes),
                      reinterpret_cast<const float*>(stage + kSlots * kABytes + kBBytes));
    hg::wgmma_wait<0>();
    hg::fence_acc(c);
    hg::keep_regs(hi);
    hg::keep_regs(lo);
    if (lane == 0) hg::mbar_arrive(&empty[st]);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] += c[i];
  }
}

// Grid (ceil(B / kSlots)); kThreads threads; kBytes of dynamic shared memory.
// xmap: x [B, n_tok, D] in boxes [1 x 64 x 32]; wmap: Wqkv^T's split [2, 3
// NH, D] in [1 x 96 x 32]; zmap: the z scratch [B, 64, NH], its first n_tok
// rows, in [1 x 64 x 32]; omap: Wo^T's split [2, D, NH] in [1 x 128 x 32].
__global__ void __launch_bounds__(kThreads, 1)
block_tf32_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                  const __grid_constant__ CUtensorMap zmap, const __grid_constant__ CUtensorMap omap,
                  const float* __restrict__ bqkv, float* __restrict__ zbuf,
                  float* __restrict__ out, int batch, int n_tok, int D, int n_heads,
                  float inv_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + hg::kSwizzleAlign - 1) &
      ~static_cast<uintptr_t>(hg::kSwizzleAlign - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOffset);
  uint64_t* empty = full + kStages;
  uint64_t* zready = empty + kStages;  // each slot's z rows are in device memory
  const int NH = n_heads * kHead;
  const int img0 = blockIdx.x * kSlots;
  const int n_img = min(kSlots, batch - img0);
  const int kq = D / kBK, ko = NH / kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      hg::mbar_init(&full[i], 1);
      hg::mbar_init(&empty[i], 4 * kSlots);  // one arrive a consumer warp
    }
    hg::mbar_init(zready, kSlots);
    hg::fence_barrier_init();
  }
  __syncthreads();

  if (wg == kSlots) {  // the producer: one thread issues every copy
    hg::reg_dealloc<40>();
    if (threadIdx.x == 128 * kSlots) {
      int it = 0;
      // Take the next stage of the ring for an A tile per image and a
      // weight tile of `rows` rows (hi and lo); returns its base.
      auto next_stage = [&](int& st, int rows) {
        st = it % kStages;
        const int round = it / kStages;
        if (round > 0) hg::mbar_wait(&empty[st], (round - 1) & 1);
        hg::mbar_expect_tx(&full[st], n_img * kABytes + 2 * rows * kBK * 4);
        ++it;
        return smem + st * kStageBytes;
      };
      auto load_weights = [&](unsigned char* stage, const CUtensorMap* map, int st, int row, int k0) {
        hg::tma_load_3d(stage + kSlots * kABytes, map, &full[st], k0, row, 0);            // hi
        hg::tma_load_3d(stage + kSlots * kABytes + kBBytes, map, &full[st], k0, row, 1);  // lo
      };
      for (int n = 0; n < n_heads; ++n)
        for (int pass = 0; pass < 2; ++pass)
          for (int kt = 0; kt < kq; ++kt) {
            int st;
            unsigned char* stage = next_stage(st, kQkvN);
            for (int i = 0; i < n_img; ++i)
              hg::tma_load_3d(stage + i * kABytes, &xmap, &full[st], kt * kBK, 0, img0 + i);
            load_weights(stage, &wmap, st, n * kQkvCols + pass * kQkvN, kt * kBK);
          }
      hg::mbar_wait(zready, 0);
      for (int ct = 0; ct < D / kOutN; ++ct)
        for (int kt = 0; kt < ko; ++kt) {
          int st;
          unsigned char* stage = next_stage(st, kOutN);
          for (int i = 0; i < n_img; ++i)
            hg::tma_load_3d(stage + i * kABytes, &zmap, &full[st], kt * kBK, 0, img0 + i);
          load_weights(stage, &omap, st, ct * kOutN, kt * kBK);
        }
    }
  } else {  // consumer warpgroup wg: image img0 + wg
    hg::reg_alloc<232>();
    const int slot = wg;
    const long long img = img0 + slot;
    const int n_valid = slot < n_img ? n_tok : 0;  // an empty slot stores nothing
    const int t = threadIdx.x % 128, warp = t / 32, lane = t & 31, g = lane >> 2, tq = lane & 3;
    float* Ks = reinterpret_cast<float*>(smem + kTilesOffset) + slot * 2 * kTileFloats;
    float* Vs = Ks + kTileFloats;
    float* zimg = zbuf + img * kRows * NH;
    int it = 0;
    // rows 16 warp + g + 8 h of the image; columns 8 j + 2 tq of a pass
    auto put = [&](float* tile, int h, int col, float v0, float v1) {
      store2(tile + (16 * warp + g + 8 * h) * kS + col, v0, v1);
    };
    for (int n = 0; n < n_heads; ++n) {
      const float* bk = bqkv + NH + n * kHead;
      const float* bv = bk + NH;
      const float* bq = bqkv + n * kHead;
      float acc[kQkvN / 2];
      // pass 0: k (j < 8) and v's first 32 columns
      gemm<kQkvN>(acc, kq, it, smem, full, empty, slot);
      hg::named_sync(1 + slot, 128);  // every warp is past the previous head's mix
#pragma unroll
      for (int j = 0; j < kQkvN / 8; ++j) {
        const int c = 8 * (j % 8) + 2 * tq;
        const float2 b01 = *reinterpret_cast<const float2*>((j < 8 ? bk : bv) + c);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          put(j < 8 ? Ks : Vs, h, c, acc[4 * j + 2 * h] + b01.x, acc[4 * j + 2 * h + 1] + b01.y);
      }
      // pass 1: v's last 32 columns (j < 4) and q
      gemm<kQkvN>(acc, kq, it, smem, full, empty, slot);
#pragma unroll
      for (int j = 0; j < kQkvN / 8; ++j) {
        const int c = j < 4 ? 32 + 8 * j + 2 * tq : 8 * (j - 4) + 2 * tq;
        const float2 b01 = *reinterpret_cast<const float2*>((j < 4 ? bv : bq) + c);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v0 = acc[4 * j + 2 * h] + b01.x, v1 = acc[4 * j + 2 * h + 1] + b01.y;
          if (j < 4) {
            put(Vs, h, c, v0, v1);
          } else {
            acc[4 * j + 2 * h] = v0 * inv_scale;
            acc[4 * j + 2 * h + 1] = v1 * inv_scale;
          }
        }
      }
      hg::named_sync(1 + slot, 128);  // the image's k and v tiles are complete
      // q's mix A fragments from the accumulator: element (row g, column
      // 8 kk + tq) lies in lane 4 g + tq / 2, element tq % 2 of its pair
      mix::tf32::Frag qs[kHead / 8];
      const int src0 = (lane & ~3) | (tq >> 1), src1 = src0 + 2;
#pragma unroll
      for (int kk = 0; kk < kHead / 8; ++kk) {
        const float* qv = acc + 4 * (kk + 4);
        float a[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // e: rows g + 8 (e % 2), columns + 4 (e / 2)
          const int src = e < 2 ? src0 : src1, r = 2 * (e & 1);
          const float x0 = __shfl_sync(0xffffffffu, qv[r], src);
          const float x1 = __shfl_sync(0xffffffffu, qv[r + 1], src);
          a[e] = tq & 1 ? x1 : x0;
        }
        mix::tf32::split4(qs[kk], a);
      }
      mix::tf32::fwd_rows<kHead>(qs, Ks, Vs, kS, zimg + n * kHead, NH, 16 * warp, n_valid, kHead,
                                 0, false);
    }
    hg::fence_proxy_async_global();  // this thread's z stores, before the producer's TMA reads
    hg::named_sync(1 + slot, 128);
    if (t == 0) hg::mbar_arrive(zready);

    for (int ct = 0; ct < D / kOutN; ++ct) {
      float acc[kOutN / 2];
      gemm<kOutN>(acc, ko, it, smem, full, empty, slot);
#pragma unroll
      for (int j = 0; j < kOutN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 16 * warp + g + 8 * h;
          if (row < n_valid)
            store2(out + (img * n_tok + row) * D + ct * kOutN + 8 * j + 2 * tq, acc[4 * j + 2 * h],
                   acc[4 * j + 2 * h + 1]);
        }
    }
  }
}

cudaError_t launch(const void* x, const void* Wqkv, const void* bqkv, const void* Wo, void* zbuf,
                   void* out, int batch, int n_tok, int D, int n_heads, float inv_scale,
                   cudaStream_t stream) {
  const int NH = n_heads * kHead;
  // the scratch: z [B, 64, NH], then Wqkv^T's split [2, 3 NH, D] and Wo^T's [2, D, NH]
  float* z = static_cast<float*>(zbuf);
  float* wq = z + static_cast<long long>(batch) * kRows * NH;
  float* wo = wq + 2LL * 3 * NH * D;
  hg::split_k_major_kernel<<<dim3(3 * NH / 32, D / 32, 1), 256, 0, stream>>>(
      static_cast<const float*>(Wqkv), 3 * NH, 0, wq, wq + 3LL * NH * D, D, 3 * NH, QkvCols{NH});
  hg::split_k_major_kernel<<<dim3(D / 32, NH / 32, 1), 256, 0, stream>>>(
      static_cast<const float*>(Wo), D, 0, wo, wo + static_cast<long long>(D) * NH, NH, D,
      hg::SameCols());
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const uint64_t nh = NH, d = D, t = n_tok, b = batch, f = 4;
  CUtensorMap xmap, wmap, zmap, omap;
  const uint64_t xd[3] = {d, t, b}, xs[2] = {d * f, t * d * f};
  const uint64_t wd[3] = {d, 3 * nh, 2}, ws[2] = {d * f, 3 * nh * d * f};
  const uint64_t zd[3] = {nh, t, b}, zs[2] = {nh * f, kRows * nh * f};
  const uint64_t od[3] = {nh, d, 2}, os[2] = {nh * f, d * nh * f};
  const uint32_t abox[3] = {kBK, kRows, 1}, wbox[3] = {kBK, kQkvN, 1}, obox[3] = {kBK, kOutN, 1};
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  if ((err = hg::make_map(&xmap, x, 3, xd, xs, abox, f32)) != cudaSuccess ||
      (err = hg::make_map(&wmap, wq, 3, wd, ws, wbox, f32)) != cudaSuccess ||
      (err = hg::make_map(&zmap, z, 3, zd, zs, abox, f32)) != cudaSuccess ||
      (err = hg::make_map(&omap, wo, 3, od, os, obox, f32)) != cudaSuccess)
    return err;
  if ((err = sae::allow_smem(block_tf32_kernel, kBytes)) != cudaSuccess) return err;
  block_tf32_kernel<<<(batch + kSlots - 1) / kSlots, kThreads, kBytes, stream>>>(
      xmap, wmap, zmap, omap, static_cast<const float*>(bqkv), z, static_cast<float*>(out), batch,
      n_tok, D, n_heads, inv_scale);
  return cudaGetLastError();
}

}  // namespace tf

// ---- bfloat16: TMA, mbarriers and wgmma -------------------------------------

namespace tc {

typedef __nv_bfloat16 bf16;
typedef flash::Geo<bf16, kHead> Geo;
constexpr int kSlots = 2;                  // images a block, one consumer warpgroup each
constexpr int kStages = 4;
constexpr int kN = kQkvCols;               // 192: a head's q, k, v columns; out's column tile
constexpr int kBoxes = kN / hg::kBox;      // weight boxes a stage
constexpr int kThreads = 128 * (kSlots + 1);  // + the producer's warpgroup
constexpr int kABytes = kRows * hg::kBox * 2;  // one image's [64 x 64] A tile
constexpr int kStageBytes = kSlots * kABytes + kBoxes * hg::kBoxBytes;
constexpr int kTilesOffset = kStages * kStageBytes;
constexpr int kBarOffset = kTilesOffset + kSlots * 3 * Geo::tile_bytes;
constexpr int kBytes = kBarOffset + (2 * kStages + 1) * 8 + hg::kSwizzleAlign;
static_assert(kBytes <= static_cast<int>(kMaxSmemBytes), "shared memory");
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Grid (ceil(B / kSlots)); kThreads threads; kBytes of dynamic shared memory.
// xmap: x [B, n_tok, D] in boxes [1 x 64 x 64]; wmap: Wqkv [D, 3 NH] in
// [64 x 64]; zmap: the z scratch [B, 64, NH] in [1 x 64 x 64] (stored and
// loaded); omap: Wo [NH, D] in [64 x 64]; outmap: out [B, n_tok, D] in
// [1 x 64 x 64] (stored).
__global__ void __launch_bounds__(kThreads, 1)
block_tc_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                const __grid_constant__ CUtensorMap zmap, const __grid_constant__ CUtensorMap omap,
                const __grid_constant__ CUtensorMap outmap, const bf16* __restrict__ bqkv,
                int batch, int n_tok, int D, int n_heads, float inv_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + hg::kSwizzleAlign - 1) &
      ~static_cast<uintptr_t>(hg::kSwizzleAlign - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOffset);
  uint64_t* empty = full + kStages;
  uint64_t* zready = empty + kStages;  // each slot's z tiles are in device memory
  const int NH = n_heads * kHead;
  const int img0 = blockIdx.x * kSlots;
  const int n_img = min(kSlots, batch - img0);
  const int kq = D / hg::kBox, ko = NH / hg::kBox, n_ct = (D + kN - 1) / kN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      hg::mbar_init(&full[i], 1);
      hg::mbar_init(&empty[i], 4 * kSlots);  // one arrive a consumer warp
    }
    hg::mbar_init(zready, kSlots);
    hg::fence_barrier_init();
  }
  __syncthreads();

  if (wg == kSlots) {  // the producer: one thread issues every copy
    hg::reg_dealloc<40>();
    if (threadIdx.x == 128 * kSlots) {
      int it = 0;
      // Take the next stage of the ring; returns its base.
      auto next_stage = [&](int& st) {
        st = it % kStages;
        const int round = it / kStages;
        if (round > 0) hg::mbar_wait(&empty[st], (round - 1) & 1);
        hg::mbar_expect_tx(&full[st], n_img * kABytes + kBoxes * hg::kBoxBytes);
        ++it;
        return smem + st * kStageBytes;
      };
      // box s of a weight tile: columns c0, rows k0
      auto load_weights = [&](unsigned char* stage, const CUtensorMap* map, int st, int s, int c0,
                              int k0) {
        hg::tma_load_2d(stage + kSlots * kABytes + s * hg::kBoxBytes, map, &full[st], c0, k0);
      };
      for (int n = 0; n < n_heads; ++n)
        for (int kt = 0; kt < kq; ++kt) {
          int st;
          unsigned char* stage = next_stage(st);
          for (int i = 0; i < n_img; ++i)
            hg::tma_load_3d(stage + i * kABytes, &xmap, &full[st], kt * hg::kBox, 0, img0 + i);
#pragma unroll
          for (int s = 0; s < kBoxes; ++s)  // the head's q, k and v columns
            load_weights(stage, &wmap, st, s, s * NH + n * kHead, kt * hg::kBox);
        }
      hg::mbar_wait(zready, 0);
      for (int ct = 0; ct < n_ct; ++ct)
        for (int kt = 0; kt < ko; ++kt) {
          int st;
          unsigned char* stage = next_stage(st);
          for (int i = 0; i < n_img; ++i)
            hg::tma_load_3d(stage + i * kABytes, &zmap, &full[st], kt * hg::kBox, 0, img0 + i);
#pragma unroll
          for (int s = 0; s < kBoxes; ++s)
            load_weights(stage, &omap, st, s, ct * kN + s * hg::kBox, kt * hg::kBox);
        }
    }
  } else {  // consumer warpgroup wg: image img0 + wg
    hg::reg_alloc<232>();
    const int slot = wg;
    const long long img = img0 + slot;
    const int t = threadIdx.x % 128, warp = t / 32, lane = t & 31, g = lane >> 2, tq = lane & 3;
    bf16* qs = reinterpret_cast<bf16*>(smem + kTilesOffset) + slot * 3 * Geo::tile;
    bf16* ks = qs + Geo::tile;
    bf16* vs = ks + Geo::tile;
    int it = 0;
    auto release = [&](int st) {  // one arrive a consumer warp
      if (lane == 0) hg::mbar_arrive(&empty[st]);
    };
    // acc = A B over nk stages of the ring: A this slot's tile, B the
    // stage's weight boxes
    auto gemm = [&](float (&acc)[kN / 2], int nk) {  // the first products overwrite acc
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int st = it % kStages;
        hg::mbar_wait(&full[st], (it / kStages) & 1);
        const unsigned char* stage = smem + st * kStageBytes;
        const bf16* As = reinterpret_cast<const bf16*>(stage + slot * kABytes);
        const bf16* Bs = reinterpret_cast<const bf16*>(stage + kSlots * kABytes);
        hg::fence_acc(acc);
        hg::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < hg::kBox / 16; ++kk)
          hg::mma_ss<kN>(acc, hg::desc_a(As, kk), hg::desc_b(Bs, kk), kt > 0 || kk > 0);
        hg::wgmma_commit();
        hg::wgmma_wait<1>();  // the previous stage's products are done
        hg::fence_acc(acc);
        if (kt > 0) release((it - 1) % kStages);
      }
      hg::wgmma_wait<0>();
      hg::fence_acc(acc);
      release((it - 1) % kStages);
    };

    // this slot's 64 x 64 z tile and 64 x 192 out tile go to device memory by
    // TMA store from 128-byte swizzled staging: z in the k tile's place
    // (free once every warp has its scores), out in the q, k, v tiles'
    unsigned char* zstage = reinterpret_cast<unsigned char*>(ks);
    unsigned char* ostage = reinterpret_cast<unsigned char*>(qs);
    for (int n = 0; n < n_heads; ++n) {
      // the head's q, k, v biases (pairs of columns), loaded under the GEMM
      __nv_bfloat162 bias[kN / 8];
#pragma unroll
      for (int j = 0; j < kN / 8; ++j)
        bias[j] = *reinterpret_cast<const __nv_bfloat162*>(bqkv + j / 8 * NH + n * kHead +
                                                            8 * (j % 8) + 2 * tq);
      float acc[kN / 2];
      gemm(acc, kq);
      if (t == 0) hg::bulk_wait_read();  // the previous head's z store has left the k tile
      hg::named_sync(1 + slot, 128);     // every warp is past the previous head's mix
      // bias, rounding, q's scale: the head's q, k, v tiles
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        const int s = j / 8, c = 8 * (j % 8) + 2 * tq;
        const float2 b01 = __bfloat1622float2(bias[j]);
        bf16* tile = qs + s * Geo::tile;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 16 * warp + g + 8 * h;
          float v0 = round_to<bf16>(acc[4 * j + 2 * h] + b01.x);
          float v1 = round_to<bf16>(acc[4 * j + 2 * h + 1] + b01.y);
          if (s == 0) {
            v0 *= inv_scale;
            v1 *= inv_scale;
          }
          store2(tile + row * Geo::stride + c, v0, v1);
        }
      }
      hg::named_sync(1 + slot, 128);
      // the mix: this warp's 16 query rows against the image's 64 keys
      float sc[8][4];
      flash::zero(sc);
      flash::nt<kHead>(sc, qs + warp * 16 * Geo::stride, ks, nullptr);
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (8 * j + 2 * tq + (e & 1) >= n_tok) sc[j][e] = -INFINITY;  // padding keys
          m[e >> 1] = fmaxf(m[e >> 1], sc[j][e]);
        }
      float nb[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // a row's 64 scores lie in the 4 lanes of its quad
        m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
        m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
        nb[h] = -m[h] * kLog2e;
      }
      // p = exp(s - m) / l as B1's bf16 kernel takes it: ex2 of s log2(e) -
      // m log2(e) on the SFUs, times 1 / l
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[j][e] = ex2(fmaf(sc[j][e], kLog2e, nb[e >> 1]));  // 0 where masked
          l[e >> 1] += sc[j][e];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        l[h] = 1.f / l[h];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] *= l[e >> 1];
      hg::named_sync(1 + slot, 128);  // every warp is done with k
      float zc[kHead / 8][4];
      flash::zero(zc);
      flash::pn<kHead>(zc, sc, vs, nullptr);  // rounds p to bf16
#pragma unroll
      for (int j = 0; j < kHead / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 16 * warp + g + 8 * h;
          store2(reinterpret_cast<bf16*>(zstage + hg::sw128(row, j) + 4 * tq), zc[j][2 * h],
                 zc[j][2 * h + 1]);
        }
      hg::fence_proxy_async_smem();
      hg::named_sync(1 + slot, 128);
      if (t == 0) {
        hg::tma_store_3d(&zmap, zstage, n * kHead, 0, static_cast<int>(img));
        hg::bulk_commit();
      }
    }
    if (t == 0) {  // z is in device memory before the producer's TMA reads it
      hg::bulk_wait();
      hg::fence_proxy_async_global();
      hg::mbar_arrive(zready);
    }

    for (int ct = 0; ct < n_ct; ++ct) {
      float acc[kN / 2];
      gemm(acc, ko);
      if (t == 0) hg::bulk_wait_read();  // the previous tile's store has left the staging
      hg::named_sync(1 + slot, 128);     // and every warp is past the last mix
#pragma unroll
      for (int j = 0; j < kN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 16 * warp + g + 8 * h;
          store2(reinterpret_cast<bf16*>(ostage + j / 8 * hg::kBoxBytes + hg::sw128(row, j % 8) +
                                         4 * tq),
                 acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      hg::fence_proxy_async_smem();
      hg::named_sync(1 + slot, 128);
      if (t == 0) {  // rows past T and columns past D are not written
#pragma unroll
        for (int s = 0; s < kBoxes; ++s)
          hg::tma_store_3d(&outmap, ostage + s * hg::kBoxBytes, ct * kN + s * hg::kBox, 0,
                           static_cast<int>(img));
        hg::bulk_commit();
      }
    }
    if (t == 0) hg::bulk_wait_read();  // the staging outlives the last store's reads
  }
}

cudaError_t launch(const void* x, const void* Wqkv, const void* bqkv, const void* Wo, void* zbuf,
                   void* out, int batch, int n_tok, int D, int n_heads, float inv_scale,
                   cudaStream_t stream) {
  const uint64_t NH = static_cast<uint64_t>(n_heads) * kHead, d = D, t = n_tok, b = batch;
  const uint32_t box2[2] = {hg::kBox, hg::kBox}, box3[3] = {hg::kBox, kRows, 1};
  CUtensorMap xmap, wmap, zmap, omap, outmap;
  const uint64_t xd[3] = {d, t, b}, xs[2] = {d * 2, t * d * 2};
  const uint64_t wd[2] = {3 * NH, d}, ws[1] = {3 * NH * 2};
  const uint64_t zd[3] = {NH, kRows, b}, zs[2] = {NH * 2, kRows * NH * 2};
  const uint64_t od[2] = {d, NH}, os[1] = {d * 2};
  cudaError_t err;
  if ((err = hg::make_map(&xmap, x, 3, xd, xs, box3)) != cudaSuccess ||
      (err = hg::make_map(&wmap, Wqkv, 2, wd, ws, box2)) != cudaSuccess ||
      (err = hg::make_map(&zmap, zbuf, 3, zd, zs, box3)) != cudaSuccess ||
      (err = hg::make_map(&omap, Wo, 2, od, os, box2)) != cudaSuccess ||
      (err = hg::make_map(&outmap, out, 3, xd, xs, box3)) != cudaSuccess)
    return err;
  if ((err = sae::allow_smem(block_tc_kernel, kBytes)) != cudaSuccess) return err;
  block_tc_kernel<<<(batch + kSlots - 1) / kSlots, kThreads, kBytes, stream>>>(
      xmap, wmap, zmap, omap, outmap, static_cast<const bf16*>(bqkv), batch, n_tok, D, n_heads,
      inv_scale);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// x [batch, n_tok, D], Wqkv [D, 3*NH], bqkv [3*NH], Wo [NH, D], out
// [batch, n_tok, D], NH = n_heads * 64; zbuf: scratch of the dtype, z
// [batch, 64, NH] and, float32 only, the weights' split K-major copies
// (2 x 3 NH x D, then 2 x D x NH floats); inv_scale already rounded to the
// dtype (0 = float32, 1 = bfloat16).  Every pointer 16-byte aligned.
// Returns the launches' cudaError_t.
extern "C" int attention_block_fwd(const void* x, const void* Wqkv, const void* bqkv,
                                   const void* Wo, void* zbuf, void* out, int batch, int n_tok,
                                   int D, int n_heads, float inv_scale, int dtype, int device,
                                   void* stream) {
  if (batch <= 0 || n_tok <= 0 || n_tok > kRows || n_heads <= 0 || D <= 0 || D % 128)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return tf::launch(x, Wqkv, bqkv, Wo, zbuf, out, batch, n_tok, D, n_heads, inv_scale, s);
  if (dtype == 1)
    return tc::launch(x, Wqkv, bqkv, Wo, zbuf, out, batch, n_tok, D, n_heads, inv_scale, s);
  return cudaErrorInvalidValue;
}
