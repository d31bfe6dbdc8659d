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
// float32 (block_f32_kernel, CUDA cores: FFMA, as TF32 would round the
// inputs).  One block of 8 warps per image, its T <= 64 token rows padded
// to 64 (rows past T read row T - 1 of x; their keys are masked and their
// outputs not stored); for each head a [64 x 192] GEMM over K = D through a
// 3-stage cp.async ring of 32-deep tiles, the epilogue leaving q, k, v in
// shared memory, warps 0-3 running the mix into the same z scratch; then
// out = z Wo in 128-column tiles.
//
// Every element of out is summed by one thread in a fixed order: no
// atomics, so the result does not depend on scheduling.  Shared memory:
// bfloat16 220,232 bytes (4 stages of 40 KB, both images' q, k, v tiles,
// the barriers and the swizzle's alignment), float32 172,544; one block an
// SM either way.  The gate (vit_prisma_tpu_torch/ops/attention.py,
// attn_block_fits_smem) takes T <= 64, H = 64, D a multiple of 128: CLIP
// ViT-B/32 (T 50, D 768, N 12) in both dtypes; CLIP L/14 (T 257) is past it.

#include "flash_tile.cuh"
#include "hopper_gemm.cuh"

namespace {

using sae::from_f;
using sae::store2;
using sae::to_f;

constexpr int kHead = 64;   // head width
constexpr int kRows = 64;   // token rows a block holds
constexpr int kThreads = 256;
constexpr int kWarpsM = 2, kWarpsN = 4;
constexpr int kWM = kRows / kWarpsM;  // 32 rows a warp
constexpr int kMI = kWM / 16;
constexpr int kBK = 32;
constexpr int kStages = 3;
constexpr int kQkvCols = 3 * kHead;  // one head's q, k and v columns
constexpr int kOutCols = 128;        // columns of out a tile
constexpr int kMixWarps = 4;         // warps of the mix, 16 query rows each
constexpr size_t kMaxSmemBytes = 232448;

template <typename T, int BN>
struct Gemm {
  static constexpr int pad = 16 / static_cast<int>(sizeof(T));
  static constexpr int a_stride = kBK + pad;  // A tile [kRows][kBK]
  static constexpr int b_stride = BN + pad;   // B tile [kBK][BN]
  static constexpr int a_elems = kRows * a_stride;
  static constexpr int stage = a_elems + kBK * b_stride;
  static constexpr int bytes = kStages * stage * static_cast<int>(sizeof(T));
  static constexpr int WN = BN / kWarpsN;  // columns a warp
  static constexpr int NI = WN / 8;
};

template <typename T>
constexpr int smem_bytes() {
  return Gemm<T, kQkvCols>::bytes + 3 * flash::Geo<T, kHead>::tile_bytes +
         (sizeof(T) == 4 ? kMixWarps * 16 * flash::kPStride * 4 : 0);
}
static_assert(Gemm<float, kQkvCols>::bytes >= Gemm<float, kOutCols>::bytes, "staging");

__device__ __forceinline__ int warp_m0() { return (threadIdx.x / 32) / kWarpsN * kWM; }

// One kBK slice of products on the CUDA cores, into the mma.sync C-fragment
// layout (A rows K-contiguous, B rows N-contiguous).
template <int BN>
__device__ __forceinline__ void compute_stage(float (&acc)[kMI][Gemm<float, BN>::NI][4],
                                              const float* As, const float* Bs) {
  typedef Gemm<float, BN> G;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wm0 = warp_m0(), wn0 = (threadIdx.x / 32) % kWarpsN * G::WN;
#pragma unroll 4
  for (int k = 0; k < kBK; ++k) {
    float a[kMI][2], b[G::NI][2];
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) a[mi][h] = As[(wm0 + 16 * mi + g + 8 * h) * G::a_stride + k];
#pragma unroll
    for (int ni = 0; ni < G::NI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) b[ni][h] = Bs[k * G::b_stride + wn0 + 8 * ni + 2 * t + h];
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int ni = 0; ni < G::NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mi][ni][e] = fmaf(a[mi][e / 2], b[ni][e % 2], acc[mi][ni][e]);
  }
}

// acc = A[0:64, 0:K] B[0:K, cols], zeroed first.  A row r at A + min(r,
// a_rows - 1) * lda; the BN columns of B are BN/64 runs of 64, run s
// starting at column cols[s] (row k at B + k * ldb).  Ends with every thread
// past a barrier and no copy in flight, so the caller may reuse the staging.
template <typename T, int BN>
__device__ __forceinline__ void gemm(float (&acc)[kMI][Gemm<T, BN>::NI][4], const T* __restrict__ A,
                                     long long lda, int a_rows, const T* __restrict__ B,
                                     long long ldb, const long long (&cols)[BN / kHead], int K,
                                     T* smem) {
  typedef Gemm<T, BN> G;
  constexpr int vec = 16 / static_cast<int>(sizeof(T));
  constexpr int a_chunks = kBK / vec;  // 16-byte copies a row of the A tile
  constexpr int b_chunks = BN / vec;
  constexpr int run_chunks = kHead / vec;
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < G::NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  const int ktiles = K / kBK;
  auto load = [&](int stage, int kt) {
    T* As = smem + stage * G::stage;
    T* Bs = As + G::a_elems;
    const int k0 = kt * kBK;
    for (int i = threadIdx.x; i < kRows * a_chunks; i += kThreads) {
      const int r = i / a_chunks, c = (i % a_chunks) * vec;
      sae::cp_async16(As + r * G::a_stride + c, A + min(r, a_rows - 1) * lda + k0 + c);
    }
    for (int i = threadIdx.x; i < kBK * b_chunks; i += kThreads) {
      const int r = i / b_chunks, cc = i % b_chunks;
      const int s = cc / run_chunks, c = (cc % run_chunks) * vec;
      sae::cp_async16(Bs + r * G::b_stride + s * kHead + c,
                      B + static_cast<long long>(k0 + r) * ldb + cols[s] + c);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load(s, s);
    sae::cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    sae::cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < ktiles) load(next % kStages, next);
    sae::cp_async_commit();
    const T* As = smem + (kt % kStages) * G::stage;
    compute_stage<BN>(acc, As, As + G::a_elems);
  }
  sae::cp_async_wait<0>();
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// float32 (instantiated for T = float only).  Grid (B); kThreads threads;
// smem_bytes<T>() of dynamic shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads)
block_f32_kernel(const T* __restrict__ x, const T* __restrict__ Wqkv,
                       const T* __restrict__ bqkv, const T* __restrict__ Wo,
                       T* __restrict__ zbuf, T* __restrict__ out, int n_tok, int D,
                       int n_heads, float inv_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  typedef flash::Geo<T, kHead> Geo;
  T* staging = reinterpret_cast<T*>(smem_raw);
  T* qkv_s = reinterpret_cast<T*>(smem_raw + Gemm<T, kQkvCols>::bytes);  // q, k, v tiles
  float* pbuf = reinterpret_cast<float*>(smem_raw + Gemm<T, kQkvCols>::bytes +
                                         3 * Geo::tile_bytes);
  const int NH = n_heads * kHead;
  const long long b = blockIdx.x;
  const T* xb = x + b * n_tok * D;
  T* zb = zbuf + b * kRows * NH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wm0 = warp_m0();

  for (int n = 0; n < n_heads; ++n) {
    typedef Gemm<T, kQkvCols> G;
    float acc[kMI][G::NI][4];
    const long long cols[3] = {n * kHead, NH + n * kHead, 2LL * NH + n * kHead};
    gemm<T, kQkvCols>(acc, xb, D, n_tok, Wqkv, 3LL * NH, cols, D, staging);
    // bias, rounding, q's scale: the head's q, k, v tiles
    const int wn0 = warp % kWarpsN * G::WN;
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int ni = 0; ni < G::NI; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = wm0 + 16 * mi + g + 8 * h, col = wn0 + 8 * ni + 2 * t;
          const int s = col / kHead, c = col % kHead;
          const T* bias = bqkv + s * NH + n * kHead + c;
          float v0 = round_to<T>(acc[mi][ni][2 * h] + to_f(bias[0]));
          float v1 = round_to<T>(acc[mi][ni][2 * h + 1] + to_f(bias[1]));
          if (s == 0) {
            v0 *= inv_scale;
            v1 *= inv_scale;
          }
          store2(qkv_s + s * Geo::tile + row * Geo::stride + c, v0, v1);
        }
    __syncthreads();
    if (warp < kMixWarps) {
      float sc[8][4];
      flash::zero(sc);
      float* pw = pbuf + warp * 16 * flash::kPStride;
      flash::nt<kHead>(sc, qkv_s + warp * 16 * Geo::stride, qkv_s + Geo::tile, pw);
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (8 * j + 2 * t + (e & 1) >= n_tok) sc[j][e] = -INFINITY;  // padding keys
          m[e >> 1] = fmaxf(m[e >> 1], sc[j][e]);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // a row's 64 scores lie in the 4 lanes of its quad
        m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
        m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[j][e] = expf(sc[j][e] - m[e >> 1]);  // 0 where masked
          l[e >> 1] += sc[j][e];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = sc[j][e] / l[e >> 1];
      float zc[kHead / 8][4];
      flash::zero(zc);
      flash::pn<kHead>(zc, sc, qkv_s + 2 * Geo::tile, pw);  // rounds p to T
      T* zrow = zb + static_cast<long long>(warp * 16 + g) * NH + n * kHead + 2 * t;
#pragma unroll
      for (int j = 0; j < kHead / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          store2(zrow + static_cast<long long>(8 * h) * NH + 8 * j, zc[j][2 * h], zc[j][2 * h + 1]);
    }
    // the next head's GEMM passes a barrier before its epilogue rewrites
    // the q, k, v tiles, and touches only the staging before it
  }
  __syncthreads();  // this block's z rows are in the scratch

  typedef Gemm<T, kOutCols> G;
  const int wn0 = warp % kWarpsN * G::WN;
  for (int n0 = 0; n0 < D; n0 += kOutCols) {
    float acc[kMI][G::NI][4];
    const long long cols[2] = {n0, n0 + kHead};
    gemm<T, kOutCols>(acc, zb, NH, kRows, Wo, D, cols, NH, staging);
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm0 + 16 * mi + g + 8 * h;
        if (row >= n_tok) continue;
        T* orow = out + (b * n_tok + row) * D + n0 + wn0 + 2 * t;
#pragma unroll
        for (int ni = 0; ni < G::NI; ++ni)
          store2(orow + 8 * ni, acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
  }
}

cudaError_t launch_f32(const void* x, const void* Wqkv, const void* bqkv, const void* Wo,
                       void* zbuf, void* out, int batch, int n_tok, int D, int n_heads,
                       float inv_scale, cudaStream_t stream) {
  auto kernel = block_f32_kernel<float>;
  cudaError_t err = sae::allow_smem(kernel, smem_bytes<float>());
  if (err != cudaSuccess) return err;
  kernel<<<batch, kThreads, smem_bytes<float>(), stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(Wqkv),
      static_cast<const float*>(bqkv), static_cast<const float*>(Wo), static_cast<float*>(zbuf),
      static_cast<float*>(out), n_tok, D, n_heads, inv_scale);
  return cudaGetLastError();
}

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

// x [batch, n_tok, D], Wqkv [D, 3*NH], bqkv [3*NH], Wo [NH, D], zbuf
// [batch, 64, NH], out [batch, n_tok, D], NH = n_heads * 64; inv_scale
// already rounded to the dtype (0 = float32, 1 = bfloat16).  Every pointer
// 16-byte aligned.  Returns the launch's cudaError_t.
extern "C" int attention_block_fwd(const void* x, const void* Wqkv, const void* bqkv,
                                   const void* Wo, void* zbuf, void* out, int batch, int n_tok,
                                   int D, int n_heads, float inv_scale, int dtype, int device,
                                   void* stream) {
  if (batch <= 0 || n_tok <= 0 || n_tok > kRows || n_heads <= 0 || D <= 0 || D % kOutCols ||
      static_cast<size_t>(smem_bytes<float>()) > kMaxSmemBytes)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(x, Wqkv, bqkv, Wo, zbuf, out, batch, n_tok, D, n_heads, inv_scale, s);
  if (dtype == 1)
    return tc::launch(x, Wqkv, bqkv, Wo, zbuf, out, batch, n_tok, D, n_heads, inv_scale, s);
  return cudaErrorInvalidValue;
}
