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
// All three products are here: bfloat16 runs them on the tensor cores
// (mma.sync m16n8k16, float32 accumulation), float32 on the CUDA cores
// (FFMA; TF32 would round the inputs).
//
// Design (simple and right first):
//  * one block of 8 warps per image, its T <= 64 token rows padded to 64:
//    rows past T read row T - 1 of x (finite values), their keys are masked
//    to -inf and their outputs are not stored;
//  * for each head n: a [64 x 192] GEMM over K = D, x and the head's 192
//    Wqkv columns streamed through a 3-stage cp.async ring of 32-deep tiles
//    (x stays in L2 across heads), whose epilogue adds the bias, rounds, and
//    leaves the head's q, k and v in shared memory; then warps 0-3 each take
//    16 query rows through flash_tile.cuh's s = q k^T and p v fragments and
//    write z_n, rounded, into this image's rows of a [B, 64, N*H] scratch in
//    device memory (it too stays in L2);
//  * then out = z Wo in 128-column tiles over K = N*H, the same GEMM loop
//    streaming z and Wo, one rounding at the end.
// The scratch is what lets both dtypes fit: holding all of z in shared
// memory takes 64 x 768 x 4 = 196,608 bytes in float32 at CLIP ViT-B/32,
// which leaves no room for a head's q, k, v and the GEMM staging, and an
// out accumulator of the same size does not fit the registers.  Every
// element of out is summed by one thread in a fixed order: no atomics, so
// the result does not depend on scheduling.
//
// Shared memory: the larger GEMM's staging (3 stages of a [64 x 32] A tile
// and a [32 x 192] B tile, rows padded by 16 bytes), three [64 x 64] q, k, v
// tiles padded likewise, and in float32 the P buffers of flash_tile.cuh:
// 81,408 bytes in bfloat16 (two blocks an SM), 172,544 in float32, whatever
// the model's widths.  The gate (vit_prisma_tpu_torch/ops/attention.py,
// attn_block_fits_smem) takes T <= 64, H = 64, D a multiple of 128: CLIP
// ViT-B/32 (T 50, D 768, N 12) in both dtypes; CLIP L/14 (T 257) is past it.

#include "flash_tile.cuh"

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

// One kBK slice of products: tensor cores for bfloat16 (A rows K-contiguous,
// B rows N-contiguous, as sae_gemm.cuh's compute_stage<true, false>).
template <int BN>
__device__ __forceinline__ void compute_stage(float (&acc)[kMI][Gemm<__nv_bfloat16, BN>::NI][4],
                                              const __nv_bfloat16* As, const __nv_bfloat16* Bs) {
  typedef Gemm<__nv_bfloat16, BN> G;
  const int lane = threadIdx.x & 31;
  const int wm0 = warp_m0(), wn0 = (threadIdx.x / 32) % kWarpsN * G::WN;
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    uint32_t a[kMI][4], b[G::NI][2];
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
      sae::ldsm_x4(a[mi], As + (wm0 + 16 * mi + (lane & 15)) * G::a_stride + kk + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < G::NI / 2; ++np) {
      uint32_t r[4];
      sae::ldsm_x4_t(r, Bs + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * G::b_stride + wn0 +
                            16 * np + (lane >> 4) * 8);
      b[2 * np][0] = r[0];
      b[2 * np][1] = r[1];
      b[2 * np + 1][0] = r[2];
      b[2 * np + 1][1] = r[3];
    }
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int ni = 0; ni < G::NI; ++ni) sae::mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
  }
}

// The same in float32 on the CUDA cores, into the same fragment layout.
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

// Grid (B); kThreads threads; smem_bytes<T>() of dynamic shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_block_kernel(const T* __restrict__ x, const T* __restrict__ Wqkv,
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

template <typename T>
cudaError_t launch(const void* x, const void* Wqkv, const void* bqkv, const void* Wo, void* zbuf,
                   void* out, int batch, int n_tok, int D, int n_heads, float inv_scale,
                   cudaStream_t stream) {
  auto kernel = attention_block_kernel<T>;
  cudaError_t err = sae::allow_smem(kernel, smem_bytes<T>());
  if (err != cudaSuccess) return err;
  kernel<<<batch, kThreads, smem_bytes<T>(), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(Wqkv), static_cast<const T*>(bqkv),
      static_cast<const T*>(Wo), static_cast<T*>(zbuf), static_cast<T*>(out), n_tok, D, n_heads,
      inv_scale);
  return cudaGetLastError();
}

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
    return launch<float>(x, Wqkv, bqkv, Wo, zbuf, out, batch, n_tok, D, n_heads, inv_scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, Wqkv, bqkv, Wo, zbuf, out, batch, n_tok, D, n_heads,
                                 inv_scale, s);
  return cudaErrorInvalidValue;
}
