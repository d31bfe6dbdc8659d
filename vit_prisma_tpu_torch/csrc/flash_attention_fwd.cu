// Flash attention, forward: z = softmax(q k^T + mask) v per (batch item,
// head) over head-major [B, N, Tp, H] tensors, tiled over keys with an
// online softmax, so that any token count fits.
//
// Replaces the Pallas TPU kernel that `_flash_call` in
// vit_prisma_tpu/ops/attention.py launches through the library's
// `flash_attention` (jax/experimental/pallas/ops/tpu/flash_attention.py),
// the forward of kernel B13 of the ROADMAP.  Same contract: q is pre-scaled
// (sm_scale 1), Tp is padded by the caller, seg [B, Tp] int32 holds segment
// ids and q row i sees key j only where seg[i] == seg[j] (and j <= i when
// causal); scores, the running max m and sum l and the accumulator are
// float32; p = exp(s - m) is rounded to v's dtype before the PV product; z is
// stored in q's dtype.  Each row's log-sum-exp m + log l is written to lse
// [B, N, Tp] (float32) for the backward (flash_attention_bwd.cu).
//
// What bounds it on an H100.  At CLIP ViT-L/14-336 serving (B 64, N 16, Tp
// 640, H 64) a head's products are 4 Tp^2 H flops against 4 Tp H elements
// moved: ~T flops per element, well above the ~295 flops a byte where the
// bf16 tensor cores, not memory, are the limit.  So the products must run on
// the tensor cores and the Tp x Tp scores must stay on the SM.
//
// Design (FlashAttention-2's, simple first; wgmma and TMA come later):
//  * one block of 4 warps per (64 query rows, head, batch item); each warp
//    owns 16 rows, so the row max and sum are reduced over the 4 lanes of a
//    quad (flash_tile.cuh's C-fragment layout);
//  * the Q tile stays in shared memory; K and V tiles of 64 keys stream
//    through a two-deep cp.async ring, the next pair loading while the
//    current one is used; a causal block stops at its last row's tile;
//  * s = Q K^T and z += P V with mma.sync m16n8k16 in bf16 (P passes from
//    the score registers to the product's A fragments directly), FFMA in
//    float32;
//  * a fully masked key tile leaves m at -inf: the row then subtracts 0, not
//    m, so exp gives 0 and no NaN, and the rescale of the running sums by
//    exp(m_old - m_new) is exact when m_old is -inf.  Padding rows (their own
//    segment id) see only padding keys and stay finite;
//  * z = acc / l at the end; a row that saw no key (impossible with segment
//    ids, kept for safety) stores 0 and lse = +inf, so its backward p is 0.

#include "flash_tile.cuh"

#include <math.h>

namespace {

using namespace flash;

// Online softmax over one tile's scores s (C-fragment layout; rows g, g + 8):
// masks, updates m and l (per-thread partial sums), rescales acc and turns s
// into p = exp(s - m).
template <int NO>
__device__ __forceinline__ void online_softmax(float (&s)[8][4], float (&acc)[NO][4],
                                               float (&m)[2], float (&l)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[h], mx);
    const float base = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = expf(m[h] - base);  // 0 when m[h] is -inf
    m[h] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = expf(s[j][2 * h + e] - base);
        s[j][2 * h + e] = p;
        sum += p;
      }
    l[h] = l[h] * alpha + sum;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      acc[j][2 * h] *= alpha;
      acc[j][2 * h + 1] *= alpha;
    }
  }
}

// Grid (Tp / 64, N, B), kThreads threads.  Shared: Q, then two (K, V) pairs,
// then the float32 P buffers, then two tiles of key segment ids.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const int* __restrict__ seg, T* __restrict__ z, float* __restrict__ lse,
                     int n_heads, int n_tok, int causal) {
  typedef Geo<T, HD> G;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* KV = Qs + G::tile;  // K0, V0, K1, V1
  float* pbuf = reinterpret_cast<float*>(KV + 4 * G::tile);
  int* segs = reinterpret_cast<int*>(smem_raw + smem_bytes<T, HD>(5, 0));  // [2][64]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, n = blockIdx.y, i0 = blockIdx.x * kTile;
  const long long head = (static_cast<long long>(b) * n_heads + n) * n_tok;
  const T* kh = k + head * HD;
  const T* vh = v + head * HD;
  const int* sb = seg + static_cast<long long>(b) * n_tok;
  const int row[2] = {i0 + 16 * warp + g, i0 + 16 * warp + g + 8};
  const int seg_q[2] = {sb[row[0]], sb[row[1]]};
  const int n_kt = causal ? blockIdx.x + 1 : n_tok / kTile;

  auto load_kv = [&](int kt) {
    T* Ks = KV + 2 * (kt & 1) * G::tile;
    load_tile<T, HD>(Ks, kh + static_cast<long long>(kt) * kTile * HD);
    load_tile<T, HD>(Ks + G::tile, vh + static_cast<long long>(kt) * kTile * HD);
    if (threadIdx.x < kTile) segs[(kt & 1) * kTile + threadIdx.x] = sb[kt * kTile + threadIdx.x];
  };
  load_tile<T, HD>(Qs, q + (head + i0) * HD);
  load_kv(0);
  sae::cp_async_commit();

  float acc[HD / 8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  zero(acc);
  const T* Qw = Qs + 16 * warp * G::stride;
  float* pw = pbuf + warp * 16 * kPStride;
  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) {
      load_kv(kt + 1);
      sae::cp_async_commit();
      sae::cp_async_wait<1>();
    } else {
      sae::cp_async_wait<0>();
    }
    __syncthreads();
    const T* Ks = KV + 2 * (kt & 1) * G::tile;
    const int* sk = segs + (kt & 1) * kTile;
    float s[8][4];
    zero(s);
    nt<HD>(s, Qw, Ks, pw);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 8 * j + 2 * t + (e & 1);
        const bool ok = sk[key] == seg_q[e >> 1] && (!causal || kt * kTile + key <= row[e >> 1]);
        if (!ok) s[j][e] = -INFINITY;
      }
    online_softmax<HD / 8>(s, acc, m, l);
    pn<HD>(acc, s, Ks + G::tile, pw);
    __syncthreads();  // every warp is done with this pair before it is reloaded
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = l[h] > 0.f ? 1.f / l[h] : 0.f;
  }
  store_rows<T, HD>(z + (head + i0 + 16 * warp) * HD, acc, inv);
  if (t == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h) lse[head + row[h]] = l[h] > 0.f ? m[h] + logf(l[h]) : INFINITY;
}

template <typename T, int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, const int* seg, void* z,
                      float* lse, int batch, int n_heads, int n_tok, int causal,
                      cudaStream_t stream) {
  const int bytes = smem_bytes<T, HD>(5, 2 * kTile * sizeof(int));
  auto kernel = flash_fwd_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(n_tok / kTile, n_heads, batch), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), seg,
      static_cast<T*>(z), lse, n_heads, n_tok, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const int* seg, void* z,
                   float* lse, int batch, int n_heads, int n_tok, int d_head, int causal,
                   cudaStream_t stream) {
  switch (d_head) {
#define VPT_CASE(HD) \
  case HD:           \
    return launch_hd<T, HD>(q, k, v, seg, z, lse, batch, n_heads, n_tok, causal, stream);
    VPT_CASE(16) VPT_CASE(32) VPT_CASE(48) VPT_CASE(64)
    VPT_CASE(80) VPT_CASE(96) VPT_CASE(112) VPT_CASE(128)
#undef VPT_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, z: [batch, n_heads, n_tok, d_head]; seg: [batch, n_tok] int32;
// lse: [batch, n_heads, n_tok] float32.  n_tok a multiple of 64; d_head a
// multiple of 16 up to 128.  dtype: 0 = float32, 1 = bfloat16.  Returns the
// launch's cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, const void* seg,
                                   void* z, void* lse, int batch, int n_heads, int n_tok,
                                   int d_head, int causal, int dtype, int device, void* stream) {
  if (batch <= 0 || batch > 65535 || n_heads <= 0 || n_heads > 65535 || n_tok <= 0 ||
      n_tok % flash::kTile || d_head <= 0 || d_head > 128 || d_head % 16)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* sg = static_cast<const int*>(seg);
  float* ls = static_cast<float*>(lse);
  if (dtype == 0)
    return launch<float>(q, k, v, sg, z, ls, batch, n_heads, n_tok, d_head, causal, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, sg, z, ls, batch, n_heads, n_tok, d_head, causal, s);
  return cudaErrorInvalidValue;
}
