// Flash attention, backward: dq, dk and dv of z = softmax(q k^T + mask) v
// over head-major [B, N, Tp, H] tensors, in two passes that recompute p.
//
// Replaces the Pallas TPU kernels that the VJP of `flash_attention_padded`
// in vit_prisma_tpu/ops/attention.py (`_fap_bwd` -> `_flash_bwd_sharded`)
// runs through the library's `_flash_attention_bwd_dkv` and
// `_flash_attention_bwd_dq` (jax/experimental/pallas/ops/tpu/
// flash_attention.py), the backward of kernel B13 of the ROADMAP.  Same
// contract and rounding points as the library's kernels:
//   p  = exp(s - lse) with the forward's float32 log-sum-exp per row (0
//        where the segment ids or the causal mask hide the key);
//   dp = dz v^T in float32;  ds = (dp - D) p  with D = rowsum(z dz) in
//        float32 (computed by the wrapper from the forward's output);
//   dv = p^T dz and dk = ds^T q with p^T and ds^T rounded to dz's dtype;
//   dq = ds k with ds rounded to k's dtype;
// float32 accumulation, each gradient stored in its input's dtype.
//
// What bounds it on an H100.  Five products of 2 Tp^2 H flops a head (s
// twice over the two passes, dp twice, and dq, dk, dv once: 14 Tp^2 H with
// the recomputation, 10 Tp^2 H of least work) against 8 Tp H elements moved
// (q, k, v, dz read, dq, dk, dv written, lse and D): as for the forward, far
// above the flops a byte where the tensor cores are the limit.  So the
// products run on the tensor cores, and the Tp x Tp tiles of p and ds stay
// on the SM.
//
// Design (FlashAttention-2's two-pass split, as the library's; simple first):
//  * dk/dv pass, one block of 4 warps per (64 keys, head, batch item): the
//    block's K and V stay in shared memory; query tiles (Q, dZ and their
//    rows' segment ids, lse and D) stream through a two-deep cp.async ring.
//    Each warp owns 16 keys, so it forms s^T = K Q^T with keys as rows and
//    p^T, dp^T and ds^T come out in the layout that dv += p^T dZ and dk +=
//    ds^T Q take as their A operands, with no transpose;
//  * dq pass, one block per (64 query rows, head, batch item): Q and dZ stay,
//    K and V tiles stream; s = Q K^T, dp = dZ V^T, ds, then dq += ds K;
//  * both passes use flash_tile.cuh's two products (mma.sync m16n8k16 in
//    bf16, FFMA in float32) and skip the tiles a causal mask hides.

#include "flash_tile.cuh"

#include <math.h>

namespace {

using namespace flash;

// Per-tile vectors a pass streams beside its tiles: two buffers of 64 ints
// (segment ids) and, in the dk/dv pass, two of 64 floats each for lse and D.
constexpr int kVecBytes = 2 * kTile * 4;

// dk/dv pass.  Grid (Tp / 64, N, B).  Shared: K, V, then two (Q, dZ) pairs,
// the float32 P buffers, then [2][64] segment ids, lse and D.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dz,
                         const int* __restrict__ seg, const float* __restrict__ lse,
                         const float* __restrict__ dsum, T* __restrict__ dk, T* __restrict__ dv,
                         int n_heads, int n_tok, int causal) {
  typedef Geo<T, HD> G;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + G::tile;
  T* QD = Vs + G::tile;  // Q0, dZ0, Q1, dZ1
  float* pbuf = reinterpret_cast<float*>(QD + 4 * G::tile);
  int* segs = reinterpret_cast<int*>(smem_raw + smem_bytes<T, HD>(6, 0));
  float* lses = reinterpret_cast<float*>(segs + 2 * kTile);
  float* ds_ = lses + 2 * kTile;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, n = blockIdx.y, j0 = blockIdx.x * kTile;
  const long long head = (static_cast<long long>(b) * n_heads + n) * n_tok;
  const T* qh = q + head * HD;
  const T* dzh = dz + head * HD;
  const int* sb = seg + static_cast<long long>(b) * n_tok;
  const int key[2] = {j0 + 16 * warp + g, j0 + 16 * warp + g + 8};
  const int seg_k[2] = {sb[key[0]], sb[key[1]]};
  const int first = causal ? blockIdx.x : 0, n_qt = n_tok / kTile;

  auto load_q = [&](int qt) {
    T* Qs = QD + 2 * (qt & 1) * G::tile;
    load_tile<T, HD>(Qs, qh + static_cast<long long>(qt) * kTile * HD);
    load_tile<T, HD>(Qs + G::tile, dzh + static_cast<long long>(qt) * kTile * HD);
    if (threadIdx.x < kTile) {
      const int i = qt * kTile + threadIdx.x, o = (qt & 1) * kTile + threadIdx.x;
      segs[o] = sb[i];
      lses[o] = lse[head + i];
      ds_[o] = dsum[head + i];
    }
  };
  load_tile<T, HD>(Ks, k + (head + j0) * HD);
  load_tile<T, HD>(Vs, v + (head + j0) * HD);
  load_q(first);
  sae::cp_async_commit();

  float adk[HD / 8][4], adv[HD / 8][4];
  zero(adk);
  zero(adv);
  const T* Kw = Ks + 16 * warp * G::stride;
  const T* Vw = Vs + 16 * warp * G::stride;
  float* pw = pbuf + warp * 16 * kPStride;
  for (int qt = first; qt < n_qt; ++qt) {
    if (qt + 1 < n_qt) {
      load_q(qt + 1);
      sae::cp_async_commit();
      sae::cp_async_wait<1>();
    } else {
      sae::cp_async_wait<0>();
    }
    __syncthreads();
    const T* Qs = QD + 2 * (qt & 1) * G::tile;
    const T* dZs = Qs + G::tile;
    const int* sq = segs + (qt & 1) * kTile;
    const float* lq = lses + (qt & 1) * kTile;
    const float* dq_ = ds_ + (qt & 1) * kTile;
    float p[8][4], dp[8][4];
    zero(p);
    nt<HD>(p, Kw, Qs, pw);  // s^T: rows are keys, columns query rows
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        const bool ok = sq[c] == seg_k[e >> 1] && (!causal || key[e >> 1] <= qt * kTile + c);
        p[j][e] = ok ? expf(p[j][e] - lq[c]) : 0.f;
      }
    pn<HD>(adv, p, dZs, pw);  // dv += p^T dZ
    zero(dp);
    nt<HD>(dp, Vw, dZs, pw);  // dp^T = V dZ^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = (dp[j][e] - dq_[8 * j + 2 * t + (e & 1)]) * p[j][e];
    pn<HD>(adk, dp, Qs, pw);  // dk += ds^T Q
    __syncthreads();  // every warp is done with this pair before it is reloaded
  }
  const float one[2] = {1.f, 1.f};
  store_rows<T, HD>(dk + (head + j0 + 16 * warp) * HD, adk, one);
  store_rows<T, HD>(dv + (head + j0 + 16 * warp) * HD, adv, one);
}

// dq pass.  Grid (Tp / 64, N, B).  Shared: Q, dZ, then two (K, V) pairs, the
// float32 P buffers, then [2][64] key segment ids.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const T* __restrict__ dz, const int* __restrict__ seg,
                        const float* __restrict__ lse, const float* __restrict__ dsum,
                        T* __restrict__ dq, int n_heads, int n_tok, int causal) {
  typedef Geo<T, HD> G;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dZs = Qs + G::tile;
  T* KV = dZs + G::tile;  // K0, V0, K1, V1
  float* pbuf = reinterpret_cast<float*>(KV + 4 * G::tile);
  int* segs = reinterpret_cast<int*>(smem_raw + smem_bytes<T, HD>(6, 0));

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, n = blockIdx.y, i0 = blockIdx.x * kTile;
  const long long head = (static_cast<long long>(b) * n_heads + n) * n_tok;
  const T* kh = k + head * HD;
  const T* vh = v + head * HD;
  const int* sb = seg + static_cast<long long>(b) * n_tok;
  const int row[2] = {i0 + 16 * warp + g, i0 + 16 * warp + g + 8};
  const int seg_q[2] = {sb[row[0]], sb[row[1]]};
  const float lse_r[2] = {lse[head + row[0]], lse[head + row[1]]};
  const float d_r[2] = {dsum[head + row[0]], dsum[head + row[1]]};
  const int n_kt = causal ? blockIdx.x + 1 : n_tok / kTile;

  auto load_kv = [&](int kt) {
    T* Ks = KV + 2 * (kt & 1) * G::tile;
    load_tile<T, HD>(Ks, kh + static_cast<long long>(kt) * kTile * HD);
    load_tile<T, HD>(Ks + G::tile, vh + static_cast<long long>(kt) * kTile * HD);
    if (threadIdx.x < kTile) segs[(kt & 1) * kTile + threadIdx.x] = sb[kt * kTile + threadIdx.x];
  };
  load_tile<T, HD>(Qs, q + (head + i0) * HD);
  load_tile<T, HD>(dZs, dz + (head + i0) * HD);
  load_kv(0);
  sae::cp_async_commit();

  float acc[HD / 8][4];
  zero(acc);
  const T* Qw = Qs + 16 * warp * G::stride;
  const T* dZw = dZs + 16 * warp * G::stride;
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
    float p[8][4], dp[8][4];
    zero(p);
    nt<HD>(p, Qw, Ks, pw);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 8 * j + 2 * t + (e & 1);
        const bool ok = sk[key] == seg_q[e >> 1] && (!causal || kt * kTile + key <= row[e >> 1]);
        p[j][e] = ok ? expf(p[j][e] - lse_r[e >> 1]) : 0.f;
      }
    zero(dp);
    nt<HD>(dp, dZw, Ks + G::tile, pw);  // dp = dZ V^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = (dp[j][e] - d_r[e >> 1]) * p[j][e];
    pn<HD>(acc, dp, Ks, pw);  // dq += ds K
    __syncthreads();
  }
  const float one[2] = {1.f, 1.f};
  store_rows<T, HD>(dq + (head + i0 + 16 * warp) * HD, acc, one);
}

struct Args {
  const void *q, *k, *v, *dz;
  const int* seg;
  const float *lse, *dsum;
  void *dq, *dk, *dv;
  int batch, n_heads, n_tok, causal;
  cudaStream_t stream;
};

template <typename T, int HD>
cudaError_t launch_hd(const Args& a, int pass) {
  const dim3 grid(a.n_tok / kTile, a.n_heads, a.batch);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dz = static_cast<const T*>(a.dz);
  cudaError_t err;
  if (pass == 0) {
    const int bytes = smem_bytes<T, HD>(6, 3 * kVecBytes);
    auto kernel = flash_bwd_dkv_kernel<T, HD>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, bytes, a.stream>>>(q, k, v, dz, a.seg, a.lse, a.dsum,
                                                static_cast<T*>(a.dk), static_cast<T*>(a.dv),
                                                a.n_heads, a.n_tok, a.causal);
  } else {
    const int bytes = smem_bytes<T, HD>(6, kVecBytes);
    auto kernel = flash_bwd_dq_kernel<T, HD>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, bytes, a.stream>>>(q, k, v, dz, a.seg, a.lse, a.dsum,
                                                static_cast<T*>(a.dq), a.n_heads, a.n_tok,
                                                a.causal);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args& a, int d_head, int pass) {
  switch (d_head) {
#define VPT_CASE(HD) \
  case HD:           \
    return launch_hd<T, HD>(a, pass);
    VPT_CASE(16) VPT_CASE(32) VPT_CASE(48) VPT_CASE(64)
    VPT_CASE(80) VPT_CASE(96) VPT_CASE(112) VPT_CASE(128)
#undef VPT_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// One pass of the backward: pass 0 writes dk and dv, pass 1 writes dq.
// q, k, v, dz, dq, dk, dv: [batch, n_heads, n_tok, d_head]; seg: [batch,
// n_tok] int32; lse (the forward's) and dsum (rowsum(z dz)): [batch, n_heads,
// n_tok] float32.  n_tok a multiple of 64; d_head a multiple of 16 up to 128.
// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* dz,
                                   const void* seg, const void* lse, const void* dsum, void* dq,
                                   void* dk, void* dv, int batch, int n_heads, int n_tok,
                                   int d_head, int causal, int pass, int dtype, int device,
                                   void* stream) {
  if (batch <= 0 || batch > 65535 || n_heads <= 0 || n_heads > 65535 || n_tok <= 0 ||
      n_tok % flash::kTile || d_head <= 0 || d_head > 128 || d_head % 16 || (pass != 0 && pass != 1))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Args a{q, k, v, dz, static_cast<const int*>(seg), static_cast<const float*>(lse),
               static_cast<const float*>(dsum), dq, dk, dv, batch, n_heads, n_tok, causal,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return launch<float>(a, d_head, pass);
  if (dtype == 1) return launch<__nv_bfloat16>(a, d_head, pass);
  return cudaErrorInvalidValue;
}
