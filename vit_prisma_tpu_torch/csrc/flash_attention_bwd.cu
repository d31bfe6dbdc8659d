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
// Two routes, chosen by dtype and head width (never after a failure):
// bfloat16 heads 64 or 128 wide run the Hopper kernels (tc::, below);
// float32, and bfloat16 at the other widths flash_fits takes, run the
// mma.sync/FFMA kernels.
//
// Design of the Hopper kernels (flash_wgmma.cuh; the same two-pass split):
//  * dk/dv pass, one block per (64 keys, head, batch item): one consumer
//    warpgroup owns the 64 keys, K and V resident; the producer warp streams
//    Q and dZ tiles with their rows' segment ids, lse and D through the
//    ring.  s^T = K Q^T and dp^T = V dZ^T as wgmma with both tiles from
//    shared memory; p^T = exp(s^T - lse) and ds^T = p^T (dp^T - D) on the
//    fragments, rounded to bf16 in registers as the A operands of
//    dv += p^T dZ and dk += ds^T Q (wgmma, dZ and Q as MN-major B).  Each
//    product is its own commit group, so p^T is formed while dp^T runs and
//    ds^T while dv runs (6% off the pass, and 20 fewer registers);
//  * dq pass, one block per (64 query rows, head, batch item): Q and dZ
//    resident, K and V tiles streamed; s = Q K^T and dp = dZ V^T (p formed
//    while dp runs), ds, then dq += ds K with K as the MN-major B;
//  * the masks on the fragments; tiles a causal mask hides are skipped.
//
// Design of the mma.sync/FFMA kernels (FlashAttention-2's two-pass split):
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
#include "flash_wgmma.cuh"

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
#define VPT_CASE(HD) \
  case HD:           \
    return launch_hd<T, HD>(a, pass);
  // bfloat16 heads 64 and 128 wide take the Hopper kernels (tc, below)
  if constexpr (sizeof(T) == 4) {
    switch (d_head) { VPT_CASE(64) VPT_CASE(128) }
  }
  switch (d_head) {
    VPT_CASE(16) VPT_CASE(32) VPT_CASE(48) VPT_CASE(80) VPT_CASE(96) VPT_CASE(112)
    default:
      return cudaErrorInvalidValue;
  }
#undef VPT_CASE
}

// ---- bfloat16, H 64 or 128: wgmma and TMA -----------------------------------

namespace tc {

using fw::aligned_base;
using fw::bf16;
using fw::ex2;
using fw::init_ring;
using fw::issue_nt;
using fw::issue_pn;
using fw::kConsumers;
using fw::kLog2e;
using fw::kStages;
using fw::kThreads;
using fw::kTile;
using fw::kVecBytes;
using fw::kVecs;
using fw::make_rows_map;
using fw::produce;
using fw::Ring;
using fw::store_acc;
using fw::to_a;

// dk/dv pass.  Grid (Tp / 64, N, B); kThreads threads; Ring<HD, 2>::bytes.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap dzmap, const int* __restrict__ seg,
                      const float* __restrict__ lse, const float* __restrict__ dsum,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int n_heads, int n_tok,
                      int causal) {
  typedef Ring<HD, 2> L;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = aligned_base(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars) + 1;
  uint64_t* empty = full + kStages;
  const int b = blockIdx.z, j0 = blockIdx.x * kTile;
  const int head = (b * n_heads + blockIdx.y) * n_tok;
  const int first = causal ? blockIdx.x : 0, n_qt = n_tok / kTile;
  const int* sb = seg + static_cast<long long>(b) * n_tok;
  init_ring<HD, 2>(smem);

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      const void* const vsrc[kVecs] = {sb, lse + head, dsum + head};
      produce<HD, 2>(smem, &kmap, &vmap, head + j0, &qmap, &dzmap, head, first, n_qt, vsrc, 3);
    }
    return;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int key[2] = {j0 + 16 * warp + g, j0 + 16 * warp + g + 8};
  const int seg_k[2] = {sb[key[0]], sb[key[1]]};
  float adk[HD / 2], adv[HD / 2];
  hg::mbar_wait(reinterpret_cast<uint64_t*>(smem + L::bars), 0);  // K and V
  for (int qt = first; qt < n_qt; ++qt) {
    const int it = qt - first, st = it % kStages;
    hg::mbar_wait(&full[st], (it / kStages) & 1);
    const unsigned char* Qs = smem + L::stages + st * 2 * L::tile;
    const unsigned char* dZs = Qs + L::tile;
    const unsigned char* vec = smem + L::vecs + st * kVecs * kVecBytes;
    float s[32], dp[32];
    hg::wgmma_fence();
    issue_nt<HD>(s, smem, Qs);  // s^T = K Q^T
    hg::wgmma_commit();
    issue_nt<HD>(dp, smem + L::tile, dZs);  // dp^T = V dZ^T
    hg::wgmma_commit();
    hg::wgmma_wait<1>();  // s^T; dp^T may still run
    hg::fence_acc(s);
    const int* sq = reinterpret_cast<const int*>(vec);
    const float* lq = reinterpret_cast<const float*>(vec + kVecBytes);
    const float* Dq = reinterpret_cast<const float*>(vec + 2 * kVecBytes);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * j + 2 * t + c, sg = sq[col];
        const float l2 = lq[col] * kLog2e;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 4 * j + 2 * h + c;
          const bool ok = sg == seg_k[h] && (!causal || key[h] <= qt * kTile + col);
          s[e] = ok ? ex2(fmaf(s[e], kLog2e, -l2)) : 0.f;
        }
      }
    uint32_t pa[4][4], da[4][4];
    to_a(pa, s);  // p^T rounded to bf16
    hg::fence_acc(adv);
    hg::wgmma_fence();
    issue_pn<HD>(adv, pa, dZs, it > 0);  // dv += p^T dZ
    hg::wgmma_commit();
    hg::wgmma_wait<1>();  // dp^T; dv may still run
    hg::fence_acc(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float d = Dq[8 * j + 2 * t + c];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 4 * j + 2 * h + c;
          dp[e] = s[e] * (dp[e] - d);
        }
      }
    to_a(da, dp);  // ds^T rounded to bf16
    hg::fence_acc(adk);
    hg::wgmma_fence();
    issue_pn<HD>(adk, da, Qs, it > 0);  // dk += ds^T Q
    hg::wgmma_commit();
    hg::wgmma_wait<0>();
    hg::fence_acc(adv);
    hg::fence_acc(adk);
    if (lane == 0) hg::mbar_arrive(&empty[st]);
  }
  const float one[2] = {1.f, 1.f};
  store_acc<HD>(dk + static_cast<long long>(head + j0) * HD, adk, one);
  store_acc<HD>(dv + static_cast<long long>(head + j0) * HD, adv, one);
}

// dq pass.  Grid (Tp / 64, N, B); kThreads threads; Ring<HD, 2>::bytes.
template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
    bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap dzmap, const int* __restrict__ seg,
                     const float* __restrict__ lse, const float* __restrict__ dsum,
                     bf16* __restrict__ dq, int n_heads, int n_tok, int causal) {
  typedef Ring<HD, 2> L;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = aligned_base(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars) + 1;
  uint64_t* empty = full + kStages;
  const int b = blockIdx.z, i0 = blockIdx.x * kTile;
  const int head = (b * n_heads + blockIdx.y) * n_tok;
  const int n_kt = causal ? blockIdx.x + 1 : n_tok / kTile;
  const int* sb = seg + static_cast<long long>(b) * n_tok;
  init_ring<HD, 2>(smem);

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      const void* const vsrc[kVecs] = {sb, nullptr, nullptr};
      produce<HD, 2>(smem, &qmap, &dzmap, head + i0, &kmap, &vmap, head, 0, n_kt, vsrc, 1);
    }
    return;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row[2] = {i0 + 16 * warp + g, i0 + 16 * warp + g + 8};
  const int seg_q[2] = {sb[row[0]], sb[row[1]]};
  const float lse2[2] = {lse[head + row[0]] * kLog2e, lse[head + row[1]] * kLog2e};
  const float d_r[2] = {dsum[head + row[0]], dsum[head + row[1]]};
  float acc[HD / 2];
  hg::mbar_wait(reinterpret_cast<uint64_t*>(smem + L::bars), 0);  // Q and dZ
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % kStages;
    hg::mbar_wait(&full[st], (kt / kStages) & 1);
    const unsigned char* Ks = smem + L::stages + st * 2 * L::tile;
    const unsigned char* vec = smem + L::vecs + st * kVecs * kVecBytes;
    float s[32], dp[32];
    hg::wgmma_fence();
    issue_nt<HD>(s, smem, Ks);  // s = Q K^T
    hg::wgmma_commit();
    issue_nt<HD>(dp, smem + L::tile, Ks + L::tile);  // dp = dZ V^T
    hg::wgmma_commit();
    hg::wgmma_wait<1>();  // s; dp may still run
    hg::fence_acc(s);
    const int* sk = reinterpret_cast<const int*>(vec);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = 8 * j + 2 * t + c, sg = sk[key];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 4 * j + 2 * h + c;
          const bool ok = sg == seg_q[h] && (!causal || kt * kTile + key <= row[h]);
          s[e] = ok ? ex2(fmaf(s[e], kLog2e, -lse2[h])) : 0.f;
        }
      }
    hg::wgmma_wait<0>();
    hg::fence_acc(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - d_r[(i >> 1) & 1]);
    uint32_t da[4][4];
    to_a(da, dp);  // ds rounded to bf16
    hg::fence_acc(acc);
    hg::wgmma_fence();
    issue_pn<HD>(acc, da, Ks, kt > 0);  // dq += ds K
    hg::wgmma_commit();
    hg::wgmma_wait<0>();
    hg::fence_acc(acc);
    if (lane == 0) hg::mbar_arrive(&empty[st]);
  }
  const float one[2] = {1.f, 1.f};
  store_acc<HD>(dq + static_cast<long long>(head + i0) * HD, acc, one);
}

template <int HD>
cudaError_t launch_hd(const Args& a, int pass) {
  const long long rows = static_cast<long long>(a.batch) * a.n_heads * a.n_tok;
  CUtensorMap qmap, kmap, vmap, dzmap;
  cudaError_t err;
  if ((err = make_rows_map(&qmap, a.q, rows, HD)) != cudaSuccess ||
      (err = make_rows_map(&kmap, a.k, rows, HD)) != cudaSuccess ||
      (err = make_rows_map(&vmap, a.v, rows, HD)) != cudaSuccess ||
      (err = make_rows_map(&dzmap, a.dz, rows, HD)) != cudaSuccess)
    return err;
  const dim3 grid(a.n_tok / kTile, a.n_heads, a.batch);
  const int bytes = Ring<HD, 2>::bytes;
  if (pass == 0) {
    if ((err = sae::allow_smem(bwd_dkv_tc_kernel<HD>, bytes)) != cudaSuccess) return err;
    bwd_dkv_tc_kernel<HD><<<grid, kThreads, bytes, a.stream>>>(
        qmap, kmap, vmap, dzmap, a.seg, a.lse, a.dsum, static_cast<bf16*>(a.dk),
        static_cast<bf16*>(a.dv), a.n_heads, a.n_tok, a.causal);
  } else {
    if ((err = sae::allow_smem(bwd_dq_tc_kernel<HD>, bytes)) != cudaSuccess) return err;
    bwd_dq_tc_kernel<HD><<<grid, kThreads, bytes, a.stream>>>(
        qmap, kmap, vmap, dzmap, a.seg, a.lse, a.dsum, static_cast<bf16*>(a.dq), a.n_heads,
        a.n_tok, a.causal);
  }
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// One pass of the backward: pass 0 writes dk and dv, pass 1 writes dq.
// q, k, v, dz, dq, dk, dv: [batch, n_heads, n_tok, d_head]; seg: [batch,
// n_tok] int32; lse (the forward's) and dsum (rowsum(z dz)): [batch, n_heads,
// n_tok] float32.  n_tok a multiple of 64; d_head a multiple of 16 up to 128;
// every pointer 16-byte aligned.  dtype: 0 = float32, 1 = bfloat16 (heads 64
// and 128 wide on the Hopper kernels).  Returns the launch's cudaError_t.
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
  if (dtype == 1 && d_head == 64) return tc::launch_hd<64>(a, pass);
  if (dtype == 1 && d_head == 128) return tc::launch_hd<128>(a, pass);
  if (dtype == 1) return launch<__nv_bfloat16>(a, d_head, pass);
  return cudaErrorInvalidValue;
}
