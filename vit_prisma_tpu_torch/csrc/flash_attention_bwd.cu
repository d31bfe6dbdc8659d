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
// Three routes, chosen by dtype and head width (never after a failure):
// bfloat16 heads 64 or 128 wide run the Hopper kernels (tc::, below);
// bfloat16 at the other widths flash_fits takes run the mma.sync kernels;
// float32 at every width runs the 3xTF32 kernels (f32tc::, below).
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
// Design of the mma.sync kernels (FlashAttention-2's two-pass split, bf16):
//  * dk/dv pass, one block of 4 warps per (64 keys, head, batch item): the
//    block's K and V stay in shared memory; query tiles (Q, dZ and their
//    rows' segment ids, lse and D) stream through a two-deep cp.async ring.
//    Each warp owns 16 keys, so it forms s^T = K Q^T with keys as rows and
//    p^T, dp^T and ds^T come out in the layout that dv += p^T dZ and dk +=
//    ds^T Q take as their A operands, with no transpose;
//  * dq pass, one block per (64 query rows, head, batch item): Q and dZ stay,
//    K and V tiles stream; s = Q K^T, dp = dZ V^T, ds, then dq += ds K;
//  * both passes use flash_tile.cuh's two products (mma.sync m16n8k16) and
//    skip the tiles a causal mask hides.
//
// Design of the float32 kernels (f32tc::; flash_tf32.cuh, tf32_mma.cuh),
// the same two-pass split with each product as three TF32 products:
//  * dk/dv pass, one block of kBwdWarps warps per (16 kBwdWarps keys, head,
//    batch item), 16 keys a warp: the block's K and V rows are staged once
//    (the A operands of s^T = K Q^T and dp^T = V dZ^T, read by ldmatrix a
//    k-step at a time); Q and dZ tiles of kStream queries, with each
//    query's segment id, -lse log2(e) and D, stream through a two-deep
//    cp.async ring.  A tile is taken in chunks of 8 dkv_steps queries: s^T
//    and dp^T (the score products in the order the forward and the dq pass
//    form s, so
//    each score comes out bit for bit as there), p^T = exp2(s^T log2(e) -
//    lse log2(e)) and ds^T = p^T (dp^T - D) on the fragments, then dv +=
//    p^T dZ and dk += ds^T Q with p^T and ds^T as A operands through the
//    permuted k index;
//  * dq pass, one block per (16 kBwdWarps query rows, head, batch item): Q
//    and dZ rows staged once, K and V tiles streamed with their keys'
//    segment ids, in chunks of 8 dq_steps keys: s = Q K^T, dp = dZ V^T, ds
//    = p (dp - D), dq += ds K;
//  * each chunk's gradient product is summed from zero on the tensor cores
//    and added in FADDs: a key or query loop of 3200 tokens (ViViT-B) would
//    otherwise take the tensor cores' truncation at every step;
//  * chunks a causal mask hides entirely are skipped.

#include "flash_tf32.cuh"
#include "flash_tile.cuh"
#include "flash_wgmma.cuh"

#include <math.h>

namespace {

using namespace flash;

// Per-tile vectors a pass streams beside its tiles: two buffers of 64 ints
// (segment ids) and, in the dk/dv pass, two of 64 floats each for lse and D.
constexpr int kVecBytes = 2 * kTile * 4;

// dk/dv pass.  Grid (Tp / 64, N, B).  Shared: K, V, then two (Q, dZ) pairs,
// then [2][64] segment ids, lse and D.
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
    nt<HD>(p, Kw, Qs, nullptr);  // s^T: rows are keys, columns query rows
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        const bool ok = sq[c] == seg_k[e >> 1] && (!causal || key[e >> 1] <= qt * kTile + c);
        p[j][e] = ok ? expf(p[j][e] - lq[c]) : 0.f;
      }
    pn<HD>(adv, p, dZs, nullptr);  // dv += p^T dZ
    zero(dp);
    nt<HD>(dp, Vw, dZs, nullptr);  // dp^T = V dZ^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = (dp[j][e] - dq_[8 * j + 2 * t + (e & 1)]) * p[j][e];
    pn<HD>(adk, dp, Qs, nullptr);  // dk += ds^T Q
    __syncthreads();  // every warp is done with this pair before it is reloaded
  }
  const float one[2] = {1.f, 1.f};
  store_rows<T, HD>(dk + (head + j0 + 16 * warp) * HD, adk, one);
  store_rows<T, HD>(dv + (head + j0 + 16 * warp) * HD, adv, one);
}

// dq pass.  Grid (Tp / 64, N, B).  Shared: Q, dZ, then two (K, V) pairs,
// then [2][64] key segment ids.
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
    nt<HD>(p, Qw, Ks, nullptr);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 8 * j + 2 * t + (e & 1);
        const bool ok = sk[key] == seg_q[e >> 1] && (!causal || kt * kTile + key <= row[e >> 1]);
        p[j][e] = ok ? expf(p[j][e] - lse_r[e >> 1]) : 0.f;
      }
    zero(dp);
    nt<HD>(dp, dZw, Ks + G::tile, nullptr);  // dp = dZ V^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = (dp[j][e] - d_r[e >> 1]) * p[j][e];
    pn<HD>(acc, dp, Ks, nullptr);  // dq += ds K
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

// bfloat16 at the widths the Hopper kernels (tc, below) do not take.
cudaError_t launch(const Args& a, int d_head, int pass) {
#define VPT_CASE(HD) \
  case HD:           \
    return launch_hd<__nv_bfloat16, HD>(a, pass);
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

// ---- float32: 3xTF32 mma.sync ------------------------------------------------

namespace f32tc {

namespace t = mix::tf32;
using flash::f32::kBwdWarps;
using flash::f32::kStream;
using flash::f32::stride;
using fw::ex2;
using fw::kLog2e;

constexpr int kRows = t::kRows;  // keys (dk/dv) or rows (dq) of a warp
constexpr int kBlock = kBwdWarps * kRows;

// One chunk of the dk/dv pass: the 8 NJ queries from c0 of the staged tile
// (Qs, dZs; sq, nl, Dq: each query's segment id, -lse log2(e), D; qbase:
// the tile's first query) against the warp's 16 keys (Kw, Vw: staged rows;
// key, seg_k: its rows g and g + 8).
template <int HD, int NJ>
__device__ __forceinline__ void dkv_chunk(float (&adk)[HD / 8][4], float (&adv)[HD / 8][4],
                                          const float* Kw, const float* Vw, const float* Qs,
                                          const float* dZs, const int* sq, const float* nl,
                                          const float* Dq, int c0, int qbase,
                                          const int (&key)[2], const int (&seg_k)[2],
                                          int causal) {
  constexpr int S = stride(HD);
  const int tq = threadIdx.x & 3;
  float s[NJ][4], dp[NJ][4];
  // the keys as A, with mma3's other order: q_lo k_hi, then q_hi k_lo
  t::nt_chunk<HD, NJ, false>(s, t::Staged{Kw, S}, Qs, S, c0);   // s^T = K Q^T
  t::nt_chunk<HD, NJ, false>(dp, t::Staged{Vw, S}, dZs, S, c0);  // dp^T = V dZ^T
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int qc = c0 + 8 * j + 2 * tq + c, sg = sq[qc];
      const float n2 = nl[qc], d = Dq[qc];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = 2 * h + c;
        const bool ok = sg == seg_k[h] && (!causal || key[h] <= qbase + qc);
        const float p = ok ? ex2(fmaf(s[j][e], kLog2e, n2)) : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - d);
      }
    }
  constexpr int G = flash::f32::dkv_group(HD);
  t::pn_chunk<HD / 8, NJ, G>(adv, s, dZs, S, c0, 0);  // dv += p^T dZ
  t::pn_chunk<HD / 8, NJ, G>(adk, dp, Qs, S, c0, 0);  // dk += ds^T Q
}

// One chunk of the dq pass: the 8 NJ keys from c0 of the staged tile (Kt,
// Vt; sk: their segment ids; kbase: the tile's first key) against the
// warp's 16 rows (Qw, dZw: staged rows; row, seg_q, nl = -lse log2(e), D:
// its rows g and g + 8).
template <int HD, int NJ>
__device__ __forceinline__ void dq_chunk(float (&acc)[HD / 8][4], const float* Qw,
                                         const float* dZw, const float* Kt, const float* Vt,
                                         const int* sk, int c0, int kbase, const int (&row)[2],
                                         const int (&seg_q)[2], const float (&nl)[2],
                                         const float (&D)[2], int causal) {
  constexpr int S = stride(HD);
  const int tq = threadIdx.x & 3;
  float s[NJ][4], dp[NJ][4];
  t::nt_chunk<HD, NJ, true>(s, t::Staged{Qw, S}, Kt, S, c0);   // s = Q K^T
  t::nt_chunk<HD, NJ, true>(dp, t::Staged{dZw, S}, Vt, S, c0);  // dp = dZ V^T
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int kc = c0 + 8 * j + 2 * tq + c, sg = sk[kc];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = 2 * h + c;
        const bool ok = sg == seg_q[h] && (!causal || kbase + kc <= row[h]);
        const float p = ok ? ex2(fmaf(s[j][e], kLog2e, nl[h])) : 0.f;
        dp[j][e] = p * (dp[j][e] - D[h]);
      }
    }
  t::pn_chunk<HD / 8, NJ>(acc, dp, Kt, S, c0, 0);  // dq += ds K
}

// dk/dv pass.  Grid (Tp / kTile, N, B), 32 kBwdWarps threads,
// dkv_smem_bytes(HD).  Shared: the block's K and V rows, two (Q, dZ) pairs
// of staged tiles, then [2][kStream] segment ids, -lse log2(e) and D.
template <int HD>
__global__ void __launch_bounds__(kBwdWarps * 32, flash::f32::min_blocks(HD))
    dkv_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dz,
                    const int* __restrict__ seg, const float* __restrict__ lse,
                    const float* __restrict__ dsum, float* __restrict__ dk,
                    float* __restrict__ dv, int n_heads, int n_tok, int causal) {
  constexpr int S = stride(HD), TILE = kStream * S, NJ = flash::f32::dkv_steps(HD);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);  // [kBlock][S]
  float* Vs = Ks + kBlock * S;                     // [kBlock][S]
  float* QD = Vs + kBlock * S;                     // Q0, dZ0, Q1, dZ1
  int* segs = reinterpret_cast<int*>(QD + 4 * TILE);
  float* nls = reinterpret_cast<float*>(segs + 2 * kStream);
  float* Ds = nls + 2 * kStream;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2;
  const int b = blockIdx.z, j0 = blockIdx.x * kBlock, key0 = j0 + kRows * warp;
  const long long head = (static_cast<long long>(b) * n_heads + blockIdx.y) * n_tok;
  const float* qh = q + head * HD;
  const float* dzh = dz + head * HD;
  const int* sb = seg + static_cast<long long>(b) * n_tok;
  const int key[2] = {key0 + g, key0 + g + 8};
  const int seg_k[2] = {sb[key[0]], sb[key[1]]};
  // a causal block's keys meet the queries from its first key on
  const int first = causal ? j0 / kStream : 0, n_qt = n_tok / kStream;

  auto load_q = [&](int qt) {
    float* Qs = QD + 2 * (qt & 1) * TILE;
    flash::f32::stage<HD>(Qs, qh + static_cast<long long>(qt) * kStream * HD, kStream);
    flash::f32::stage<HD>(Qs + TILE, dzh + static_cast<long long>(qt) * kStream * HD, kStream);
    if (threadIdx.x < kStream) {
      const int i = qt * kStream + threadIdx.x, o = (qt & 1) * kStream + threadIdx.x;
      segs[o] = sb[i];
      nls[o] = -lse[head + i] * kLog2e;
      Ds[o] = dsum[head + i];
    }
  };
  flash::f32::stage<HD>(Ks, k + (head + j0) * HD, kBlock);
  flash::f32::stage<HD>(Vs, v + (head + j0) * HD, kBlock);
  load_q(first);
  sae::cp_async_commit();

  float adk[HD / 8][4], adv[HD / 8][4];
  flash::zero(adk);
  flash::zero(adv);
  const float* Kw = Ks + kRows * warp * S;
  const float* Vw = Vs + kRows * warp * S;
  for (int qt = first; qt < n_qt; ++qt) {
    if (qt + 1 < n_qt) {
      load_q(qt + 1);
      sae::cp_async_commit();
      sae::cp_async_wait<1>();
    } else {
      sae::cp_async_wait<0>();
    }
    __syncthreads();
    const int o = (qt & 1) * kStream;
    const float* Qs = QD + 2 * (qt & 1) * TILE;
#pragma unroll 1
    for (int c0 = 0; c0 < kStream; c0 += 8 * NJ) {
      // queries before every key of the warp are masked when causal
      if (causal && qt * kStream + c0 + 8 * NJ - 1 < key0) continue;
      dkv_chunk<HD, NJ>(adk, adv, Kw, Vw, Qs, Qs + TILE, segs + o, nls + o, Ds + o, c0,
                        qt * kStream, key, seg_k, causal);
    }
    __syncthreads();  // every warp is done with this pair before it is reloaded
  }
  const float one[2] = {1.f, 1.f};
  flash::store_rows<float, HD>(dk + (head + key0) * HD, adk, one);
  flash::store_rows<float, HD>(dv + (head + key0) * HD, adv, one);
}

// dq pass.  Grid (Tp / kTile, N, B), 32 kBwdWarps threads,
// dq_smem_bytes(HD).  Shared: the block's Q and dZ rows, two (K, V) pairs
// of staged tiles, then [2][kStream] key segment ids.
template <int HD>
__global__ void __launch_bounds__(kBwdWarps * 32, flash::f32::min_blocks(HD))
    dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dz,
                   const int* __restrict__ seg, const float* __restrict__ lse,
                   const float* __restrict__ dsum, float* __restrict__ dq, int n_heads,
                   int n_tok, int causal) {
  constexpr int S = stride(HD), TILE = kStream * S, NJ = flash::f32::dq_steps(HD);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [kBlock][S]
  float* dZs = Qs + kBlock * S;                    // [kBlock][S]
  float* KV = dZs + kBlock * S;                    // K0, V0, K1, V1
  int* segs = reinterpret_cast<int*>(KV + 4 * TILE);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2;
  const int b = blockIdx.z, i0 = blockIdx.x * kBlock, row0 = i0 + kRows * warp;
  const long long head = (static_cast<long long>(b) * n_heads + blockIdx.y) * n_tok;
  const float* kh = k + head * HD;
  const float* vh = v + head * HD;
  const int* sb = seg + static_cast<long long>(b) * n_tok;
  const int row[2] = {row0 + g, row0 + g + 8};
  const int seg_q[2] = {sb[row[0]], sb[row[1]]};
  const float nl[2] = {-lse[head + row[0]] * kLog2e, -lse[head + row[1]] * kLog2e};
  const float d_r[2] = {dsum[head + row[0]], dsum[head + row[1]]};
  const int n_kt = (causal ? i0 + kBlock : n_tok) / kStream;

  auto load_kv = [&](int kt) {
    float* Kt = KV + 2 * (kt & 1) * TILE;
    flash::f32::stage<HD>(Kt, kh + static_cast<long long>(kt) * kStream * HD, kStream);
    flash::f32::stage<HD>(Kt + TILE, vh + static_cast<long long>(kt) * kStream * HD, kStream);
    if (threadIdx.x < kStream)
      segs[(kt & 1) * kStream + threadIdx.x] = sb[kt * kStream + threadIdx.x];
  };
  flash::f32::stage<HD>(Qs, q + (head + i0) * HD, kBlock);
  flash::f32::stage<HD>(dZs, dz + (head + i0) * HD, kBlock);
  load_kv(0);
  sae::cp_async_commit();

  float acc[HD / 8][4];
  flash::zero(acc);
  const float* Qw = Qs + kRows * warp * S;
  const float* dZw = dZs + kRows * warp * S;
  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) {
      load_kv(kt + 1);
      sae::cp_async_commit();
      sae::cp_async_wait<1>();
    } else {
      sae::cp_async_wait<0>();
    }
    __syncthreads();
    const float* Kt = KV + 2 * (kt & 1) * TILE;
    const int* sk = segs + (kt & 1) * kStream;
#pragma unroll 1
    for (int c0 = 0; c0 < kStream; c0 += 8 * NJ) {
      if (causal && kt * kStream + c0 > row0 + kRows - 1) break;  // keys past every row
      dq_chunk<HD, NJ>(acc, Qw, dZw, Kt, Kt + TILE, sk, c0, kt * kStream, row, seg_q, nl, d_r,
                       causal);
    }
    __syncthreads();
  }
  const float one[2] = {1.f, 1.f};
  flash::store_rows<float, HD>(dq + (head + row0) * HD, acc, one);
}

template <int HD>
cudaError_t launch_hd(const Args& a, int pass) {
  const dim3 grid(a.n_tok / kBlock, a.n_heads, a.batch);
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dz = static_cast<const float*>(a.dz);
  cudaError_t err;
  if (pass == 0) {
    const int bytes = flash::f32::dkv_smem_bytes(HD);
    if ((err = sae::allow_smem(dkv_tf32_kernel<HD>, bytes)) != cudaSuccess) return err;
    dkv_tf32_kernel<HD><<<grid, kBwdWarps * 32, bytes, a.stream>>>(
        q, k, v, dz, a.seg, a.lse, a.dsum, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
        a.n_heads, a.n_tok, a.causal);
  } else {
    const int bytes = flash::f32::dq_smem_bytes(HD);
    if ((err = sae::allow_smem(dq_tf32_kernel<HD>, bytes)) != cudaSuccess) return err;
    dq_tf32_kernel<HD><<<grid, kBwdWarps * 32, bytes, a.stream>>>(
        q, k, v, dz, a.seg, a.lse, a.dsum, static_cast<float*>(a.dq), a.n_heads, a.n_tok,
        a.causal);
  }
  return cudaGetLastError();
}

cudaError_t launch(const Args& a, int d_head, int pass) {
  switch (d_head) {
#define F32TC_CASE(HD) \
  case HD:             \
    return launch_hd<HD>(a, pass);
    F32TC_CASE(16) F32TC_CASE(32) F32TC_CASE(48) F32TC_CASE(64)
    F32TC_CASE(80) F32TC_CASE(96) F32TC_CASE(112) F32TC_CASE(128)
#undef F32TC_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace f32tc

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
  if (dtype == 0) return f32tc::launch(a, d_head, pass);
  if (dtype == 1 && d_head == 64) return tc::launch_hd<64>(a, pass);
  if (dtype == 1 && d_head == 128) return tc::launch_hd<128>(a, pass);
  if (dtype == 1) return launch(a, d_head, pass);
  return cudaErrorInvalidValue;
}
