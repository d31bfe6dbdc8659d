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
// Three routes, chosen by dtype and head width (never after a failure):
// bfloat16 heads 64 or 128 wide run the Hopper kernel (tc::fwd_tc_kernel,
// below); bfloat16 at the other widths flash_fits takes (multiples of 16 up
// to 128) run flash_fwd_kernel (mma.sync); float32 at every width runs
// f32tc::fwd_tf32_kernel (3xTF32 mma.sync, below).
//
// Design of the Hopper kernel (flash_wgmma.cuh):
//  * one block per (64 query rows, head, batch item): one consumer
//    warpgroup, 16 rows a warp, and one producer warp, which loads the Q
//    tile once and streams K and V tiles of 64 keys and their segment ids
//    through a two-stage TMA/mbarrier ring; a causal block stops at its
//    last row's tile;
//  * s = Q K^T as wgmma m64n64k16 with both tiles K-major in shared memory;
//    the masks on the accumulator fragments; the online softmax in
//    registers with ex2 (log2(e) folded in); p rounded to bf16 in registers
//    becomes the A operand of z += P V (wgmma m64nHk16, V MN-major);
//  * two or three blocks an SM overlap one block's softmax with another's
//    products.  Issuing the next tile's scores before this tile's P V
//    inside a block (two score accumulators) measured 16% slower at the
//    serve shape, so each block waits for its products.
//
// Design of flash_fwd_kernel (FlashAttention-2's, on mma.sync, bfloat16):
//  * one block of 4 warps per (64 query rows, head, batch item); each warp
//    owns 16 rows, so the row max and sum are reduced over the 4 lanes of a
//    quad (flash_tile.cuh's C-fragment layout);
//  * the Q tile stays in shared memory; K and V tiles of 64 keys stream
//    through a two-deep cp.async ring, the next pair loading while the
//    current one is used; a causal block stops at its last row's tile;
//  * s = Q K^T and z += P V with mma.sync m16n8k16 (P passes from the score
//    registers to the product's A fragments directly);
//  * a fully masked key tile leaves m at -inf: the row then subtracts 0, not
//    m, so exp gives 0 and no NaN, and the rescale of the running sums by
//    exp(m_old - m_new) is exact when m_old is -inf.  Padding rows (their own
//    segment id) see only padding keys and stay finite;
//  * z = acc / l at the end; a row that saw no key (impossible with segment
//    ids, kept for safety) stores 0 and lse = +inf, so its backward p is 0.
//
// Design of the float32 kernel (f32tc::fwd_tf32_kernel; flash_tf32.cuh,
// tf32_mma.cuh), flash_fwd_kernel's loop with each product as three TF32
// products:
//  * one block of kFwdWarps warps per (16 kFwdWarps query rows, head, batch
//    item); a warp's 16 q rows go from device memory straight into A
//    fragments, held raw and split per use (split once they took 46 more
//    registers at H 64 for no gain);
//  * K and V tiles of kStream keys, and their segment ids, stream through
//    the two-deep cp.async ring, staged as float32 rows of H + 4 floats;
//  * a tile is taken in chunks of 8 NJ keys (32, or 16 past H 96): s = q K^T
//    (B fragments by ldmatrix, split in registers, the small products summed
//    apart), the masks on the fragments, the online softmax (m and l in
//    registers, ex2 with log2(e) folded in, the -inf guards above), then
//    the chunk's P V summed from zero on the tensor cores with p as the A
//    operand through the permuted k index (no shared P buffer) and folded
//    into the rescaled accumulator in FADDs: the tensor cores' accumulation
//    truncates, so no sum runs on them past one chunk;
//  * a causal warp skips the chunks past its last row.

#include "flash_tf32.cuh"
#include "flash_tile.cuh"
#include "flash_wgmma.cuh"

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
// then two tiles of key segment ids.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const int* __restrict__ seg, T* __restrict__ z, float* __restrict__ lse,
                     int n_heads, int n_tok, int causal) {
  typedef Geo<T, HD> G;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* KV = Qs + G::tile;  // K0, V0, K1, V1
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
    nt<HD>(s, Qw, Ks, nullptr);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 8 * j + 2 * t + (e & 1);
        const bool ok = sk[key] == seg_q[e >> 1] && (!causal || kt * kTile + key <= row[e >> 1]);
        if (!ok) s[j][e] = -INFINITY;
      }
    online_softmax<HD / 8>(s, acc, m, l);
    pn<HD>(acc, s, Ks + G::tile, nullptr);
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

// bfloat16 at the widths the Hopper kernel (tc, below) does not take.
cudaError_t launch(const void* q, const void* k, const void* v, const int* seg, void* z,
                   float* lse, int batch, int n_heads, int n_tok, int d_head, int causal,
                   cudaStream_t stream) {
#define VPT_CASE(HD)                                                                            \
  case HD:                                                                                      \
    return launch_hd<__nv_bfloat16, HD>(q, k, v, seg, z, lse, batch, n_heads, n_tok, causal, \
                                        stream);
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

// Grid (Tp / 64, N, B); kThreads threads; Ring<HD, 1>::bytes of shared
// memory.  qmap, kmap, vmap: [B N Tp, HD] in [64 x 64] boxes.
template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
    fwd_tc_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap, const int* __restrict__ seg,
                  bf16* __restrict__ z, float* __restrict__ lse, int n_heads, int n_tok,
                  int causal) {
  typedef Ring<HD, 1> L;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = aligned_base(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars) + 1;
  uint64_t* empty = full + kStages;
  const int b = blockIdx.z, i0 = blockIdx.x * kTile;
  const int head = (b * n_heads + blockIdx.y) * n_tok;  // row (b, n, 0) of the maps
  const int n_kt = causal ? blockIdx.x + 1 : n_tok / kTile;
  const int* sb = seg + static_cast<long long>(b) * n_tok;
  init_ring<HD, 1>(smem);

  if (threadIdx.x >= kConsumers) {  // the producer warp
    if (threadIdx.x == kConsumers) {
      const void* const vsrc[kVecs] = {sb, nullptr, nullptr};
      produce<HD, 1>(smem, &qmap, nullptr, head + i0, &kmap, &vmap, head, 0, n_kt, vsrc, 1);
    }
    return;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row[2] = {i0 + 16 * warp + g, i0 + 16 * warp + g + 8};
  const int seg_q[2] = {sb[row[0]], sb[row[1]]};
  float acc[HD / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  hg::fence_acc(acc);
  hg::mbar_wait(reinterpret_cast<uint64_t*>(smem + L::bars), 0);  // Q

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % kStages;
    hg::mbar_wait(&full[st], (kt / kStages) & 1);
    const unsigned char* Ks = smem + L::stages + st * 2 * L::tile;
    const int* sk = reinterpret_cast<const int*>(smem + L::vecs + st * kVecs * kVecBytes);
    float s[32];
    hg::wgmma_fence();
    issue_nt<HD>(s, smem, Ks);
    hg::wgmma_commit();
    hg::wgmma_wait<0>();
    hg::fence_acc(s);
    // s[4 j + e]: row 16 w + g + 8 (e / 2), key 8 j + 2 t + (e % 2)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = 8 * j + 2 * t + c, sg = sk[key];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (sg != seg_q[h] || (causal && kt * kTile + key > row[h])) s[4 * j + 2 * h + c] = -INFINITY;
      }
    // the online softmax: a fully masked tile leaves m at -inf, and the row
    // then subtracts 0, so p and the rescale are 0, not NaN
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      const float nb = -(m_new == -INFINITY ? 0.f : m_new) * kLog2e;
      const float alpha = ex2(fmaf(m[h], kLog2e, nb));  // 0 when m[h] is -inf
      m[h] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = ex2(fmaf(s[4 * j + 2 * h + c], kLog2e, nb));
          s[4 * j + 2 * h + c] = p;
          sum += p;
        }
      l[h] = l[h] * alpha + sum;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        acc[4 * j + 2 * h] *= alpha;
        acc[4 * j + 2 * h + 1] *= alpha;
      }
    }
    uint32_t pa[4][4];
    to_a(pa, s);  // p rounded to bf16
    hg::fence_acc(acc);
    hg::wgmma_fence();
    issue_pn<HD>(acc, pa, Ks + L::tile, 1);  // z += P V
    hg::wgmma_commit();
    hg::wgmma_wait<0>();
    hg::fence_acc(acc);
    if (lane == 0) hg::mbar_arrive(&empty[st]);
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = l[h] > 0.f ? 1.f / l[h] : 0.f;
  }
  store_acc<HD>(z + static_cast<long long>(head + i0) * HD, acc, inv);
  if (t == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h) lse[head + row[h]] = l[h] > 0.f ? m[h] + logf(l[h]) : INFINITY;
}

template <int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, const int* seg, void* z,
                      float* lse, int batch, int n_heads, int n_tok, int causal,
                      cudaStream_t stream) {
  const long long rows = static_cast<long long>(batch) * n_heads * n_tok;
  CUtensorMap qmap, kmap, vmap;
  cudaError_t err;
  if ((err = make_rows_map(&qmap, q, rows, HD)) != cudaSuccess ||
      (err = make_rows_map(&kmap, k, rows, HD)) != cudaSuccess ||
      (err = make_rows_map(&vmap, v, rows, HD)) != cudaSuccess)
    return err;
  const int bytes = Ring<HD, 1>::bytes;
  if ((err = sae::allow_smem(fwd_tc_kernel<HD>, bytes)) != cudaSuccess) return err;
  fwd_tc_kernel<HD><<<dim3(n_tok / kTile, n_heads, batch), kThreads, bytes, stream>>>(
      qmap, kmap, vmap, seg, static_cast<bf16*>(z), lse, n_heads, n_tok, causal);
  return cudaGetLastError();
}

}  // namespace tc

// ---- float32: 3xTF32 mma.sync ------------------------------------------------

namespace f32tc {

namespace t = mix::tf32;
using flash::f32::kFwdWarps;
using flash::f32::kStream;
using fw::ex2;
using fw::kLog2e;

// One chunk of 8 NJ keys from c0 of the staged tile (Ks, Vs, sk: its keys'
// segment ids; kbase: the tile's first key): scores, masks, the online
// softmax update of m and l (each thread's partial sums over its columns,
// m the row's), then acc = alpha acc + P V.
template <int HD, int NJ>
__device__ __forceinline__ void fwd_chunk(float (&acc)[HD / 8][4], float (&m)[2], float (&l)[2],
                                          const float (&qa)[HD / 8][4], const float* Ks,
                                          const float* Vs, const int* sk, int c0, int kbase,
                                          const int (&row)[2], const int (&seg_q)[2],
                                          int causal) {
  constexpr int S = flash::f32::stride(HD);
  const int tq = threadIdx.x & 3;
  float s[NJ][4];
  t::nt_chunk<HD, NJ, true, true>(s, qa, Ks, S, c0);
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int key = c0 + 8 * j + 2 * tq + c, sg = sk[key];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (sg != seg_q[h] || (causal && kbase + key > row[h])) s[j][2 * h + c] = -INFINITY;
    }
  // a row whose keys so far are all masked keeps m at -inf and subtracts 0,
  // so p and the rescale are 0, not NaN.  The rescale is formed from m's
  // difference, exactly 1 while m holds: from nb (m log2(e) rounded) it
  // would be 2^(the rounding), off 1 by up to 1.7e-7 at every chunk, and
  // over ViViT-B's 100 chunks l (and so lse) would drift 1.7e-5
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NJ; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[h], mx);
    const float base = m_new == -INFINITY ? 0.f : m_new;
    const float nb = -base * kLog2e;
    const float alpha = ex2((m[h] - base) * kLog2e);  // 0 while m[h] is -inf
    m[h] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float p = ex2(fmaf(s[j][2 * h + c], kLog2e, nb));
        s[j][2 * h + c] = p;
        sum += p;
      }
    l[h] = fmaf(l[h], alpha, sum);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      acc[n][2 * h] *= alpha;
      acc[n][2 * h + 1] *= alpha;
    }
  }
  t::pn_chunk<HD / 8, NJ>(acc, s, Vs, S, c0, 0);
}

// Grid (Tp / kTile, N, B), 32 kFwdWarps threads, fwd_smem_bytes(HD).
// Shared: two (K, V) pairs of staged tiles, then two tiles of key segment
// ids.
template <int HD>
__global__ void __launch_bounds__(kFwdWarps * 32, flash::f32::min_blocks(HD))
    fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const int* __restrict__ seg,
                    float* __restrict__ z, float* __restrict__ lse, int n_heads, int n_tok,
                    int causal) {
  constexpr int TILE = kStream * flash::f32::stride(HD), ROWS = kFwdWarps * t::kRows;
  constexpr int NJ = flash::f32::fwd_steps(HD);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* KV = reinterpret_cast<float*>(smem_raw);      // K0, V0, K1, V1
  int* segs = reinterpret_cast<int*>(KV + 4 * TILE);  // [2][kStream]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int b = blockIdx.z, i0 = blockIdx.x * ROWS, row0 = i0 + t::kRows * warp;
  const long long head = (static_cast<long long>(b) * n_heads + blockIdx.y) * n_tok;
  const int* sb = seg + static_cast<long long>(b) * n_tok;
  const int n_kt = (causal ? i0 + ROWS : n_tok) / kStream;

  auto load_kv = [&](int kt) {
    float* Ks = KV + 2 * (kt & 1) * TILE;
    flash::f32::stage<HD>(Ks, k + (head + kt * kStream) * HD, kStream);
    flash::f32::stage<HD>(Ks + TILE, v + (head + kt * kStream) * HD, kStream);
    if (threadIdx.x < kStream)
      segs[(kt & 1) * kStream + threadIdx.x] = sb[kt * kStream + threadIdx.x];
  };
  load_kv(0);
  sae::cp_async_commit();

  const int row[2] = {row0 + g, row0 + g + 8};
  const int seg_q[2] = {sb[row[0]], sb[row[1]]};
  float qa[HD / 8][4];  // raw, split per use (split once: no faster, 46 more registers)
  t::load_a<HD>(qa, q + head * HD, HD, row0, n_tok, HD);
  float acc[HD / 8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  flash::zero(acc);

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) {
      load_kv(kt + 1);
      sae::cp_async_commit();
      sae::cp_async_wait<1>();
    } else {
      sae::cp_async_wait<0>();
    }
    __syncthreads();
    const float* Ks = KV + 2 * (kt & 1) * TILE;
    const int* sk = segs + (kt & 1) * kStream;
#pragma unroll 1
    for (int c0 = 0; c0 < kStream; c0 += 8 * NJ) {
      if (causal && kt * kStream + c0 > row0 + t::kRows - 1) break;  // keys past every row
      fwd_chunk<HD, NJ>(acc, m, l, qa, Ks, Ks + TILE, sk, c0, kt * kStream, row, seg_q, causal);
    }
    __syncthreads();  // every warp is done with this pair before it is reloaded
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = l[h] > 0.f ? 1.f / l[h] : 0.f;
  }
  flash::store_rows<float, HD>(z + (head + row0) * HD, acc, inv);
  if (tq == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h) lse[head + row[h]] = l[h] > 0.f ? m[h] + logf(l[h]) : INFINITY;
}

template <int HD>
cudaError_t launch_hd(const float* q, const float* k, const float* v, const int* seg, float* z,
                      float* lse, int batch, int n_heads, int n_tok, int causal,
                      cudaStream_t stream) {
  const int bytes = flash::f32::fwd_smem_bytes(HD);
  cudaError_t err = sae::allow_smem(fwd_tf32_kernel<HD>, bytes);
  if (err != cudaSuccess) return err;
  fwd_tf32_kernel<HD><<<dim3(n_tok / kTile, n_heads, batch), kFwdWarps * 32, bytes, stream>>>(
      q, k, v, seg, z, lse, n_heads, n_tok, causal);
  return cudaGetLastError();
}

cudaError_t launch(const void* q, const void* k, const void* v, const int* seg, void* z,
                   float* lse, int batch, int n_heads, int n_tok, int d_head, int causal,
                   cudaStream_t stream) {
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v);
  float* zf = static_cast<float*>(z);
  switch (d_head) {
#define F32TC_CASE(HD) \
  case HD:             \
    return launch_hd<HD>(qf, kf, vf, seg, zf, lse, batch, n_heads, n_tok, causal, stream);
    F32TC_CASE(16) F32TC_CASE(32) F32TC_CASE(48) F32TC_CASE(64)
    F32TC_CASE(80) F32TC_CASE(96) F32TC_CASE(112) F32TC_CASE(128)
#undef F32TC_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace f32tc

}  // namespace

// q, k, v, z: [batch, n_heads, n_tok, d_head]; seg: [batch, n_tok] int32;
// lse: [batch, n_heads, n_tok] float32.  n_tok a multiple of 64; d_head a
// multiple of 16 up to 128; every pointer 16-byte aligned.  dtype: 0 =
// float32 (3xTF32), 1 = bfloat16 (heads 64 and 128 wide on the Hopper
// kernel).
// Returns the launch's cudaError_t.
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
    return f32tc::launch(q, k, v, sg, z, ls, batch, n_heads, n_tok, d_head, causal, s);
  if (dtype == 1 && d_head == 64)
    return tc::launch_hd<64>(q, k, v, sg, z, ls, batch, n_heads, n_tok, causal, s);
  if (dtype == 1 && d_head == 128)
    return tc::launch_hd<128>(q, k, v, sg, z, ls, batch, n_heads, n_tok, causal, s);
  if (dtype == 1)
    return launch(q, k, v, sg, z, ls, batch, n_heads, n_tok, d_head, causal, s);
  return cudaErrorInvalidValue;
}
