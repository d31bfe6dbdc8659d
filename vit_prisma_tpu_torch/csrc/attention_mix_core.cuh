// Attention mix, forward: z = softmax(q k^T) v per (batch item, head), for
// any layout in which each head's rows of H elements lie a fixed stride
// apart.  Shared by kernel B1 (attention_mix_tnh.cu: token-major
// [B, T, N*H]), which replaces the Pallas TPU kernel `_mix_kernel_tnh`
// launched by `_mix_tnh_forward` (vit_prisma_tpu/ops/attention.py:250), and
// kernel B15 (attention_mix.cu: head-major [B, N, T, H]), which replaces
// `_mix_kernel` launched by `_mix_forward` (:109).
//
// Element h of token t of head n of batch item b sits at
//   b * batch_stride + n * head_stride + t * tok_stride + h
// B1:  tok_stride = N*H, head_stride = H,   batch_stride = T*N*H;
// B15: tok_stride = H,   head_stride = T*H, batch_stride = N*T*H.
//
// Contract (both kernels, the Pallas kernels'): q is already scaled by
// 1/sqrt(H), scores and softmax are float32, p = e / sum(e) with the row's
// final max and sum is rounded to the input dtype before the PV product, z
// accumulates in float32 and is stored in the input dtype.  An optional
// causal mask keeps key columns col <= row.  Each (batch item, head) result
// depends on its own q, k and v alone: no atomics, no split of the keys, no
// tiling that changes with B.
//
// Three kernels, chosen by dtype and head width (never after a failure):
//  * bfloat16 with H <= 128: mix_tc_kernel, below;
//  * float32 with H <= 128: mix_tf32_kernel (mix_tf32.cuh), each float32
//    product as three TF32 products on the tensor cores ("3xTF32");
//  * float32 and bfloat16 with 128 < H <= 256 (no registered model has such
//    a head): mix_fwd_kernel, FFMA on float32 copies of K and V.
//
// What bounds the bfloat16 kernel on an H100.  At CLIP ViT-L/14 (B 256,
// T 257, N 16, H 64) it must move q, k, v and z once, 0.54 GB, 0.16 ms at
// 3.35 TB/s; its two products are 69 GFLOP, 0.07 ms on the tensor cores.
// Next come the exponentials: the exact softmax computes each score's exp
// twice (below), 0.54 G ex2 on the SFUs (16 a clock per SM), some 0.15 ms;
// then the shared-memory reads that feed the products (7.3 GB of ldmatrix,
// some 0.25 ms).  On an H100 it takes about 3x its bound.  q K^T as wgmma
// (four warps sharing each K read) measured 4.5% faster at L/14 and 29%
// slower on the causal text tower, so mma.sync serves every width.
//
// Design of mix_tc_kernel:
//  * one block per (head, batch item); it stages that head's K and V once,
//    as bfloat16, in shared memory (cp.async, 16 bytes at a time where a
//    head row allows it; rows zero-padded to a multiple of 16 keys, columns
//    to HP = H rounded up to 16), K first and V behind it, so that the
//    first scores are computed while V is still arriving;
//  * the block's warps walk the head's 16-row tiles, up to 8 warps in as
//    few rounds as possible: no head's K and V are staged twice, and at
//    T = 257 a block takes 78 KB, so two blocks share an SM;
//  * q goes from device memory straight into mma A fragments;
//  * pass 1 over chunks of 64 keys (32 where H > 64; then 16 at a time):
//    s = q K^T with mma.sync m16n8k16 in bfloat16 with float32 accumulation
//    (K fragments by ldmatrix), and each thread's running max and sum of
//    exp over its own columns; the four threads of a row then merge theirs
//    into the row's max m and sum l;
//  * pass 2: each score chunk again, p = exp(s - m) * (1/l) rounded to
//    bfloat16 in registers, which are the A fragments of z += p V (V
//    fragments by ldmatrix.trans).  No online-softmax rescale of z: p is
//    rounded where the contract rounds it.  The sum l may differ from a
//    direct sum in its last bits (partial sums, rescaled), as any sum order.
// The arithmetic of a row depends neither on the layout nor on which warp
// takes it, so B1 and B15 agree to the bit on the same data.
//
// Shared memory: FFMA kernel, T*(H4+4) floats for K, T*H for V, and per
// warp R rows of q (H4 each) and of p (T each), H4 = H rounded up to 4; the
// Python wrapper (vit_prisma_tpu_torch/ops/attention.py, mix_tnh_smem_bytes)
// gates T on its R = 1 size, which is the route gate of B1, B2 and B15.
// bfloat16 kernel: 2 * Tk * S bf16, Tk = T rounded up to 16, S = HP + 8
// (16 bytes of padding a row, so ldmatrix hits distinct banks; no padding at
// HP = 16, where it would not fit the gate's T at H <= 4): at most 219 KB for
// every (T, H <= 128) the gate admits (mix_tc_smem_bytes mirrors it).
// float32 tensor-core kernel: K and V as float32 rows (mix_tf32.cuh,
// smem_bytes; mix_tf32_layout mirrors it), within the gate as well.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_tile.cuh"  // sae_gemm.cuh's mma and copy helpers, pack_bf16

namespace mix {

constexpr int kWarps = 8;
constexpr int kRowsPerBlock = 64;
constexpr int kLoadRows = 4;  // key rows a warp loads per step
constexpr int kMaxHead = 256;
constexpr size_t kMaxSmemBytes = 232448;  // 227 KB, the H100's per-block limit

// Where each head's rows lie (see the top of this file).
struct Layout {
  long long tok_stride, head_stride, batch_stride;
};

__host__ __device__ inline int round_up4(int x) { return (x + 3) & ~3; }

__host__ __device__ inline size_t smem_bytes(int t, int h, int rows_per_warp) {
  const size_t h4 = round_up4(h);
  return sizeof(float) * (size_t(t) * (h4 + 4) + size_t(t) * h +
                          size_t(kWarps) * rows_per_warp * (h4 + t));
}

// The arguments every launcher checks: the grid's limits, the head width and
// the R = 1 shared memory.
inline bool args_ok(int batch, int n_tok, int n_heads, int d_head) {
  return batch > 0 && batch <= 65535 && n_tok > 0 && n_heads > 0 && n_heads <= 65535 &&
         d_head > 0 && d_head <= kMaxHead && smem_bytes(n_tok, d_head, 1) <= kMaxSmemBytes;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch casts
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int NC, int R>
__global__ void __launch_bounds__(kWarps * 32)
    mix_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ z, int n_tok,
                   int d_head, int causal, Layout lay) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int h4 = round_up4(d_head);
  const int k_stride = h4 + 4;
  float* ks = smem;                        // [n_tok][k_stride]
  float* qs = ks + n_tok * k_stride;       // [kWarps][R][h4]
  float* vs = qs + kWarps * R * h4;        // [n_tok][d_head]
  float* ps = vs + n_tok * d_head;         // [kWarps][R][n_tok]

  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int row_end = min(n_tok, row0 + kRowsPerBlock);
  const long long ts = lay.tok_stride;
  const long long base = (long long)b * lay.batch_stride + (long long)n * lay.head_stride;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // Stage K and V: warp w loads key rows 4w..4w+3, then 4(w+kWarps).., lane
  // l columns l, l+32, ...; all 8*NC loads of a step are issued before the
  // first is used, so their latencies overlap.  Causal rows of this tile see
  // keys [0, row_end) only.
  const int n_keys = causal ? row_end : n_tok;
  for (int t0 = warp * kLoadRows; t0 < n_keys; t0 += kWarps * kLoadRows) {
    float kr[kLoadRows][NC], vr[kLoadRows][NC];
#pragma unroll
    for (int u = 0; u < kLoadRows; ++u)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int h = lane + 32 * c;
        const bool in = t0 + u < n_keys && h < d_head;
        const long long off = base + (t0 + u) * ts + h;
        kr[u][c] = in ? to_f32(k[off]) : 0.f;
        vr[u][c] = in ? to_f32(v[off]) : 0.f;
      }
#pragma unroll
    for (int u = 0; u < kLoadRows; ++u) {
      if (t0 + u >= n_keys) break;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int h = lane + 32 * c;
        if (h < h4) ks[(t0 + u) * k_stride + h] = kr[u][c];  // zero padding
        if (h < d_head) vs[(t0 + u) * d_head + h] = vr[u][c];
      }
    }
  }
  __syncthreads();

  float* qw = qs + warp * R * h4;
  float* pw = ps + warp * R * n_tok;

  // Rows first..first+R-1; rows past the tile compute on zero q and are
  // not stored.
  for (int first = row0 + warp * R; first < row_end; first += kWarps * R) {
    const int n_rows = min(R, row_end - first);
    float qr[R][NC];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int h = lane + 32 * c;
        qr[r][c] = (r < n_rows && h < d_head)
                       ? to_f32(q[base + (first + r) * ts + h]) : 0.f;
      }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int h = lane + 32 * c;
        if (h < h4) qw[r * h4 + h] = qr[r][c];
      }
    __syncwarp();

    // Keys past the last row are masked for every row of the group.
    const int j_end = causal ? first + n_rows : n_tok;
    float m[R];
#pragma unroll
    for (int r = 0; r < R; ++r) m[r] = -INFINITY;
    for (int j = lane; j < j_end; j += 32) {
      const float4* kr = reinterpret_cast<const float4*>(ks + j * k_stride);
      float s[R];
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] = 0.f;
      for (int c = 0; c < h4 / 4; ++c) {
        const float4 bk = kr[c];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 a = reinterpret_cast<const float4*>(qw + r * h4)[c];
          s[r] = fmaf(a.x, bk.x, s[r]);
          s[r] = fmaf(a.y, bk.y, s[r]);
          s[r] = fmaf(a.z, bk.z, s[r]);
          s[r] = fmaf(a.w, bk.w, s[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (causal && j > first + r) s[r] = -INFINITY;
        pw[r * n_tok + j] = s[r];
        m[r] = fmaxf(m[r], s[r]);
      }
    }
    float sum[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      m[r] = warp_max(m[r]);
      sum[r] = 0.f;
    }
    for (int j = lane; j < j_end; j += 32) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float e = expf(pw[r * n_tok + j] - m[r]);  // 0 where masked
        pw[r * n_tok + j] = e;
        sum[r] += e;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) sum[r] = warp_sum(sum[r]);
    for (int j = lane; j < j_end; j += 32) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        pw[r * n_tok + j] = to_f32(from_f32<T>(pw[r * n_tok + j] / sum[r]));
    }
    __syncwarp();

    float acc[R][NC];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
    for (int j = 0; j < j_end; ++j) {
      const float* vr = vs + j * d_head;
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int h = lane + 32 * c;
        vv[c] = h < d_head ? vr[h] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float p = pw[r * n_tok + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= n_rows) break;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int h = lane + 32 * c;
        if (h < d_head) z[base + (first + r) * ts + h] = from_f32<T>(acc[r][c]);
      }
    }
    __syncwarp();  // qw and pw are rewritten for the next rows
  }
}

template <typename T, int NC, int R>
cudaError_t launch_nc(const void* q, const void* k, const void* v, void* z,
                      int batch, int n_tok, int n_heads, int d_head, int causal,
                      Layout lay, cudaStream_t stream) {
  const size_t smem = smem_bytes(n_tok, d_head, R);
  auto kernel = mix_fwd_kernel<T, NC, R>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n_tok + kRowsPerBlock - 1) / kRowsPerBlock, n_heads, batch);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(z), n_tok, d_head, causal, lay);
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t launch_rows(const void* q, const void* k, const void* v, void* z,
                        int batch, int n_tok, int n_heads, int d_head,
                        int causal, Layout lay, cudaStream_t stream) {
#define VPT_CASE(NC) \
  case NC:           \
    return launch_nc<T, NC, R>(q, k, v, z, batch, n_tok, n_heads, d_head, causal, lay, stream);
  // heads up to 128 wide take a tensor-core kernel (below, mix_tf32.cuh)
  switch ((d_head + 31) / 32) {
    VPT_CASE(5) VPT_CASE(6) VPT_CASE(7) VPT_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef VPT_CASE
}

// Four rows per warp where their q and p buffers fit, else one.
template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* z,
                   int batch, int n_tok, int n_heads, int d_head, int causal,
                   Layout lay, cudaStream_t stream) {
  if (smem_bytes(n_tok, d_head, 4) <= kMaxSmemBytes)
    return launch_rows<T, 4>(q, k, v, z, batch, n_tok, n_heads, d_head, causal, lay, stream);
  return launch_rows<T, 1>(q, k, v, z, batch, n_tok, n_heads, d_head, causal, lay, stream);
}

// ---- bfloat16: tensor cores ------------------------------------------------

typedef __nv_bfloat16 bf16;

constexpr int kTcMaxHead = 128;
constexpr int kTcMaxWarps = 8;
constexpr int kSub = 16;  // keys of one k-step of the PV product; rows of a warp's tile
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int tc_head_pad(int h) { return (h + 15) & ~15; }
__host__ __device__ constexpr int tc_stride(int hp) { return hp == 16 ? 16 : hp + 8; }
__host__ __device__ constexpr int tc_keys(int t) { return (t + kSub - 1) / kSub * kSub; }
// Per padded head width, measured on the H100: the 16-key sub-chunks a
// score chunk spans (independent mma chains) and the blocks of 8 warps an
// SM must hold (which caps registers: 128 a thread at 2).  Two 16-row tiles
// a warp, sharing each K and V fragment, lost at every width: their
// registers left too few warps an SM.
__host__ __device__ constexpr int tc_subs(int hp) { return hp <= 64 ? 4 : 2; }
__host__ __device__ constexpr int tc_min_blocks(int hp) { return hp <= 64 ? 2 : 1; }

// K and V of one head, bfloat16 (must match mix_tc_smem_bytes in
// vit_prisma_tpu_torch/ops/attention.py).
__host__ __device__ inline size_t tc_smem_bytes(int t, int h) {
  return 2 * sizeof(bf16) * size_t(tc_keys(t)) * tc_stride(tc_head_pad(h));
}

// Warps of a block for n_tiles 16-row tiles: as few rounds as max_warps
// allow, then as few warps as those rounds need.
inline int tc_warps(int n_tiles, int max_warps = kTcMaxWarps) {
  const int rounds = (n_tiles + max_warps - 1) / max_warps;
  return (n_tiles + rounds - 1) / rounds;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Elements (col, col + 1) of row `row` of a head as one A-fragment register,
// zero past the head's rows and columns.  vec: d_head even and the tensors
// 4-byte aligned, so the pair is one aligned 32-bit load.
__device__ __forceinline__ uint32_t load_pair(const bf16* __restrict__ p, long long ts, int row,
                                              int col, int n_tok, int d_head, bool vec) {
  if (row >= n_tok) return 0u;
  const bf16* r = p + row * ts;
  if (vec) return col < d_head ? *reinterpret_cast<const uint32_t*>(r + col) : 0u;
  const unsigned short lo = col < d_head ? __bfloat16_as_ushort(r[col]) : 0;
  const unsigned short hi = col + 1 < d_head ? __bfloat16_as_ushort(r[col + 1]) : 0;
  return uint32_t(lo) | (uint32_t(hi) << 16);
}

__device__ __forceinline__ void store_pair(bf16* __restrict__ p, long long ts, int row, int col,
                                           float a, float b, int n_tok, int d_head, bool vec) {
  if (row >= n_tok) return;
  bf16* r = p + row * ts;
  if (vec) {
    if (col < d_head) *reinterpret_cast<__nv_bfloat162*>(r + col) = __floats2bfloat162_rn(a, b);
    return;
  }
  if (col < d_head) r[col] = __float2bfloat16_rn(a);
  if (col + 1 < d_head) r[col + 1] = __float2bfloat16_rn(b);
}

// Scores of the warp's 16 rows (from row0) against the NJ 16-key sub-chunks
// from key key0, in the mma C-fragment layout: s[j][e] is row row0 + g +
// 8 (e / 2), key key0 + 8 j + 2 t + (e % 2); -inf where the key lies past
// the tokens or, causal, after the row.
template <int HP, int NJ>
__device__ __forceinline__ void chunk_scores(float (&s)[2 * NJ][4], const uint32_t (&qa)[HP / 16][4],
                                             const bf16* Ks, int key0, int row0, int n_tok,
                                             int causal) {
  constexpr int S = tc_stride(HP);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 2 * NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  const bf16* Kc = Ks + (key0 + (lane & 7) + ((lane >> 4) << 3)) * S + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < HP / 16; ++kk)
#pragma unroll
    for (int sj = 0; sj < NJ; ++sj) {
      uint32_t r[4];
      sae::ldsm_x4(r, Kc + 16 * sj * S + 16 * kk);
      sae::mma_bf16(s[2 * sj], qa[kk], r[0], r[1]);
      sae::mma_bf16(s[2 * sj + 1], qa[kk], r[2], r[3]);
    }
  if (key0 + kSub * NJ > n_tok || (causal && key0 + kSub * NJ - 1 > row0)) {
#pragma unroll
    for (int j = 0; j < 2 * NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + 8 * j + 2 * t + (e & 1);
        if (key >= n_tok || (causal && key > row0 + g + 8 * (e >> 1))) s[j][e] = -INFINITY;
      }
  }
}

// Pass 1 over one chunk: each thread's running max m and sum l of exp over
// its own columns of rows g and g + 8.
template <int HP, int NJ>
__device__ __forceinline__ void pass1_chunk(float (&m)[2], float (&l)[2],
                                            const uint32_t (&qa)[HP / 16][4], const bf16* Ks,
                                            int key0, int row0, int n_tok, int causal) {
  float s[2 * NJ][4];
  chunk_scores<HP, NJ>(s, qa, Ks, key0, row0, n_tok, causal);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = m[h];
#pragma unroll
    for (int j = 0; j < 2 * NJ; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
    const float shift = -(mx == -INFINITY ? 0.f : mx) * kLog2e;
    float sum = l[h] * ex2(fmaf(m[h], kLog2e, shift));  // 0 while m is -inf
#pragma unroll
    for (int j = 0; j < 2 * NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) sum += ex2(fmaf(s[j][2 * h + e], kLog2e, shift));
    m[h] = mx;
    l[h] = sum;
  }
}

// Pass 2 over one chunk: p = exp(s - m) / l rounded to bfloat16 in
// registers (nb = -m log2(e), inv = 1 / l), the A fragments of acc += p V.
template <int HP, int NJ>
__device__ __forceinline__ void pass2_chunk(float (&acc)[HP / 8][4], const float (&nb)[2],
                                            const float (&inv)[2], const uint32_t (&qa)[HP / 16][4],
                                            const bf16* Ks, const bf16* Vs, int key0, int row0,
                                            int n_tok, int causal) {
  constexpr int S = tc_stride(HP);
  const int lane = threadIdx.x & 31;
  float s[2 * NJ][4];
  chunk_scores<HP, NJ>(s, qa, Ks, key0, row0, n_tok, causal);
  const bf16* Vc = Vs + (key0 + (lane & 7) + ((lane >> 3) & 1) * 8) * S + (lane >> 4) * 8;
#pragma unroll
  for (int sj = 0; sj < NJ; ++sj) {
    float p[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[j][e] = ex2(fmaf(s[2 * sj + j][e], kLog2e, nb[e >> 1])) * inv[e >> 1];
    const uint32_t pa[4] = {flash::pack_bf16(p[0][0], p[0][1]), flash::pack_bf16(p[0][2], p[0][3]),
                            flash::pack_bf16(p[1][0], p[1][1]), flash::pack_bf16(p[1][2], p[1][3])};
#pragma unroll
    for (int np = 0; np < HP / 16; ++np) {
      uint32_t r[4];
      sae::ldsm_x4_t(r, Vc + 16 * sj * S + 16 * np);
      sae::mma_bf16(acc[2 * np], pa, r[0], r[1]);
      sae::mma_bf16(acc[2 * np + 1], pa, r[2], r[3]);
    }
  }
}

// z for rows [row0, row0 + 16) of one head.  sync_v: this is the warp's
// first tile, so every warp of the block waits here, after pass 1, for V.
template <int HP>
__device__ __forceinline__ void mix_rows(const bf16* Ks, const bf16* Vs,
                                         const bf16* __restrict__ qh, bf16* __restrict__ zh,
                                         long long ts, int row0, int n_tok, int d_head,
                                         int causal, bool vec, bool sync_v) {
  constexpr int NJ = tc_subs(HP);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;

  uint32_t qa[HP / 16][4];
#pragma unroll
  for (int kk = 0; kk < HP / 16; ++kk) {
    const int c0 = 16 * kk + 2 * t;
    qa[kk][0] = load_pair(qh, ts, row0 + g, c0, n_tok, d_head, vec);
    qa[kk][1] = load_pair(qh, ts, row0 + g + 8, c0, n_tok, d_head, vec);
    qa[kk][2] = load_pair(qh, ts, row0 + g, c0 + 8, n_tok, d_head, vec);
    qa[kk][3] = load_pair(qh, ts, row0 + g + 8, c0 + 8, n_tok, d_head, vec);
  }

  // The keys the tile sees: chunks of NJ 16-key sub-chunks, then the
  // remaining sub-chunks one at a time.
  const int n_sub = ((causal ? min(n_tok, row0 + kSub) : n_tok) + kSub - 1) / kSub;
  const int full_end = n_sub / NJ * NJ * kSub, end = n_sub * kSub;

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll 1
  for (int key0 = 0; key0 < full_end; key0 += NJ * kSub)
    pass1_chunk<HP, NJ>(m, l, qa, Ks, key0, row0, n_tok, causal);
#pragma unroll 1
  for (int key0 = full_end; key0 < end; key0 += kSub)
    pass1_chunk<HP, 1>(m, l, qa, Ks, key0, row0, n_tok, causal);

  // The row's max and sum from its four threads.
  float nb[2], inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = m[h];
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    nb[h] = -(mx == -INFINITY ? 0.f : mx) * kLog2e;
    float sum = l[h] * ex2(fmaf(m[h], kLog2e, nb[h]));
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    inv[h] = sum > 0.f ? 1.f / sum : 0.f;
  }

  if (sync_v) {
    sae::cp_async_wait<0>();
    __syncthreads();
  }

  float acc[HP / 8][4];
#pragma unroll
  for (int j = 0; j < HP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll 1
  for (int key0 = 0; key0 < full_end; key0 += NJ * kSub)
    pass2_chunk<HP, NJ>(acc, nb, inv, qa, Ks, Vs, key0, row0, n_tok, causal);
#pragma unroll 1
  for (int key0 = full_end; key0 < end; key0 += kSub)
    pass2_chunk<HP, 1>(acc, nb, inv, qa, Ks, Vs, key0, row0, n_tok, causal);

#pragma unroll
  for (int j = 0; j < HP / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      store_pair(zh, ts, row0 + g + 8 * h, 8 * j + 2 * t, acc[j][2 * h], acc[j][2 * h + 1],
                 n_tok, d_head, vec);
}

// Stage one head's rows [0, tc_keys(n_tok)) (row r at src + r * ts) into
// dst as bfloat16 rows of tc_stride(HP), as one cp.async group: 16 bytes at
// a time with `vec`, else element-wise; rows past the tokens and columns
// past the head are zeros.
template <int HP>
__device__ __forceinline__ void stage_head(bf16* dst, const bf16* __restrict__ src, long long ts,
                                           int n_tok, int d_head, bool vec) {
  constexpr int S = tc_stride(HP);
  const int n_keys = tc_keys(n_tok);
  if (vec) {
    constexpr int C = HP / 8;  // 16-byte chunks a padded row
    const int hc = d_head / 8;
    for (int i = threadIdx.x; i < n_keys * C; i += blockDim.x) {
      const int r = i / C, c = i % C;
      bf16* d = dst + r * S + 8 * c;
      if (r < n_tok && c < hc)
        sae::cp_async16(d, src + r * ts + 8 * c);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int i = threadIdx.x; i < n_keys * HP; i += blockDim.x) {
      const int r = i / HP, c = i % HP;
      bf16 x = __float2bfloat16(0.f);
      if (r < n_tok && c < d_head) x = src[r * ts + c];
      dst[r * S + c] = x;
    }
  }
  sae::cp_async_commit();
}

// Grid (N, B); tc_warps(ceil(T / 16)) warps; tc_smem_bytes(n_tok, d_head)
// of shared memory.  vec: d_head a multiple of 8 and q, k, v, z 16-byte
// aligned (so every head row is), else element-wise copies.
template <int HP>
__global__ void __launch_bounds__(kTcMaxWarps * 32, tc_min_blocks(HP))
    mix_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ z, int n_tok, int d_head,
                  int causal, int vec, Layout lay) {
  constexpr int S = tc_stride(HP);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_keys = tc_keys(n_tok);
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [n_keys][S]
  bf16* Vs = Ks + n_keys * S;                   // [n_keys][S]

  const long long ts = lay.tok_stride;
  const long long base =
      (long long)blockIdx.y * lay.batch_stride + (long long)blockIdx.x * lay.head_stride;

  // Stage K (one cp.async group), then V (another).
  stage_head<HP>(Ks, k + base, ts, n_tok, d_head, vec);
  stage_head<HP>(Vs, v + base, ts, n_tok, d_head, vec);
  sae::cp_async_wait<1>();
  __syncthreads();

  // Warp w takes the 16-row tiles w, w + warps, ...; every warp has one.
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int n_tiles = (n_tok + kSub - 1) / kSub;
  for (int i = warp; i < n_tiles; i += warps)
    mix_rows<HP>(Ks, Vs, q + base, z + base, ts, i * kSub, n_tok, d_head, causal, vec, i == warp);
}

template <int HP>
cudaError_t launch_tc_hp(const void* q, const void* k, const void* v, void* z, int batch,
                         int n_tok, int n_heads, int d_head, int causal, Layout lay,
                         cudaStream_t stream) {
  const size_t smem = tc_smem_bytes(n_tok, d_head);
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  auto kernel = mix_tc_kernel<HP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             int(cudaSharedmemCarveoutMaxShared));
  if (err != cudaSuccess) return err;
  const int warps = tc_warps((n_tok + kSub - 1) / kSub);
  const bool vec = d_head % 8 == 0 &&
                   ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(z)) & 15) == 0;
  kernel<<<dim3(n_heads, batch), warps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(z), n_tok, d_head, causal, int(vec), lay);
  return cudaGetLastError();
}

inline cudaError_t launch_tc(const void* q, const void* k, const void* v, void* z, int batch,
                             int n_tok, int n_heads, int d_head, int causal, Layout lay,
                             cudaStream_t stream) {
  switch (tc_head_pad(d_head)) {
#define TC_CASE(HP) \
  case HP:          \
    return launch_tc_hp<HP>(q, k, v, z, batch, n_tok, n_heads, d_head, causal, lay, stream);
    TC_CASE(16) TC_CASE(32) TC_CASE(48) TC_CASE(64)
    TC_CASE(80) TC_CASE(96) TC_CASE(112) TC_CASE(128)
#undef TC_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace mix

#include "mix_tf32.cuh"

namespace mix {

// Check the arguments, select the device and launch (0 = float32, 1 =
// bfloat16): heads up to kTcMaxHead wide take the tensor-core kernel of
// their dtype (mix_tc_kernel, mix_tf32_kernel), wider ones the FFMA kernel.
// Returns the cudaError_t.
inline int run(const void* q, const void* k, const void* v, void* z, int batch,
               int n_tok, int n_heads, int d_head, int causal, int dtype, int device,
               Layout lay, void* stream) {
  if (!args_ok(batch, n_tok, n_heads, d_head)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d_head <= tf32::kMaxHead)
    return tf32::launch_fwd(q, k, v, z, batch, n_tok, n_heads, d_head, causal, lay, device, s);
  if (dtype == 0) return launch<float>(q, k, v, z, batch, n_tok, n_heads, d_head, causal, lay, s);
  if (dtype == 1 && d_head <= kTcMaxHead)
    return launch_tc(q, k, v, z, batch, n_tok, n_heads, d_head, causal, lay, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, z, batch, n_tok, n_heads, d_head, causal, lay, s);
  return cudaErrorInvalidValue;
}

}  // namespace mix
