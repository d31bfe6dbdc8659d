// Token-major attention mix, backward: dq, dk and dv of z = softmax(q k^T) v
// per head.
//
// Replaces the Pallas TPU kernel `_mix_tnh_bwd_kernel`, launched by
// `_mix_tnh_backward` in vit_prisma_tpu/ops/attention.py (kernel B2 of the
// ROADMAP): the exact VJP of the forward kernel (attention_mix_tnh.cu, B1)
// over the same [B, T, N*H] layout, q pre-scaled, causal optional.  Per head
// and with the Pallas kernel's rounding points:
//   p  = softmax(q k^T) in float32 (0 where masked), recomputed, not stored;
//   dp = dz v^T, float32 sums of the input-dtype products;
//   ds = p (dp - rowsum(dp p)) in float32, then rounded to q's dtype;
//   dq = ds k,  dk = ds^T q,  dv = pc^T dz  with pc = p rounded to v's dtype;
// float32 accumulation, each output stored in its input's dtype.
//
// What bounds it on an H100.  It reads q, k, v, dz and writes dq, dk, dv
// once: 7 B T N H elements, against 5 products of 2 B N T^2 H flops.  At the
// CLIP ViT-B/32 shape (T = 50, H = 64) that is some 70 flops per element
// moved, below the ~295 flops per byte where the tensor cores, not memory,
// would be the limit; so, as for B1, the aim is to cross device memory once
// per element and to keep the T x T scores and their gradient on the SM.
// This version runs its products on the CUDA cores out of shared memory, so
// shared-memory loads and their latency bound it; each warp works on R rows
// (or keys) at once, so that one load feeds R independent FMA chains.
//
// Design: two passes, each within B1's shared memory, so that every (T, H)
// the forward accepts has a backward (a single block holding K, V and
// float32 dK, dV accumulators for the whole T would not fit at the L/14
// shape, T = 257).
//  * rows pass, one block per (64 query rows, head, batch item): K (rows
//    padded, as in B1) and V transposed in float32 shared memory; each warp
//    owns R query rows at a time and each lane keys lane, lane+32, ...:
//    scores, each row's max m and sum l (warp shuffles), p, dp and the row's
//    D = sum(dp p); then ds per key, and dq with each lane owning columns
//    lane, lane+32, ...  It writes dq and each row's m, l and D (float32).
//  * columns pass, one block per (64 key columns, head, batch item): Q and dZ
//    in float32 shared memory, with every row's m, l and D; each warp owns R
//    keys at a time; lanes take 32 query rows at a time, recompute s with the
//    same products in the same order as the rows pass, so p = exp(s - m) / l
//    comes out bit for bit the same, form ds and pc, park them in a per-warp
//    buffer, and then accumulate dk and dv with each lane owning columns.
// Each pass takes the first of (8 warps, R = 4), (4, 4), then R = 1 at 8, 4,
// 2 or 1 warps that its shared memory allows; at (4 warps, R = 1) the rows
// pass takes exactly B1's bytes (R = 1), and the columns pass no more than
// them at the T where that matters.  The Python wrapper
// (vit_prisma_tpu_torch/ops/attention.py, mix_tnh_bwd_fits_smem) mirrors
// both sizes.
//
// Two routes, chosen by dtype and head width (never after a failure), as
// B1's forward: float32, and bfloat16 heads wider than 128, run the FFMA
// passes above; bfloat16 heads up to 128 wide run the tensor-core passes
// below (namespace tc), whose five products are mma.sync m16n8k16 in
// bfloat16 with float32 accumulation:
//  * one block per (head, batch item) in each pass; the block stages its
//    resident pair once, as bfloat16 rows zero-padded to 16 (B1's
//    stage_head: K and V in the rows pass, Q and dZ in the columns pass),
//    and its warps walk the head's 16-row (16-key) tiles as B1's warps do,
//    so no head is staged twice and no block holds a near-empty tile.  Each
//    pass takes B1's bf16 bytes exactly (mix_tc_smem_bytes), inside the
//    gate at every H <= 128;
//  * rows pass, per 16-row tile with q and dz in A fragments: sweep 1 forms
//    s = q K^T and dp = dz V^T, each row's running max m, sum l of
//    exp(s - m) and sum w of dp exp(s - m), both rescaled as m grows (ex2
//    with log2(e) folded in), so D = w / l = sum(dp p) in float32 from the
//    fragments (the Pallas kernel's D, summed in another order); sweep 2
//    forms s and dp again, p = exp(s - m) / l (one reciprocal a row) and
//    ds = p (dp - D), rounded to bfloat16 in registers as the A fragments of
//    dq += ds K (K fragments by ldmatrix.trans).  It writes dq and each
//    row's log2-sum-exp m log2(e) + log2(l) and D, [T][2] per head, to the
//    stats scratch;
//  * columns pass, per 16-key tile with k and v in A fragments: s^T = K Q^T
//    and dp^T = V dZ^T with keys as rows, p^T = exp2(s^T log2(e) - lse2),
//    p^T rounded to bfloat16 and ds^T = p^T (dp^T - D) rounded to bfloat16
//    go straight into the A fragments of dv += p^T dZ and dk += ds^T Q: no
//    per-warp buffer.  Each query's statistics sit in the 16 bytes of
//    padding of its Q row in shared memory (read through L1 at H <= 16,
//    whose rows have none: 1.7x slower at L/14 than from shared memory).
//    At H <= 64 a block has at most 6 warps and two blocks share an SM at
//    170 registers a thread, so the A fragments and both accumulators stay
//    in registers.
// The two passes need not agree on p to the bit (the rows pass scales by
// 1 / l, the columns pass subtracts log2(l)): the plain version's tolerance
// holds each output.  No atomics and no split of a head's keys across
// blocks: a (head, batch item) result depends on its own inputs alone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_mix_core.cuh"

namespace {

constexpr int kTile = 64;     // query rows (rows pass) or keys (columns pass) per block
constexpr int kLoadRows = 4;  // rows a warp loads per staging step
constexpr int kMaxHead = 256;
constexpr int kMaxWarps = 8;
constexpr size_t kMaxSmemBytes = 232448;  // 227 KB, the H100's per-block limit

struct Shape {
  int warps, rows;  // warps a block, rows (or keys) a warp works on at once
};
constexpr Shape kShapes[] = {{8, 4}, {4, 4}, {8, 1}, {4, 1}, {2, 1}, {1, 1}};

__host__ __device__ inline int round_up4(int x) { return (x + 3) & ~3; }

// Rows pass (floats): K [t][h4 + 4], V^T [h][t], and per warp R q rows and
// R dz rows (h4 each) and R p and R dp rows (t each).
__host__ __device__ inline size_t rows_smem_bytes(int t, int h, Shape s) {
  const size_t h4 = round_up4(h);
  return sizeof(float) * (size_t(t) * (h4 + 4) + size_t(t) * h +
                          size_t(s.warps) * s.rows * (2 * h4 + 2 * size_t(t)));
}

// Columns pass: Q and dZ rows padded like K where H is a multiple of 4.
__host__ __device__ inline int cols_stride(int h) {
  return round_up4(h) + ((h & 3) ? 0 : 4);
}

// Columns pass (floats): Q and dZ [t][stride], m, l and D [t] each, and per
// warp R k and R v rows (h4 each) and 32 R ds and 32 R pc values.
__host__ __device__ inline size_t cols_smem_bytes(int t, int h, Shape s) {
  return sizeof(float) * (2 * size_t(t) * cols_stride(h) + 3 * size_t(t) +
                          size_t(s.warps) * s.rows * (2 * size_t(round_up4(h)) + 64));
}

// The first shape whose pass fits; warps = 0 where none does.
Shape pick(size_t (*bytes)(int, int, Shape), int t, int h) {
  for (const Shape& s : kShapes)
    if (bytes(t, h, s) <= kMaxSmemBytes) return s;
  return {0, 0};
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

// x rounded to T and back: the kernel's cast points for ds and pc.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
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

// acc[r] += a[r] . b over n4 float4s, one fmaf per element in column order,
// for R rows a (stride a_stride) against one row b.  Both passes form s (and
// dp) through this one function with q (dz) as a and k (v) as b, so that
// their p agree bit for bit whatever R each pass takes.
template <int R>
__device__ __forceinline__ void dots(float (&acc)[R], const float* a, int a_stride,
                                     const float* b, int n4) {
  const float4* b4 = reinterpret_cast<const float4*>(b);
  for (int c = 0; c < n4; ++c) {
    const float4 y = b4[c];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 x = reinterpret_cast<const float4*>(a + r * a_stride)[c];
      acc[r] = fmaf(x.x, y.x, acc[r]);
      acc[r] = fmaf(x.y, y.y, acc[r]);
      acc[r] = fmaf(x.z, y.z, acc[r]);
      acc[r] = fmaf(x.w, y.w, acc[r]);
    }
  }
}

// The same with one row a against R rows b: acc[r] += a . b[r].
template <int R>
__device__ __forceinline__ void dots_t(float (&acc)[R], const float* a, const float* b,
                                       int b_stride, int n4) {
  const float4* a4 = reinterpret_cast<const float4*>(a);
  for (int c = 0; c < n4; ++c) {
    const float4 x = a4[c];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 y = reinterpret_cast<const float4*>(b + r * b_stride)[c];
      acc[r] = fmaf(x.x, y.x, acc[r]);
      acc[r] = fmaf(x.y, y.y, acc[r]);
      acc[r] = fmaf(x.z, y.z, acc[r]);
      acc[r] = fmaf(x.w, y.w, acc[r]);
    }
  }
}

// Stage rows [first, end) of x (one head of [B, T, N*H]) into xs as float32
// rows of `stride` floats, zero from d_head to h4, and y into ys: transposed,
// [d_head][n_tok], with `y_transposed`, else as rows like x.  Each warp
// issues the loads of kLoadRows rows before storing any, so that their
// latencies overlap.
template <typename T, int NC>
__device__ void stage(const T* __restrict__ x, const T* __restrict__ y, float* xs,
                      float* ys, bool y_transposed, int first, int end, int stride,
                      int n_tok, int d_head, long long base, long long nh) {
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int h4 = round_up4(d_head);
  for (int t0 = first + warp * kLoadRows; t0 < end; t0 += warps * kLoadRows) {
    float xr[kLoadRows][NC], yr[kLoadRows][NC];
#pragma unroll
    for (int u = 0; u < kLoadRows; ++u)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int h = lane + 32 * c;
        const bool in = t0 + u < end && h < d_head;
        const long long off = base + (t0 + u) * nh + h;
        xr[u][c] = in ? to_f32(x[off]) : 0.f;
        yr[u][c] = in ? to_f32(y[off]) : 0.f;
      }
#pragma unroll
    for (int u = 0; u < kLoadRows; ++u) {
      if (t0 + u >= end) break;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int h = lane + 32 * c;
        if (h < h4) xs[(t0 + u) * stride + h] = xr[u][c];  // zero padding
        if (y_transposed) {
          if (h < d_head) ys[h * n_tok + t0 + u] = yr[u][c];
        } else if (h < h4) {
          ys[(t0 + u) * stride + h] = yr[u][c];
        }
      }
    }
  }
}

// Load `n` rows of one head (from row `first`) into R float32 rows of h4
// (zero past d_head and past the n rows).
template <typename T, int NC, int R>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src, int first,
                                          int n, int d_head, long long base,
                                          long long nh, int lane) {
  const int h4 = round_up4(d_head);
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int h = lane + 32 * c;
      if (h < h4)
        dst[r * h4 + h] = (r < n && h < d_head) ? to_f32(src[base + (first + r) * nh + h]) : 0.f;
    }
}

template <typename T, int NC, int R>
__global__ void __launch_bounds__(kMaxWarps * 32)
    mix_tnh_bwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ dz,
                            T* __restrict__ dq, float* __restrict__ stats,
                            int n_tok, int n_heads, int d_head, int causal) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int warps = blockDim.x >> 5;
  const int h4 = round_up4(d_head);
  const int k_stride = h4 + 4;
  float* ks = smem;                         // [n_tok][k_stride]
  float* rows = ks + n_tok * k_stride;      // per warp: q [R][h4], dz [R][h4]
  float* vt = rows + warps * 2 * R * h4;    // [d_head][n_tok]
  float* pbuf = vt + d_head * n_tok;        // per warp: p [R][n_tok], dp [R][n_tok]

  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = blockIdx.x * kTile;
  const int row_end = min(n_tok, row0 + kTile);
  const long long nh = (long long)n_heads * d_head;
  const long long base = (long long)b * n_tok * nh + (long long)n * d_head;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // Causal rows of this tile see keys [0, row_end) only.
  stage<T, NC>(k, v, ks, vt, true, 0, causal ? row_end : n_tok, k_stride, n_tok,
               d_head, base, nh);
  __syncthreads();

  float* qw = rows + warp * 2 * R * h4;
  float* dzw = qw + R * h4;
  float* pw = pbuf + warp * 2 * R * n_tok;
  float* dpw = pw + R * n_tok;
  float* st = stats + ((long long)b * n_heads + n) * 3 * n_tok;  // m | l | D

  // Rows first..first+R-1; rows past the tile compute on zero q and dz and
  // are not stored.
  for (int first = row0 + warp * R; first < row_end; first += warps * R) {
    const int n_rows = min(R, row_end - first);
    load_rows<T, NC, R>(qw, q, first, n_rows, d_head, base, nh, lane);
    load_rows<T, NC, R>(dzw, dz, first, n_rows, d_head, base, nh, lane);
    __syncwarp();

    // Keys past the group's last row are masked for every row of it.
    const int j_end = causal ? first + n_rows : n_tok;
    float m[R];
#pragma unroll
    for (int r = 0; r < R; ++r) m[r] = -INFINITY;
    for (int j = lane; j < j_end; j += 32) {
      float s[R];
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] = 0.f;
      dots<R>(s, qw, h4, ks + j * k_stride, h4 / 4);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (causal && j > first + r) s[r] = -INFINITY;
        pw[r * n_tok + j] = s[r];
        m[r] = fmaxf(m[r], s[r]);
      }
    }
    float l[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      m[r] = warp_max(m[r]);
      l[r] = 0.f;
    }
    for (int j = lane; j < j_end; j += 32) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float e = expf(pw[r * n_tok + j] - m[r]);  // 0 where masked
        pw[r * n_tok + j] = e;
        l[r] += e;
      }
    }
    float dsum[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      l[r] = warp_sum(l[r]);
      dsum[r] = 0.f;
    }
    for (int j = lane; j < j_end; j += 32) {
      float dp[R];
#pragma unroll
      for (int r = 0; r < R; ++r) dp[r] = 0.f;
      for (int h = 0; h < d_head; ++h) {
        const float vh = vt[h * n_tok + j];
#pragma unroll
        for (int r = 0; r < R; ++r) dp[r] = fmaf(dzw[r * h4 + h], vh, dp[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float p = pw[r * n_tok + j] / l[r];
        pw[r * n_tok + j] = p;
        dpw[r * n_tok + j] = dp[r];
        dsum[r] = fmaf(dp[r], p, dsum[r]);
      }
    }
    float D[R];
#pragma unroll
    for (int r = 0; r < R; ++r) D[r] = warp_sum(dsum[r]);
    for (int j = lane; j < j_end; j += 32) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        pw[r * n_tok + j] = round_to<T>(pw[r * n_tok + j] * (dpw[r * n_tok + j] - D[r]));
    }
    __syncwarp();

    float acc[R][NC];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
    for (int j = 0; j < j_end; ++j) {
      const float* kr = ks + j * k_stride;
      float ds[R];
#pragma unroll
      for (int r = 0; r < R; ++r) ds[r] = pw[r * n_tok + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int h = lane + 32 * c;
        const float kh = h < d_head ? kr[h] : 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r][c] = fmaf(ds[r], kh, acc[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= n_rows) break;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int h = lane + 32 * c;
        if (h < d_head) dq[base + (first + r) * nh + h] = from_f32<T>(acc[r][c]);
      }
      if (lane == 0) {
        st[first + r] = m[r];
        st[n_tok + first + r] = l[r];
        st[2 * n_tok + first + r] = D[r];
      }
    }
    __syncwarp();  // the per-warp rows are rewritten for the next group
  }
}

template <typename T, int NC, int R>
__global__ void __launch_bounds__(kMaxWarps * 32)
    mix_tnh_bwd_cols_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ dz,
                            const float* __restrict__ stats, T* __restrict__ dk,
                            T* __restrict__ dv, int n_tok, int n_heads, int d_head,
                            int causal) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int warps = blockDim.x >> 5;
  const int h4 = round_up4(d_head);
  const int stride = cols_stride(d_head);
  float* qs = smem;                       // [n_tok][stride]
  float* dzs = qs + n_tok * stride;       // [n_tok][stride]
  float* kv = dzs + n_tok * stride;       // per warp: k [R][h4], v [R][h4]
  float* sts = kv + warps * 2 * R * h4;   // m [n_tok], l [n_tok], D [n_tok]
  float* bufs = sts + 3 * n_tok;          // per warp: ds [32][R], pc [32][R]

  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int col0 = blockIdx.x * kTile;
  const int col_end = min(n_tok, col0 + kTile);
  const long long nh = (long long)n_heads * d_head;
  const long long base = (long long)b * n_tok * nh + (long long)n * d_head;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // Causal keys of this tile are seen by rows [col0, n_tok) only.
  const int row_first = causal ? col0 : 0;
  stage<T, NC>(q, dz, qs, dzs, false, row_first, n_tok, stride, n_tok, d_head, base, nh);
  const float* st = stats + ((long long)b * n_heads + n) * 3 * n_tok;
  for (int t = row_first + threadIdx.x; t < n_tok; t += blockDim.x) {
    sts[t] = st[t];
    sts[n_tok + t] = st[n_tok + t];
    sts[2 * n_tok + t] = st[2 * n_tok + t];
  }
  __syncthreads();

  float* kw = kv + warp * 2 * R * h4;
  float* vw = kw + R * h4;
  float* dsb = bufs + warp * 64 * R;
  float* pcb = dsb + 32 * R;

  // Keys first..first+R-1; keys past the tile compute on zero k and v and
  // are not stored.
  for (int first = col0 + warp * R; first < col_end; first += warps * R) {
    const int n_keys = min(R, col_end - first);
    load_rows<T, NC, R>(kw, k, first, n_keys, d_head, base, nh, lane);
    load_rows<T, NC, R>(vw, v, first, n_keys, d_head, base, nh, lane);
    __syncwarp();

    float ak[R][NC], av[R][NC];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) ak[r][c] = av[r][c] = 0.f;
    // Rows below a key are masked when causal; start at the group's 32.
    for (int r0 = causal ? (first & ~31) : 0; r0 < n_tok; r0 += 32) {
      const int i = r0 + lane;
      float ds[R], pc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) ds[r] = pc[r] = 0.f;
      if (i < n_tok) {
        float s[R], dp[R];
#pragma unroll
        for (int r = 0; r < R; ++r) s[r] = dp[r] = 0.f;
        dots_t<R>(s, qs + i * stride, kw, h4, h4 / 4);
        dots_t<R>(dp, dzs + i * stride, vw, h4, h4 / 4);
        const float m = sts[i], l = sts[n_tok + i], D = sts[2 * n_tok + i];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r < n_keys && (!causal || i >= first + r)) {
            const float p = expf(s[r] - m) / l;
            ds[r] = round_to<T>(p * (dp[r] - D));
            pc[r] = round_to<T>(p);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        dsb[lane * R + r] = ds[r];
        pcb[lane * R + r] = pc[r];
      }
      __syncwarp();
      const int n_rows = min(32, n_tok - r0);
      for (int u = 0; u < n_rows; ++u) {
        float a[R], pp[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          a[r] = dsb[u * R + r];
          pp[r] = pcb[u * R + r];
        }
        const float* qr = qs + (r0 + u) * stride;
        const float* dr = dzs + (r0 + u) * stride;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int h = lane + 32 * c;
          const float qh = h < d_head ? qr[h] : 0.f;
          const float dh = h < d_head ? dr[h] : 0.f;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            ak[r][c] = fmaf(a[r], qh, ak[r][c]);
            av[r][c] = fmaf(pp[r], dh, av[r][c]);
          }
        }
      }
      __syncwarp();  // dsb and pcb are rewritten for the next rows
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= n_keys) break;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int h = lane + 32 * c;
        if (h < d_head) {
          dk[base + (first + r) * nh + h] = from_f32<T>(ak[r][c]);
          dv[base + (first + r) * nh + h] = from_f32<T>(av[r][c]);
        }
      }
    }
    __syncwarp();  // kw and vw are rewritten for the next keys
  }
}

template <typename T, int NC, int R>
cudaError_t launch_rows(const T* q, const T* k, const T* v, const T* dz, T* dq,
                        float* stats, dim3 grid, Shape s, int n_tok, int n_heads,
                        int d_head, int causal, cudaStream_t stream) {
  const size_t smem = rows_smem_bytes(n_tok, d_head, s);
  auto kernel = mix_tnh_bwd_rows_kernel<T, NC, R>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, s.warps * 32, smem, stream>>>(q, k, v, dz, dq, stats, n_tok, n_heads,
                                               d_head, causal);
  return cudaGetLastError();
}

template <typename T, int NC, int R>
cudaError_t launch_cols(const T* q, const T* k, const T* v, const T* dz, const float* stats,
                        T* dk, T* dv, dim3 grid, Shape s, int n_tok, int n_heads,
                        int d_head, int causal, cudaStream_t stream) {
  const size_t smem = cols_smem_bytes(n_tok, d_head, s);
  auto kernel = mix_tnh_bwd_cols_kernel<T, NC, R>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, s.warps * 32, smem, stream>>>(q, k, v, dz, stats, dk, dv, n_tok,
                                               n_heads, d_head, causal);
  return cudaGetLastError();
}

template <typename T, int NC>
cudaError_t launch_nc(const void* q, const void* k, const void* v, const void* dz,
                      void* dq, void* dk, void* dv, float* stats, int batch,
                      int n_tok, int n_heads, int d_head, int causal,
                      cudaStream_t stream) {
  const dim3 grid((n_tok + kTile - 1) / kTile, n_heads, batch);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dzt = static_cast<const T*>(dz);
  const Shape s1 = pick(rows_smem_bytes, n_tok, d_head);
  cudaError_t err =
      s1.rows == 4
          ? launch_rows<T, NC, 4>(qt, kt, vt, dzt, static_cast<T*>(dq), stats, grid, s1,
                                  n_tok, n_heads, d_head, causal, stream)
          : launch_rows<T, NC, 1>(qt, kt, vt, dzt, static_cast<T*>(dq), stats, grid, s1,
                                  n_tok, n_heads, d_head, causal, stream);
  if (err != cudaSuccess) return err;
  const Shape s2 = pick(cols_smem_bytes, n_tok, d_head);
  return s2.rows == 4
             ? launch_cols<T, NC, 4>(qt, kt, vt, dzt, stats, static_cast<T*>(dk),
                                     static_cast<T*>(dv), grid, s2, n_tok, n_heads,
                                     d_head, causal, stream)
             : launch_cols<T, NC, 1>(qt, kt, vt, dzt, stats, static_cast<T*>(dk),
                                     static_cast<T*>(dv), grid, s2, n_tok, n_heads,
                                     d_head, causal, stream);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dz,
                   void* dq, void* dk, void* dv, float* stats, int batch, int n_tok,
                   int n_heads, int d_head, int causal, cudaStream_t stream) {
#define VPT_CASE(NC)                                                             \
  case NC:                                                                       \
    return launch_nc<T, NC>(q, k, v, dz, dq, dk, dv, stats, batch, n_tok, n_heads, \
                            d_head, causal, stream);
  // heads up to 128 wide take a tensor-core route (tc and tf32, below)
  switch ((d_head + 31) / 32) {
    VPT_CASE(5) VPT_CASE(6) VPT_CASE(7) VPT_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef VPT_CASE
}

// ---- bfloat16: tensor cores -------------------------------------------------

namespace tc {

using mix::bf16;
using mix::ex2;
using mix::kLog2e;
using mix::kSub;
using mix::tc_stride;

// The A fragments of rows [row0, row0 + 16) of one head (row r at p + r *
// ts), zero past the tokens and the head, as B1's q.
template <int HP>
__device__ __forceinline__ void load_a(uint32_t (&a)[HP / 16][4], const bf16* __restrict__ p,
                                       long long ts, int row0, int n_tok, int d_head, bool vec) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < HP / 16; ++kk) {
    const int c0 = 16 * kk + 2 * t;
    a[kk][0] = mix::load_pair(p, ts, row0 + g, c0, n_tok, d_head, vec);
    a[kk][1] = mix::load_pair(p, ts, row0 + g + 8, c0, n_tok, d_head, vec);
    a[kk][2] = mix::load_pair(p, ts, row0 + g, c0 + 8, n_tok, d_head, vec);
    a[kk][3] = mix::load_pair(p, ts, row0 + g + 8, c0 + 8, n_tok, d_head, vec);
  }
}

// c = a B^T for the 16 columns from n0: B's rows [n][HP] in shared memory
// (B fragments by ldmatrix), c in the mma C-fragment layout: c[j][e] is
// row g + 8 (e / 2), column n0 + 8 j + 2 t + (e % 2).
template <int HP>
__device__ __forceinline__ void nt16(float (&c)[2][4], const uint32_t (&a)[HP / 16][4],
                                     const bf16* Bs, int n0) {
  constexpr int S = tc_stride(HP);
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
  const bf16* Bc = Bs + (n0 + (lane & 7) + ((lane >> 4) << 3)) * S + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < HP / 16; ++kk) {
    uint32_t r[4];
    sae::ldsm_x4(r, Bc + 16 * kk);
    sae::mma_bf16(c[0], a[kk], r[0], r[1]);
    sae::mma_bf16(c[1], a[kk], r[2], r[3]);
  }
}

// acc += P B over the 16 rows of B from k0 (rows [k][HP] in shared memory,
// fragments by ldmatrix.trans); pa: P's A fragment.
template <int HP>
__device__ __forceinline__ void pn16(float (&acc)[HP / 8][4], const uint32_t (&pa)[4],
                                     const bf16* Bs, int k0) {
  constexpr int S = tc_stride(HP);
  const int lane = threadIdx.x & 31;
  const bf16* Bc = Bs + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * S + (lane >> 4) * 8;
#pragma unroll
  for (int np = 0; np < HP / 16; ++np) {
    uint32_t r[4];
    sae::ldsm_x4_t(r, Bc + 16 * np);
    sae::mma_bf16(acc[2 * np], pa, r[0], r[1]);
    sae::mma_bf16(acc[2 * np + 1], pa, r[2], r[3]);
  }
}

// C fragments of 16 columns, rounded to bfloat16, as one A fragment.
__device__ __forceinline__ void to_a(uint32_t (&a)[4], const float (&c)[2][4]) {
  a[0] = flash::pack_bf16(c[0][0], c[0][1]);
  a[1] = flash::pack_bf16(c[0][2], c[0][3]);
  a[2] = flash::pack_bf16(c[1][0], c[1][1]);
  a[3] = flash::pack_bf16(c[1][2], c[1][3]);
}

// Store a warp's c[HP/8][4] as rows row0 + g and row0 + g + 8 of one head.
template <int HP>
__device__ __forceinline__ void store_rows(bf16* __restrict__ p, const float (&c)[HP / 8][4],
                                           long long ts, int row0, int n_tok, int d_head,
                                           bool vec) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < HP / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      mix::store_pair(p, ts, row0 + g + 8 * h, 8 * j + 2 * t, c[j][2 * h], c[j][2 * h + 1],
                      n_tok, d_head, vec);
}

// The rows pass for rows [row0, row0 + 16).
template <int HP>
__device__ __forceinline__ void rows_tile(const bf16* Ks, const bf16* Vs,
                                          const bf16* __restrict__ qh,
                                          const bf16* __restrict__ dzh, bf16* __restrict__ dqh,
                                          float2* __restrict__ st, long long ts, int row0,
                                          int n_tok, int d_head, int causal, bool vec) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t qa[HP / 16][4], da[HP / 16][4];
  load_a<HP>(qa, qh, ts, row0, n_tok, d_head, vec);
  load_a<HP>(da, dzh, ts, row0, n_tok, d_head, vec);
  // The keys the tile sees, in 16-key sub-chunks.
  const int end = ((causal ? min(n_tok, row0 + kSub) : n_tok) + kSub - 1) / kSub * kSub;

  // Sweep 1: s and dp, each row's running max m and sums l = sum(exp(s - m))
  // and w = sum(dp exp(s - m)), rescaled as m grows; D = w / l is
  // sum(dp p), summed in another order.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, w[2] = {0.f, 0.f};
#pragma unroll 1
  for (int key0 = 0; key0 < end; key0 += kSub) {
    float s[2][4], dp[2][4];
    mix::chunk_scores<HP, 1>(s, qa, Ks, key0, row0, n_tok, causal);
    nt16<HP>(dp, da, Vs, key0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m[h];
#pragma unroll
      for (int j = 0; j < 2; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      const float shift = -(mx == -INFINITY ? 0.f : mx) * kLog2e;
      const float a = ex2(fmaf(m[h], kLog2e, shift));  // 0 while m is -inf
      float sum = l[h] * a, ws = w[h] * a;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float e = ex2(fmaf(s[j][2 * h + c], kLog2e, shift));
          sum += e;
          ws = fmaf(dp[j][2 * h + c], e, ws);
        }
      m[h] = mx;
      l[h] = sum;
      w[h] = ws;
    }
  }
  float nb[2], inv[2], lse2[2], D[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = m[h];
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    nb[h] = -(mx == -INFINITY ? 0.f : mx) * kLog2e;
    const float a = ex2(fmaf(m[h], kLog2e, nb[h]));
    float sum = l[h] * a, ws = w[h] * a;
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    ws += __shfl_xor_sync(0xffffffffu, ws, 1);
    ws += __shfl_xor_sync(0xffffffffu, ws, 2);
    inv[h] = sum > 0.f ? 1.f / sum : 0.f;
    lse2[h] = log2f(sum) - nb[h];
    D[h] = ws * inv[h];
  }

  // p and dp of one 16-key sub-chunk (p = 0 where masked).
  auto p_dp = [&](float (&p)[2][4], float (&dp)[2][4], int key0) {
    mix::chunk_scores<HP, 1>(p, qa, Ks, key0, row0, n_tok, causal);
    nt16<HP>(dp, da, Vs, key0);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[j][e] = ex2(fmaf(p[j][e], kLog2e, nb[e >> 1])) * inv[e >> 1];
  };

  // Sweep 2: dq += ds K with ds = p (dp - D) rounded to bfloat16.
  float acc[HP / 8][4];
  flash::zero(acc);
#pragma unroll 1
  for (int key0 = 0; key0 < end; key0 += kSub) {
    float p[2][4], dp[2][4];
    p_dp(p, dp, key0);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[j][e] *= dp[j][e] - D[e >> 1];
    uint32_t a[4];
    to_a(a, p);
    pn16<HP>(acc, a, Ks, key0);
  }
  store_rows<HP>(dqh, acc, ts, row0, n_tok, d_head, vec);
  if (t == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + g + 8 * h;
      if (row < n_tok) st[row] = make_float2(lse2[h], D[h]);
    }
}

// The columns pass for keys [key0, key0 + 16).
template <int HP>
__device__ __forceinline__ void cols_tile(const bf16* Qs, const bf16* dZs,
                                          const bf16* __restrict__ kh,
                                          const bf16* __restrict__ vh, bf16* __restrict__ dkh,
                                          bf16* __restrict__ dvh, const float2* __restrict__ st,
                                          long long ts, int key0, int n_tok, int d_head,
                                          int causal, bool vec) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t ka[HP / 16][4], va[HP / 16][4];
  load_a<HP>(ka, kh, ts, key0, n_tok, d_head, vec);
  load_a<HP>(va, vh, ts, key0, n_tok, d_head, vec);
  float adk[HP / 8][4], adv[HP / 8][4];
  flash::zero(adk);
  flash::zero(adv);
  // Queries before a key are masked when causal.
  const int end = mix::tc_keys(n_tok);
#pragma unroll 1
  for (int q0 = causal ? key0 : 0; q0 < end; q0 += kSub) {
    float p[2][4], dp[2][4];
    nt16<HP>(p, ka, Qs, q0);   // s^T: rows are keys, columns queries
    nt16<HP>(dp, va, dZs, q0);  // dp^T = V dZ^T
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int qi = q0 + 8 * j + 2 * t + c;
        const float2 sd = qi >= n_tok ? make_float2(0.f, 0.f)
                          : HP > 16 ? *reinterpret_cast<const float2*>(Qs + qi * tc_stride(HP) + HP)
                                    : __ldg(st + qi);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 2 * h + c;
          const bool ok = qi < n_tok && (!causal || qi >= key0 + g + 8 * h);
          const float pe = ok ? ex2(fmaf(p[j][e], kLog2e, -sd.x)) : 0.f;
          p[j][e] = pe;
          dp[j][e] = pe * (dp[j][e] - sd.y);
        }
      }
    uint32_t a[4];
    to_a(a, p);  // p^T rounded to bfloat16
    pn16<HP>(adv, a, dZs, q0);
    to_a(a, dp);  // ds^T rounded to bfloat16
    pn16<HP>(adk, a, Qs, q0);
  }
  store_rows<HP>(dkh, adk, ts, key0, n_tok, d_head, vec);
  store_rows<HP>(dvh, adv, ts, key0, n_tok, d_head, vec);
}

// The columns pass's warps a block at most and blocks an SM: two blocks of
// at most 6 warps where H <= 64 (170 registers a thread: the 16 keys' A
// fragments and both accumulators stay in registers), else B1's.
__host__ __device__ constexpr int cols_max_warps(int hp) { return hp <= 64 ? 6 : mix::kTcMaxWarps; }
__host__ __device__ constexpr int cols_min_blocks(int hp) { return hp <= 64 ? 2 : 1; }

// Grid (N, B); mix::tc_warps(ceil(T / 16)) warps (the columns pass:
// mix::tc_warps(ceil(T / 16), cols_max_warps(HP))); mix::tc_smem_bytes(T, H)
// of shared memory.  vec as B1's.  stats: per head [T][2] float2.
template <int HP>
__global__ void __launch_bounds__(mix::kTcMaxWarps * 32, mix::tc_min_blocks(HP))
    bwd_rows_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dz, bf16* __restrict__ dq,
                float2* __restrict__ stats, int n_tok, int n_heads, int d_head, int causal,
                int vec) {
  constexpr int S = tc_stride(HP);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [tc_keys(T)][S]
  bf16* Vs = Ks + mix::tc_keys(n_tok) * S;
  const long long ts = (long long)n_heads * d_head;
  const long long base = (long long)blockIdx.y * n_tok * ts + (long long)blockIdx.x * d_head;
  mix::stage_head<HP>(Ks, k + base, ts, n_tok, d_head, vec);
  mix::stage_head<HP>(Vs, v + base, ts, n_tok, d_head, vec);
  sae::cp_async_wait<0>();
  __syncthreads();
  float2* st = stats + ((long long)blockIdx.y * n_heads + blockIdx.x) * n_tok;
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int n_tiles = (n_tok + kSub - 1) / kSub;
  for (int i = warp; i < n_tiles; i += warps)
    rows_tile<HP>(Ks, Vs, q + base, dz + base, dq + base, st, ts, i * kSub, n_tok, d_head, causal,
                  vec);
}

template <int HP>
__global__ void __launch_bounds__(cols_max_warps(HP) * 32, cols_min_blocks(HP))
    bwd_cols_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dz,
                const float2* stats, bf16* __restrict__ dk, bf16* __restrict__ dv,
                int n_tok, int n_heads, int d_head, int causal, int vec) {
  constexpr int S = tc_stride(HP);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [tc_keys(T)][S]
  bf16* dZs = Qs + mix::tc_keys(n_tok) * S;
  const long long ts = (long long)n_heads * d_head;
  const long long base = (long long)blockIdx.y * n_tok * ts + (long long)blockIdx.x * d_head;
  mix::stage_head<HP>(Qs, q + base, ts, n_tok, d_head, vec);
  mix::stage_head<HP>(dZs, dz + base, ts, n_tok, d_head, vec);
  const float2* st = stats + ((long long)blockIdx.y * n_heads + blockIdx.x) * n_tok;
  if (HP > 16)  // each row's statistics in its 16 bytes of padding, past column HP
    for (int i = threadIdx.x; i < n_tok; i += blockDim.x)
      *reinterpret_cast<float2*>(Qs + i * S + HP) = st[i];
  sae::cp_async_wait<0>();
  __syncthreads();
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int n_tiles = (n_tok + kSub - 1) / kSub;
  for (int i = warp; i < n_tiles; i += warps)
    cols_tile<HP>(Qs, dZs, k + base, v + base, dk + base, dv + base, st, ts, i * kSub, n_tok,
                  d_head, causal, vec);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              int(cudaSharedmemCarveoutMaxShared));
}

template <int HP>
cudaError_t launch_hp(const void* q, const void* k, const void* v, const void* dz, void* dq,
                      void* dk, void* dv, float* stats, int batch, int n_tok, int n_heads,
                      int d_head, int causal, cudaStream_t stream) {
  const size_t smem = mix::tc_smem_bytes(n_tok, d_head);
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  cudaError_t err;
  if ((err = prepare(bwd_rows_tc_kernel<HP>, smem)) != cudaSuccess ||
      (err = prepare(bwd_cols_tc_kernel<HP>, smem)) != cudaSuccess)
    return err;
  const int warps = mix::tc_warps((n_tok + kSub - 1) / kSub);  // the rows pass
  const bool vec = d_head % 8 == 0 &&
                   ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dz) |
                     reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
                     reinterpret_cast<uintptr_t>(dv)) & 15) == 0;
  const dim3 grid(n_heads, batch);
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v), *dzb = static_cast<const bf16*>(dz);
  float2* st = reinterpret_cast<float2*>(stats);
  bwd_rows_tc_kernel<HP><<<grid, warps * 32, smem, stream>>>(
      qb, kb, vb, dzb, static_cast<bf16*>(dq), st, n_tok, n_heads, d_head, causal, int(vec));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int n_tiles = (n_tok + kSub - 1) / kSub;
  bwd_cols_tc_kernel<HP><<<grid, mix::tc_warps(n_tiles, cols_max_warps(HP)) * 32, smem,
                           stream>>>(
      qb, kb, vb, dzb, st, static_cast<bf16*>(dk), static_cast<bf16*>(dv), n_tok, n_heads,
      d_head, causal, int(vec));
  return cudaGetLastError();
}

cudaError_t launch(const void* q, const void* k, const void* v, const void* dz, void* dq,
                   void* dk, void* dv, float* stats, int batch, int n_tok, int n_heads,
                   int d_head, int causal, cudaStream_t stream) {
  switch (mix::tc_head_pad(d_head)) {
#define TC_CASE(HP) \
  case HP:          \
    return launch_hp<HP>(q, k, v, dz, dq, dk, dv, stats, batch, n_tok, n_heads, d_head, causal, stream);
    TC_CASE(16) TC_CASE(32) TC_CASE(48) TC_CASE(64)
    TC_CASE(80) TC_CASE(96) TC_CASE(112) TC_CASE(128)
#undef TC_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace tc

// ---- float32: tensor cores (3xTF32) ------------------------------------------

namespace f32tc {

namespace t = mix::tf32;
using t::kStep;
using t::round8;

// Per padded head width: the rows (keys) of a warp's tile and the gradient
// columns a sweep accumulates (the scores are formed again for each group).
// A warp holds both A operands (q and dz, or k and v) raw in registers; past
// H 64 that took every register and spilled, so wider heads take 8-row
// tiles, whose fragments' rows 8-15 are zero constants (half the registers,
// twice the products a row), and chunks of two 8-key (8-query) steps.  Past
// H 64 the operands' splits stay in the chunk loop (t::split_kept; else the
// compiler hoists them, doubling the operands' registers).
__host__ __device__ constexpr int tile_rows(int hp) { return hp <= 64 ? 16 : 8; }
__host__ __device__ constexpr int group(int hp) {
  return hp <= 64 ? hp : hp == 128 ? 32 : hp / 2;
}
constexpr int kSubs = 2;
template <int HP>
constexpr bool kKeptSplit = HP > 64;

// s = q K^T and dp = dz V^T for the NJ 8-key steps from key0 (rows pass), s
// masked.
template <int HP, int NJ>
__device__ __forceinline__ void rows_scores(float (&s)[NJ][4], float (&dp)[NJ][4],
                                            const float (&qa)[HP / 8][4],
                                            const float (&da)[HP / 8][4], const float* Ks,
                                            const float* Vs, int S, int key0, int row0,
                                            int n_tok, int causal) {
  t::nt_chunk<HP, NJ, true, kKeptSplit<HP>>(s, qa, Ks, S, key0);
  t::nt_chunk<HP, NJ, true, kKeptSplit<HP>>(dp, da, Vs, S, key0);
  t::mask_scores<NJ>(s, key0, row0, n_tok, causal);
}

template <int HP, int NJ>
__device__ __forceinline__ void rows_sweep1(float (&m)[2], float (&l)[2], float (&w)[2],
                                            const float (&qa)[HP / 8][4],
                                            const float (&da)[HP / 8][4], const float* Ks,
                                            const float* Vs, int S, int key0, int row0,
                                            int n_tok, int causal) {
  float s[NJ][4], dp[NJ][4];
  rows_scores<HP, NJ>(s, dp, qa, da, Ks, Vs, S, key0, row0, n_tok, causal);
  t::running_stats<NJ, true>(m, l, w, s, dp);
}

// acc += ds K over one chunk, for the CG gradient columns from c0.
template <int HP, int NJ, int CG>
__device__ __forceinline__ void rows_sweep2(float (&acc)[CG / 8][4], const float (&nb)[2],
                                            const float (&inv)[2], const float (&D)[2],
                                            const float (&qa)[HP / 8][4],
                                            const float (&da)[HP / 8][4], const float* Ks,
                                            const float* Vs, int S, int key0, int row0,
                                            int c0, int n_tok, int causal) {
  float s[NJ][4], dp[NJ][4];
  rows_scores<HP, NJ>(s, dp, qa, da, Ks, Vs, S, key0, row0, n_tok, causal);
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dp[j][e] = t::prob(s[j][e], nb[e >> 1], inv[e >> 1]) * (dp[j][e] - D[e >> 1]);
  t::pn_chunk<CG / 8>(acc, dp, Ks, S, key0, c0);
}

// The rows pass for rows [row0, row0 + R): sweep 1 forms s and dp, each
// row's running max m and sums l = sum(exp(s - m)) and w = sum(dp exp(s - m)),
// so D = w / l = sum(dp p) (the Pallas kernel's D, summed in another order);
// sweep 2 forms them again, p = exp(s - m) / l and ds = p (dp - D) (float32:
// no rounding), the A fragments of dq += ds K.  It writes dq and each row's
// m, l and D (st: m | l | D, T floats each).
template <int HP>
__device__ __forceinline__ void rows_tile(const float* Ks, const float* Vs, int S,
                                          const float* __restrict__ qh,
                                          const float* __restrict__ dzh, float* __restrict__ dqh,
                                          float* __restrict__ st, long long ts, int row0,
                                          int n_tok, int d_head, int causal) {
  constexpr int R = tile_rows(HP), NJ = kSubs, CG = group(HP);
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  float qa[HP / 8][4], da[HP / 8][4];
  t::load_a<HP, R>(qa, qh, ts, row0, n_tok, d_head);
  t::load_a<HP, R>(da, dzh, ts, row0, n_tok, d_head);
  const int end = round8(causal ? min(n_tok, row0 + R) : n_tok);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, w[2] = {0.f, 0.f};
  t::for_chunks<NJ>(0, end, [&](auto nj, int key0) {
    rows_sweep1<HP, decltype(nj)::value>(m, l, w, qa, da, Ks, Vs, S, key0, row0, n_tok, causal);
  });
  float mx[2], sum[2], ws[2], nb[2], inv[2], D[2];
  t::merge_stats<true>(mx, sum, ws, m, l, w);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    t::row_factors(mx[h], sum[h], nb[h], inv[h]);
    D[h] = ws[h] * inv[h];
  }

#pragma unroll 1
  for (int c0 = 0; c0 < HP; c0 += CG) {
    float acc[CG / 8][4];
    flash::zero(acc);
    t::for_chunks<NJ>(0, end, [&](auto nj, int key0) {
      rows_sweep2<HP, decltype(nj)::value, CG>(acc, nb, inv, D, qa, da, Ks, Vs, S, key0, row0,
                                               c0, n_tok, causal);
    });
    t::store_acc<CG / 8, R>(dqh, acc, ts, row0, c0, n_tok, d_head);
  }
  if (tq == 0)
#pragma unroll
    for (int h = 0; h < R / 8; ++h) {
      const int row = row0 + g + 8 * h;
      if (row < n_tok) {
        st[row] = mx[h];
        st[n_tok + row] = sum[h];
        st[2 * n_tok + row] = D[h];
      }
    }
}

// One chunk of the columns pass (NJ 8-query steps from q0) for keys [key0,
// key0 + R) and the CG gradient columns from c0: s^T = K Q^T and dp^T =
// V dZ^T with the keys as A, in the rows pass's product order (so s, and p,
// come out bit for bit as there); p^T and ds^T = p^T (dp^T - D) into dv +=
// p^T dZ and dk += ds^T Q.  rs: each query's nb, inv and D (rows floats each).
template <int HP, int NJ, int CG>
__device__ __forceinline__ void cols_chunk(float (&adk)[CG / 8][4], float (&adv)[CG / 8][4],
                                           const float (&ka)[HP / 8][4],
                                           const float (&va)[HP / 8][4], const float* Qs,
                                           const float* dZs, const float* rs, int rows, int S,
                                           int q0, int key0, int c0, int n_tok, int causal) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  float s[NJ][4], dp[NJ][4];
  t::nt_chunk<HP, NJ, false, kKeptSplit<HP>>(s, ka, Qs, S, q0);
  t::nt_chunk<HP, NJ, false, kKeptSplit<HP>>(dp, va, dZs, S, q0);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = q0 + kStep * j + 2 * tq + (e & 1);
      const bool ok = qi < n_tok && (!causal || qi >= key0 + g + 8 * (e >> 1));
      const float p = ok ? t::prob(s[j][e], rs[qi], rs[rows + qi]) : 0.f;
      s[j][e] = p;
      dp[j][e] = p * (dp[j][e] - rs[2 * rows + qi]);
    }
  }
  t::pn_chunk<CG / 8>(adv, s, dZs, S, q0, c0);
  t::pn_chunk<CG / 8>(adk, dp, Qs, S, q0, c0);
}

// The columns pass for keys [key0, key0 + R): dk and dv, CG columns a sweep.
template <int HP>
__device__ __forceinline__ void cols_tile(const float* Qs, const float* dZs, const float* rs,
                                          int rows, int S,
                                          const float* __restrict__ kh,
                                          const float* __restrict__ vh, float* __restrict__ dkh,
                                          float* __restrict__ dvh, long long ts, int key0,
                                          int n_tok, int d_head, int causal) {
  constexpr int R = tile_rows(HP), NJ = kSubs, CG = group(HP);
  float ka[HP / 8][4], va[HP / 8][4];
  t::load_a<HP, R>(ka, kh, ts, key0, n_tok, d_head);
  t::load_a<HP, R>(va, vh, ts, key0, n_tok, d_head);
  // Queries before a key are masked when causal.
  const int q_first = causal ? key0 : 0;
#pragma unroll 1
  for (int c0 = 0; c0 < HP; c0 += CG) {
    float adk[CG / 8][4], adv[CG / 8][4];
    flash::zero(adk);
    flash::zero(adv);
    t::for_chunks<NJ>(q_first, rows, [&](auto nj, int q0) {
      cols_chunk<HP, decltype(nj)::value, CG>(adk, adv, ka, va, Qs, dZs, rs, rows, S, q0, key0,
                                              c0, n_tok, causal);
    });
    t::store_acc<CG / 8, R>(dkh, adk, ts, key0, c0, n_tok, d_head);
    t::store_acc<CG / 8, R>(dvh, adv, ts, key0, c0, n_tok, d_head);
  }
}

// Grid (splits, N, B); t::plan's warps; t::smem_bytes(T, H, false) of shared
// memory.  Block x takes the tiles [x * tiles, (x + 1) * tiles) of its head
// (tile_rows(HP) rows each) and stages K and V for the keys its rows see.
// stats: per head m | l | D, T floats each.
template <int HP>
__global__ void __launch_bounds__(mix::kTcMaxWarps * 32, 1)
    bwd_rows_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dz,
                         float* __restrict__ dq, float* __restrict__ stats, int n_tok,
                         int n_heads, int d_head, int causal, int S, int tiles, int vec) {
  constexpr int R = tile_rows(HP);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rows = round8(n_tok);
  float* Ks = reinterpret_cast<float*>(smem_raw);  // [rows][S]
  float* Vs = Ks + rows * S;                       // [rows][S], then the slack
  const long long ts = (long long)n_heads * d_head;
  const long long base = (long long)blockIdx.z * n_tok * ts + (long long)blockIdx.y * d_head;
  const int n_tiles = (n_tok + R - 1) / R;
  const int tile0 = blockIdx.x * tiles, tile_end = min(n_tiles, tile0 + tiles);
  const int key_end = round8(causal ? min(n_tok, tile_end * R) : n_tok);
  t::stage_rows(Ks, k + base, ts, 0, key_end, rows, n_tok, d_head, S, vec);
  t::stage_rows(Vs, v + base, ts, 0, key_end, rows, n_tok, d_head, S, vec);
  t::zero_slack(Vs + rows * S);
  sae::cp_async_wait<0>();
  __syncthreads();
  float* st = stats + ((long long)blockIdx.z * n_heads + blockIdx.y) * 3 * n_tok;
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  for (int i = tile0 + warp; i < tile_end; i += warps)
    rows_tile<HP>(Ks, Vs, S, q + base, dz + base, dq + base, st, ts, i * R, n_tok, d_head,
                  causal);
}

// Grid (splits, N, B); t::plan's warps; t::smem_bytes(T, H, true) of shared
// memory.  Block x takes the key tiles [x * tiles, (x + 1) * tiles) of its
// head and stages Q and dZ for the queries those keys meet (all, or causal
// from its first key), and each such query's nb, inv (from the rows pass's m
// and l, by t::row_factors as there) and D.
template <int HP>
__global__ void __launch_bounds__(mix::kTcMaxWarps * 32, 1)
    bwd_cols_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dz,
                         const float* __restrict__ stats, float* __restrict__ dk,
                         float* __restrict__ dv, int n_tok, int n_heads, int d_head, int causal,
                         int S, int tiles, int vec) {
  constexpr int R = tile_rows(HP);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rows = round8(n_tok);
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [rows][S]
  float* dZs = Qs + rows * S;                      // [rows][S]
  float* rs = dZs + rows * S;                      // nb, inv, D: [rows] each, then the slack
  const long long ts = (long long)n_heads * d_head;
  const long long base = (long long)blockIdx.z * n_tok * ts + (long long)blockIdx.y * d_head;
  const int n_tiles = (n_tok + R - 1) / R;
  const int tile0 = blockIdx.x * tiles, tile_end = min(n_tiles, tile0 + tiles);
  const int q_lo = causal ? tile0 * R : 0;
  t::stage_rows(Qs, q + base, ts, q_lo, rows, rows, n_tok, d_head, S, vec);
  t::stage_rows(dZs, dz + base, ts, q_lo, rows, rows, n_tok, d_head, S, vec);
  const float* st = stats + ((long long)blockIdx.z * n_heads + blockIdx.y) * 3 * n_tok;
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    float nb = 0.f, inv = 0.f, D = 0.f;
    if (i >= q_lo && i < n_tok) {
      t::row_factors(st[i], st[n_tok + i], nb, inv);
      D = st[2 * n_tok + i];
    }
    rs[i] = nb;
    rs[rows + i] = inv;
    rs[2 * rows + i] = D;
  }
  t::zero_slack(rs + 3 * rows);
  sae::cp_async_wait<0>();
  __syncthreads();
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  for (int i = tile0 + warp; i < tile_end; i += warps)
    cols_tile<HP>(Qs, dZs, rs, rows, S, k + base, v + base, dk + base, dv + base, ts, i * R,
                  n_tok, d_head, causal);
}

template <int HP>
cudaError_t launch_hp(const float* q, const float* k, const float* v, const float* dz,
                      float* dq, float* dk, float* dv, float* stats, int batch, int n_tok,
                      int n_heads, int d_head, int causal, int device, cudaStream_t stream) {
  const size_t smem_rows = t::smem_bytes(n_tok, d_head, false);
  const size_t smem_cols = t::smem_bytes(n_tok, d_head, true);
  if (smem_rows > kMaxSmemBytes || smem_cols > kMaxSmemBytes) return cudaErrorInvalidValue;
  auto rows_kernel = bwd_rows_tf32_kernel<HP>;
  auto cols_kernel = bwd_cols_tf32_kernel<HP>;
  cudaError_t err;
  if ((err = t::prepare(rows_kernel, smem_rows)) != cudaSuccess ||
      (err = t::prepare(cols_kernel, smem_cols)) != cudaSuccess)
    return err;
  const int n_tiles = (n_tok + tile_rows(HP) - 1) / tile_rows(HP);
  const long long pairs = (long long)batch * n_heads;
  const int vec = d_head % 4 == 0 &&
                  ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dz)) & 15) == 0;
  const t::Plan pr = t::plan(rows_kernel, pairs, n_tiles, smem_rows, device);
  rows_kernel<<<dim3(pr.splits, n_heads, batch), pr.warps * 32, smem_rows, stream>>>(
      q, k, v, dz, dq, stats, n_tok, n_heads, d_head, causal,
      t::row_stride(n_tok, d_head, false), pr.tiles, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const t::Plan pc = t::plan(cols_kernel, pairs, n_tiles, smem_cols, device);
  cols_kernel<<<dim3(pc.splits, n_heads, batch), pc.warps * 32, smem_cols, stream>>>(
      q, k, v, dz, stats, dk, dv, n_tok, n_heads, d_head, causal,
      t::row_stride(n_tok, d_head, true), pc.tiles, vec);
  return cudaGetLastError();
}

cudaError_t launch(const void* q, const void* k, const void* v, const void* dz, void* dq,
                   void* dk, void* dv, float* stats, int batch, int n_tok, int n_heads,
                   int d_head, int causal, int device, cudaStream_t stream) {
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v), *dzf = static_cast<const float*>(dz);
  float *dqf = static_cast<float*>(dq), *dkf = static_cast<float*>(dk),
        *dvf = static_cast<float*>(dv);
  switch (t::head_pad(d_head)) {
#define F32TC_CASE(HP)                                                                        \
  case HP:                                                                                    \
    return launch_hp<HP>(qf, kf, vf, dzf, dqf, dkf, dvf, stats, batch, n_tok, n_heads, d_head, \
                         causal, device, stream);
    F32TC_CASE(16) F32TC_CASE(32) F32TC_CASE(48) F32TC_CASE(64)
    F32TC_CASE(80) F32TC_CASE(96) F32TC_CASE(112) F32TC_CASE(128)
#undef F32TC_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace f32tc

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  stats: float32 scratch of 3 * batch *
// n_heads * n_tok floats (each row's statistics, from the rows pass to the
// columns pass: m, l and D on the FFMA and 3xTF32 routes, log2-sum-exp and D
// on the bfloat16 tensor cores).  Heads up to 128 wide take the tensor-core
// passes of their dtype, wider ones the FFMA passes.  Returns the launches'
// cudaError_t.
extern "C" int attention_mix_tnh_bwd(const void* q, const void* k, const void* v,
                                     const void* dz, void* dq, void* dk, void* dv,
                                     void* stats, int batch, int n_tok, int n_heads,
                                     int d_head, int causal, int dtype, int device,
                                     void* stream) {
  if (batch <= 0 || batch > 65535 || n_tok <= 0 || n_heads <= 0 ||
      n_heads > 65535 || d_head <= 0 || d_head > kMaxHead ||
      pick(rows_smem_bytes, n_tok, d_head).warps == 0 ||
      pick(cols_smem_bytes, n_tok, d_head).warps == 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  if (dtype == 0 && d_head <= mix::tf32::kMaxHead)
    return f32tc::launch(q, k, v, dz, dq, dk, dv, st, batch, n_tok, n_heads, d_head, causal,
                         device, s);
  if (dtype == 0)
    return launch<float>(q, k, v, dz, dq, dk, dv, st, batch, n_tok, n_heads, d_head,
                         causal, s);
  if (dtype == 1 && d_head <= mix::kTcMaxHead)
    return tc::launch(q, k, v, dz, dq, dk, dv, st, batch, n_tok, n_heads, d_head, causal, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, dz, dq, dk, dv, st, batch, n_tok, n_heads,
                                 d_head, causal, s);
  return cudaErrorInvalidValue;
}
