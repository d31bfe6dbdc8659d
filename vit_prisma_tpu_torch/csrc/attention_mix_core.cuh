// Attention mix, forward: z = softmax(q k^T) v per (batch item, head), for
// any layout in which each head's rows of H elements lie a fixed stride
// apart.  Shared by kernel B1 (attention_mix_tnh.cu: token-major
// [B, T, N*H]) and kernel B15 (attention_mix.cu: head-major [B, N, T, H]).
//
// Element h of token t of head n of batch item b sits at
//   b * batch_stride + n * head_stride + t * tok_stride + h
// B1:  tok_stride = N*H, head_stride = H,   batch_stride = T*N*H;
// B15: tok_stride = H,   head_stride = T*H, batch_stride = N*T*H.
//
// Contract (both kernels): q is already scaled by 1/sqrt(H), scores and
// softmax are float32 with a division, p is rounded to the input dtype
// before the PV product, z accumulates in float32 and is stored in the input
// dtype.  An optional causal mask keeps key columns col <= row.
//
// What bounds it on an H100.  At the CLIP ViT-B/32 shape (T=50, N=12, H=64)
// the kernel reads q, k, v and writes z once, about 4*B*T*N*H elements, and
// does about 4*B*N*T^2*H flops: some T/2 = 25 flops per element moved, far
// below the ~295 flops per byte the card needs before its tensor cores, not
// its memory, are the limit.  So the aim is to touch device memory once per
// element and to keep the T x T scores out of it.
//
// Design (simple and right first; wgmma, TMA and tuning come later):
//  * one block per (row tile of 64 query rows, head, batch item);
//  * the block stages that head's K and V in shared memory as float32 (K rows
//    padded to a multiple of 4 plus 4 floats, so that float4 reads from 32
//    lanes hitting 32 different key rows fall in distinct banks); each warp
//    issues the loads of 4 key rows before storing any, so that their
//    device-memory latencies overlap (one load at a time, waiting for each,
//    made the kernel latency-bound);
//  * each warp owns R query rows at a time (R = 4 where shared memory allows,
//    else 1): each lane scores keys lane, lane+32, ... for all R rows, so one
//    K float4 from shared memory feeds 4R FMAs; the row max and sum are warp
//    shuffles; the rows' p sit in per-warp shared buffers; for PV each lane
//    owns columns lane, lane+32, ... of z (NC = ceil(H/32) float32
//    accumulators per row), and one V element feeds R rows.
// The scores never leave the SM, and q, k, v, z each cross device memory
// once per row tile (once in all when T <= 64).  The arithmetic of one row
// depends neither on R nor on the layout.
//
// Shared memory (floats): T*(H4+4) for K, T*H for V, and per warp R rows of
// q (H4 each) and of p (T each), H4 = H rounded up to 4.  The Python wrapper
// (vit_prisma_tpu_torch/ops/attention.py, mix_tnh_smem_bytes) gates T on the
// R = 1 size and refuses what does not fit in the 227 KB a block may use.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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
  switch ((d_head + 31) / 32) {
#define VPT_CASE(NC) \
  case NC:           \
    return launch_nc<T, NC, R>(q, k, v, z, batch, n_tok, n_heads, d_head, causal, lay, stream);
    VPT_CASE(1) VPT_CASE(2) VPT_CASE(3) VPT_CASE(4)
    VPT_CASE(5) VPT_CASE(6) VPT_CASE(7) VPT_CASE(8)
#undef VPT_CASE
    default:
      return cudaErrorInvalidValue;
  }
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

// Check the arguments, select the device and launch in the dtype's
// instantiation (0 = float32, 1 = bfloat16).  Returns the cudaError_t.
inline int run(const void* q, const void* k, const void* v, void* z, int batch,
               int n_tok, int n_heads, int d_head, int causal, int dtype, int device,
               Layout lay, void* stream) {
  if (!args_ok(batch, n_tok, n_heads, d_head)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, z, batch, n_tok, n_heads, d_head, causal, lay, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, z, batch, n_tok, n_heads, d_head, causal, lay, s);
  return cudaErrorInvalidValue;
}

}  // namespace mix
