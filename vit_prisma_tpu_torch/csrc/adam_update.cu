// Fused clip + decoder-row projection + Adam over a [L, R, C] tensor.
//
// Replaces the Pallas TPU kernel `_adam_kernel`, launched by
// `_adam_update_kernel` in vit_prisma_tpu/ops/opt_step.py (kernel B7 of the
// ROADMAP).  Same contract and cast points as `_adam_update_ref` there:
// p and g are float32, the moments mu and nu are float32 or bfloat16, and
// scal is a [L, 4] float32 table (clip_scale, lr, 1/bc1, 1/sqrt(bc2)) per
// layer, read here on the device so that the host never waits for it.
//     g   = g * clip_scale
//     g   = g - <g, p_row> p_row                 (project: W_dec rows)
//     mu  = b1 * mu + (1 - b1) * g
//     nu  = b2 * nu + (1 - b2) * g * g
//     p   = p + (-lr) * (mu * rbc1) / (sqrt(nu) * sbc2 + eps)
// with the moments stored back in their dtype (round to nearest even).
// Every operation is one correctly rounded float32 operation, in the
// reference's order (__fmul_rn and friends: no FMA contraction), so the
// elementwise result equals the plain PyTorch version's bit for bit; only
// the row dot of the projection is summed in another order.  (1 - b1) and
// (1 - b2) are rounded from double on the host, as PyTorch and JAX round a
// Python float.
//
// What bounds it on an H100.  About 12 flops per element against 28 bytes
// moved with float32 moments (read p, g, mu, nu; write p, mu, nu) or 20
// with bfloat16 ones: far below the ~20 flops per byte where float32 math,
// and not device memory, would be the limit.  At the default SAE (W_enc and
// W_dec, 18.9 M elements) one step moves 0.53 GB, about 0.16 ms at
// 3.35 TB/s.  So the design reads and writes every tensor once.
//
// Design.
//  * project = 0 (W_enc, the biases as [L, 1, C]): a flat grid-stride pass,
//    one float4 of p and g and four moments per thread and step.
//  * project = 1 (W_dec, C = d_in): one warp per row.  A first sweep sums
//    <g*clip, p> over the row (warp shuffle); a second sweep re-reads the
//    row, which the first left in L1/L2, and updates it.  Device memory
//    still sees one read of p and g.
// C must be a multiple of 4 and the pointers 16-byte (float32) or 8-byte
// (bfloat16) aligned; the wrapper (vit_prisma_tpu_torch/ops/opt_step.py)
// checks both.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowWarps = 8;
constexpr long long kMaxBlocks = 1 << 20;

struct AdamConst {
  float b1, omb1, b2, omb2, eps;
};

__device__ __forceinline__ float4 load4(const float* p, long long i) {
  return reinterpret_cast<const float4*>(p)[i];
}
__device__ __forceinline__ void store4(float* p, long long i, float4 v) {
  reinterpret_cast<float4*>(p)[i] = v;
}

// bfloat16 is the top half of a float32: widening is exact.
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, long long i) {
  const uint2 w = reinterpret_cast<const uint2*>(p)[i];
  return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
}
__device__ __forceinline__ unsigned int bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, long long i, float4 v) {
  uint2 w;
  w.x = bf16_bits(v.x) | (bf16_bits(v.y) << 16);
  w.y = bf16_bits(v.z) | (bf16_bits(v.w) << 16);
  reinterpret_cast<uint2*>(p)[i] = w;
}

// The moment and parameter update of one element whose gradient g is
// already scaled (and projected).
__device__ __forceinline__ void adam_elem(float p, float g, float& mu, float& nu,
                                          float lr, float rbc1, float sbc2,
                                          const AdamConst& c, float& p_out) {
  mu = __fadd_rn(__fmul_rn(c.b1, mu), __fmul_rn(c.omb1, g));
  nu = __fadd_rn(__fmul_rn(c.b2, nu), __fmul_rn(c.omb2, __fmul_rn(g, g)));
  const float num = __fmul_rn(-lr, __fmul_rn(mu, rbc1));
  const float den = __fadd_rn(__fmul_rn(__fsqrt_rn(nu), sbc2), c.eps);
  p_out = __fadd_rn(p, __fdiv_rn(num, den));
}

__device__ __forceinline__ void adam4(float4 p, float4 g, float4& mu, float4& nu,
                                      float lr, float rbc1, float sbc2,
                                      const AdamConst& c, float4& p_out) {
  adam_elem(p.x, g.x, mu.x, nu.x, lr, rbc1, sbc2, c, p_out.x);
  adam_elem(p.y, g.y, mu.y, nu.y, lr, rbc1, sbc2, c, p_out.y);
  adam_elem(p.z, g.z, mu.z, nu.z, lr, rbc1, sbc2, c, p_out.z);
  adam_elem(p.w, g.w, mu.w, nu.w, lr, rbc1, sbc2, c, p_out.w);
}

__device__ __forceinline__ float4 scale4(float4 g, float s) {
  return make_float4(__fmul_rn(g.x, s), __fmul_rn(g.y, s), __fmul_rn(g.z, s),
                     __fmul_rn(g.w, s));
}

template <typename M>
__global__ void __launch_bounds__(kThreads)
adam_flat_kernel(const float* __restrict__ p, const float* __restrict__ g,
                 const M* __restrict__ mu, const M* __restrict__ nu,
                 const float* __restrict__ scal, float* __restrict__ p_out,
                 M* __restrict__ mu_out, M* __restrict__ nu_out,
                 long long per_layer4, long long n4, AdamConst c) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < n4; i += stride) {
    const float* s = scal + 4 * (i / per_layer4);
    float4 m = load4(mu, i), v = load4(nu, i), out;
    adam4(load4(p, i), scale4(load4(g, i), s[0]), m, v, s[1], s[2], s[3], c, out);
    store4(p_out, i, out);
    store4(mu_out, i, m);
    store4(nu_out, i, v);
  }
}

template <typename M>
__global__ void __launch_bounds__(kRowWarps * 32)
adam_rows_kernel(const float* __restrict__ p, const float* __restrict__ g,
                 const M* __restrict__ mu, const M* __restrict__ nu,
                 const float* __restrict__ scal, float* __restrict__ p_out,
                 M* __restrict__ mu_out, M* __restrict__ nu_out,
                 long long n_rows, long long rows_per_layer, int c4, AdamConst c) {
  const int lane = threadIdx.x & 31;
  const long long n_warps = static_cast<long long>(gridDim.x) * kRowWarps;
  for (long long row = static_cast<long long>(blockIdx.x) * kRowWarps + (threadIdx.x >> 5);
       row < n_rows; row += n_warps) {
    const float* s = scal + 4 * (row / rows_per_layer);
    const float sc = s[0];
    const long long base = row * c4;
    float dot = 0.f;
    for (int j = lane; j < c4; j += 32) {
      const float4 pv = load4(p, base + j), gv = scale4(load4(g, base + j), sc);
      dot = fmaf(gv.x, pv.x, dot);
      dot = fmaf(gv.y, pv.y, dot);
      dot = fmaf(gv.z, pv.z, dot);
      dot = fmaf(gv.w, pv.w, dot);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    for (int j = lane; j < c4; j += 32) {
      const float4 pv = load4(p, base + j);
      float4 gv = scale4(load4(g, base + j), sc);
      gv = make_float4(__fsub_rn(gv.x, __fmul_rn(dot, pv.x)),
                       __fsub_rn(gv.y, __fmul_rn(dot, pv.y)),
                       __fsub_rn(gv.z, __fmul_rn(dot, pv.z)),
                       __fsub_rn(gv.w, __fmul_rn(dot, pv.w)));
      float4 m = load4(mu, base + j), v = load4(nu, base + j), out;
      adam4(pv, gv, m, v, s[1], s[2], s[3], c, out);
      store4(p_out, base + j, out);
      store4(mu_out, base + j, m);
      store4(nu_out, base + j, v);
    }
  }
}

long long clamp_blocks(long long n) { return n < kMaxBlocks ? n : kMaxBlocks; }

template <typename M>
cudaError_t launch(const void* p, const void* g, const void* mu, const void* nu,
                   const void* scal, void* p_out, void* mu_out, void* nu_out,
                   int n_layers, long long R, long long C, int project,
                   const AdamConst& c, cudaStream_t stream) {
  const float* pp = static_cast<const float*>(p);
  const float* gg = static_cast<const float*>(g);
  const M* mm = static_cast<const M*>(mu);
  const M* nn = static_cast<const M*>(nu);
  const float* ss = static_cast<const float*>(scal);
  float* po = static_cast<float*>(p_out);
  M* mo = static_cast<M*>(mu_out);
  M* no = static_cast<M*>(nu_out);
  if (project) {
    const long long n_rows = static_cast<long long>(n_layers) * R;
    const dim3 grid(static_cast<unsigned int>(clamp_blocks((n_rows + kRowWarps - 1) / kRowWarps)));
    adam_rows_kernel<M><<<grid, kRowWarps * 32, 0, stream>>>(
        pp, gg, mm, nn, ss, po, mo, no, n_rows, R, static_cast<int>(C / 4), c);
  } else {
    const long long n4 = static_cast<long long>(n_layers) * R * C / 4;
    const dim3 grid(static_cast<unsigned int>(clamp_blocks((n4 + kThreads - 1) / kThreads)));
    adam_flat_kernel<M><<<grid, kThreads, 0, stream>>>(
        pp, gg, mm, nn, ss, po, mo, no, R * C / 4, n4, c);
  }
  return cudaGetLastError();
}

}  // namespace

// moment_dtype: 0 = float32, 1 = bfloat16.  omb1 and omb2 are (1 - b1) and
// (1 - b2) rounded from double.  Returns the launch's cudaError_t.
extern "C" int adam_update(const void* p, const void* g, const void* mu,
                           const void* nu, const void* scal, void* p_out,
                           void* mu_out, void* nu_out, int n_layers,
                           long long R, long long C, float b1, float omb1,
                           float b2, float omb2, float eps, int project,
                           int moment_dtype, int device, void* stream) {
  if (n_layers <= 0 || R <= 0 || C <= 0 || C % 4 || C / 4 > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const AdamConst c{b1, omb1, b2, omb2, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (moment_dtype == 0)
    return launch<float>(p, g, mu, nu, scal, p_out, mu_out, nu_out, n_layers, R, C,
                         project, c, s);
  if (moment_dtype == 1)
    return launch<__nv_bfloat16>(p, g, mu, nu, scal, p_out, mu_out, nu_out,
                                 n_layers, R, C, project, c, s);
  return cudaErrorInvalidValue;
}
