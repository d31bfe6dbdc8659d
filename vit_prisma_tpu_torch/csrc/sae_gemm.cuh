// One tile GEMM, shared by the fused SAE kernels B4-B6, B8, B9, B11 and
// B12 (sae_fused_fwd.cu, sae_fused_fwd_topk.cu, sae_fused_bwd.cu,
// sae_fused_fwd_gated.cu, sae_fused_bwd_gated.cu), and the kernels that
// more than one of them launch (center, decoder, wgrad, partial_sums, B8's
// counts; the bf16 Hopper route, sae_fused_tc.cu, launches center,
// partial_sums and the counts).
//
// A block computes a BM x BN tile of C = A B for one layer of an [L, ...]
// stack, accumulating in float32 registers over K in steps of BK, and then
// runs the calling kernel's own epilogue on the registers.  A is [M, K] and
// B is [K, N]; each may lie in device memory with either axis contiguous:
//   A_KC: A(m, k) at A[m * lda + k] (K contiguous), else A[k * lda + m];
//   B_KC: B(k, n) at B[n * ldb + k] (K contiguous), else B[k * ldb + n].
// The tiles are copied into shared memory as they lie (16-byte cp.async,
// a kStages-deep ring), so every layout costs the same copy.
//
// bfloat16 only (float32 runs sae_fused_tf32.cu, 3xTF32 on tf32 wgmma):
// warp-level tensor-core products, mma.sync m16n8k16 with float32
// accumulation, fed by ldmatrix (.trans where the contiguous axis is not K).
// The accumulator is in the mma C-fragment layout:
//   acc[mi][ni][e], mi < MI, ni < NI, e < 4, holds
//   row = wm0 + 16 mi + g + 8 (e / 2),  col = wn0 + 8 ni + 2 t + (e % 2)
// within the block tile, with g = lane / 4, t = lane % 4 and (wm0, wn0)
// the warp's corner (acc_row / acc_col below).
//
// The tile sizes need M and N to be multiples of 128 and K of 32; the
// wrappers (vit_prisma_tpu_torch/ops/sae_step.py) check the shapes and that
// every pointer is 16-byte aligned.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sae {

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int kWarpsM = 2, kWarpsN = 4, kThreads = 32 * kWarpsM * kWarpsN;
constexpr int WM = BM / kWarpsM, WN = BN / kWarpsN;  // 64 x 32 per warp
constexpr int MI = WM / 16, NI = WN / 8;
constexpr int kStages = 3;

typedef float Acc[MI][NI][4];

template <typename T>
struct Pad {
  static constexpr int v = 16 / sizeof(T);  // one 16-byte chunk per row
};

// Shared-memory tile geometry for one operand: R rows of C elements, the
// contiguous axis last, each row padded by 16 bytes (ldmatrix's reads then
// hit distinct banks).
template <typename T, bool KC, int MN>
struct Tile {
  static constexpr int rows = KC ? MN : BK;
  static constexpr int cols = KC ? BK : MN;
  static constexpr int stride = cols + Pad<T>::v;
  static constexpr int elems = rows * stride;
};

template <typename T, bool A_KC, bool B_KC>
struct Smem {
  typedef Tile<T, A_KC, BM> TA;
  typedef Tile<T, B_KC, BN> TB;
  static constexpr int stage_elems = TA::elems + TB::elems;
  static constexpr int bytes = kStages * stage_elems * static_cast<int>(sizeof(T));
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy an R x C tile (C contiguous, row r at g + r * ld) into shared memory.
template <typename T, int R, int C, int S>
__device__ __forceinline__ void load_tile(T* s, const T* g, long long ld) {
  constexpr int per_row = C * static_cast<int>(sizeof(T)) / 16;
  constexpr int n = R * per_row;
  constexpr int vec = 16 / sizeof(T);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i / per_row, c = (i % per_row) * vec;
    cp_async16(s + r * S + c, g + r * ld + c);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int warp_m0() { return (threadIdx.x / 32) / kWarpsN * WM; }
__device__ __forceinline__ int warp_n0() { return (threadIdx.x / 32) % kWarpsN * WN; }

// Row and column, within the block tile, of accumulator element (mi, ni, e).
__device__ __forceinline__ int acc_row(int mi, int e) {
  return warp_m0() + 16 * mi + (threadIdx.x & 31) / 4 + 8 * (e / 2);
}
__device__ __forceinline__ int acc_col(int ni, int e) {
  return warp_n0() + 8 * ni + 2 * ((threadIdx.x & 31) % 4) + (e % 2);
}

// One BK slice of products from shared memory into acc: tensor cores.
template <bool A_KC, bool B_KC>
__device__ __forceinline__ void compute_stage(Acc& acc, const __nv_bfloat16* As,
                                              const __nv_bfloat16* Bs) {
  typedef Tile<__nv_bfloat16, A_KC, BM> TA;
  typedef Tile<__nv_bfloat16, B_KC, BN> TB;
  const int lane = threadIdx.x & 31;
  const int wm0 = warp_m0(), wn0 = warp_n0();
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t a[MI][4], b[NI][2];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const int m0 = wm0 + 16 * mi;
      if (A_KC) {  // As[m][k]
        ldsm_x4(a[mi], As + (m0 + (lane & 15)) * TA::stride + kk + (lane >> 4) * 8);
      } else {     // As[k][m]
        ldsm_x4_t(a[mi], As + (kk + (lane & 7) + ((lane >> 4) << 3)) * TA::stride + m0 +
                             ((lane >> 3) & 1) * 8);
      }
    }
#pragma unroll
    for (int np = 0; np < NI / 2; ++np) {
      const int n0 = wn0 + 16 * np;
      uint32_t r[4];
      if (B_KC) {  // Bs[n][k]
        ldsm_x4(r, Bs + (n0 + (lane & 7) + ((lane >> 4) << 3)) * TB::stride + kk +
                       ((lane >> 3) & 1) * 8);
      } else {     // Bs[k][n]
        ldsm_x4_t(r, Bs + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * TB::stride + n0 +
                         (lane >> 4) * 8);
      }
      b[2 * np][0] = r[0];
      b[2 * np][1] = r[1];
      b[2 * np + 1][0] = r[2];
      b[2 * np + 1][1] = r[3];
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
  }
}

// acc += A[m0:m0+BM, :K] B[:K, n0:n0+BN].  A and B point at this layer's
// matrices.  smem holds Smem<T, A_KC, B_KC>::bytes.  Ends with every
// thread past a barrier and no copy in flight, so the caller may reuse smem.
template <typename T, bool A_KC, bool B_KC>
__device__ __forceinline__ void mainloop(Acc& acc, const T* __restrict__ A, long long lda,
                                         const T* __restrict__ B, long long ldb, int K,
                                         int m0, int n0, T* smem) {
  typedef Smem<T, A_KC, B_KC> SM;
  typedef typename SM::TA TA;
  typedef typename SM::TB TB;
  const int ktiles = K / BK;
  auto load = [&](int stage, int kt) {
    T* As = smem + stage * SM::stage_elems;
    T* Bs = As + TA::elems;
    const int k0 = kt * BK;
    if (A_KC)
      load_tile<T, TA::rows, TA::cols, TA::stride>(As, A + m0 * lda + k0, lda);
    else
      load_tile<T, TA::rows, TA::cols, TA::stride>(As, A + k0 * lda + m0, lda);
    if (B_KC)
      load_tile<T, TB::rows, TB::cols, TB::stride>(Bs, B + n0 * ldb + k0, ldb);
    else
      load_tile<T, TB::rows, TB::cols, TB::stride>(Bs, B + k0 * ldb + n0, ldb);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < ktiles) load(next % kStages, next);
    cp_async_commit();
    const T* As = smem + (kt % kStages) * SM::stage_elems;
    compute_stage<A_KC, B_KC>(acc, As, As + TA::elems);
  }
  cp_async_wait<0>();
  __syncthreads();
}

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Store the element pair (cols c, c + 1) of one row, converted to T.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Column sums of a per-thread [NI][2] partial over the block's BM rows,
// written to out[0 .. BN) for the block's columns.  red: kWarpsM * BN
// floats of shared memory.  Sums in a fixed order: deterministic.
__device__ __forceinline__ void block_col_sums(float (&part)[NI][2], float* red, float* out) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
        part[ni][h] += __shfl_xor_sync(0xffffffffu, part[ni][h], o);
  const int wm = (threadIdx.x / 32) / kWarpsN;
  if (lane < 4) {
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) red[wm * BN + acc_col(ni, h)] = part[ni][h];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < BN; c += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarpsM; ++w) s += red[w * BN + c];
    out[c] = s;
  }
}

// Sum of one float per thread over the block, in a fixed order; the result
// is valid in thread 0.  red: kThreads / 32 floats of shared memory.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  return s;
}

// Opt a kernel into more than 48 KB of dynamic shared memory once.
template <typename Kernel>
cudaError_t allow_smem(Kernel k, int bytes) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// xc = x - b_dec[l] in T (one rounding, as PyTorch and JAX subtract), over
// [L, B, D], 16 bytes a thread (8 bf16 or 4 float32 values: D a multiple of
// that and every pointer 16-byte aligned, as the wrappers check).  The one
// center of every SAE kernel (B4-B6, B8, B9, B11, B12, on every route): at
// the sweep's bf16 shape it takes 0.13 ms on an H100 80GB HBM3, where one
// element a thread took 0.53.
template <typename T>
__global__ void center_kernel(const uint4* __restrict__ x, const T* __restrict__ bd,
                              uint4* __restrict__ xc, long long n16, int d16,
                              long long per_layer16) {
  constexpr int V = 16 / sizeof(T);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n16;
       i += stride) {
    const long long l = i / per_layer16;
    const int d = static_cast<int>(i % d16);
    uint4 v = x[i];
    const uint4 b = reinterpret_cast<const uint4*>(bd)[l * d16 + d];
    T* pv = reinterpret_cast<T*>(&v);
    const T* pb = reinterpret_cast<const T*>(&b);
#pragma unroll
    for (int k = 0; k < V; ++k) pv[k] = from_f<T>(__fsub_rn(to_f(pv[k]), to_f(pb[k])));
    xc[i] = v;
  }
}

template <typename T>
cudaError_t center(const T* x, const T* bd, T* xc, int L, int B, int D, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const long long per_layer16 = static_cast<long long>(B) * D / V, n16 = per_layer16 * L;
  long long blocks = (n16 + 255) / 256;
  if (blocks > (1 << 20)) blocks = 1 << 20;
  center_kernel<T><<<static_cast<unsigned int>(blocks), 256, 0, s>>>(
      reinterpret_cast<const uint4*>(x), bd, reinterpret_cast<uint4*>(xc), n16, D / V,
      per_layer16);
  return cudaGetLastError();
}

// sums[g, s] = sum over b of part[g, b, s] for G groups of nB partial rows
// of S columns, in the order b = 0, 1, ... (no atomics: the same bits from
// run to run).  The gated backward's (B12's) column sums on both routes.
static __global__ void partial_sums_kernel(const float* __restrict__ part,
                                           float* __restrict__ sums, long long n, int nB,
                                           int S) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long grp = i / S;
  const int s = static_cast<int>(i % S);
  const float* p = part + grp * nB * S + s;
  float acc = 0.f;
  for (int b = 0; b < nB; ++b) acc += p[static_cast<long long>(b) * S];
  sums[i] = acc;
}

inline cudaError_t partial_sums(const float* part, float* sums, int G, int nB, int S,
                                cudaStream_t s) {
  const long long n = static_cast<long long>(G) * S;
  partial_sums_kernel<<<static_cast<unsigned int>((n + 255) / 256), 256, 0, s>>>(part, sums, n,
                                                                                 nB, S);
  return cudaGetLastError();
}

__device__ __forceinline__ void load2(const float* p, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float& a, float& b) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  a = __low2float(v);
  b = __high2float(v);
}

constexpr int kCountThreads = BN / 2;  // two features a thread

// B8's counts pass over its masked h [L, B, S] (h > 0 exactly on the active
// set), on every route: per 128-row block, nact_part[l, rb, j] = rows with
// h > 0 in feature j, and l1_part[l, rb, cb] = sum of h over the 128 x 128
// tile, each summed in a fixed order (no atomics: the same bits from run to
// run).  Grid (S/BN, B/BM, L).
template <typename T>
__global__ void __launch_bounds__(kCountThreads)
count_kernel(const T* __restrict__ h, float* __restrict__ nact_part,
             float* __restrict__ l1_part, int B, int S) {
  const int l = blockIdx.z, rb = blockIdx.y, cb = blockIdx.x;
  const int c = cb * BN + 2 * threadIdx.x;
  const T* p = h + (static_cast<long long>(l) * B + static_cast<long long>(rb) * BM) * S + c;
  float n0 = 0.f, n1 = 0.f, s = 0.f;
  for (int r = 0; r < BM; ++r) {
    float a, b;
    load2(p + static_cast<long long>(r) * S, a, b);
    n0 += a > 0.f ? 1.f : 0.f;
    n1 += b > 0.f ? 1.f : 0.f;
    s += a + b;
  }
  float* out = nact_part + (static_cast<long long>(l) * gridDim.y + rb) * S + c;
  out[0] = n0;
  out[1] = n1;
  __shared__ float red[kCountThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x / 32] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kCountThreads / 32; ++w) total += red[w];
    l1_part[(static_cast<long long>(l) * gridDim.y + rb) * gridDim.x + cb] = total;
  }
}

// nact_part [L, B/128, S] and l1_part [L, B/128, S/128] from h (count_kernel).
template <typename T>
cudaError_t active_counts(const T* h, float* nact_part, float* l1_part, int L, int B, int S,
                          cudaStream_t s) {
  count_kernel<T><<<dim3(S / BN, B / BM, L), kCountThreads, 0, s>>>(h, nact_part, l1_part, B, S);
  return cudaGetLastError();
}

// y = b_dec + hc W_dec, the decoder of B4, B8 and B11 (hc: the ReLU, TopK
// or gated activations in T).  Grid (D/BN, B/BM, L); Smem<T, true, false>::bytes.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decoder_kernel(const T* __restrict__ hc, const T* __restrict__ Wd, const T* __restrict__ bd,
               T* __restrict__ y, int B, int D, int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int l = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const long long BS = static_cast<long long>(B) * S, SD = static_cast<long long>(S) * D;
  const long long BD = static_cast<long long>(B) * D;
  Acc acc;
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float b = to_f(bd[static_cast<long long>(l) * D + n0 + acc_col(ni, e)]);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) acc[mi][ni][e] = b;
    }
  mainloop<T, true, false>(acc, hc + l * BS, S, Wd + l * SD, D, S, m0, n0, smem);
  T* out = y + l * BD;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store2(out + static_cast<long long>(m0 + acc_row(mi, 2 * h)) * D + n0 + acc_col(ni, 0),
               acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
}

// C[l] = A[l]^T Bm[l] in float32, the weight-gradient product of the
// backward kernels (B5, B6, B9, B12), A [K, M] and Bm [K, N] row-major (M and N
// contiguous), reduced over K = the B rows.  Grid (N/BN, M/BM, L).
template <typename T>
__global__ void __launch_bounds__(kThreads)
wgrad_kernel(const T* __restrict__ A, const T* __restrict__ Bm, float* __restrict__ C, int M,
             int N, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int l = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const long long KM = static_cast<long long>(K) * M, KN = static_cast<long long>(K) * N;
  const long long MN = static_cast<long long>(M) * N;
  Acc acc;
  zero(acc);
  mainloop<T, false, false>(acc, A + l * KM, M, Bm + l * KN, N, K, m0, n0, smem);
  float* out = C + l * MN;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store2(out + static_cast<long long>(m0 + acc_row(mi, 2 * h)) * N + n0 + acc_col(ni, 0),
               acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
}

inline bool shapes_ok(int L, int B, int D, int S) {
  return L > 0 && B > 0 && D > 0 && S > 0 && B % BM == 0 && D % BM == 0 && S % BM == 0 &&
         B / BM <= 65535 && S / BM <= 65535 && L <= 65535;
}

}  // namespace sae
