// Per-row k-th largest value (kernel B10).
//
// Replaces the Pallas TPU kernel `_kth_value_kernel`, launched by `kth_value`
// in vit_prisma_tpu/ops/topk.py.  For x [R, D] in float32 or bfloat16 it
// writes t [R] in float32:
//     u = order-preserving unsigned map of x (sign set: flip all bits; clear:
//         set the sign bit)
//     t = the largest pattern, over the searched bits, with at least k of
//         the row's u at or above it, mapped back to a float
// 32 searched bits for float32 rows; for bfloat16 rows the 16 bits of the
// bfloat16 pattern, which are the high half of its float32 pattern (the
// TPU kernel's 16 passes over the float32 map, whose low halves are zero
// for positives and all ones for negatives).  So t is the k-th value for
// float32 rows and for non-negative bfloat16 k-th values; for a negative
// bfloat16 k-th value it is the pattern with a zero low half, which the
// inverse map turns into a float just below the value, as in the TPU
// kernel.  Either way x >= t holds exactly for the top k, ties kept.  The
// plain version is `kth_value_reference` (vit_prisma_tpu_torch/ops/topk.py).
//
// Design (topk_search.cuh): one 256-thread block per row; the row is staged
// in shared memory when it fits (up to 96 KB: float32 rows to 24,576,
// bfloat16 rows to 49,152) and read from device memory on every pass
// otherwise, so every d_sae up to 65,536 and beyond runs; each of the 32 or
// 16 passes is a count and one block barrier.  The TPU kernel instead holds a
// block of rows in VMEM and counts with vector compares.
//
// What bounds it on an H100.  At [4096, 12288] the input is 201 MB in
// float32 (60 us at 3.35 TB/s) and 101 MB in bfloat16 (30 us), while the
// search does 32 (16) compares per element on the CUDA cores: 1.6 G (0.8 G)
// compares, 24 (12) us at the 67 T/s of the non-tensor rate.  So the
// bound is device memory.  The kernel re-reads each staged row from shared
// memory on every pass, which costs issue slots rather than bytes;
// `PERF.md` has its measured time.

#include "topk_search.cuh"

namespace {

using namespace topk;

template <typename T>
__global__ void __launch_bounds__(kThreads)
kth_value_kernel(const T* __restrict__ x, float* __restrict__ t, int D, int k, int staged) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ unsigned red[2 * kWarps];
  const T* row = stage_row(x + static_cast<long long>(blockIdx.x) * D, D, staged != 0,
                           reinterpret_cast<T*>(smem_raw));
  constexpr int bits = 8 * sizeof(T);
  const unsigned acc = search_row<false>(row, D, k, bits - 1, 0, red);
  if (threadIdx.x == 0) {
    const unsigned u = acc << (32 - bits);  // the float32 map's pattern
    const unsigned back = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
    t[blockIdx.x] = __uint_as_float(back);
  }
}

template <typename T>
cudaError_t launch(const void* x, void* t, long long R, int D, int k, cudaStream_t s) {
  const bool staged = stages(D, sizeof(T));
  cudaError_t err = allow_stage(kth_value_kernel<T>);
  if (err != cudaSuccess) return err;
  kth_value_kernel<T><<<static_cast<unsigned int>(R), kThreads,
                        staged ? static_cast<size_t>(D) * sizeof(T) : 0, s>>>(
      static_cast<const T*>(x), static_cast<float*>(t), D, k, staged);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x [R, D] contiguous, t [R] float32;
// 1 <= k <= D.  Returns the launch's cudaError_t.
extern "C" int kth_value(const void* x, void* t, long long R, int D, int k, int dtype,
                         int device, void* stream) {
  if (R <= 0 || R > 0x7fffffffLL || D <= 0 || k < 1 || k > D) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, t, R, D, k, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, t, R, D, k, s);
  return cudaErrorInvalidValue;
}
