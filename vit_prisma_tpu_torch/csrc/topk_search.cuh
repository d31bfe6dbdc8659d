// Per-row k-th-largest search, shared by kernel B10 (kth_value.cu) and the
// threshold pass of kernel B8 (sae_fused_fwd_topk.cu).
//
// One block of kThreads threads owns one row.  Values are mapped onto
// unsigned keys in value order, and the block builds the k-th largest key
// bit by bit, from the highest searched bit down: a candidate bit is kept
// when at least k keys are >= the candidate.  Each pass is one count over
// the row, summed across the block with one barrier, so a row of D values
// costs (number of searched bits) x D compares.  The result is the largest
// key with at least k keys at or above it: the k-th largest, ties counted
// with multiplicity, so every entry tied at the k-th value passes a >= mask.
//
// Rows are read from shared memory where they fit (stage_row) and from
// device memory, through L2, on every pass where they do not.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace topk {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// A row of at most this many bytes is staged in shared memory: 96 KB keeps
// two blocks on an SM (227 KB); a float32 row of 12,288 takes 48 KB.
constexpr int kStageBytes = 96 * 1024;

__device__ __forceinline__ unsigned bits_of(float v) { return __float_as_uint(v); }
__device__ __forceinline__ unsigned bits_of(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }

// Order-preserving map of a signed value onto an unsigned key of the same
// width: a set sign bit flips every bit, a clear one sets the sign bit.
template <typename T>
__device__ __forceinline__ unsigned signed_key(T v) {
  constexpr unsigned sign = 1u << (8 * sizeof(T) - 1);
  constexpr unsigned all = sizeof(T) == 4 ? 0xffffffffu : 0xffffu;
  const unsigned b = bits_of(v);
  return (b & sign) ? (~b & all) : (b | sign);
}

// Key of max(v, 0) for a search over non-negative values: the pattern of a
// positive value, 0 for zero, -0 and negatives.  Non-negative patterns are
// ordered as integers, so no flip is needed.
template <typename T>
__device__ __forceinline__ unsigned relu_key(T v) {
  constexpr unsigned sign = 1u << (8 * sizeof(T) - 1);
  const unsigned b = bits_of(v);
  return (b & sign) ? 0u : b;
}

template <bool RELU, typename T>
__device__ __forceinline__ unsigned key_of(T v) {
  return RELU ? relu_key(v) : signed_key(v);
}

// Sum of one count per thread over the block.  red holds 2 * kWarps
// unsigned ints of shared memory, used by pass parity: a thread writes its
// warp's sum for pass p + 2 only after the barrier of pass p + 1, which every
// thread reaches after reading pass p's sums, so one barrier a pass serves.
__device__ __forceinline__ unsigned block_count(unsigned c, unsigned* red, int parity) {
  c = __reduce_add_sync(0xffffffffu, c);
  if ((threadIdx.x & 31) == 0) red[parity * kWarps + threadIdx.x / 32] = c;
  __syncthreads();
  unsigned s = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[parity * kWarps + w];
  return s;
}

// The largest key built from bits hi .. lo (bits below lo zero) with at
// least k of the row's n keys at or above it.  Every thread returns it.
template <bool RELU, typename T>
__device__ unsigned search_row(const T* row, int n, int k, int hi, int lo, unsigned* red) {
  unsigned acc = 0;
  int parity = 0;
  for (int b = hi; b >= lo; --b, parity ^= 1) {
    const unsigned cand = acc | (1u << b);
    unsigned c = 0;
    for (int i = threadIdx.x; i < n; i += kThreads) c += key_of<RELU>(row[i]) >= cand ? 1u : 0u;
    if (block_count(c, red, parity) >= static_cast<unsigned>(k)) acc = cand;
  }
  return acc;
}

// Copy a row into shared memory when it fits; returns where to read it.
template <typename T>
__device__ __forceinline__ const T* stage_row(const T* row, int n, bool staged, T* smem) {
  if (!staged) return row;
  for (int i = threadIdx.x; i < n; i += kThreads) smem[i] = row[i];
  __syncthreads();
  return smem;
}

inline bool stages(int n, int elem_bytes) {
  return static_cast<long long>(n) * elem_bytes <= kStageBytes;
}

// Opt a kernel into kStageBytes of dynamic shared memory.
template <typename Kernel>
cudaError_t allow_stage(Kernel k) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, kStageBytes);
}

}  // namespace topk
