// Per-row k-th largest value (kernel B10): a radix select on 8-bit digits.
//
// Replaces the Pallas TPU kernel `_kth_value_kernel`, launched by `kth_value`
// in vit_prisma_tpu/ops/topk.py.  For x [R, D] in float32 or bfloat16 it
// writes t [R] in float32:
//     u = order-preserving unsigned map of x (topk::signed_key: sign set,
//         flip all bits; clear, set the sign bit), 32 bits for float32 rows,
//         the 16 bits of the bfloat16 pattern for bfloat16 rows
//     t = the largest u with at least k of the row's u at or above it (the
//         k-th largest, ties counted with multiplicity), mapped back to a
//         float32 from its float32 pattern (a bfloat16 key is the high half)
// This is the function the TPU kernel's bitwise search computes (32 or 16
// passes), so a bfloat16 row with a negative k-th value gets the same
// separator just below it, and x >= t keeps exactly the top k, ties kept.
// The plain version is `kth_value_reference` (vit_prisma_tpu_torch/ops/topk.py).
//
// Design: the radix select of radix_select.cuh (8-bit digits, 4 passes for
// float32 keys and 2 for bfloat16, per-warp shared histograms; one block, a
// thread-block cluster or a streamed cluster by row width: `plan`, mirrored
// by `kth_value_route` in ops/topk.py), which B8's bf16 Hopper route shares.
//
// What bounds it on an H100: one read of x, 201 MB in float32 at [4096,
// 12288] (60 us at 3.35 TB/s), 101 MB in bfloat16 (30 us).  The staged
// routes read it once; the passes over shared memory cost issue slots.
// `PERF.md` has the measured times.

#include "radix_select.cuh"

// dtype: 0 = float32, 1 = bfloat16.  x [R, D] contiguous, t [R] float32;
// 1 <= k <= D.  Returns the launch's cudaError_t.
extern "C" int kth_value(const void* x, void* t, long long R, int D, int k, int dtype,
                         int device, void* stream) {
  if (R <= 0 || R > 0x7fffffffLL || D <= 0 || k < 1 || k > D) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return rsel::select_rows<float, false>(static_cast<const float*>(x), static_cast<float*>(t),
                                           nullptr, R, D, k, s);
  if (dtype == 1)
    return rsel::select_rows<__nv_bfloat16, false>(static_cast<const __nv_bfloat16*>(x),
                                                   static_cast<float*>(t), nullptr, R, D, k, s);
  return cudaErrorInvalidValue;
}

// The route `kth_value` takes for rows of D elements: out[0] blocks a row,
// out[1] elements a block covers, out[2] 1 if staged in shared memory,
// out[3] dynamic shared memory bytes a block.  For checking the Python
// mirror (ops/topk.py kth_value_route).
extern "C" int kth_value_plan(int D, int dtype, int* out) {
  if (D <= 0 || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  const int elem = dtype == 0 ? 4 : 2;
  const rsel::Plan p = rsel::plan(D, elem);
  out[0] = p.cluster;
  out[1] = p.part;
  out[2] = p.staged;
  out[3] = static_cast<int>(rsel::stage_bytes(p, elem));
  return 0;
}
