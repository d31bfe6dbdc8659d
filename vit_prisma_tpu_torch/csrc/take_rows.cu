// Row gather: out[i, :] = x[idx[i], :].
//
// Replaces the Pallas TPU kernel `_gather_kernel`, launched by `take_rows`
// in vit_prisma_tpu/ops/shuffle.py (kernel B3 of the ROADMAP).  Same
// contract: x is a contiguous [N, D] source (trailing dims flattened) of any
// element size, idx is [M] int32 or int64, out is [M, D] in x's dtype, and
// the copy is exact.  The Python wrapper (vit_prisma_tpu_torch/ops/shuffle.py)
// checks that every index lies in [0, N) before the launch, so the kernel
// trusts them.
//
// What bounds it on an H100.  It moves bytes and computes nothing: one read
// and one write of every output row, 2 * M * row_bytes in all.  At the
// activation store's shape (M = N = 819,200 rows of 768 float32, 3,072 bytes
// each) that is 5.0 GB, about 1.5 ms at the card's 3.35 TB/s.  So the aim
// is to keep enough bytes in flight to saturate device memory.
//
// Design.  The TPU kernel keeps a ring of per-row DMAs and semaphores in
// flight from one core; on Hopper the parallelism comes from many warps
// instead.  That ring's Hopper counterpart, TMA bulk copies through a ring
// of shared-memory slots (probes/take_rows_bulk.cu), ran 5-7% slower at the
// activation store's shapes, and 16-byte loads with streaming hints
// (probes/take_rows_stream.cu) 1-3% slower; this kernel moves the store's
// rows at 0.87-0.89 of 3.35 TB/s, as fast as index_select (`PERF.md`).
//  * Each warp copies one row at a time (grid-stride over rows, 8 warps per
//    block); all lanes read the row's index (one broadcast load).
//  * A lane moves the widest vector (16, 8, 4, 2 or 1 bytes) that the row
//    width and both base pointers are aligned to; the wrapper picks it.  A
//    3,072-byte row is 192 16-byte vectors: 6 per lane, issued as loads of
//    4 vectors before any store, so that their latencies overlap.
//  * Reads go through the read-only path (__ldg); the output never aliases
//    the source (the wrapper allocates it).

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;   // warps per block
constexpr int kUnroll = 4;  // vectors a lane loads before it stores them
constexpr long long kMaxBlocks = 1 << 20;

template <typename V, typename I>
__global__ void __launch_bounds__(kWarps * 32)
take_rows_kernel(const char* __restrict__ x, const I* __restrict__ idx,
                 char* __restrict__ out, long long m, long long row_bytes) {
  const int lane = threadIdx.x & 31;
  const long long n_vec = row_bytes / static_cast<long long>(sizeof(V));
  const long long n_warps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       row < m; row += n_warps) {
    const long long src = static_cast<long long>(__ldg(idx + row));
    const V* s = reinterpret_cast<const V*>(x + src * row_bytes);
    V* d = reinterpret_cast<V*>(out + row * row_bytes);
    for (long long c = lane; c < n_vec; c += 32 * kUnroll) {
      V buf[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long j = c + 32 * u;
        if (j < n_vec) buf[u] = __ldg(s + j);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long j = c + 32 * u;
        if (j < n_vec) d[j] = buf[u];
      }
    }
  }
}

template <typename V>
cudaError_t launch_vec(const void* x, const void* idx, void* out, long long m,
                       long long row_bytes, int idx_is_int64,
                       cudaStream_t stream) {
  long long blocks = (m + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const dim3 grid(static_cast<unsigned int>(blocks));
  const char* xs = static_cast<const char*>(x);
  char* o = static_cast<char*>(out);
  if (idx_is_int64)
    take_rows_kernel<V, long long><<<grid, kWarps * 32, 0, stream>>>(
        xs, static_cast<const long long*>(idx), o, m, row_bytes);
  else
    take_rows_kernel<V, int><<<grid, kWarps * 32, 0, stream>>>(
        xs, static_cast<const int*>(idx), o, m, row_bytes);
  return cudaGetLastError();
}

}  // namespace

// idx_is_int64: 0 = int32 indices, 1 = int64.  vec_bytes: 16, 8, 4, 2 or 1,
// dividing row_bytes, with x and out aligned to it.  Returns the launch's
// cudaError_t.
extern "C" int take_rows(const void* x, const void* idx, void* out,
                         long long m, long long row_bytes, int idx_is_int64,
                         int vec_bytes, int device, void* stream) {
  if (m <= 0 || row_bytes <= 0 || vec_bytes <= 0 || row_bytes % vec_bytes)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec_bytes) {
    case 16: return launch_vec<int4>(x, idx, out, m, row_bytes, idx_is_int64, s);
    case 8: return launch_vec<int2>(x, idx, out, m, row_bytes, idx_is_int64, s);
    case 4: return launch_vec<int>(x, idx, out, m, row_bytes, idx_is_int64, s);
    case 2: return launch_vec<short>(x, idx, out, m, row_bytes, idx_is_int64, s);
    case 1: return launch_vec<char>(x, idx, out, m, row_bytes, idx_is_int64, s);
    default: return cudaErrorInvalidValue;
  }
}
