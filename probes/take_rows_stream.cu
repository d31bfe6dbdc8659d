// B3's 16-byte route as a vector loop with streaming hints, the design the
// bulk-copy route of csrc/take_rows.cu was measured against
// (probes/select_gather_versions.py): one warp a row, 8 warps a block,
// grid-stride over rows; each lane loads its share of the row's 16-byte
// vectors (up to kPerLane, ld.global.nc.L1::no_allocate) before it stores
// them (st.global.cs), so a 3,072-byte row is 6 vectors a lane in one trip.
// Same C interface as the package's take_rows; only vec_bytes 16 is taken.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kPerLane = 8;
constexpr long long kMaxBlocks = 1 << 20;

__device__ __forceinline__ int4 ld_stream(const int4* p) {
  int4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

template <typename I>
__global__ void __launch_bounds__(kWarps * 32)
take_rows_stream_kernel(const char* __restrict__ x, const I* __restrict__ idx,
                        char* __restrict__ out, long long m, long long row_bytes) {
  const int lane = threadIdx.x & 31;
  const long long n_vec = row_bytes / 16;
  const long long n_warps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       row < m; row += n_warps) {
    const int4* s = reinterpret_cast<const int4*>(x + static_cast<long long>(idx[row]) * row_bytes);
    int4* d = reinterpret_cast<int4*>(out + row * row_bytes);
    for (long long c = lane; c < n_vec; c += 32 * kPerLane) {
      int4 buf[kPerLane];
#pragma unroll
      for (int u = 0; u < kPerLane; ++u)
        if (c + 32 * u < n_vec) buf[u] = ld_stream(s + c + 32 * u);
#pragma unroll
      for (int u = 0; u < kPerLane; ++u)
        if (c + 32 * u < n_vec) __stcs(d + c + 32 * u, buf[u]);
    }
  }
}

}  // namespace

extern "C" int take_rows(const void* x, const void* idx, void* out, long long m,
                         long long row_bytes, int idx_is_int64, int vec_bytes, int device,
                         void* stream) {
  if (m <= 0 || row_bytes <= 0 || vec_bytes != 16 || row_bytes % 16) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const long long blocks = (m + kWarps - 1) / kWarps < kMaxBlocks ? (m + kWarps - 1) / kWarps
                                                                 : kMaxBlocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx_is_int64)
    take_rows_stream_kernel<long long><<<static_cast<unsigned>(blocks), kWarps * 32, 0, s>>>(
        static_cast<const char*>(x), static_cast<const long long*>(idx), static_cast<char*>(out),
        m, row_bytes);
  else
    take_rows_stream_kernel<int><<<static_cast<unsigned>(blocks), kWarps * 32, 0, s>>>(
        static_cast<const char*>(x), static_cast<const int*>(idx), static_cast<char*>(out), m,
        row_bytes);
  return cudaGetLastError();
}
