// Row gather: out[i, :] = x[idx[i], :].
//
// B3 as a ring of TMA bulk copies, the Hopper counterpart of the TPU
// kernel's ring of per-row DMAs, measured against the package's vector
// kernel (csrc/take_rows.cu) by probes/select_gather_versions.py and not
// kept: 5-7% slower at the store shapes, 2% at the sweep store's rows
// (`PERF.md`).  Same C interface as the package's take_rows.
// Two routes, chosen by the caller from the row width and both base
// pointers (`vec_bytes`, the widest access all of them are aligned to):
//  * bulk (vec_bytes 16): persistent one-warp blocks, a few an SM.  One lane
//    issues every copy: a 1-D bulk copy (cp.async.bulk) of each source row,
//    with an L2 evict-first hint since each row is read once, into a ring of
//    kSlots shared-memory slots completing on one mbarrier a slot; and a
//    bulk store of each arrived slot back out, tracked by bulk groups, so a
//    slot is refilled once its store has read it.  Loads run kAhead items
//    ahead of stores.  Rows wider than kSlotMax bytes (the sweep store's
//    49,152-byte rows) are split into chunks, one copy each.  The warp reads
//    the indices 32 items at a time, one batch ahead.
//  * vector (any other alignment): the package's kernel.

#include <algorithm>

#include "hopper_gemm.cuh"

namespace {

// ---- bulk route --------------------------------------------------------------

constexpr int kSlots = 16;          // ring slots a block
constexpr int kAhead = kSlots / 2;  // items whose loads run ahead of the stores
constexpr int kSlotMax = 4096;      // bytes a slot (a chunk of a wider row)
constexpr int kSmemPerSM = 200 * 1024;  // ring bytes given to the blocks of an SM
constexpr int kMaxBlocksPerSM = 8;
// Block b copies items b, b + grid, b + 2 grid, ... (true), so that the
// blocks' stores advance through the output together; or a contiguous
// share of them (false).
constexpr bool kStrided = true;

// L2 policy: evict these lines first (each source row is read once).
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

__device__ __forceinline__ void bulk_load_hint(void* dst, const void* src, uint32_t bytes,
                                               uint64_t* bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;\n" ::"r"(hg::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(hg::smem_u32(bar)), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                   reinterpret_cast<uint64_t>(dst)),
               "r"(hg::smem_u32(src)), "r"(bytes)
               : "memory");
}

// All but the newest N committed stores have read their shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read_but() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Items are (output row, chunk) pairs in output order.
template <typename I>
__global__ void __launch_bounds__(32)
take_rows_bulk_kernel(const char* __restrict__ x, const I* __restrict__ idx,
                      char* __restrict__ out, long long m, long long row_bytes, int slot_bytes,
                      int chunks) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kSlots];
  const int lane = threadIdx.x;
  const long long items = m * chunks;
  const long long begin = kStrided ? blockIdx.x : items * blockIdx.x / gridDim.x;
  const long long step = kStrided ? gridDim.x : 1;
  const long long n = kStrided ? (items - begin + step - 1) / step
                               : items * (blockIdx.x + 1) / gridDim.x - begin;
  if (lane == 0) {
    for (int s = 0; s < kSlots; ++s) hg::mbar_init(&full[s], 1);
    hg::fence_barrier_init();
  }
  __syncwarp();
  const uint64_t policy = evict_first_policy();

  // Source row offset of item begin + q, for the lane's item of a batch.
  auto source = [&](long long q) -> long long {
    return q < n ? static_cast<long long>(idx[(begin + q * step) / chunks]) * row_bytes : 0;
  };
  long long cur = source(lane), nxt = source(32 + lane);
  for (long long q = 0; q < n + kAhead; ++q) {
    if (q % 32 == 0 && q > 0) {  // the next batch's indices, one batch ahead
      cur = nxt;
      nxt = source(q + 32 + lane);
    }
    const long long src = __shfl_sync(0xffffffffu, cur, static_cast<int>(q % 32));
    if (lane == 0) {
      if (q < n) {  // load item q into its slot once the slot's last store has read it
        const int slot = static_cast<int>(q % kSlots);
        if (q >= kSlots) bulk_wait_read_but<kSlots - 1 - kAhead>();
        const long long chunk = (begin + q * step) % chunks;
        const uint32_t bytes = static_cast<uint32_t>(
            min(static_cast<long long>(slot_bytes), row_bytes - chunk * slot_bytes));
        hg::mbar_expect_tx(&full[slot], bytes);
        bulk_load_hint(ring + slot * slot_bytes, x + src + chunk * slot_bytes, bytes,
                       &full[slot], policy);
      }
      const long long p = q - kAhead;
      if (p >= 0 && p < n) {  // store item p once it has arrived
        const int slot = static_cast<int>(p % kSlots);
        hg::mbar_wait(&full[slot], static_cast<uint32_t>((p / kSlots) & 1));
        const long long item = begin + p * step;
        const long long chunk = item % chunks;
        const uint32_t bytes = static_cast<uint32_t>(
            min(static_cast<long long>(slot_bytes), row_bytes - chunk * slot_bytes));
        bulk_store(out + (item / chunks) * row_bytes + chunk * slot_bytes,
                   ring + slot * slot_bytes, bytes);
        hg::bulk_commit();
      }
    }
  }
  if (lane == 0) hg::bulk_wait();
}

template <typename I>
cudaError_t launch_bulk(const void* x, const void* idx, void* out, long long m,
                        long long row_bytes, int device, cudaStream_t stream) {
  const int slot_bytes = static_cast<int>(std::min(row_bytes, static_cast<long long>(kSlotMax)));
  const int chunks = static_cast<int>((row_bytes + slot_bytes - 1) / slot_bytes);
  const size_t smem = static_cast<size_t>(kSlots) * slot_bytes;
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long per_sm = std::min(static_cast<long long>(kMaxBlocksPerSM),
                                    std::max(1LL, static_cast<long long>(kSmemPerSM / smem)));
  const long long blocks = std::min(per_sm * sms, m * chunks);
  err = cudaFuncSetAttribute(take_rows_bulk_kernel<I>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  take_rows_bulk_kernel<I><<<static_cast<unsigned>(blocks), 32, smem, stream>>>(
      static_cast<const char*>(x), static_cast<const I*>(idx), static_cast<char*>(out), m,
      row_bytes, slot_bytes, chunks);
  return cudaGetLastError();
}

// ---- vector route -------------------------------------------------------------

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
// dividing row_bytes, with x and out aligned to it; 16 takes the bulk route.
// Returns the launch's cudaError_t.
extern "C" int take_rows(const void* x, const void* idx, void* out,
                         long long m, long long row_bytes, int idx_is_int64,
                         int vec_bytes, int device, void* stream) {
  if (m <= 0 || row_bytes <= 0 || vec_bytes <= 0 || row_bytes % vec_bytes)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec_bytes) {
    case 16:
      return idx_is_int64 ? launch_bulk<long long>(x, idx, out, m, row_bytes, device, s)
                          : launch_bulk<int>(x, idx, out, m, row_bytes, device, s);
    case 8: return launch_vec<int2>(x, idx, out, m, row_bytes, idx_is_int64, s);
    case 4: return launch_vec<int>(x, idx, out, m, row_bytes, idx_is_int64, s);
    case 2: return launch_vec<short>(x, idx, out, m, row_bytes, idx_is_int64, s);
    case 1: return launch_vec<char>(x, idx, out, m, row_bytes, idx_is_int64, s);
    default: return cudaErrorInvalidValue;
  }
}
