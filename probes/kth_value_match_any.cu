// Per-row k-th largest value (kernel B10): a radix select on 8-bit digits.
//
// B10 with its lanes' equal digits added together before one shared
// atomic (__match_any_sync, kWarpHistograms false), the counting the
// package's csrc/kth_value.cu was measured against by
// probes/select_gather_versions.py and replaced: 1.3-2x slower at the
// smoke's shapes, tied rows included (`PERF.md`).  Otherwise the
// package's kernel as it stood then; same C interface.

#include <cooperative_groups.h>
#include <stdint.h>

#include <algorithm>

#include "topk_search.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // one bin a thread
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr int kMaxPasses = 4;
constexpr int kUnroll = 4;               // 16-byte vectors a lane loads before it counts
constexpr int kStageCap = 64 * 1024;     // bytes of a row one block stages
constexpr int kClusterPart = 32 * 1024;  // bytes a block of a cluster aims at
constexpr int kMaxCluster = 8;           // the portable cluster size
// How a warp counts: true, into a histogram of its own, one atomic a key,
// the eight summed before the scan; false, its lanes' equal digits add
// through one atomic (__match_any_sync) on the block's histogram.  `PERF.md`
// has both on the smoke's rows (ties included): true is 1.3-2x faster.
constexpr bool kWarpHistograms = false;

// Route of a row of D elements of elem_bytes: blocks a row (cluster), the
// elements each block covers (part, a multiple of 16 bytes), and whether
// the row is staged in shared memory.
struct Plan {
  int cluster, part, staged;
};

inline Plan plan(int D, int elem_bytes) {
  const long long bytes = static_cast<long long>(D) * elem_bytes;
  const int vec = 16 / elem_bytes;
  const int cluster =
      bytes <= kStageCap ? 1
                         : static_cast<int>(std::min<long long>(
                               kMaxCluster, (bytes + kClusterPart - 1) / kClusterPart));
  const int staged = bytes <= static_cast<long long>(kMaxCluster) * kStageCap;
  const int part = ((D + cluster - 1) / cluster + vec - 1) / vec * vec;
  return {cluster, part, staged};
}

// Dynamic shared memory of a block: its part, plus one vector so that the
// staged copy keeps the row's 16-byte phase.
inline size_t stage_bytes(const Plan& p, int elem_bytes) {
  return p.staged ? static_cast<size_t>(p.part) * elem_bytes + 16 : 0;
}

template <typename T>
__device__ __forceinline__ T from_bits(unsigned b);
template <>
__device__ __forceinline__ float from_bits<float>(unsigned b) { return __uint_as_float(b); }
template <>
__device__ __forceinline__ __nv_bfloat16 from_bits<__nv_bfloat16>(unsigned b) {
  return __ushort_as_bfloat16(static_cast<unsigned short>(b));
}

// Element e of a 16-byte vector, as its bit pattern.
template <typename T>
__device__ __forceinline__ unsigned elem_bits(const uint4& v, int e) {
  const unsigned w = (&v.x)[e * sizeof(T) / 4];
  return sizeof(T) == 4 ? w : (w >> (16 * (e & 1))) & 0xffffu;
}

// One count a lane (where ok) into bin `digit` of hist: the warp's own
// histogram, one atomic a key; or, without kWarpHistograms, the block's,
// the lanes with equal digits adding together through one atomic (a warp
// none of whose lanes counts, as most past the first pass, skips the
// match).  Every lane of the warp calls it.
__device__ __forceinline__ void count(unsigned* hist, unsigned digit, bool ok) {
  if (kWarpHistograms) {
    if (ok) atomicAdd(&hist[digit], 1u);
    return;
  }
  if (!__any_sync(0xffffffffu, ok)) return;
  const unsigned peers = __match_any_sync(0xffffffffu, ok ? digit : 0xffffffffu);
  if (ok && (threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(&hist[digit], __popc(peers));
}

// One digit pass over the n elements at src (the block's part; global or
// shared memory, 16-byte phase `head`: elements before the first aligned
// vector), counting digit (key >> shift) & 0xff of the keys whose bits
// above shift + 8 equal prefix (all keys when `all`).  With STORE, the
// elements are also written to dst (shared memory of the same phase).
// Warp-uniform control flow: every lane reaches each count().
template <typename T, bool STORE>
__device__ __forceinline__ void digit_pass(const T* src, T* dst, int n, int head, int shift,
                                           bool all, unsigned prefix, unsigned* hist) {
  constexpr int V = 16 / sizeof(T);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto one = [&](unsigned bits, bool ok) {
    const unsigned key = topk::signed_key(from_bits<T>(bits));
    ok = ok && (all || (key >> (shift + 8)) == prefix);
    count(hist, (key >> shift) & 0xffu, ok);
  };
  const int nv = (n - head) / V;
  const int tail = n - head - nv * V;
  if (warp == kWarps - 1) {  // the ragged ends: fewer than V elements each
    const bool ok = lane < head;
    unsigned b = 0;
    if (ok) {
      b = topk::bits_of(src[lane]);
      if (STORE) dst[lane] = src[lane];
    }
    one(b, ok);
    const int i = head + nv * V + lane;
    const bool ok2 = lane < tail;
    b = 0;
    if (ok2) {
      b = topk::bits_of(src[i]);
      if (STORE) dst[i] = src[i];
    }
    one(b, ok2);
  }
  const uint4* s4 = reinterpret_cast<const uint4*>(src + head);
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  for (int base = warp * 32 * kUnroll; base < nv; base += kThreads * kUnroll) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + 32 * u + lane;
      if (j < nv) v[u] = STORE ? __ldcs(s4 + j) : s4[j];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + 32 * u + lane;
      const bool ok = j < nv;
      if (STORE && ok) d4[j] = v[u];
#pragma unroll
      for (int e = 0; e < V; ++e) one(ok ? elem_bits<T>(v[u], e) : 0u, ok);
    }
  }
}

// Block-wide choice of the bin that holds the k-th key: thread t holds the
// count c of bin 255 - t; an inclusive scan from the top bin finds the one
// bin with (counts above) < k <= (counts above) + c.  Every thread returns
// it, and k becomes the rank within it.
__device__ __forceinline__ unsigned choose_bin(unsigned c, unsigned& k, unsigned* wsum,
                                               unsigned* sel) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned incl = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  for (int w = 0; w < warp; ++w) incl += wsum[w];
  const unsigned above = incl - c;
  if (above < k && k <= incl) {
    sel[0] = kBins - 1 - threadIdx.x;
    sel[1] = k - above;
  }
  __syncthreads();
  k = sel[1];
  return sel[0];
}

// One row (CLUSTER: one part of a row, the cluster holding the row) per
// block.  STAGED: the part is read from device memory once and kept in
// shared memory; else every pass reads it from device memory.
template <typename T, bool STAGED, bool CLUSTER>
__global__ void __launch_bounds__(kThreads)
radix_select_kernel(const T* __restrict__ x, float* __restrict__ t, int D, int k, int part) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ unsigned hist[kMaxPasses][kBins];
  __shared__ unsigned sub[kWarpHistograms ? kWarps : 1][kWarpHistograms ? kBins : 1];
  __shared__ unsigned wsum[kWarps], sel[2];
  constexpr int bits = 8 * sizeof(T);
  constexpr int passes = bits / 8;
  constexpr int V = 16 / sizeof(T);

  int rank = 0, ranks = 1;
  long long row = blockIdx.x;
  if (CLUSTER) {
    cg::cluster_group cluster = cg::this_cluster();
    rank = static_cast<int>(cluster.block_rank());
    ranks = static_cast<int>(cluster.num_blocks());
    row = blockIdx.x / ranks;
  }
  const int start = min(D, rank * part);
  const int n = min(D, start + part) - start;
  const T* src = x + row * D + start;
  const int phase = static_cast<int>((reinterpret_cast<uintptr_t>(src) & 15) / sizeof(T));
  const int head = min(n, (V - phase) % V);
  T* stage = reinterpret_cast<T*>(smem_raw) + phase;

  for (int i = threadIdx.x; i < kMaxPasses * kBins; i += kThreads) (&hist[0][0])[i] = 0;
  for (int i = threadIdx.x; i < static_cast<int>(sizeof(sub) / 4); i += kThreads) (&sub[0][0])[i] = 0;
  __syncthreads();
  unsigned* counts = kWarpHistograms ? &sub[threadIdx.x >> 5][0] : nullptr;

  unsigned prefix = 0, kk = static_cast<unsigned>(k);
#pragma unroll 1
  for (int p = 0; p < passes; ++p) {
    const int shift = bits - 8 * (p + 1);
    unsigned* h = kWarpHistograms ? counts : hist[p];
    if (STAGED && p == 0)
      digit_pass<T, true>(src, stage, n, head, shift, true, 0, h);
    else
      digit_pass<T, false>(STAGED ? stage : src, nullptr, n, head, shift, p == 0, prefix, h);
    if (kWarpHistograms) {  // thread t sums (and clears) bin t of every warp
      __syncthreads();
      unsigned s = 0;
      for (int w = 0; w < kWarps; ++w) {
        s += sub[w][threadIdx.x];
        sub[w][threadIdx.x] = 0;
      }
      hist[p][threadIdx.x] = s;
    }
    unsigned c = 0;
    if (CLUSTER) {
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      for (int r = 0; r < ranks; ++r)
        c += cluster.map_shared_rank(&hist[p][0], r)[kBins - 1 - threadIdx.x];
    } else {
      __syncthreads();
      c = hist[p][kBins - 1 - threadIdx.x];
    }
    prefix = (prefix << 8) | choose_bin(c, kk, wsum, sel);
  }
  // No block leaves while another may still read its histograms.
  if (CLUSTER) cg::this_cluster().sync();
  if (rank == 0 && threadIdx.x == 0) {
    const unsigned u = prefix << (32 - bits);  // the float32 map's pattern
    const unsigned back = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
    t[row] = __uint_as_float(back);
  }
}

template <typename T, bool STAGED, bool CLUSTER>
cudaError_t launch_route(const T* x, float* t, long long R, int D, int k, const Plan& p,
                         cudaStream_t s) {
  auto kernel = radix_select_kernel<T, STAGED, CLUSTER>;
  const size_t smem = stage_bytes(p, sizeof(T));
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (!CLUSTER) {
    kernel<<<static_cast<unsigned>(R), kThreads, smem, s>>>(x, t, D, k, p.part);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(R * p.cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, x, t, D, k, p.part);
}

template <typename T>
cudaError_t launch(const void* x, void* t, long long R, int D, int k, cudaStream_t s) {
  const Plan p = plan(D, sizeof(T));
  const T* xs = static_cast<const T*>(x);
  float* ts = static_cast<float*>(t);
  if (R * p.cluster > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (!p.staged) return launch_route<T, false, true>(xs, ts, R, D, k, p, s);
  if (p.cluster > 1) return launch_route<T, true, true>(xs, ts, R, D, k, p, s);
  return launch_route<T, true, false>(xs, ts, R, D, k, p, s);
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

// The route `kth_value` takes for rows of D elements: out[0] blocks a row,
// out[1] elements a block covers, out[2] 1 if staged in shared memory,
// out[3] dynamic shared memory bytes a block.  For checking the Python
// mirror (ops/topk.py kth_value_route).
extern "C" int kth_value_plan(int D, int dtype, int* out) {
  if (D <= 0 || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  const int elem = dtype == 0 ? 4 : 2;
  const Plan p = plan(D, elem);
  out[0] = p.cluster;
  out[1] = p.part;
  out[2] = p.staged;
  out[3] = static_cast<int>(stage_bytes(p, elem));
  return 0;
}
