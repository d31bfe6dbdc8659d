// Per-row k-th largest value by a radix select on 8-bit digits: the device
// code of kernel B10 (kth_value.cu) and of the select-and-mask step of kernel
// B8's bf16 Hopper route (sae_fused_tc.cu), which runs it on its rows of
// max(hpre, 0) and zeroes each row's entries below the value in place.
//
// For x [R, D] in float32 or bfloat16 it writes t [R] in float32:
//     u = order-preserving unsigned map of x (topk::signed_key: sign set,
//         flip all bits; clear, set the sign bit), 32 bits for float32 rows,
//         the 16 bits of the bfloat16 pattern for bfloat16 rows
//     t = the largest u with at least k of the row's u at or above it (the
//         k-th largest, ties counted with multiplicity), mapped back to a
//         float32 from its float32 pattern (a bfloat16 key is the high half)
// This is the function the TPU kernel's bitwise search computes (32 or 16
// passes), so a bfloat16 row with a negative k-th value gets the same
// separator just below it, and x >= t keeps exactly the top k, ties kept.
// On rows of max(hp, 0) with +0 for every entry not above 0 (never -0: its
// key sits below +0's), t is `_row_threshold`'s threshold of B8's bitwise
// search (ops/sae_step.py) to the bit.  With MASK, each row's entries are
// rewritten in place as (x > 0 && x >= t) ? x : +0, B8's h.
//
// Design.  Radix select from the top digit: 4 digit passes for float32 keys,
// 2 for bfloat16.  Each pass builds a 256-bin histogram of the digit over
// the keys whose higher digits equal the prefix chosen so far, scans it from
// the top bin for the bin holding the k-th key, appends that bin to the
// prefix and takes the counts above it off k.  Ties keep their multiplicity
// in the counts, so the result is the bitwise search's.  Each warp counts
// into a histogram of its own (one shared atomic a key), and the eight are
// summed before the scan: a row's top digit (sign and exponent) takes a few
// values only and tied rows put thousands of keys in one bin, yet adding a
// warp's equal digits first (__match_any_sync, probes/kth_value_match_any.cu)
// measured 1.3-2x slower (`PERF.md`).
//
// Routes, by (D, dtype) alone (`plan`, mirrored by `kth_value_route` in
// ops/topk.py and checked over every D up to 2^20 by the CPU tests):
//  * one block: a row of at most kStageCap bytes (float32 D <= 16,384,
//    bfloat16 D <= 32,768).  The first pass reads the row from device memory
//    with 16-byte loads, stages it in shared memory sized to the row and
//    counts its top digit in the same loop; later passes read shared memory.
//    The 48 KB float32 row of the TopK slice ([4096, 12288]) and 12 KB of
//    histograms leave three blocks an SM; B8's bf16 rows (24 KB at the TopK
//    slice, 16 KB at the sweep) take this route.
//  * cluster: a row of up to kMaxCluster x kStageCap bytes (float32 D <=
//    131,072, bfloat16 D <= 262,144) is split over a thread-block cluster
//    of 3-8 blocks (launched by cudaLaunchKernelEx), parts of kClusterPart
//    bytes where 8 blocks allow it, each staged once.  Each pass's
//    histograms are summed across the cluster through distributed shared
//    memory, so every block picks the same bin.  The widest d_sae of the
//    repo's configs, 65,536 float32 (256 KB), takes 8 blocks of 32 KB:
//    more SMs read each row at once than with 4 of 64 KB (0.079 against
//    0.103 ms on an H100, `PERF.md`), while a row the TopK slice gives
//    stays on one block (0.168 ms; 0.195 as a cluster of 32 KB parts).
//  * streamed: wider rows take a cluster of 8 that stages nothing: each
//    digit pass reads its part from device memory again (4 or 2 reads of
//    the row, where the bitwise search took 32 or 16).
// With MASK each block rewrites its own part from its staged copy (streamed:
// from device memory, once more), after every pass has read it.
//
// What bounds it on an H100: one read of x, 201 MB in float32 at [4096,
// 12288] (60 us at 3.35 TB/s), 101 MB in bfloat16 (30 us); MASK writes the
// rows back (twice the bytes).  The staged routes read x once; the passes
// over shared memory cost issue slots.  `PERF.md` has the measured times.
#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

#include <algorithm>

#include "topk_search.cuh"

namespace rsel {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;  // one bin a thread
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr int kMaxPasses = 4;
constexpr int kUnroll = 4;               // 16-byte vectors a lane loads before it counts
constexpr int kStageCap = 64 * 1024;     // bytes of a row one block stages
constexpr int kClusterPart = 32 * 1024;  // bytes a block of a cluster aims at
constexpr int kMaxCluster = 8;           // the portable cluster size

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

// One digit pass over the n elements at src (the block's part; global or
// shared memory, 16-byte phase `head`: elements before the first aligned
// vector), counting digit (key >> shift) & 0xff of the keys whose bits
// above shift + 8 equal prefix (all keys when `all`) into hist, the warp's
// own histogram.  With STORE, the elements are also written to dst (shared
// memory of the same phase).
template <typename T, bool STORE>
__device__ __forceinline__ void digit_pass(const T* src, T* dst, int n, int head, int shift,
                                           bool all, unsigned prefix, unsigned* hist) {
  constexpr int V = 16 / sizeof(T);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto one = [&](unsigned bits) {
    const unsigned key = topk::signed_key(from_bits<T>(bits));
    if (all || (key >> (shift + 8)) == prefix) atomicAdd(&hist[(key >> shift) & 0xffu], 1u);
  };
  const int nv = (n - head) / V;
  const int tail = n - head - nv * V;
  if (warp == kWarps - 1) {  // the ragged ends, fewer than V <= 8 elements each
    const bool in_head = lane < 16;
    const int i = in_head ? lane : head + nv * V + lane - 16;
    if (in_head ? lane < head : lane - 16 < tail) {
      if (STORE) dst[i] = src[i];
      one(topk::bits_of(src[i]));
    }
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
      if (j >= nv) continue;
      if (STORE) d4[j] = v[u];
#pragma unroll
      for (int e = 0; e < V; ++e) one(elem_bits<T>(v[u], e));
    }
  }
}

// A bit pattern of T kept where its value is above 0 and at least tf, else
// +0 (the pattern 0).
template <typename T>
__device__ __forceinline__ unsigned keep_bits(unsigned b, float tf) {
  const float f = __uint_as_float(sizeof(T) == 4 ? b : b << 16);
  return f > 0.f && f >= tf ? b : 0u;
}

// The n elements at src, rewritten to dst (device memory of the same 16-byte
// phase `head`) as (x > 0 && x >= tf) ? x : +0, 16 bytes a lane.
template <typename T>
__device__ __forceinline__ void mask_pass(const T* src, T* dst, int n, int head, float tf) {
  constexpr int V = 16 / sizeof(T);
  const int nv = (n - head) / V;
  const int tail = n - head - nv * V;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp == kWarps - 1) {  // the ragged ends
    const bool in_head = lane < 16;
    const int i = in_head ? lane : head + nv * V + lane - 16;
    if (in_head ? lane < head : lane - 16 < tail)
      dst[i] = from_bits<T>(keep_bits<T>(topk::bits_of(src[i]), tf));
  }
  const uint4* s4 = reinterpret_cast<const uint4*>(src + head);
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  for (int j = threadIdx.x; j < nv; j += kThreads) {
    uint4 v = s4[j];
    unsigned* w = &v.x;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      w[q] = sizeof(T) == 4 ? keep_bits<T>(w[q], tf)
                            : keep_bits<T>(w[q] & 0xffffu, tf) | keep_bits<T>(w[q] >> 16, tf) << 16;
    __stcs(d4 + j, v);
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
// shared memory; else every pass reads it from device memory.  MASK: the
// block then rewrites its part of the row through `out` (x's memory: the
// reads of x are all done by then).
template <typename T, bool STAGED, bool CLUSTER, bool MASK>
__global__ void __launch_bounds__(kThreads)
radix_select_kernel(const T* __restrict__ x, float* __restrict__ t, T* out, int D, int k,
                    int part) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ unsigned hist[kMaxPasses][kBins];
  __shared__ unsigned sub[kWarps][kBins];  // each warp's counts of the pass
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

  for (int i = threadIdx.x; i < kWarps * kBins; i += kThreads) (&sub[0][0])[i] = 0;
  __syncthreads();
  unsigned* counts = &sub[threadIdx.x >> 5][0];

  unsigned prefix = 0, kk = static_cast<unsigned>(k);
#pragma unroll 1
  for (int p = 0; p < passes; ++p) {
    const int shift = bits - 8 * (p + 1);
    if (STAGED && p == 0)
      digit_pass<T, true>(src, stage, n, head, shift, true, 0, counts);
    else
      digit_pass<T, false>(STAGED ? stage : src, nullptr, n, head, shift, p == 0, prefix, counts);
    __syncthreads();
    unsigned sum = 0;  // thread t sums (and clears) bin t of every warp
    for (int w = 0; w < kWarps; ++w) {
      sum += sub[w][threadIdx.x];
      sub[w][threadIdx.x] = 0;
    }
    hist[p][threadIdx.x] = sum;
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
  const unsigned u = prefix << (32 - bits);  // the float32 map's pattern
  const float tf = __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
  if (MASK) {
    T* dst = out + row * D + start;
    mask_pass<T>(STAGED ? stage : dst, dst, n, head, tf);
  }
  // No block leaves while another may still read its histograms.
  if (CLUSTER) cg::this_cluster().sync();
  if (rank == 0 && threadIdx.x == 0) t[row] = tf;
}

template <typename T, bool STAGED, bool CLUSTER, bool MASK>
cudaError_t launch_route(const T* x, float* t, T* out, long long R, int D, int k, const Plan& p,
                         cudaStream_t s) {
  auto kernel = radix_select_kernel<T, STAGED, CLUSTER, MASK>;
  const size_t smem = stage_bytes(p, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (!CLUSTER) {
    kernel<<<static_cast<unsigned>(R), kThreads, smem, s>>>(x, t, out, D, k, p.part);
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
  return cudaLaunchKernelEx(&cfg, kernel, x, t, out, D, k, p.part);
}

// t [R] = the k-th largest of each row of x [R, D] (1 <= k <= D); with MASK
// each row also rewritten in place (out == x) as (x > 0 && x >= t) ? x : +0.
template <typename T, bool MASK>
cudaError_t select_rows(const T* x, float* t, T* out, long long R, int D, int k,
                        cudaStream_t s) {
  const Plan p = plan(D, sizeof(T));
  if (R <= 0 || R * p.cluster > 0x7fffffffLL || D <= 0 || k < 1 || k > D)
    return cudaErrorInvalidValue;
  if (!p.staged) return launch_route<T, false, true, MASK>(x, t, out, R, D, k, p, s);
  if (p.cluster > 1) return launch_route<T, true, true, MASK>(x, t, out, R, D, k, p, s);
  return launch_route<T, true, false, MASK>(x, t, out, R, D, k, p, s);
}

}  // namespace rsel
