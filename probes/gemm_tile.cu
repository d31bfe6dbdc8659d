// One [128 x 256] bf16 GEMM tile through hopper_gemm.cuh alone: TMA into a
// 4-stage ring of 128-byte swizzled tiles on mbarriers, a producer warp,
// two consumer warpgroups issuing wgmma m64n256k16 with A K-major and B
// MN-major, float32 out.  Built and checked by probes/gemm_tile.py.
#include "hopper_gemm.cuh"

namespace {

constexpr int kStages = 4, kBK = 64, kBN = 256, kBM = 128;
constexpr int kABytes = kBM * kBK * 2;
constexpr int kStage = kABytes + 4 * hg::kBoxBytes;
constexpr int kBytes = kStages * kStage + 2 * kStages * 8 + hg::kSwizzleAlign;

__global__ void __launch_bounds__(384, 1)
    tile_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
                float* out, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + hg::kSwizzleAlign - 1) &
      ~static_cast<uintptr_t>(hg::kSwizzleAlign - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStage);
  uint64_t* empty = full + kStages;
  const int ktiles = K / kBK, wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      hg::mbar_init(&full[i], 1);
      hg::mbar_init(&empty[i], 8);
    }
    hg::fence_barrier_init();
  }
  __syncthreads();
  if (wg == 2) {
    hg::reg_dealloc<40>();
    if (threadIdx.x == 256) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int st = kt % kStages, round = kt / kStages;
        if (round > 0) hg::mbar_wait(&empty[st], (round - 1) & 1);
        unsigned char* s = smem + st * kStage;
        hg::mbar_expect_tx(&full[st], kStage);
        hg::tma_load_2d(s, &amap, &full[st], kt * kBK, 0);
        for (int i = 0; i < 4; ++i)
          hg::tma_load_2d(s + kABytes + i * hg::kBoxBytes, &bmap, &full[st], i * 64, kt * kBK);
      }
    }
  } else {
    hg::reg_alloc<232>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t & 31;
    float acc[128];
    for (int kt = 0; kt < ktiles; ++kt) {
      const int st = kt % kStages;
      hg::mbar_wait(&full[st], (kt / kStages) & 1);
      unsigned char* s = smem + st * kStage;
      const __nv_bfloat16* As = reinterpret_cast<const __nv_bfloat16*>(s) + 64 * wg * kBK;
      const __nv_bfloat16* Bs = reinterpret_cast<const __nv_bfloat16*>(s + kABytes);
      hg::fence_acc(acc);
      hg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hg::mma_ss<256>(acc, hg::desc_a(As, kk), hg::desc_b(Bs, kk), kt > 0 || kk > 0);
      hg::wgmma_commit();
      hg::wgmma_wait<1>();
      hg::fence_acc(acc);
      if (kt > 0 && lane == 0) hg::mbar_arrive(&empty[(kt - 1) % kStages]);
    }
    hg::wgmma_wait<0>();
    hg::fence_acc(acc);
    const int g = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int j = 0; j < 32; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        out[(64 * wg + 16 * warp + g + 8 * (e / 2)) * kBN + 8 * j + 2 * tq + (e % 2)] =
            acc[4 * j + e];
  }
}

}  // namespace

// A [128, K] and B [K, 256] bf16 (K a multiple of 64), out [128, 256] float32.
extern "C" int gemm_tile(const void* A, const void* B, void* out, int K) {
  CUtensorMap amap, bmap;
  const uint64_t ad[2] = {static_cast<uint64_t>(K), kBM}, as[1] = {static_cast<uint64_t>(K) * 2};
  const uint32_t ab[2] = {64, kBM};
  cudaError_t err = hg::make_map(&amap, A, 2, ad, as, ab);
  if (err != cudaSuccess) return err;
  const uint64_t bd[2] = {kBN, static_cast<uint64_t>(K)}, bs[1] = {kBN * 2};
  const uint32_t bb[2] = {64, 64};
  if ((err = hg::make_map(&bmap, B, 2, bd, bs, bb)) != cudaSuccess) return err;
  err = cudaFuncSetAttribute(tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return err;
  tile_kernel<<<1, 384, kBytes>>>(amap, bmap, static_cast<float*>(out), K);
  return cudaGetLastError();
}
