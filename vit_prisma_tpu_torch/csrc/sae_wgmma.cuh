// A persistent, warp-specialized bf16 GEMM for the SAE kernels on Hopper,
// on hopper_gemm.cuh's TMA loads, mbarriers and wgmma.  B4's encoder and
// decoder and B6's three products (sae_fused_tc.cu) run on it; it is
// written so that the other SAE kernels (B5, B8, B11, B12), which still run
// on sae_gemm.cuh's mma.sync tiles, can move onto it.  sm_90a only.
//
// A block computes 128 x 256 tiles of C = A B for one layer of an [L, ...]
// stack at a time: A [M, K] and B [K, N], each lying in device memory with
// either axis contiguous ("K-major": K contiguous; "MN-major": M or N
// contiguous), bf16 in, float32 accumulators.  Every form that the five SAE
// products need is one wgmma instruction, m64n256k16, with the operands'
// transpose bits set from their layouts:
//   hpre = xc W_enc, y = hc W_dec:   A K-major, B MN-major;
//   dh = dy W_dec^T:                 A K-major, B K-major (W_dec[s, d] is
//                                    B(k = d, n = s) with K contiguous);
//   dW_enc = xc^T dhc, dW_dec = hc^T dy: A MN-major (xc[b, d] is A(m = d,
//                                    k = b) with M contiguous), B MN-major.
//
// Roles.  Three warpgroups a block, one block an SM (the shared memory
// allows no second), launched once with as many blocks as the card has SMs
// (or tiles, if fewer); block b takes tiles b, b + grid, ... of a static
// schedule.  Warpgroup 2's first thread is the producer: it walks the same
// tiles and K steps as the consumers and keeps the ring of kStages stages
// full, one [128 x 64] A tile (16 KB) and one [64 x 256] B tile (32 KB) a
// stage, by TMA with 128-byte swizzle, each stage on a `full` mbarrier
// (expect-tx) and an `empty` one (one arrive a consumer warp).  Warpgroups
// 0 and 1 are the consumers, 64 rows of the tile each: four m64n256k16
// wgmmas a stage, one stage in flight while the next is issued, then the
// calling kernel's epilogue on the 128 float32 accumulators a thread.
// setmaxnreg gives the producer 40 registers and each consumer thread 232.
// The first product of a tile starts with scale-d 0, so the accumulators
// are never zeroed by hand (that, or a branch around the wgmmas, makes
// ptxas serialize them: PERF.md section 6).  The producer runs ahead into the
// next tile while the consumers run an epilogue.
//
// Stage layout (byte offsets from a 1024-aligned stage): A at 0, warpgroup
// w's 64 rows at w * 8192 in both layouts (K-major: one [64 K x 128 rows]
// box, row r at r * 128; MN-major: two [64 K rows x 64 M] boxes, M-chunk w
// at w * 8192); B at 16384 (MN-major: four [64 K rows x 64 N] boxes 8192
// bytes apart; K-major: one [64 K x 256 N rows] box, row n at n * 128).
// Descriptors: K-major tiles as hg::desc_a (a k16 step is 32 bytes along
// the swizzled row, SBO 1024), MN-major ones as hg::desc_b (a k16 step is
// 16 rows, 2048 bytes; LBO 8192 to the next 64 columns, SBO 1024).
//
// The accumulator of m64n256k16: d[4 j + e] of warp w of the warpgroup
// holds row 16 w + g + 8 (e / 2), column 8 j + 2 t + (e % 2), j < 32, with
// g = lane / 4 and t = lane % 4 (hopper_gemm.cuh).  Epilogues that write a
// bf16 C tile stage each warpgroup's [64 x 256] in four 128-byte swizzled
// [64 x 64] boxes (stage_off) and store them by TMA; column sums over the
// tile's 128 rows go through shared memory in a fixed order (col_partial,
// then one thread a column), so results are bitwise repeatable.
#pragma once

#include "hopper_gemm.cuh"
#include "sae_gemm.cuh"

namespace sw {

typedef __nv_bfloat16 bf16;

constexpr int kBM = 128;                          // block tile rows, 64 a consumer warpgroup
constexpr int kBN = 256;                          // block tile columns: mma256's N
constexpr int kBK = hg::kBox;                     // K a stage: one 128-byte swizzled row
constexpr int kConsumers = 2;                     // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer's warpgroup
constexpr int kABytes = kBM * kBK * 2;            // 16 KB
constexpr int kBBytes = kBN * kBK * 2;            // 32 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kOutBytes = 64 * kBN * 2;           // a warpgroup's bf16 C tile: 32 KB
constexpr int kRedFloats = 4 * kConsumers * kBN;  // one row of column partials a consumer warp
constexpr int kMaxSmem = 232448;                  // an H100 block's dynamic shared memory

enum Major { kKMajor = 0, kMNMajor = 1 };

// ---- host ---------------------------------------------------------------------

// An [L, rows, cols] bf16 tensor (cols contiguous) in boxes of [box_rows x 64].
inline cudaError_t map3(CUtensorMap* map, const void* p, int L, int rows, int cols,
                        int box_rows) {
  const uint64_t dims[3] = {static_cast<uint64_t>(cols), static_cast<uint64_t>(rows),
                            static_cast<uint64_t>(L)};
  const uint64_t strides[2] = {static_cast<uint64_t>(cols) * 2,
                               static_cast<uint64_t>(rows) * cols * 2};
  const uint32_t box[3] = {static_cast<uint32_t>(hg::kBox), static_cast<uint32_t>(box_rows), 1};
  return hg::make_map(map, p, 3, dims, strides, box);
}

// The tensor map of a GEMM operand lying as [L, rows, cols]: a K-major A
// ([M, K]) lands in [128 x 64] boxes, a K-major B ([N, K]) in [256 x 64]
// boxes, an MN-major operand ([K, M or N]) in [64 x 64] boxes.
inline cudaError_t operand_map(CUtensorMap* map, const void* p, int L, int rows, int cols,
                               int major, bool is_a) {
  return map3(map, p, L, rows, cols, major == kMNMajor ? hg::kBox : is_a ? kBM : kBN);
}

inline int sm_count(int device) {
  int n = 0;
  return cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) == cudaSuccess
             ? n
             : 0;
}

// ---- the tile schedule -----------------------------------------------------------

// One product's tiles: C [L, M, N] in [128 x 256] tiles, layer-major; within
// a layer, consecutive tiles walk the axis with fewer tiles first, so that
// the blocks running together share the operand panels of the other axis
// (and the first axis's whole operand stays in L2).
struct Grid {
  int tm, tn, L;
  bool m_fast;
};

inline Grid make_grid(int L, int M, int N) {
  Grid g;
  g.tm = M / kBM;
  g.tn = N / kBN;
  g.L = L;
  g.m_fast = g.tm < g.tn;
  return g;
}
inline int tiles(const Grid& g) { return g.L * g.tm * g.tn; }

struct Tile {
  int l, m0, n0, mt;
};

__device__ __forceinline__ Tile tile_at(const Grid& g, int t) {
  const int per = g.tm * g.tn, r = t % per;
  const int mt = g.m_fast ? r % g.tm : r / g.tn;
  const int nt = g.m_fast ? r / g.tm : r % g.tn;
  Tile x;
  x.l = t / per;
  x.m0 = mt * kBM;
  x.n0 = nt * kBN;
  x.mt = mt;
  return x;
}

// ---- device: wgmma m64n256k16 with the operands' transpose bits ------------------

// d[64 x 256] (+)= A[64 x 16] B[16 x 256]; TA, TB: 0 K-major, 1 MN-major;
// scale_d = 0 overwrites d.
template <int TA, int TB>
__device__ __forceinline__ void mma256(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int MAJOR>
__device__ __forceinline__ uint64_t desc(const unsigned char* tile, int kk) {
  const bf16* t = reinterpret_cast<const bf16*>(tile);
  return MAJOR == kKMajor ? hg::desc_a(t, kk) : hg::desc_b(t, kk);
}

// ---- device: the producer -------------------------------------------------------

// Stage `stage` of A rows [m0, m0 + 128) and B columns [n0, n0 + 256) over
// K [k0, k0 + 64) of layer l, completing on `bar`.
template <int AM, int BM>
__device__ __forceinline__ void load_stage(unsigned char* stage, const CUtensorMap* am,
                                           const CUtensorMap* bm, uint64_t* bar, int l, int m0,
                                           int n0, int k0) {
  hg::mbar_expect_tx(bar, kStageBytes);
  if (AM == kKMajor) {
    hg::tma_load_3d(stage, am, bar, k0, m0, l);
  } else {
#pragma unroll
    for (int i = 0; i < kBM / hg::kBox; ++i)
      hg::tma_load_3d(stage + i * hg::kBoxBytes, am, bar, m0 + i * hg::kBox, k0, l);
  }
  unsigned char* b = stage + kABytes;
  if (BM == kKMajor) {
    hg::tma_load_3d(b, bm, bar, k0, n0, l);
  } else {
#pragma unroll
    for (int i = 0; i < kBN / hg::kBox; ++i)
      hg::tma_load_3d(b + i * hg::kBoxBytes, bm, bar, n0 + i * hg::kBox, k0, l);
  }
}

// The ring's position: `it` counts the stages used since the kernel began,
// in the same order on the producer and the consumers.
template <int STAGES>
struct Ring {
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;
  __device__ __forceinline__ unsigned char* stage(uint32_t it) const {
    return base + (it % STAGES) * kStageBytes;
  }
};

// The producer's K loop of one tile.
template <int STAGES, int AM, int BM>
__device__ __forceinline__ void produce_tile(const Ring<STAGES>& ring, uint32_t& it,
                                             const CUtensorMap* am, const CUtensorMap* bm,
                                             int ktiles, int l, int m0, int n0) {
  for (int kt = 0; kt < ktiles; ++kt, ++it) {
    const uint32_t st = it % STAGES, round = it / STAGES;
    if (round > 0) hg::mbar_wait(&ring.empty[st], (round - 1) & 1);
    load_stage<AM, BM>(ring.stage(it), am, bm, &ring.full[st], l, m0, n0, kt * kBK);
  }
}

// ---- device: the consumers -------------------------------------------------------

// acc = A B over one tile's ktiles stages, for consumer warpgroup wg (its 64
// rows).  Each consumer warp releases a stage once the products that read
// it are done; ends with every product done and every stage released.
template <int STAGES, int AM, int BM>
__device__ __forceinline__ void consume_tile(float (&acc)[kBN / 2], const Ring<STAGES>& ring,
                                             uint32_t& it, int ktiles, int wg, int lane) {
  for (int kt = 0; kt < ktiles; ++kt, ++it) {
    const uint32_t st = it % STAGES;
    hg::mbar_wait(&ring.full[st], (it / STAGES) & 1);
    const unsigned char* stage = ring.stage(it);
    const unsigned char* a = stage + wg * hg::kBoxBytes;
    const unsigned char* b = stage + kABytes;
    hg::fence_acc(acc);
    hg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      mma256<AM, BM>(acc, desc<AM>(a, kk), desc<BM>(b, kk), kt > 0 || kk > 0);
    hg::wgmma_commit();
    hg::wgmma_wait<1>();  // the previous stage's products are done
    hg::fence_acc(acc);
    if (kt > 0 && lane == 0) hg::mbar_arrive(&ring.empty[(it - 1) % STAGES]);
  }
  hg::wgmma_wait<0>();
  hg::fence_acc(acc);
  if (lane == 0) hg::mbar_arrive(&ring.empty[(it - 1) % STAGES]);
}

// ---- device: epilogue pieces ------------------------------------------------------

// Byte offset, in a warpgroup's staged [64 x 256] bf16 C tile, of the
// column pair (8 j + 2 t, + 1) of row r (four swizzled [64 x 64] boxes).
__device__ __forceinline__ int stage_off(int r, int j, int t) {
  return (j >> 3) * hg::kBoxBytes + hg::sw128(r, j & 7) + 4 * t;
}

// A consumer warp's column partials v0, v1 (columns 8 j + 2 t, + 1, over
// the thread's two rows) summed over the warp's 16 rows, into its row of
// `red` (kBN floats).
__device__ __forceinline__ void col_partial(float v0, float v1, float* red_row, int j,
                                            int lane) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    v0 += __shfl_xor_sync(0xffffffffu, v0, o);
    v1 += __shfl_xor_sync(0xffffffffu, v1, o);
  }
  if (lane < 4) *reinterpret_cast<float2*>(red_row + 8 * j + 2 * lane) = make_float2(v0, v1);
}

// After every consumer warp wrote its row of `red` and met the others:
// consumer thread c (0 .. 255) writes out[c] = the sum of column c over the
// eight warps' rows, in warp order, for the tile's kBN columns.
__device__ __forceinline__ void col_sums(const float* red, float* out, int c) {
  if (c >= kBN) return;
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < 4 * kConsumers; ++w) s += red[w * kBN + c];
  out[c] = s;
}

// xc = x - b_dec[l] over [L, B, D] bf16 (D % 8 == 0, 16-byte aligned), one
// rounding as PyTorch subtracts (sae::center's result), 16 bytes a thread.
static __global__ void center16_kernel(const uint4* __restrict__ x, const bf16* __restrict__ bd,
                                uint4* __restrict__ xc, long long n16, int d16,
                                long long per_layer16) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n16;
       i += stride) {
    const long long l = i / per_layer16;
    const int d = static_cast<int>(i % d16);
    uint4 v = x[i];
    const uint4 b = reinterpret_cast<const uint4*>(bd)[l * d16 + d];
    __nv_bfloat162* pv = reinterpret_cast<__nv_bfloat162*>(&v);
    const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 a = __bfloat1622float2(pv[k]), c = __bfloat1622float2(pb[k]);
      pv[k] = __floats2bfloat162_rn(__fsub_rn(a.x, c.x), __fsub_rn(a.y, c.y));
    }
    xc[i] = v;
  }
}

inline cudaError_t center16(const bf16* x, const bf16* bd, bf16* xc, int L, int B, int D,
                            cudaStream_t s) {
  const long long per_layer16 = static_cast<long long>(B) * D / 8, n16 = per_layer16 * L;
  long long blocks = (n16 + 255) / 256;
  if (blocks > (1 << 20)) blocks = 1 << 20;
  center16_kernel<<<static_cast<unsigned int>(blocks), 256, 0, s>>>(
      reinterpret_cast<const uint4*>(x), bd, reinterpret_cast<uint4*>(xc), n16, D / 8,
      per_layer16);
  return cudaGetLastError();
}

// The barrier over both consumer warpgroups (ids 1 and 2 are theirs alone).
__device__ __forceinline__ void consumers_sync() { hg::named_sync(3, 128 * kConsumers); }

__device__ __forceinline__ unsigned char* aligned_base(unsigned char* raw) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + hg::kSwizzleAlign - 1) &
      ~static_cast<uintptr_t>(hg::kSwizzleAlign - 1));
}

}  // namespace sw
