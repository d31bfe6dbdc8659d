// A persistent, warp-specialized bf16 GEMM for the SAE kernels on Hopper,
// on hopper_gemm.cuh's TMA loads, mbarriers and wgmma.  B4's encoder and
// decoder, B6's three products, B5's four, B8's two and B9's four, and
// B11's and B12's gated products (sae_fused_tc.cu) run on it.  sm_90a
// only.
//
// A block computes 128 x 256 tiles of C = A B for one layer of an [L, ...]
// stack at a time (128 x 192 for B11's decoder where those fill the waves
// better, 128 x 128 for B12's dg tile, below): A [M, K] and B [K, N], each
// lying in device memory with either axis contiguous ("K-major": K
// contiguous; "MN-major": M or N contiguous), bf16 in, float32
// accumulators.  Every form that the SAE products need is one wgmma
// instruction, m64n256k16 (m64n192k16, m64n128k16), with the operands'
// transpose bits set from their layouts:
//   hpre = xc W_enc, y = hc W_dec:   A K-major, B MN-major;
//   dh = dy W_dec^T:                 A K-major, B K-major (W_dec[s, d] is
//                                    B(k = d, n = s) with K contiguous);
//   dW_enc = xc^T dhc, dW_dec = hc^T dy: A MN-major (xc[b, d] is A(m = d,
//                                    k = b) with M contiguous), B MN-major.
// B12's dg tile computes two products on one B tile, dy W_dec^T and
// dvia W_dec^T, into two accumulators: 128 x 128 tiles, m64n128k16 (mma128),
// as two m64n256 accumulators would not fit a thread's registers.
//
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
constexpr int kDgStageBytes = 3 * kABytes;        // B12's dg stage: dy, dvia, W_dec tiles
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
  int tm, tn, L, bn;  // bn: the tile's columns, kBN (or 128: B12's dg tiles)
  bool m_fast;
};

inline Grid make_grid(int L, int M, int N, int bn = kBN) {
  Grid g;
  g.tm = M / kBM;
  g.tn = N / bn;
  g.L = L;
  g.bn = bn;
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
  x.n0 = nt * g.bn;
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

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], as mma256.
template <int TA, int TB>
__device__ __forceinline__ void mma128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d[64 x 192] (+)= A[64 x 16] B[16 x 192], as mma256.
template <int TA, int TB>
__device__ __forceinline__ void mma192(float (&d)[96], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
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
      "%88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, %99, %100;\n}\n"
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
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int MAJOR>
__device__ __forceinline__ uint64_t desc(const unsigned char* tile, int kk) {
  const bf16* t = reinterpret_cast<const bf16*>(tile);
  return MAJOR == kKMajor ? hg::desc_a(t, kk) : hg::desc_b(t, kk);
}

// ---- device: the producer -------------------------------------------------------

// Bytes of a stage whose B tile is BN columns wide.
template <int BN>
__host__ __device__ constexpr int stage_bytes() { return kABytes + BN * kBK * 2; }

// Stage `stage` of A rows [m0, m0 + 128) over K [ka, ka + 64) and B columns
// [n0, n0 + BN) over K [kb, kb + 64) of layer l, completing on `bar`.
template <int AM, int BM, int BN = kBN>
__device__ __forceinline__ void load_stage(unsigned char* stage, const CUtensorMap* am,
                                           const CUtensorMap* bm, uint64_t* bar, int l, int m0,
                                           int n0, int ka, int kb) {
  hg::mbar_expect_tx(bar, stage_bytes<BN>());
  if (AM == kKMajor) {
    hg::tma_load_3d(stage, am, bar, ka, m0, l);
  } else {
#pragma unroll
    for (int i = 0; i < kBM / hg::kBox; ++i)
      hg::tma_load_3d(stage + i * hg::kBoxBytes, am, bar, m0 + i * hg::kBox, ka, l);
  }
  unsigned char* b = stage + kABytes;
  if (BM == kKMajor) {
    hg::tma_load_3d(b, bm, bar, kb, n0, l);
  } else {
#pragma unroll
    for (int i = 0; i < BN / hg::kBox; ++i)
      hg::tma_load_3d(b + i * hg::kBoxBytes, bm, bar, n0 + i * hg::kBox, kb, l);
  }
}

// The ring's position: `it` counts the stages used since the kernel began,
// in the same order on the producer and the consumers.
template <int STAGES, int STAGE_BYTES = kStageBytes>
struct Ring {
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;
  __device__ __forceinline__ unsigned char* stage(uint32_t it) const {
    return base + (it % STAGES) * STAGE_BYTES;
  }
};

// The producer's K loop of one tile.  B's K steps from kswitch on come
// from bm2, from its K row 0 (B12's dW_dec: [dy; dvia] stacked along K);
// kswitch = ktiles reads bm alone.
template <int STAGES, int AM, int BM, int BN = kBN>
__device__ __forceinline__ void produce_tile(const Ring<STAGES, stage_bytes<BN>()>& ring,
                                             uint32_t& it, const CUtensorMap* am,
                                             const CUtensorMap* bm, const CUtensorMap* bm2,
                                             int kswitch, int ktiles, int l, int m0, int n0) {
  for (int kt = 0; kt < ktiles; ++kt, ++it) {
    const uint32_t st = it % STAGES, round = it / STAGES;
    if (round > 0) hg::mbar_wait(&ring.empty[st], (round - 1) & 1);
    const bool lo = kt < kswitch;
    load_stage<AM, BM, BN>(ring.stage(it), am, lo ? bm : bm2, &ring.full[st], l, m0, n0,
                           kt * kBK, (lo ? kt : kt - kswitch) * kBK);
  }
}

// B12's dg stage: dy and dvia rows [m0, m0 + 128) and W_dec rows [n0, n0 +
// 128), all K-major [128 x 64] boxes over K [k0, k0 + 64): dy at 0, dvia at
// kABytes, W_dec at 2 kABytes.  K steps [kt0, kt1) of the tile.
template <int STAGES>
__device__ __forceinline__ void produce_tile_dg(const Ring<STAGES, kDgStageBytes>& ring,
                                                uint32_t& it, const CUtensorMap* dy,
                                                const CUtensorMap* dvia, const CUtensorMap* wd,
                                                int kt0, int kt1, int l, int m0, int n0) {
  for (int kt = kt0; kt < kt1; ++kt, ++it) {
    const uint32_t st = it % STAGES, round = it / STAGES;
    if (round > 0) hg::mbar_wait(&ring.empty[st], (round - 1) & 1);
    unsigned char* stage = ring.stage(it);
    uint64_t* bar = &ring.full[st];
    hg::mbar_expect_tx(bar, kDgStageBytes);
    hg::tma_load_3d(stage, dy, bar, kt * kBK, m0, l);
    hg::tma_load_3d(stage + kABytes, dvia, bar, kt * kBK, m0, l);
    hg::tma_load_3d(stage + 2 * kABytes, wd, bar, kt * kBK, n0, l);
  }
}

// ---- device: the consumers -------------------------------------------------------

// acc = A B over one tile's ktiles stages, for consumer warpgroup wg (its 64
// rows; BN columns: 256, or 192 for B11's decoder).  Each consumer warp
// releases a stage once the products that read it are done; ends with
// every product done and every stage released.
template <int STAGES, int AM, int BM, int BN = kBN>
__device__ __forceinline__ void consume_tile(float (&acc)[BN / 2],
                                             const Ring<STAGES, stage_bytes<BN>()>& ring,
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
    for (int kk = 0; kk < kBK / 16; ++kk) {
      if constexpr (BN == kBN)
        mma256<AM, BM>(acc, desc<AM>(a, kk), desc<BM>(b, kk), kt > 0 || kk > 0);
      else
        mma192<AM, BM>(acc, desc<AM>(a, kk), desc<BM>(b, kk), kt > 0 || kk > 0);
    }
    hg::wgmma_commit();
    hg::wgmma_wait<1>();  // the previous stage's products are done
    hg::fence_acc(acc);
    if (kt > 0 && lane == 0) hg::mbar_arrive(&ring.empty[(it - 1) % STAGES]);
  }
  hg::wgmma_wait<0>();
  hg::fence_acc(acc);
  if (lane == 0) hg::mbar_arrive(&ring.empty[(it - 1) % STAGES]);
}

// B12's dg tile: ady = dy W_dec^T and adv = dvia W_dec^T over one tile's
// ktiles stages (the stages of produce_tile_dg), for consumer warpgroup wg.
template <int STAGES>
__device__ __forceinline__ void consume_tile_dg(float (&ady)[64], float (&adv)[64],
                                                const Ring<STAGES, kDgStageBytes>& ring,
                                                uint32_t& it, int ktiles, int wg, int lane) {
  for (int kt = 0; kt < ktiles; ++kt, ++it) {
    const uint32_t st = it % STAGES;
    hg::mbar_wait(&ring.full[st], (it / STAGES) & 1);
    const unsigned char* stage = ring.stage(it);
    const unsigned char* ay = stage + wg * hg::kBoxBytes;
    const unsigned char* av = stage + kABytes + wg * hg::kBoxBytes;
    const unsigned char* b = stage + 2 * kABytes;
    hg::fence_acc(ady);
    hg::fence_acc(adv);
    hg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t db = desc<kKMajor>(b, kk);
      mma128<kKMajor, kKMajor>(ady, desc<kKMajor>(ay, kk), db, kt > 0 || kk > 0);
      mma128<kKMajor, kKMajor>(adv, desc<kKMajor>(av, kk), db, kt > 0 || kk > 0);
    }
    hg::wgmma_commit();
    hg::wgmma_wait<1>();
    hg::fence_acc(ady);
    hg::fence_acc(adv);
    if (kt > 0 && lane == 0) hg::mbar_arrive(&ring.empty[(it - 1) % STAGES]);
  }
  hg::wgmma_wait<0>();
  hg::fence_acc(ady);
  hg::fence_acc(adv);
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

// Every committed bulk store group but the newest N has read its shared
// memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read_but() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// The barrier over both consumer warpgroups (ids 1 and 2 are theirs alone).
__device__ __forceinline__ void consumers_sync() { hg::named_sync(3, 128 * kConsumers); }

__device__ __forceinline__ unsigned char* aligned_base(unsigned char* raw) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + hg::kSwizzleAlign - 1) &
      ~static_cast<uintptr_t>(hg::kSwizzleAlign - 1));
}

}  // namespace sw
