// 3xTF32: float32 products on the tensor cores with mma.sync, shared by
// the attention mix's float32 route (mix_tf32.cuh: B1 and B15; B2's f32tc
// in attention_mix_tnh_bwd.cu) and B13's (flash_attention_fwd.cu,
// flash_attention_bwd.cu, namespace f32tc in each).
//
// mma.sync m16n8k8 multiplies TF32 operands (10 explicit mantissa bits)
// with float32 accumulation, so plain TF32 would round float32 inputs to
// 2^-11.  Each operand x is split as
//   hi = x rounded to TF32,  lo = (x - hi) rounded to TF32
// (to nearest, ties away from zero, as cvt.rna.tf32.f32 rounds; x - hi is
// exact), and each product a b is formed as
//   a_lo b_hi + a_hi b_lo + a_hi b_hi
// with float32 accumulation (the small terms first, and in the score
// products summed apart from the large ones: mma3); the dropped a_lo b_lo
// and the two roundings leave about 2^-21 of |a b|, the order of a float32
// FFMA chain's own rounding.
//
// Fragments (a warp's tile in the m16n8 layouts, g = lane / 4, t = lane % 4):
// an A fragment holds rows g, g + 8 at columns t, t + 4 of an 8-wide k-step;
// an accumulator holds columns 2t, 2t + 1 of rows g, g + 8.  nt_chunk forms
// a [16 x 8 NJ] product of A rows against rows of a staged operand (B
// fragments by ldmatrix); pn_chunk feeds accumulators (p, ds) back as A with
// the k index permuted (acc_as_a) and reads the staged operand's rows in the
// same permutation, so no shuffles are needed.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "sae_gemm.cuh"  // sae::smem_u32

namespace mix {
namespace tf32 {

constexpr int kRows = 16;  // rows (or keys) of a warp's tile
constexpr int kStep = 8;   // keys of one mma k- or n-step

// x = hi + lo as the two TF32 operands of 3xTF32, each x's TF32 rounding to
// nearest with ties away from zero (cvt.rna.tf32.f32's): adding half of the
// 13 dropped bits' range to the magnitude, whose low 13 bits the mma then
// drops, rounds as cvt.rna does (hi is masked where x - hi is formed, which
// is exact).  Four integer and float instructions on the full-rate pipes
// (with cvt.rna.tf32.f32 the kernels ran 15-20% slower).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) + 0x1000u;
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u)) + 0x1000u;
}

// split() as one asm volatile block, which the compiler keeps where it
// stands: the split of a loop-invariant raw operand (a warp's held q, or
// B2's q, dz, k, v) would otherwise be hoisted out of the chunk loop, which
// doubles that operand's registers (and spilled past H 64).
__device__ __forceinline__ void split_kept(float x, uint32_t& hi, uint32_t& lo) {
  asm volatile(
      "{\n\t.reg .b32 m, d;\n\t.reg .f32 mf, r;\n\t"
      "add.u32 %0, %2, 4096;\n\t"
      "and.b32 m, %0, 0xFFFFE000;\n\t"
      "mov.b32 mf, m;\n\t"
      "sub.rn.f32 r, %3, mf;\n\t"
      "mov.b32 d, r;\n\t"
      "add.u32 %1, d, 4096;\n\t}"
      : "=r"(hi), "=r"(lo)
      : "r"(__float_as_uint(x)), "f"(x));
}

// An A fragment split: a = hi + lo.
struct Frag {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ void split4(Frag& f, const float (&x)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split(x[e], f.hi[e], f.lo[e]);
}

// An accumulator fragment (columns 2t, 2t + 1 of rows g, g + 8) as the A
// fragment of the permuted k-step: k = t is column 2t, k = t + 4 column 2t + 1.
__device__ __forceinline__ void acc_as_a(Frag& f, const float (&c)[4]) {
  split(c[0], f.hi[0], f.lo[0]);
  split(c[2], f.hi[1], f.lo[1]);
  split(c[1], f.hi[2], f.lo[2]);
  split(c[3], f.hi[3], f.lo[3]);
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[j] += a b[j] in 3xTF32 for N accumulators, b[j] given as (hi, lo) of its
// two registers: each of the three products across all N before the next, so
// that consecutive mma.sync instructions are independent (one accumulator's
// chain of products would wait out each one's latency).  The two small
// products go to ds[j] (a_lo b_hi, then a_hi b_lo with kALoFirst, else a_hi
// b_lo, then a_lo b_hi), the large one to d[j]: the tensor cores' float32
// accumulation truncates at each product, so a sum of k-steps kept whole in
// one accumulator would take three truncations a k-step at its full
// magnitude.  The columns pass of B2 forms s^T = K Q^T with the keys as A:
// the second order puts its products in the rows pass's order (q_lo k_hi
// first), so both passes compute each score bit for bit alike.
template <bool kALoFirst, int N>
__device__ __forceinline__ void mma3(float (&d)[N][4], float (&ds)[N][4], const Frag& a,
                                     const uint32_t (&bh)[N][2], const uint32_t (&bl)[N][2]) {
  if constexpr (kALoFirst) {
#pragma unroll
    for (int j = 0; j < N; ++j) mma(ds[j], a.lo, bh[j][0], bh[j][1]);
#pragma unroll
    for (int j = 0; j < N; ++j) mma(ds[j], a.hi, bl[j][0], bl[j][1]);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) mma(ds[j], a.hi, bl[j][0], bl[j][1]);
#pragma unroll
    for (int j = 0; j < N; ++j) mma(ds[j], a.lo, bh[j][0], bh[j][1]);
  }
#pragma unroll
  for (int j = 0; j < N; ++j) mma(d[j], a.hi, bh[j][0], bh[j][1]);
}

// ---- fragments ---------------------------------------------------------------

// The raw A fragments of rows [row0, row0 + R) of one head (row r at p + r *
// ts), R = 16 or 8: a[kk] = (row g, col 8 kk + t), (g + 8, 8 kk + t), (g, 8
// kk + t + 4), (g + 8, 8 kk + t + 4); zero past the tokens, the head and R
// (with R = 8 rows g + 8 are zero constants: half the registers).
template <int HP, int R = kRows>
__device__ __forceinline__ void load_a(float (&a)[HP / 8][4], const float* __restrict__ p,
                                       long long ts, int row0, int n_tok, int d_head) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool in0 = row0 + g < n_tok, in1 = R == kRows && row0 + g + 8 < n_tok;
  const float* r0 = p + (long long)(row0 + g) * ts;
  const float* r1 = r0 + 8 * ts;
#pragma unroll
  for (int kk = 0; kk < HP / 8; ++kk) {
    const int c0 = 8 * kk + t, c1 = c0 + 4;
    a[kk][0] = in0 && c0 < d_head ? __ldg(r0 + c0) : 0.f;
    a[kk][1] = in1 && c0 < d_head ? __ldg(r1 + c0) : 0.f;
    a[kk][2] = in0 && c1 < d_head ? __ldg(r0 + c1) : 0.f;
    a[kk][3] = in1 && c1 < d_head ? __ldg(r1 + c1) : 0.f;
  }
}

// An A fragment as nt_chunk takes it: raw (split here; kKept: by
// split_kept) or already split.
template <bool kKept>
__device__ __forceinline__ Frag as_frag(const float (&x)[4]) {
  Frag f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (kKept)
      split_kept(x[e], f.hi[e], f.lo[e]);
    else
      split(x[e], f.hi[e], f.lo[e]);
  }
  return f;
}
template <bool kKept>
__device__ __forceinline__ const Frag& as_frag(const Frag& f) { return f; }

// A warp's 16 rows of an A operand staged in shared memory (row r at p + r
// S), read a k-step at a time by one ldmatrix x4 and split.
struct Staged {
  const float* p;
  int S;
};

// The A fragment of k-step kk: from an array of fragments (as_frag) or from
// staged rows.
template <bool kKept, typename F, int N>
__device__ __forceinline__ decltype(auto) a_frag(const F (&a)[N], int kk) {
  return as_frag<kKept>(a[kk]);
}
template <bool kKept>
__device__ __forceinline__ Frag a_frag(const Staged& a, int kk) {
  const int lane = threadIdx.x & 31;
  uint32_t r[4];
  sae::ldsm_x4(r, a.p + (lane & 15) * a.S + 8 * kk + 4 * (lane >> 4));
  Frag f;
#pragma unroll
  for (int e = 0; e < 4; ++e) split(__uint_as_float(r[e]), f.hi[e], f.lo[e]);
  return f;
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(sae::smem_u32(p)));
}

// c[j] = a X^T for the NJ 8-row steps of the staged operand X from row x0
// (rows of S floats): k-steps in order, each as mma3<kALoFirst>, the small
// products summed apart and added at the end; X's B fragments by ldmatrix
// (rows x0 + 8 j + lane % 8, one k-step a load: two held at once cost the
// registers the 12-warp tuning lacks), split in registers.  a: HP / 8 raw
// float fragments (float[4]; kKept: split with split_kept), split ones
// (Frag), or Staged rows.
template <int HP, int NJ, bool kALoFirst, bool kKept = false, typename A>
__device__ __forceinline__ void nt_chunk(float (&c)[NJ][4], const A& a, const float* X, int S,
                                         int x0) {
  const int lane = threadIdx.x & 31;
  float cs[NJ][4];  // the small products (mma3)
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = cs[j][e] = 0.f;
  const float* Xl = X + (x0 + (lane & 7)) * S + 4 * ((lane >> 3) & 1);
#pragma unroll
  for (int kk = 0; kk < HP / 8; ++kk) {
    uint32_t h[NJ][2], l[NJ][2];  // B fragments of k-step kk for every step j
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      uint32_t r[2];
      ldsm_x2(r, Xl + 8 * j * S + 8 * kk);
#pragma unroll
      for (int e = 0; e < 2; ++e) split(__uint_as_float(r[e]), h[j][e], l[j][e]);
    }
    mma3<kALoFirst>(c, cs, a_frag<kKept>(a, kk), h, l);
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] += cs[j][e];
}

// The 8-column steps of a group: the largest divisor of NC up to max_group.
__host__ __device__ constexpr int col_group(int nc, int max_group = 8) {
  int d = nc < max_group ? nc : max_group;
  while (nc % d) --d;
  return d;
}

// acc[n] += P X for the 8 columns from c0 + 8 n, over one chunk of NJ 8-key
// steps: p[j] an accumulator fragment of step j (keys k0 + 8 j.. as
// columns), X's rows read with acc_as_a's permutation: b0 = X[k0 + 8 j +
// 2t][c0 + 8n + g], b1 = X[k0 + 8 j + 2t + 1][c0 + 8n + g], in groups of up
// to kMaxGroup 8-column steps (registers: their accumulators and B
// fragments).  The tensor cores' float32 accumulation drops the bits below
// the accumulator's last place (it truncates), so adding a long key loop's
// steps into acc would bias it by about an ulp of |acc| a step (6e-6 of |z|
// over T 257): each chunk is summed from zero on the tensor cores, all
// three products in one accumulator, and added to acc in FADDs, which round
// to nearest.

template <int NC, int NJ, int kMaxGroup = 8>
__device__ __forceinline__ void pn_chunk(float (&acc)[NC][4], const float (&p)[NJ][4],
                                         const float* X, int S, int k0, int c0) {
  constexpr int NG = col_group(NC, kMaxGroup);
  static_assert(NC % NG == 0, "column groups must tile the columns");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  Frag pa[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc_as_a(pa[j], p[j]);
  const float* x = X + (k0 + 2 * t) * S + c0 + g;
#pragma unroll
  for (int n0 = 0; n0 < NC; n0 += NG) {
    float c[NG][4];
#pragma unroll
    for (int n = 0; n < NG; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      uint32_t h[NG][2], l[NG][2];
#pragma unroll
      for (int n = 0; n < NG; ++n) {
        const float* xn = x + 8 * j * S + 8 * (n0 + n);
        split(xn[0], h[n][0], l[n][0]);
        split(xn[S], h[n][1], l[n][1]);
      }
      mma3<true>(c, c, pa[j], h, l);
    }
#pragma unroll
    for (int n = 0; n < NG; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n0 + n][e] += c[n][e];
  }
}

}  // namespace tf32
}  // namespace mix
