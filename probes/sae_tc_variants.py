"""Write the versions of B4/B6's bf16 Hopper kernels that PERF.md measures
against the package's, each a directory under the gitignored
``vit_prisma_tpu_torch/csrc/build/`` holding an edited copy of
``csrc/sae_fused_tc.cu`` (and, where the header changes, of
``csrc/sae_wgmma.cuh``, which the copy then includes in place of the
package's):

* ``v_shuffle``: the encoder counts nact by shuffle sums over each column's
  rows (the first version) instead of ballots;
* ``v_noreduce``: the encoder skips nact and l1 (wrong counts: a bound on
  what the reductions cost);
* ``v_bn128``: 128-wide block tiles (``kBN = 128``: the header's
  m64n128k16, ``mma128``) for every product.

and of B11's and B12's gated modes:

* ``g_dec256``: B11's decoder on 256-wide tiles (as B4's), where the
  package's takes 192-wide ones at the gated slice;
* ``g_cvt2``: the gated epilogues rounding hg and hm two columns a
  conversion and masking the rounded pairs' bits for h and hga, where the
  package's round one value a conversion (and h, hga, dg again for their
  stores);
* ``g_two_pass``: the gated encoders' first epilogue: all of c(h) staged
  and stored by TMA, a wait until the store has read the staging buffer,
  then all of c(hga) (hg recomputed) in the same buffer;
* ``g_dg_nopart``: the dg epilogue takes no column partials (wrong sums: a
  bound on what the three reductions cost).

and of B8's:

* ``t_dec256``: B8's decoder on 256-wide tiles (96 of them at the TopK
  slice), where the package's takes 192-wide ones (128).
* ``t_sparse_dec``: B8's decoder over each row's active set alone, y =
  b_dec + sum of h[j] W_dec[j, :] over the row's nonzero h (about k of
  d_sae), one block a row (d_in / 2 threads, a column pair each), the
  row's nonzeros compacted into shared memory in index order a chunk at a
  time, W_dec's rows read through L2; in place of the dense decoder GEMM.

Prints the sources written.  Then, on a CUDA card:
``python3 probes/sae_tc_versions.py [--only relu|gated|remat|topk]
<dir>/sae_fused_tc.cu ...``."""

from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "vit_prisma_tpu_torch" / "csrc"

BALLOT = """          const unsigned same_col = 0x11111111u << tq;
          int c0 = 0, c1 = 0;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float p0 = acc[4 * j + 2 * h] + b.x, p1 = acc[4 * j + 2 * h + 1] + b.y;
            const float h0 = p0 > 0.f ? p0 : 0.f, h1 = p1 > 0.f ? p1 : 0.f;
            c0 += __popc(__ballot_sync(0xffffffffu, p0 > 0.f) & same_col);
            c1 += __popc(__ballot_sync(0xffffffffu, p1 > 0.f) & same_col);
            l1 += h0 + h1;
            sae::store2(reinterpret_cast<bf16*>(stg + stage_off(16 * warp + g + 8 * h, j, tq)),
                        h0, h1);
          }
          if (lane < 4)
            *reinterpret_cast<float2*>(red + cw * kBN + 8 * j + 2 * lane) =
                make_float2(static_cast<float>(c0), static_cast<float>(c1));"""

SHUFFLE = """          float c0 = 0.f, c1 = 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float p0 = acc[4 * j + 2 * h] + b.x, p1 = acc[4 * j + 2 * h + 1] + b.y;
            const float h0 = p0 > 0.f ? p0 : 0.f, h1 = p1 > 0.f ? p1 : 0.f;
            c0 += p0 > 0.f ? 1.f : 0.f;
            c1 += p1 > 0.f ? 1.f : 0.f;
            l1 += h0 + h1;
            sae::store2(reinterpret_cast<bf16*>(stg + stage_off(16 * warp + g + 8 * h, j, tq)),
                        h0, h1);
          }
          col_partial(c0, c1, red + cw * kBN, j, lane);"""

NOREDUCE = """#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float p0 = acc[4 * j + 2 * h] + b.x, p1 = acc[4 * j + 2 * h + 1] + b.y;
            sae::store2(reinterpret_cast<bf16*>(stg + stage_off(16 * warp + g + 8 * h, j, tq)),
                        p0 > 0.f ? p0 : 0.f, p1 > 0.f ? p1 : 0.f);
          }"""

# B11's and B12's epilogues: the package's (one chunked pass, hg and hm
# rounded to bf16 one value a conversion) and other versions' pieces (hg
# and hm rounded two columns a conversion, the rounded pairs' bits masked
# for h and hga; two passes)
HELPERS = """// The gated pre-activations from the float32 product g, rounded to bf16 as
// `_gated_pre` rounds them: one rounding each, no FMA contraction.
__device__ __forceinline__ void gated_pre(float g, float bg, float e, float bm, float& hg,
                                          float& hm) {
  hg = __bfloat162float(__float2bfloat16_rn(__fadd_rn(g, bg)));
  hm = __bfloat162float(__float2bfloat16_rn(__fadd_rn(__fmul_rn(g, e), bm)));
}

// One element of B12's dg: from g, dy W_dec^T (ady) and dvia W_dec^T (adv),
// dg = dhg + dhm e before its rounding to bf16; adds dhg, dhm and dhm g to
// the column partials.
__device__ __forceinline__ float dg_elem(float g, float ady, float adv, float bg, float e,
                                         float bm, float vt, float& sg, float& sm, float& sx) {
  float hg, hm;
  gated_pre(g, bg, e, bm, hg, hm);
  const bool gate = hg > 0.f;
  const float dhm = gate && hm > 0.f ? ady : 0.f;
  const float dhg = gate ? __fadd_rn(adv, vt) : 0.f;
  sg += dhg;
  sm += dhm;
  sx += dhm * g;
  return __fadd_rn(dhg, __fmul_rn(dhm, e));
}

"""
HELPERS_CVT2 = """// The gated pre-activations of a column pair (c, c + 1) from the float32
// products g0, g1, rounded to bf16 as `_gated_pre` rounds them (one rounding
// each, no FMA contraction), both columns in one conversion: hg and hm as
// bf16 pairs and as floats.
struct GatedPair {
  __nv_bfloat162 hg, hm;
  float2 hgf, hmf;
};

__device__ __forceinline__ GatedPair gated_pre2(float g0, float g1, float2 bg, float2 e,
                                                float2 bm) {
  GatedPair r;
  r.hg = __floats2bfloat162_rn(__fadd_rn(g0, bg.x), __fadd_rn(g1, bg.y));
  r.hm = __floats2bfloat162_rn(__fadd_rn(__fmul_rn(g0, e.x), bm.x),
                               __fadd_rn(__fmul_rn(g1, e.y), bm.y));
  r.hgf = __bfloat1622float2(r.hg);
  r.hmf = __bfloat1622float2(r.hm);
  return r;
}

// The bf16 pair v with each half whose flag is off set to +0.
__device__ __forceinline__ uint32_t keep2(__nv_bfloat162 v, bool lo, bool hi) {
  return *reinterpret_cast<const uint32_t*>(&v) & ((lo ? 0xFFFFu : 0u) | (hi ? 0xFFFF0000u : 0u));
}

// One element of B12's dg: from g, its rounded hg and hm, dy W_dec^T (ady)
// and dvia W_dec^T (adv), dg = dhg + dhm e before its rounding to bf16;
// adds dhg, dhm and dhm g to the column partials.
__device__ __forceinline__ float dg_elem(float g, float ady, float adv, float hg, float hm,
                                         float e, float vt, float& sg, float& sm, float& sx) {
  const bool gate = hg > 0.f;
  const float dhm = gate && hm > 0.f ? ady : 0.f;
  const float dhg = gate ? __fadd_rn(adv, vt) : 0.f;
  sg += dhg;
  sm += dhm;
  sx += dhm * g;
  return __fadd_rn(dhg, __fmul_rn(dhm, e));
}

"""
DG_CALLS = """          const int k = 4 * j + 2 * h;
          const float d0 = dg_elem(gv.x, ady[k], adv[k], bg.x, e.x, bm.x, vt0, sg0, sm0, sx0);
          const float d1 =
              dg_elem(gv.y, ady[k + 1], adv[k + 1], bg.y, e.y, bm.y, vt1, sg1, sm1, sx1);
"""
DG_CALLS_CVT2 = """          const int k = 4 * j + 2 * h;
          const GatedPair pr = gated_pre2(gv.x, gv.y, bg, e, bm);
          const float d0 =
              dg_elem(gv.x, ady[k], adv[k], pr.hgf.x, pr.hmf.x, e.x, vt0, sg0, sm0, sx0);
          const float d1 =
              dg_elem(gv.y, ady[k + 1], adv[k + 1], pr.hgf.y, pr.hmf.y, e.y, vt1, sg1, sm1, sx1);
"""
CHUNKED = """        // One pass over the tile in four chunks of 64 columns: a chunk's c(h)
        // (the magnitude path where the gate is open) and c(hga) = max(hg,
        // 0) go into two of the warpgroup's four staged boxes and out by TMA
        // to rows [0, B) and [B, 2B), so a chunk waits only for the stores of
        // the chunk two back, issued a chunk's work earlier.  B11 counts the
        // rows with h > 0 of each column (nact) from ballots, as B4 does, and
        // sums hga wdn (l1); B12 sums the columns of hga.
        float l1 = 0.f;
#pragma unroll
        for (int q = 0; q < kBN / hg::kBox; ++q) {
          unsigned char* hb = stg + (2 * q % 4) * hg::kBoxBytes;
          unsigned char* ab = hb + hg::kBoxBytes;
          if (t == 0) bulk_wait_read_but<1>();  // chunk q - 2's stores have read hb, ab
          hg::named_sync(1 + wg, 128);
#pragma unroll
          for (int jj = 0; jj < hg::kBox / 8; ++jj) {
            const int j = hg::kBox / 8 * q + jj, c = 8 * j + 2 * tq;
            const float2 bg = bf2(p.bias + lcol + c), bm = bf2(p.bmag + lcol + c);
            const float2 e = f2(p.e + lcol + c);
            const float2 w = MODE == kGatedEncoder ? f2(p.wdn + lcol + c) : make_float2(0.f, 0.f);
            const unsigned same_col = 0x11111111u << tq;
            int c0 = 0, c1 = 0;
            float s0 = 0.f, s1 = 0.f;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float hg0, hm0, hg1, hm1;
              gated_pre(acc[4 * j + 2 * h], bg.x, e.x, bm.x, hg0, hm0);
              gated_pre(acc[4 * j + 2 * h + 1], bg.y, e.y, bm.y, hg1, hm1);
              const bool on0 = hg0 > 0.f && hm0 > 0.f, on1 = hg1 > 0.f && hm1 > 0.f;
              const float a0 = hg0 > 0.f ? hg0 : 0.f, a1 = hg1 > 0.f ? hg1 : 0.f;
              if (MODE == kGatedEncoder) {
                c0 += __popc(__ballot_sync(0xffffffffu, on0) & same_col);
                c1 += __popc(__ballot_sync(0xffffffffu, on1) & same_col);
                l1 += a0 * w.x + a1 * w.y;
              }
              s0 += a0;
              s1 += a1;
              const int off = hg::sw128(16 * warp + g + 8 * h, jj) + 4 * tq;
              sae::store2(reinterpret_cast<bf16*>(hb + off), on0 ? hm0 : 0.f, on1 ? hm1 : 0.f);
              sae::store2(reinterpret_cast<bf16*>(ab + off), a0, a1);
            }
            if (MODE == kGatedEncoder && lane < 4)
              *reinterpret_cast<float2*>(red + cw * kBN + 8 * j + 2 * lane) =
                  make_float2(static_cast<float>(c0), static_cast<float>(c1));
            if (MODE == kGatedRemat) col_partial(s0, s1, red + cw * kBN, j, lane);
          }
          hg::fence_proxy_async_smem();
          hg::named_sync(1 + wg, 128);
          if (t == 0) {
            const int n = x.n0 + q * hg::kBox;
            hg::tma_store_3d(&cout, hb, n, x.m0 + 64 * wg, x.l);
            hg::tma_store_3d(&cout, ab, n, B + x.m0 + 64 * wg, x.l);
            hg::bulk_commit();
          }
        }
"""
CHUNKED_CVT2 = """        // One pass over the tile in four chunks of 64 columns: a chunk's c(h)
        // (the magnitude path where the gate is open) and c(hga) = max(hg,
        // 0) go into two of the warpgroup's four staged boxes and out by TMA
        // to rows [0, B) and [B, 2B), so a chunk waits only for the stores of
        // the chunk two back, issued a chunk's work earlier.  B11 counts the
        // rows with h > 0 of each column (nact) from ballots, as B4 does, and
        // sums hga wdn (l1); B12 sums the columns of hga.
        float l1 = 0.f;
#pragma unroll
        for (int q = 0; q < kBN / hg::kBox; ++q) {
          unsigned char* hb = stg + (2 * q % 4) * hg::kBoxBytes;
          unsigned char* ab = hb + hg::kBoxBytes;
          if (t == 0) bulk_wait_read_but<1>();  // chunk q - 2's stores have read hb, ab
          hg::named_sync(1 + wg, 128);
#pragma unroll
          for (int jj = 0; jj < hg::kBox / 8; ++jj) {
            const int j = hg::kBox / 8 * q + jj, c = 8 * j + 2 * tq;
            const float2 bg = bf2(p.bias + lcol + c), bm = bf2(p.bmag + lcol + c);
            const float2 e = f2(p.e + lcol + c);
            const float2 w = MODE == kGatedEncoder ? f2(p.wdn + lcol + c) : make_float2(0.f, 0.f);
            const unsigned same_col = 0x11111111u << tq;
            int c0 = 0, c1 = 0;
            float s0 = 0.f, s1 = 0.f;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const GatedPair pr =
                  gated_pre2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], bg, e, bm);
              const bool g0 = pr.hgf.x > 0.f, g1 = pr.hgf.y > 0.f;
              const bool on0 = g0 && pr.hmf.x > 0.f, on1 = g1 && pr.hmf.y > 0.f;
              const float a0 = g0 ? pr.hgf.x : 0.f, a1 = g1 ? pr.hgf.y : 0.f;
              if (MODE == kGatedEncoder) {
                c0 += __popc(__ballot_sync(0xffffffffu, on0) & same_col);
                c1 += __popc(__ballot_sync(0xffffffffu, on1) & same_col);
                l1 += a0 * w.x + a1 * w.y;
              }
              s0 += a0;
              s1 += a1;
              // h = hm where the magnitude mask is on, hga = hg where the gate
              // is: the rounded pairs' bits, masked
              const int off = hg::sw128(16 * warp + g + 8 * h, jj) + 4 * tq;
              *reinterpret_cast<uint32_t*>(hb + off) = keep2(pr.hm, on0, on1);
              *reinterpret_cast<uint32_t*>(ab + off) = keep2(pr.hg, g0, g1);
            }
            if (MODE == kGatedEncoder && lane < 4)
              *reinterpret_cast<float2*>(red + cw * kBN + 8 * j + 2 * lane) =
                  make_float2(static_cast<float>(c0), static_cast<float>(c1));
            if (MODE == kGatedRemat) col_partial(s0, s1, red + cw * kBN, j, lane);
          }
          hg::fence_proxy_async_smem();
          hg::named_sync(1 + wg, 128);
          if (t == 0) {
            const int n = x.n0 + q * hg::kBox;
            hg::tma_store_3d(&cout, hb, n, x.m0 + 64 * wg, x.l);
            hg::tma_store_3d(&cout, ab, n, B + x.m0 + 64 * wg, x.l);
            hg::bulk_commit();
          }
        }
"""
TWO_PASS = """        // c(h): the magnitude path where the gate is open; B11 counts its
        // rows > 0 in each column (nact) from ballots, as B4 does
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          const int c = 8 * j + 2 * tq;
          const float2 bg = bf2(p.bias + lcol + c), bm = bf2(p.bmag + lcol + c);
          const float2 e = f2(p.e + lcol + c);
          const unsigned same_col = 0x11111111u << tq;
          int c0 = 0, c1 = 0;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float hg0, hm0, hg1, hm1;
            gated_pre(acc[4 * j + 2 * h], bg.x, e.x, bm.x, hg0, hm0);
            gated_pre(acc[4 * j + 2 * h + 1], bg.y, e.y, bm.y, hg1, hm1);
            const bool on0 = hg0 > 0.f && hm0 > 0.f, on1 = hg1 > 0.f && hm1 > 0.f;
            if (MODE == kGatedEncoder) {
              c0 += __popc(__ballot_sync(0xffffffffu, on0) & same_col);
              c1 += __popc(__ballot_sync(0xffffffffu, on1) & same_col);
            }
            sae::store2(reinterpret_cast<bf16*>(stg + stage_off(16 * warp + g + 8 * h, j, tq)),
                        on0 ? hm0 : 0.f, on1 ? hm1 : 0.f);
          }
          if (MODE == kGatedEncoder && lane < 4)
            *reinterpret_cast<float2*>(red + cw * kBN + 8 * j + 2 * lane) =
                make_float2(static_cast<float>(c0), static_cast<float>(c1));
        }
        store_staged<kBN / hg::kBox>(&cout, stg, x.n0, x.m0 + 64 * wg, x.l, t, wg);
        staging_free(t, wg);  // c(hga) goes into the same buffer once the store has read it
        // c(hga) = max(hg, 0) into rows [B, 2B): B11 sums hga wdn (l1), B12
        // the columns of hga
        float l1 = 0.f;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          const int c = 8 * j + 2 * tq;
          const float2 bg = bf2(p.bias + lcol + c);
          const float2 w = MODE == kGatedEncoder ? f2(p.wdn + lcol + c) : make_float2(0.f, 0.f);
          float s0 = 0.f, s1 = 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float hg0 =
                __bfloat162float(__float2bfloat16_rn(__fadd_rn(acc[4 * j + 2 * h], bg.x)));
            const float hg1 =
                __bfloat162float(__float2bfloat16_rn(__fadd_rn(acc[4 * j + 2 * h + 1], bg.y)));
            const float a0 = hg0 > 0.f ? hg0 : 0.f, a1 = hg1 > 0.f ? hg1 : 0.f;
            s0 += a0;
            s1 += a1;
            l1 += a0 * w.x + a1 * w.y;
            sae::store2(reinterpret_cast<bf16*>(stg + stage_off(16 * warp + g + 8 * h, j, tq)),
                        a0, a1);
          }
          if (MODE == kGatedRemat) col_partial(s0, s1, red + cw * kBN, j, lane);
        }
        store_staged<kBN / hg::kBox>(&cout, stg, x.n0, B + x.m0 + 64 * wg, x.l, t, wg);
"""
FILL_WAVES = "decoder(h, Wd, bd, y, L, 2 * B, D, S, device, s, true);"
STAGING_FREE = """      } else if (!C::kGated) {
        staging_free(t, wg);  // the last tile's store has read the staging"""
DG_PARTS = """        col_partial(sg0, sg1, red + (0 * 4 * kConsumers + cw) * C::kTileN, j, lane);
        col_partial(sm0, sm1, red + (1 * 4 * kConsumers + cw) * C::kTileN, j, lane);
        col_partial(sx0, sx1, red + (2 * 4 * kConsumers + cw) * C::kTileN, j, lane);
"""


TOPK_FILL_WAVES = "constexpr bool kTopkFillWaves = true;"
TOPK_DECODER_CALL = "return decoder(h, Wd, bd, y, L, B, D, S, device, s, kTopkFillWaves);"
SPARSE_DECODER = """// B8's decoder over the active set (probes/sae_tc_variants.py, t_sparse_dec):
// one block a row of h [L * B, S], blockDim D / 2 (a column pair a thread);
// the row's nonzeros compacted into shared memory in index order, a chunk
// of 8 blockDim entries at a time; y = b_dec + sum of h[j] W_dec[j, :].
__global__ void sparse_decoder_kernel(const bf16* __restrict__ h, const bf16* __restrict__ Wd,
                                      const bf16* __restrict__ bd, bf16* __restrict__ y, int B,
                                      int D, int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nt = blockDim.x, chunk = 8 * nt;
  int* idx = reinterpret_cast<int*>(smem_raw);
  float* val = reinterpret_cast<float*>(idx + chunk);
  __shared__ int wsum[33];
  const long long row = blockIdx.x;
  const int l = static_cast<int>(row / B), c = threadIdx.x, lane = c & 31, warp = c >> 5;
  const bf16* hr = h + row * S;
  const bf16* W = Wd + static_cast<long long>(l) * S * D + 2 * c;
  const float2 b = bf2(bd + static_cast<long long>(l) * D + 2 * c);
  float a0 = b.x, a1 = b.y;
  for (int base = 0; base < S; base += chunk) {
    const int i0 = base + 8 * c;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (i0 < S) v = *reinterpret_cast<const uint4*>(hr + i0);
    const unsigned* w = &v.x;
    int n = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) n += ((w[q] & 0xffffu) != 0u) + ((w[q] >> 16) != 0u);
    int incl = n;  // the block's exclusive scan of n, in thread order
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    if (c == 0) {
      int s = 0;
      for (int k = 0; k < nt / 32; ++k) {
        const int t = wsum[k];
        wsum[k] = s;
        s += t;
      }
      wsum[32] = s;
    }
    __syncthreads();
    int pos = wsum[warp] + incl - n;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const unsigned bits = (w[q >> 1] >> (16 * (q & 1))) & 0xffffu;
      if (bits != 0u) {
        idx[pos] = i0 + q;
        val[pos] = __uint_as_float(bits << 16);
        ++pos;
      }
    }
    __syncthreads();
    const int total = wsum[32];
    int j = 0;
    for (; j + 4 <= total; j += 4) {
      float2 wv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) wv[u] = bf2(W + static_cast<long long>(idx[j + u]) * D);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        a0 += val[j + u] * wv[u].x;
        a1 += val[j + u] * wv[u].y;
      }
    }
    for (; j < total; ++j) {
      const float2 wv = bf2(W + static_cast<long long>(idx[j]) * D);
      a0 += val[j] * wv.x;
      a1 += val[j] * wv.y;
    }
    __syncthreads();
  }
  *reinterpret_cast<__nv_bfloat162*>(y + row * D + 2 * c) = __floats2bfloat162_rn(a0, a1);
}

cudaError_t sparse_decoder(const void* h, const void* Wd, const void* bd, void* y, int L, int B,
                           int D, int S, cudaStream_t s) {
  const int nt = D / 2;
  if (nt % 32 != 0 || nt > 1024 || S % 8 != 0) return cudaErrorInvalidValue;
  const int smem = 8 * nt * 8;
  cudaError_t err = sae::allow_smem(sparse_decoder_kernel, smem);
  if (err != cudaSuccess) return err;
  sparse_decoder_kernel<<<static_cast<unsigned>(static_cast<long long>(L) * B), nt, smem, s>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(Wd), static_cast<const bf16*>(bd),
      static_cast<bf16*>(y), B, D, S);
  return cudaGetLastError();
}

"""
TILE_256 = "constexpr int kBN = 256; "
MMA_CALL = "mma256<AM, BM>(acc, "


def main():
    src = (CSRC / "sae_fused_tc.cu").read_text()
    hdr = (CSRC / "sae_wgmma.cuh").read_text()
    if (BALLOT not in src or any(t not in hdr for t in (TILE_256, MMA_CALL))
            or any(t not in src for t in (HELPERS, DG_CALLS, CHUNKED, STAGING_FREE,
                                          DG_PARTS, FILL_WAVES, TOPK_FILL_WAVES,
                                          TOPK_DECODER_CALL))):
        raise SystemExit("sae_fused_tc.cu or sae_wgmma.cuh no longer has the code these "
                         "versions edit")
    versions = {"v_shuffle": (src.replace(BALLOT, SHUFFLE), None),
                "v_noreduce": (src.replace(BALLOT, NOREDUCE), None),
                "v_bn128": (src, hdr.replace(TILE_256, "constexpr int kBN = 128; ")
                            .replace(MMA_CALL, "mma128<AM, BM>(acc, ")),
                "g_dec256": (src.replace(FILL_WAVES, FILL_WAVES.replace("true", "false")), None),
                "g_cvt2": (src.replace(HELPERS, HELPERS_CVT2).replace(DG_CALLS, DG_CALLS_CVT2)
                           .replace(CHUNKED, CHUNKED_CVT2), None),
                "g_two_pass": (src.replace(CHUNKED, TWO_PASS).replace(
                    STAGING_FREE, STAGING_FREE.replace("if (!C::kGated)", "")
                    .replace("} else  {", "} else {")), None),
                "g_dg_nopart": (src.replace(DG_PARTS, ""), None),
                "t_dec256": (src.replace(TOPK_FILL_WAVES, TOPK_FILL_WAVES.replace("true",
                                                                                  "false")),
                             None),
                "t_sparse_dec": (src.replace(TOPK_FILL_WAVES, SPARSE_DECODER + TOPK_FILL_WAVES)
                                 .replace(TOPK_DECODER_CALL, "return sparse_decoder(h, Wd, bd, "
                                          "y, L, B, D, S, s);"), None)}
    for name, (cu, cuh) in versions.items():
        d = CSRC / "build" / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "sae_fused_tc.cu").write_text(cu)
        if cuh is not None:
            (d / "sae_wgmma.cuh").write_text(cuh)
        print(d / "sae_fused_tc.cu")


if __name__ == "__main__":
    main()
