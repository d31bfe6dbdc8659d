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
* ``v_bn128``: 128-wide block tiles (``kBN = 128``: m64n128k16, whose
  instruction this file carries) for every product.

Prints the sources written.  Then, on a CUDA card:
``python3 probes/sae_tc_versions.py <dir>/sae_fused_tc.cu ...``."""

from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "vit_prisma_tpu_torch" / "csrc"

BALLOT = """        const unsigned same_col = 0x11111111u << tq;
        int c0 = 0, c1 = 0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float p0 = acc[4 * j + 2 * h] + b.x, p1 = acc[4 * j + 2 * h + 1] + b.y;
          const float h0 = p0 > 0.f ? p0 : 0.f, h1 = p1 > 0.f ? p1 : 0.f;
          c0 += __popc(__ballot_sync(0xffffffffu, p0 > 0.f) & same_col);
          c1 += __popc(__ballot_sync(0xffffffffu, p1 > 0.f) & same_col);
          l1 += h0 + h1;
          sae::store2(reinterpret_cast<bf16*>(stg + stage_off(16 * warp + g + 8 * h, j, tq)), h0,
                      h1);
        }
        if (lane < 4)
          *reinterpret_cast<float2*>(red + cw * kBN + 8 * j + 2 * lane) =
              make_float2(static_cast<float>(c0), static_cast<float>(c1));"""

SHUFFLE = """        float c0 = 0.f, c1 = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float p0 = acc[4 * j + 2 * h] + b.x, p1 = acc[4 * j + 2 * h + 1] + b.y;
          const float h0 = p0 > 0.f ? p0 : 0.f, h1 = p1 > 0.f ? p1 : 0.f;
          c0 += p0 > 0.f ? 1.f : 0.f;
          c1 += p1 > 0.f ? 1.f : 0.f;
          l1 += h0 + h1;
          sae::store2(reinterpret_cast<bf16*>(stg + stage_off(16 * warp + g + 8 * h, j, tq)), h0,
                      h1);
        }
        col_partial(c0, c1, red + cw * kBN, j, lane);"""

NOREDUCE = """#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float p0 = acc[4 * j + 2 * h] + b.x, p1 = acc[4 * j + 2 * h + 1] + b.y;
          sae::store2(reinterpret_cast<bf16*>(stg + stage_off(16 * warp + g + 8 * h, j, tq)),
                      p0 > 0.f ? p0 : 0.f, p1 > 0.f ? p1 : 0.f);
        }"""

TILE_256 = "constexpr int kBN = 256; "
MMA_CALL = "mma256<AM, BM>(acc, "
DESC = "template <int MAJOR>\n__device__ __forceinline__ uint64_t desc("


def mma128():
    """wgmma m64n128k16 (bf16 in, float32 accumulators) in mma256's form."""
    regs = ", ".join(f"%{i}" for i in range(64))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(64))
    return ("template <int TA, int TB>\n"
            "__device__ __forceinline__ void mma128(float (&d)[64], uint64_t da, uint64_t db, "
            "int scale_d) {\n  asm volatile(\n"
            '      "{\\n.reg .pred p;\\nsetp.ne.b32 p, %66, 0;\\n"\n'
            '      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"\n'
            f'      "{regs}}}, "\n'
            '      "%64, %65, p, 1, 1, %67, %68;\\n}\\n"\n'
            f"      : {outs}\n"
            '      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));\n}\n\n')


def main():
    src = (CSRC / "sae_fused_tc.cu").read_text()
    hdr = (CSRC / "sae_wgmma.cuh").read_text()
    if BALLOT not in src or any(t not in hdr for t in (TILE_256, MMA_CALL, DESC)):
        raise SystemExit("sae_fused_tc.cu or sae_wgmma.cuh no longer has the code these "
                         "versions edit")
    versions = {"v_shuffle": (src.replace(BALLOT, SHUFFLE), None),
                "v_noreduce": (src.replace(BALLOT, NOREDUCE), None),
                "v_bn128": (src, hdr.replace(TILE_256, "constexpr int kBN = 128; ")
                            .replace(MMA_CALL, "mma128<AM, BM>(acc, ")
                            .replace(DESC, mma128() + DESC))}
    for name, (cu, cuh) in versions.items():
        d = CSRC / "build" / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "sae_fused_tc.cu").write_text(cu)
        if cuh is not None:
            (d / "sae_wgmma.cuh").write_text(cuh)
        print(d / "sae_fused_tc.cu")


if __name__ == "__main__":
    main()
