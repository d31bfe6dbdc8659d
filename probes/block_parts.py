"""Where B16's bf16 time goes: copies of ``csrc/attention_block.cu`` with
parts of block_tc_kernel cut out (their outputs are wrong; timing only),
built in parallel and timed in turns at CLIP ViT-B/32 batch 256 against
the whole kernel: without the mix, without the epilogue and the mix,
without the output projection, and the QKV products alone.  Prints JSON
lines.  Run from the repository root on a CUDA card:
``python3 probes/block_parts.py``."""

import ctypes
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _common import BUILD, CSRC, card, finish_build, ms, start_build  # noqa: E402

EPILOGUE = "      if (t == 0) hg::bulk_wait_read();  // the previous head's z store"
MIX = "      // the mix: this warp's 16 query rows"
MIX_END = "zc[j][2 * h + 1]);\n        }\n"  # the end of the loop staging z
N_CT = "n_ct = (D + kN - 1) / kN;"


def variants(src: str) -> dict:
    k0 = src.index("block_tc_kernel(const __grid_constant__")
    epi, mix = src.index(EPILOGUE, k0), src.index(MIX, k0)
    end = src.index(MIX_END, mix) + len(MIX_END)
    assert N_CT in src
    no_epi_mix = src[:epi] + src[end:]
    return {"whole": src, "no_mix": src[:mix] + src[end:], "no_epilogue_mix": no_epi_mix,
            "no_out": src.replace(N_CT, "n_ct = 0;"),
            "qkv_products_only": no_epi_mix.replace(N_CT, "n_ct = 0;")}


def main():
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variants((CSRC / "attention_block.cu").read_text()).items():
        path = BUILD / f"parts_{name}.cu"
        path.write_text(text)
        procs[name] = start_build(path, f"parts_{name}")
    libs = {}
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, proc in procs.items():
        lib = finish_build(proc, f"parts_{name}")
        if lib is not None:
            lib.attention_block_fwd.argtypes = [p] * 6 + [i] * 4 + [f, i, i, p]
            libs[name] = lib
    print(json.dumps({"card": card(), "built": list(libs)}))
    g = torch.Generator(device="cuda").manual_seed(13)
    B, T, D, N = 256, 50, 768, 12
    NH = N * 64
    x = torch.randn(B, T, D, generator=g, device="cuda").bfloat16()
    Wqkv = (torch.randn(D, 3 * NH, generator=g, device="cuda") * D ** -0.5).bfloat16()
    bqkv = (torch.randn(3 * NH, generator=g, device="cuda") * 0.1).bfloat16()
    Wo = (torch.randn(NH, D, generator=g, device="cuda") * NH ** -0.5).bfloat16()
    out = torch.empty_like(x)
    zbuf = torch.zeros(B, 64, NH, dtype=x.dtype, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def call(lib):
        lib.attention_block_fwd(x.data_ptr(), Wqkv.data_ptr(), bqkv.data_ptr(), Wo.data_ptr(),
                                zbuf.data_ptr(), out.data_ptr(), B, T, D, N, 0.125, 1, 0, stream)

    names = list(libs)
    times = {n: [] for n in names}
    for n in names + names[::-1] + names:
        times[n].append(ms(lambda: call(libs[n])))
    print(json.dumps({"ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
