"""B14's bf16 kernel as the package builds it against another version of
``csrc/ln_matmul.cu`` (an optional path, built alone), at the shapes of
chip_smoke.py's ln_gemm phase plus a 96-deep one: error against the plain
version, outputs equal to the bit, times from CUDA events in turns, and
``F.layer_norm`` + ``torch.matmul`` beside.  Prints JSON lines.  Run from
the repository root on a CUDA card:
``python3 probes/ln_versions.py [other/ln_matmul.cu]``."""

import ctypes
import json
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _common import card, finish_build, ms, start_build  # noqa: E402

SHAPES = [("b32_qkv", 12800, 3, 768, 768), ("b32_mlp_in", 12800, 1, 768, 3072),
          ("l14_336_mlp_in", 36928, 1, 1024, 4096), ("l14_336_qkv_lnpre", 36928, 3, 1024, 1024),
          ("edge", 12801, 1, 768, 640), ("d96", 300, 2, 96, 256)]


def run(lib, x, W, b):
    R, D = x.shape
    S, _, C = W.shape
    out = torch.empty(S, R, C, dtype=x.dtype, device=x.device)
    stats = torch.empty(R, 2, dtype=torch.float32, device=x.device)
    rc = lib.ln_matmul_fwd(x.data_ptr(), W.data_ptr(), b.data_ptr(), out.data_ptr(),
                           stats.data_ptr(), R, S, D, C, 1e-5, 1, 0,
                           torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"ln_matmul_fwd: CUDA error {rc}")
    return out


def main():
    from vit_prisma_tpu_torch.ops import _build
    from vit_prisma_tpu_torch.ops.ln_matmul import ln_matmul_reference
    proc = start_build(Path(sys.argv[1]), "ln_other") if len(sys.argv) > 1 else None
    libs = {"package": _build.load_library()}
    if proc is not None:
        lib = finish_build(proc, "ln_other")
        if lib is not None:
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.ln_matmul_fwd.argtypes = [p] * 5 + [i] * 4 + [f, i, i, p]
            libs["other"] = lib
    print(json.dumps({"card": card(), "versions": list(libs)}))
    g = torch.Generator(device="cuda").manual_seed(11)
    names = list(libs)
    for name, R, S, D, C in SHAPES:
        x = (torch.randn(R, D, generator=g, device="cuda") * 2.0 + 0.5).bfloat16()
        W = (torch.randn(S, D, C, generator=g, device="cuda") * D ** -0.5).bfloat16()
        b = (torch.randn(S, C, generator=g, device="cuda") * 0.02).bfloat16()
        want = ln_matmul_reference(x, W, b)
        outs = {n: run(lib, x, W, b) for n, lib in libs.items()}
        t = {n: [] for n in names}
        for n in names + names[::-1]:
            t[n].append(ms(lambda: run(libs[n], x, W, b), iters=20, warmup=3))
        print(json.dumps({
            "shape": name, "R": R, "S": S, "D": D, "C": C,
            "max_abs_err": {n: (o.float() - want.float()).abs().max().item() for n, o in outs.items()},
            "rel_tol": 2 ** -6, "equal": all(torch.equal(o, outs["package"]) for o in outs.values()),
            "ms": t, "library_ms": ms(lambda: torch.matmul(F.layer_norm(x, (D,)), W) + b[:, None],
                                      iters=20, warmup=3),
            "TFLOP_s": {n: 2 * S * R * D * C / (min(v) * 1e-3) / 1e12 for n, v in t.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
