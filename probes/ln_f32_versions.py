"""B14's float32 route as the package builds it (3xTF32 on tf32 wgmma,
``ln_gemm_tf32_kernel``) against other versions of ``ln_matmul.cu``: each
directory given holds a copy of ``vit_prisma_tpu_torch/csrc`` (a parent
commit's, unpacked with ``git archive`` into the gitignored
``archive_run/``, for the FFMA kernel; or edited copies), and every
version's ``ln_matmul.cu`` is built alone, the package's too.  At every
float32 shape of chip_smoke.py's LN_SHAPES: each version's error against
the plain version (relative to max(1, absmax)), the first 128 rows alone
against the same rows of the whole call (to the bit), times from CUDA
events in turns (package, others, others reversed, package),
``F.layer_norm`` + ``torch.matmul`` beside, the bound at chip_smoke.py's
peaks, the kernel names ``torch.profiler`` sees, and each version's ptxas
registers and spills.  ``--check`` stops after the errors and the ptxas
records.  Prints JSON lines.  Run from the repository root on a CUDA card:
``python3 probes/ln_f32_versions.py [--check] [DIR ...]``."""

import ctypes
import json
import re
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _common import BUILD, card, finish_build, ms, start_build  # noqa: E402

import chip_smoke  # noqa: E402  (on the path through _common)

PACKAGE = Path(__file__).resolve().parent.parent / "vit_prisma_tpu_torch" / "csrc"


def run(lib, x, W, b):
    """One float32 call; the scratch is the package's size (the parent's
    kernel reads only its first 2 R floats)."""
    from vit_prisma_tpu_torch.ops.ln_matmul import _scratch_floats
    R, D = x.shape
    S, _, C = W.shape
    out = torch.empty(S, R, C, dtype=x.dtype, device=x.device)
    scratch = torch.empty(_scratch_floats(R, S, D, C, x.dtype), dtype=torch.float32,
                          device=x.device)
    rc = lib.ln_matmul_fwd(x.data_ptr(), W.data_ptr(), b.data_ptr(), out.data_ptr(),
                           scratch.data_ptr(), R, S, D, C, 1e-5, 0, 0,
                           torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"ln_matmul_fwd: CUDA error {rc}")
    return out


def ptxas_f32(log):
    """Registers and spill bytes of a build's float32 GEMM (the 3xTF32
    kernel, or a parent's FFMA ``ln_gemm_kernel<float>``)."""
    out, fn = {}, None
    for line in Path(log).read_text().splitlines():
        m = re.search(r"Function properties for \S*?(ln_gemm_tf32_kernel|ln_gemm_kernelIf)", line)
        if "Function properties for" in line:
            fn = m.group(1) if m else None
        elif fn and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            out[fn] = {"spill_bytes": int(m.group(1)) + int(m.group(2))}
        elif fn and (m := re.search(r"Used (\d+) registers", line)):
            out[fn]["registers"] = int(m.group(1))
    serialized = [l.strip()[:160] for l in Path(log).read_text().splitlines()
                  if "wgmma" in l and "serialized" in l]
    return {"kernels": out, "wgmma_serialized": serialized}


def main():
    from vit_prisma_tpu_torch.ops.ln_matmul import ln_matmul_reference
    torch.backends.cuda.matmul.allow_tf32 = False
    args = sys.argv[1:]
    check = "--check" in args
    dirs = {"package": PACKAGE, **{f"{i}:{Path(a).name}": Path(a)
                                   for i, a in enumerate(x for x in args if x != "--check")}}
    procs = {name: start_build(d / "ln_matmul.cu", f"ln_f32_{j}")
             for j, (name, d) in enumerate(dirs.items())}
    libs = {}
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for j, (name, proc) in enumerate(procs.items()):
        lib = finish_build(proc, f"ln_f32_{j}")
        print(json.dumps({"version": name, "built": lib is not None,
                          "ptxas": ptxas_f32(BUILD / f"ln_f32_{j}.log")}), flush=True)
        if lib is not None:
            lib.ln_matmul_fwd.argtypes = [p] * 5 + [i] * 4 + [f, i, i, p]
            libs[name] = lib
    print(json.dumps({"card": card(), "versions": list(libs)}), flush=True)
    g = torch.Generator(device="cuda").manual_seed(11)
    names = list(libs)
    for name, R, S, D, C, dtypes in chip_smoke.LN_SHAPES:
        if torch.float32 not in dtypes:
            continue
        x = torch.randn(R, D, generator=g, device="cuda") * 2.0 + 0.5
        W = torch.randn(S, D, C, generator=g, device="cuda") * D ** -0.5
        b = torch.randn(S, C, generator=g, device="cuda") * 0.02
        want = ln_matmul_reference(x, W, b)
        scale = max(1.0, want.abs().max().item())
        outs = {n: run(lib, x, W, b) for n, lib in libs.items()}
        rec = {"shape": name, "R": R, "S": S, "D": D, "C": C,
               "rel_err": {n: (o - want).abs().max().item() / scale for n, o in outs.items()},
               "rel_tol": chip_smoke.LN_REL[torch.float32]}
        head = min(R, 128)
        rec["rows_alone_equal"] = {
            n: bool(torch.equal(run(lib, x[:head], W, b), outs[n][:, :head]))
            for n, lib in libs.items()}
        if not check:
            t = {n: [] for n in names}
            for n in names + names[::-1]:
                t[n].append(ms(lambda: run(libs[n], x, W, b), iters=20, warmup=3))
            rec["ms"] = t
            rec["library_ms"] = ms(lambda: torch.matmul(F.layer_norm(x, (D,)), W) + b[:, None],
                                   iters=20, warmup=3)
            rec["kernels"] = [k[:70] for k in chip_smoke.kernel_names(
                lambda: run(libs["package"], x, W, b))]
            rec["TFLOP_s"] = {n: 2 * S * R * D * C / (min(v) * 1e-3) / 1e12 for n, v in t.items()}
            rec["bound"] = chip_smoke.bound((R * D + S * D * C + S * C + S * R * C) * 4,
                                            [("f32_product", 2 * S * R * D * C),
                                             ("fp32", 6 * R * D)])
        print(json.dumps(rec), flush=True)
        del x, W, b, want, outs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
