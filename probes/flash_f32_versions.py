"""B13's float32 route as the package's sources build it (3xTF32 on the
tensor cores) against other versions of the same sources: each directory
given holds a copy of ``vit_prisma_tpu_torch/csrc`` (a parent commit's,
unpacked with ``git archive`` into the gitignored ``archive_run/``, for the
FFMA kernels; or edited copies), and every version's
``flash_attention_fwd.cu`` and ``flash_attention_bwd.cu`` are built alone,
the package's too.  At every float32 shape of chip_smoke.py's FLASH_SHAPES:
each version's error against the plain versions (z, lse and the three
gradients, relative to max(1, absmax)), times of the forward and of each
backward pass from CUDA events in turns (package, others, others reversed,
package), ``scaled_dot_product_attention``'s forward and whole backward
under the same mask (device times, as chip_smoke.py takes them), the bounds
at chip_smoke.py's peaks, the kernel names ``torch.profiler`` sees, and each
version's ptxas registers and spills.  ``--check`` stops after the errors
and the ptxas records.  Prints JSON lines.  Run from the repository root on
a CUDA card: ``python3 probes/flash_f32_versions.py [--check] [DIR ...]``."""

import ctypes
import json
import re
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _common import BUILD, card, finish_build, ms, start_build  # noqa: E402

import chip_smoke  # noqa: E402  (on the path through _common)

FILES = {"fwd": "flash_attention_fwd.cu", "bwd": "flash_attention_bwd.cu"}
PACKAGE = Path(__file__).resolve().parent.parent / "vit_prisma_tpu_torch" / "csrc"


def declare(lib, kind):
    p, i = ctypes.c_void_p, ctypes.c_int
    if kind == "fwd":
        lib.flash_attention_fwd.argtypes = [p] * 6 + [i] * 7 + [p]
    else:
        lib.flash_attention_bwd.argtypes = [p] * 10 + [i] * 8 + [p]


def stream():
    return torch.cuda.current_stream().cuda_stream


def fwd(lib, q, k, v, seg, causal):
    B, N, Tp, H = q.shape
    z = torch.empty_like(q)
    lse = torch.empty(B, N, Tp, dtype=torch.float32, device=q.device)
    rc = lib.flash_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
                                 z.data_ptr(), lse.data_ptr(), B, N, Tp, H, int(causal), 0, 0,
                                 stream())
    if rc:
        raise RuntimeError(f"flash_attention_fwd: CUDA error {rc}")
    return z, lse


def bwd(lib, which, q, k, v, seg, dz, lse, dsum, causal):
    B, N, Tp, H = q.shape
    outs = [torch.empty_like(q)] if which else [torch.empty_like(k), torch.empty_like(v)]
    ptrs = [outs[0].data_ptr(), 0, 0] if which else [0, outs[0].data_ptr(), outs[1].data_ptr()]
    rc = lib.flash_attention_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), dz.data_ptr(),
                                 seg.data_ptr(), lse.data_ptr(), dsum.data_ptr(), *ptrs, B, N, Tp,
                                 H, int(causal), which, 0, 0, stream())
    if rc:
        raise RuntimeError(f"flash_attention_bwd: CUDA error {rc}")
    return outs


def ptxas_f32(log):
    """Registers and spill bytes of a build's float32 flash kernels (the
    3xTF32 ones, or a parent's FFMA instantiations for float), by kernel and
    head width."""
    out, fn = {}, None
    for line in Path(log).read_text().splitlines():
        m = re.search(r"Function properties for \S*?((?:fwd|dkv|dq)_tf32_kernel|"
                      r"flash_(?:fwd|bwd_dkv|bwd_dq)_kernel)I(f)?\S*?Li(\d+)E", line)
        if "Function properties for" in line:
            fn = None
            if m and (m.group(1).endswith("tf32_kernel") or m.group(2)):
                fn = f"{m.group(1)}<{m.group(3)}>"
        elif fn and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            out[fn] = {"spill_bytes": int(m.group(1)) + int(m.group(2))}
        elif fn and (m := re.search(r"Used (\d+) registers", line)):
            out[fn]["registers"] = int(m.group(1))
    return out


def rel_err(got, want):
    return (got - want).abs().max().item() / max(1.0, want.abs().max().item())


def in_turns(versions, call):
    """ms of each version, timed package, others, others reversed, package."""
    names = list(versions)
    t = {n: [] for n in names}
    for n in names + names[::-1]:
        t[n].append(ms(lambda: call(versions[n]), iters=10, warmup=2))
    return t


def main():
    from vit_prisma_tpu_torch.ops import attention as A
    torch.backends.cuda.matmul.allow_tf32 = False
    args = sys.argv[1:]
    check = "--check" in args
    dirs = {"package": PACKAGE, **{f"{i}:{Path(a).name}": Path(a)
                                   for i, a in enumerate(x for x in args if x != "--check")}}
    procs = {(name, kind): start_build(d / f, f"flash_f32_{j}_{kind}")
             for j, (name, d) in enumerate(dirs.items()) for kind, f in FILES.items()}
    versions = {}
    for j, name in enumerate(dirs):
        libs = {}
        for kind in FILES:
            lib = finish_build(procs[(name, kind)], f"flash_f32_{j}_{kind}")
            if lib is not None:
                declare(lib, kind)
                libs[kind] = lib
        print(json.dumps({"version": name, "built": sorted(libs), "ptxas": {
            kind: ptxas_f32(BUILD / f"flash_f32_{j}_{kind}.log") for kind in FILES}}), flush=True)
        if len(libs) == len(FILES):
            versions[name] = libs
    print(json.dumps({"card": card(), "versions": list(versions)}), flush=True)
    g = torch.Generator(device="cuda").manual_seed(23)
    for name, B, N, T, H, causal, dtypes in chip_smoke.FLASH_SHAPES:
        if torch.float32 not in dtypes:
            continue
        q, k, v, dz, seg = chip_smoke._flash_inputs(g, B, N, T, H, torch.float32)
        Tp = q.shape[2]
        want_z = A.flash_attention_padded_reference(q, k, v, seg, causal)
        want_lse = A.flash_lse_reference(q, k, seg, causal)
        dsum = A.flash_dsum(want_z, dz)
        args_ = (q, k, v, seg, dz, want_lse, dsum, causal)
        want_dk, want_dv = A.flash_attention_padded_bwd_dkv_reference(*args_)
        want_dq = A.flash_attention_padded_bwd_dq_reference(*args_)
        calls = {"fwd": lambda lib: fwd(lib["fwd"], q, k, v, seg, causal),
                 "bwd_dkv": lambda lib: bwd(lib["bwd"], 0, *args_),
                 "bwd_dq": lambda lib: bwd(lib["bwd"], 1, *args_)}
        errs = {}
        for n, lib in versions.items():
            z, lse = calls["fwd"](lib)
            dk, dv = calls["bwd_dkv"](lib)
            dq, = calls["bwd_dq"](lib)
            errs[n] = {"z": rel_err(z, want_z), "lse": rel_err(lse, want_lse),
                       "dq": rel_err(dq, want_dq), "dk": rel_err(dk, want_dk),
                       "dv": rel_err(dv, want_dv)}
        rec = {"shape": name, "B": B, "N": N, "T": T, "Tp": Tp, "H": H, "causal": causal,
               "route": A.flash_route(H, torch.float32), "rel_err": errs}
        if not check:
            rec["ms"] = {p: in_turns(versions, c) for p, c in calls.items()}
            rec["kernels"] = {p: [x[:60] for x in chip_smoke.kernel_names(
                lambda: c(versions["package"]))] for p, c in calls.items()}
            keep = seg[:, None, :, None] == seg[:, None, None, :]
            if causal:
                keep = keep & torch.ones(Tp, Tp, dtype=torch.bool, device="cuda").tril()
            sdpa = lambda *a: torch.nn.functional.scaled_dot_product_attention(
                *a, attn_mask=keep, scale=1.0)
            leaves = [a.clone().requires_grad_(True) for a in (q, k, v)]
            out = sdpa(*leaves)
            rec["library_ms"] = {
                "fwd": chip_smoke.device_us(lambda: sdpa(q, k, v)) * 1e-3,
                "bwd": chip_smoke.device_us(
                    lambda: torch.autograd.grad(out, leaves, dz, retain_graph=True),
                    one_call_short=True) * 1e-3}
            rec["bound"] = chip_smoke.flash_bounds(B, N, T, Tp, H, causal, torch.float32)
            del leaves, out, keep
        print(json.dumps(rec), flush=True)
        del q, k, v, dz, seg, want_z, want_lse, dsum, want_dk, want_dv, want_dq
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
