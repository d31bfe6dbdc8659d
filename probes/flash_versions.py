"""B13's bf16 Hopper kernels as the package builds them against other
versions of ``csrc/flash_attention_fwd.cu`` or ``csrc/flash_attention_bwd.cu``
(each built alone; a version replaces the package's passes it exports), at
the bf16 shapes of chip_smoke.py's flash_kernels phase: error against the
plain versions, outputs equal to the package's or not, and times from CUDA
events in turns (package, others, others reversed, package).  Prints JSON
lines.  Run from the repository root on a CUDA card:
``python3 probes/flash_versions.py [other.cu ...]``."""

import ctypes
import json
import re
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _common import BUILD, card, finish_build, ms, start_build  # noqa: E402

import chip_smoke  # noqa: E402  (the repository root is on the path via _common)

SHAPES = [("l14_336_serve", 64, 16, 577, 64, False), ("l14_336_attrib", 32, 16, 577, 64, False),
          ("causal", 8, 16, 577, 64, True), ("l14_336_attrib_h128", 32, 16, 577, 128, False)]


def fwd(lib, q, k, v, seg, causal):
    B, N, Tp, H = q.shape
    z = torch.empty_like(q)
    lse = torch.empty(B, N, Tp, dtype=torch.float32, device=q.device)
    rc = lib.flash_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
                                 z.data_ptr(), lse.data_ptr(), B, N, Tp, H, int(causal), 1, 0,
                                 torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"flash_attention_fwd: CUDA error {rc}")
    return z, lse


def bwd(lib, which, q, k, v, seg, dz, lse, dsum, causal):
    B, N, Tp, H = q.shape
    outs = [torch.empty_like(q)] if which else [torch.empty_like(k), torch.empty_like(v)]
    ptrs = [outs[0].data_ptr(), 0, 0] if which else [0, outs[0].data_ptr(), outs[1].data_ptr()]
    rc = lib.flash_attention_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), dz.data_ptr(),
                                 seg.data_ptr(), lse.data_ptr(), dsum.data_ptr(), *ptrs, B, N, Tp,
                                 H, int(causal), which, 1, 0,
                                 torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"flash_attention_bwd: CUDA error {rc}")
    return outs


def ptxas_tc(name):
    """Registers and spill bytes of a version's Hopper kernels, and ptxas's
    warnings that it serialized their wgmma instructions."""
    out, fn = {"serialized": []}, None
    for line in (BUILD / f"{name}.log").read_text().splitlines():
        if "wgmma" in line and "serialized" in line:
            out["serialized"].append(line.strip()[-160:])
        m = re.search(r"Function properties for \S*?((?:fwd|bwd_dkv|bwd_dq)_tc_kernelILi\d+E)", line)
        if "Function properties for" in line:
            fn = m.group(1) if m else None
        elif fn and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            out[fn] = {"spill_bytes": int(m.group(1)) + int(m.group(2))}
        elif fn and (m := re.search(r"Used (\d+) registers", line)):
            out[fn]["registers"] = int(m.group(1))
    return out


def main():
    from vit_prisma_tpu_torch.ops import _build
    from vit_prisma_tpu_torch.ops import attention as A
    others = [Path(a) for a in sys.argv[1:]]
    procs = [start_build(src, f"flash_{i}") for i, src in enumerate(others)]
    package = _build.load_library()
    versions = {"package": {"fwd": package, "bwd": package}}
    p, n = ctypes.c_void_p, ctypes.c_int
    for i, (src, proc) in enumerate(zip(others, procs)):
        lib = finish_build(proc, f"flash_{i}")
        print(json.dumps({"version": src.stem, "ptxas": ptxas_tc(f"flash_{i}")}))
        if lib is None:
            continue
        v = dict(versions["package"])
        if hasattr(lib, "flash_attention_fwd"):
            lib.flash_attention_fwd.argtypes = [p] * 6 + [n] * 7 + [p]
            v["fwd"] = lib
        if hasattr(lib, "flash_attention_bwd"):
            lib.flash_attention_bwd.argtypes = [p] * 10 + [n] * 8 + [p]
            v["bwd"] = lib
        versions[src.stem] = v
    names = list(versions)
    print(json.dumps({"card": card(), "versions": names}))
    g = torch.Generator(device="cuda").manual_seed(12)
    for name, B, N, T, H, causal in SHAPES:
        q, k, v, dz, seg = chip_smoke._flash_inputs(g, B, N, T, H, torch.bfloat16)
        want_z = A.flash_attention_padded_reference(q, k, v, seg, causal)
        lse = A.flash_lse_reference(q, k, seg, causal)
        dsum = A.flash_dsum(want_z, dz)
        args = (q, k, v, seg, dz, lse, dsum, causal)
        want = {"fwd": [want_z], "bwd_dkv": list(A.flash_attention_padded_bwd_dkv_reference(*args)),
                "bwd_dq": [A.flash_attention_padded_bwd_dq_reference(*args)]}
        calls = {"fwd": lambda vs: [fwd(vs["fwd"], q, k, v, seg, causal)[0]],
                 "bwd_dkv": lambda vs: bwd(vs["bwd"], 0, *args),
                 "bwd_dq": lambda vs: bwd(vs["bwd"], 1, *args)}
        rec = {"shape": name, "B": B, "N": N, "T": T, "H": H, "causal": causal, "rel_tol": 2e-2,
               "rel_err": {}, "equal": {}, "ms": {}}
        for part, call in calls.items():
            outs = {nm: call(vs) for nm, vs in versions.items()}
            rec["rel_err"][part] = {nm: max((a.float() - w.float()).abs().max().item()
                                            / max(1.0, w.float().abs().max().item())
                                            for a, w in zip(o, want[part]))
                                    for nm, o in outs.items()}
            rec["equal"][part] = {nm: all(torch.equal(a, b) for a, b in zip(o, outs["package"]))
                                  for nm, o in outs.items()}
            t = {nm: [] for nm in names}
            for nm in names + names[::-1]:
                t[nm].append(ms(lambda: call(versions[nm]), iters=20, warmup=3))
            rec["ms"][part] = t
        print(json.dumps(rec))
        del q, k, v, dz, seg, want_z, lse, dsum, args, want
    return 0


if __name__ == "__main__":
    sys.exit(main())
