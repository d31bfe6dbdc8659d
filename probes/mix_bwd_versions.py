"""B2 (``attention_mix_tnh_bwd``) as the package builds it against other
versions of ``csrc/attention_mix_tnh_bwd.cu``, each built alone, at the bf16
shapes of chip_smoke.py's grad_kernels phase: error against the plain
version, times from CUDA events in turns (package, others, others reversed,
package), each pass's device time from ``torch.profiler``, and SDPA's
backward beside.  Prints JSON lines.  Run from the repository root on a
CUDA card: ``python3 probes/mix_bwd_versions.py [other.cu ...]``."""

import ctypes
import json
import re
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _common import BUILD, card, finish_build, ms, start_build  # noqa: E402

SHAPES = [("b32", 256, 50, 12, 64, False), ("l14", 48, 257, 16, 64, False),
          ("text_causal", 256, 77, 8, 64, True), ("gate_edge", 4, 411, 2, 64, False),
          ("l14_h88", 48, 257, 16, 88, False)]
REL = 2e-2  # chip_smoke.py's GRAD_KERNEL_REL in bf16


def run(lib, q, k, v, dz, n_heads, causal):
    B, T, NH = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stats = torch.empty(B, n_heads, 3, T, dtype=torch.float32, device=q.device)
    rc = lib.attention_mix_tnh_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), dz.data_ptr(),
                                   dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
                                   B, T, n_heads, NH // n_heads, int(causal), 1, 0,
                                   torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"attention_mix_tnh_bwd: CUDA error {rc}")
    return dq, dk, dv


def passes_ms(fn, calls=10):
    """Device time a call of each pass (rows, cols), from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {"rows": 0.0, "cols": 0.0}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for p in out:
                if f"bwd_{p}" in e.key:
                    out[p] += e.device_time_total / 1000.0 / calls
    return out


def ptxas_tc(name):
    """Registers and spill bytes of the bf16 passes' H 64 instantiations
    from a version's build log."""
    out, fn = {}, None
    for line in (BUILD / f"{name}.log").read_text().splitlines():
        m = re.search(r"Function properties for \S*(bwd_(?:rows|cols)_tc_kernel)ILi64E", line)
        if "Function properties for" in line:
            fn = m.group(1) if m else None
        elif fn and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            out[fn] = {"spill_bytes": int(m.group(1)) + int(m.group(2))}
        elif fn and (m := re.search(r"Used (\d+) registers", line)):
            out[fn]["registers"] = int(m.group(1))
    return out


def main():
    from vit_prisma_tpu_torch.ops import _build
    from vit_prisma_tpu_torch.ops.attention import attention_mix_tnh_bwd_reference
    others = [Path(a) for a in sys.argv[1:]]
    procs = [start_build(src, f"mix_bwd_{i}") for i, src in enumerate(others)]
    libs = {"package": _build.load_library()}
    for i, (src, proc) in enumerate(zip(others, procs)):
        lib = finish_build(proc, f"mix_bwd_{i}")
        print(json.dumps({"version": src.stem, "ptxas": ptxas_tc(f"mix_bwd_{i}")}))
        if lib is not None:
            p, n = ctypes.c_void_p, ctypes.c_int
            lib.attention_mix_tnh_bwd.argtypes = [p] * 8 + [n] * 7 + [p]
            libs[src.stem] = lib
    print(json.dumps({"card": card(), "versions": list(libs)}))
    g = torch.Generator(device="cuda").manual_seed(4)
    names = list(libs)
    for name, B, T, N, H, causal in SHAPES:
        shape = (B, T, N * H)
        q = (torch.randn(shape, generator=g, device="cuda") * H ** -0.5).bfloat16()
        k, v, dz = (torch.randn(shape, generator=g, device="cuda").bfloat16() for _ in range(3))
        want = attention_mix_tnh_bwd_reference(q, k, v, dz, N, causal)
        errs = {}
        for n, lib in libs.items():
            got = run(lib, q, k, v, dz, N, causal)
            errs[n] = max((a.float() - b.float()).abs().max().item()
                          / max(1.0, b.float().abs().max().item()) for a, b in zip(got, want))
        t = {n: [] for n in names}
        for n in names + names[::-1]:
            t[n].append(ms(lambda: run(libs[n], q, k, v, dz, N, causal), iters=20, warmup=3))
        qh, kh, vh, dzh = (a.reshape(B, T, N, H).transpose(1, 2).contiguous() for a in (q, k, v, dz))
        leaves = [a.requires_grad_(True) for a in (qh, kh, vh)]
        out = torch.nn.functional.scaled_dot_product_attention(*leaves, is_causal=causal, scale=1.0)
        library = ms(lambda: torch.autograd.grad(out, leaves, dzh, retain_graph=True),
                     iters=20, warmup=3)
        print(json.dumps({
            "shape": name, "B": B, "T": T, "N": N, "H": H, "causal": causal,
            "rel_err": errs, "rel_tol": REL, "ms": t, "library_ms": library,
            "pass_ms": {n: passes_ms(lambda: run(libs[n], q, k, v, dz, N, causal))
                        for n in names}}))
        del q, k, v, dz, want, qh, kh, vh, dzh, leaves, out
    return 0


if __name__ == "__main__":
    sys.exit(main())
