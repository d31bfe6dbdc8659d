"""B4 and B6 in bf16 on their two tensor-core routes, called through the
package's library: the wgmma/TMA kernels (``sae_fused_fwd_tc``,
``sae_fused_bwd_stored_tc``; and those of other ``sae_fused_tc.cu`` files
given as paths, each built alone and named by its directory; a header
copied beside one is included in place of the package's) against the
mma.sync tiles (``sae_fused_fwd``,
``sae_fused_bwd`` in its stored mode) and the plain versions, at a small
shape, the TopK slice's and the sweep's: every output's error against the
plain version, nact against the kernel's own mask, two calls equal to the
bit, times from CUDA events in turns (tc, mma.sync, mma.sync, tc), the bf16
cuBLAS products alone beside them, each wgmma version's device time by
kernel (``torch.profiler``), and ptxas's record of the new kernels.
Prints JSON lines.  Run from the repository root on a CUDA card:
``python3 probes/sae_tc_versions.py [dir/sae_fused_tc.cu ...]``; a
version whose ``sae_wgmma.cuh`` copy sets ``kBN = 128`` is named with
``bn128`` in its directory's name."""

import ctypes
import json
import re
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _common import BUILD, card, finish_build, ms, start_build  # noqa: E402

SHAPES = [("small", 2, 256, 256, 512), ("topk_slice", 1, 4096, 768, 12288),
          ("sweep", 24, 4096, 1024, 8192)]
REL = 2.0 ** -7      # bf16 y and hc against the plain version (chip_smoke SAE_REL)
GRAD_REL = 2e-3      # grads (chip_smoke SAE_GRAD_REL)
L1_REL = 1e-5


def inputs(g, L, B, D, S):
    r = lambda *shape, sc=1.0: (torch.randn(*shape, generator=g, device="cuda") * sc).bfloat16()
    return (r(L, B, D), r(L, D, S, sc=D ** -0.5), r(L, S, sc=0.01), r(L, S, D, sc=D ** -0.5),
            r(L, D, sc=0.1), r(L, B, D, sc=1e-3), torch.rand(L, generator=g, device="cuda") * 1e-3)


def fwd(lib, tc, x, We, be, Wd, bd, bn=256):
    L, B, D = x.shape
    S = We.shape[-1]
    new = lambda *s, dtype=torch.bfloat16: torch.empty(s, dtype=dtype, device="cuda")
    xc, hc, y = new(L, B, D), new(L, B, S), new(L, B, D)
    nact_p = new(L, B // 128, S, dtype=torch.float32)
    # one l1 partial a block tile: S / bn of them (S / 128 on the mma.sync route)
    l1_p = new(L, B // 128, S // (bn if tc else 128), dtype=torch.float32)
    ptrs = [t.data_ptr() for t in (x, We, be, Wd, bd, xc, hc, y, nact_p, l1_p)]
    stream = torch.cuda.current_stream().cuda_stream
    rc = (lib.sae_fused_fwd_tc(*ptrs, L, B, D, S, 0, stream) if tc
          else lib.sae_fused_fwd(*ptrs, L, B, D, S, 1, 0, stream))
    if rc:
        raise RuntimeError(f"forward ({'tc' if tc else 'mma.sync'}): CUDA error {rc}")
    return y, l1_p.sum(dim=(1, 2)), nact_p.sum(dim=1), hc


def bwd(lib, tc, x, hc, Wd, bd, dy, dl1):
    L, B, D = x.shape
    S = hc.shape[-1]
    new = lambda *s, dtype=torch.bfloat16: torch.empty(s, dtype=dtype, device="cuda")
    xc, dhc = new(L, B, D), new(L, B, S)
    dWe, dWd = new(L, D, S, dtype=torch.float32), new(L, S, D, dtype=torch.float32)
    dbe_p = new(L, B // 128, S, dtype=torch.float32)
    stream = torch.cuda.current_stream().cuda_stream
    if tc:
        rc = lib.sae_fused_bwd_stored_tc(*[t.data_ptr() for t in (
            x, hc, Wd, bd, dy, dl1, xc, dhc, dWe, dWd, dbe_p)], L, B, D, S, 0, stream)
    else:  # B6's mode of sae_fused_bwd: W_enc and b_enc are not read
        rc = lib.sae_fused_bwd(*[t.data_ptr() for t in (x, hc, hc, Wd, bd, dy, dl1)], None,
                               *[t.data_ptr() for t in (hc, xc, dhc, dWe, dWd, dbe_p)],
                               L, B, D, S, 1, 0, 0, stream)
    if rc:
        raise RuntimeError(f"backward ({'tc' if tc else 'mma.sync'}): CUDA error {rc}")
    return dWe, dWd, dbe_p.sum(dim=1)


def by_kernel(fn, calls=5):
    """Device milliseconds a call by kernel name, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key[:70]: e.device_time_total / calls / 1000.0 for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0}


def err(a, b):
    return (a.float() - b.float()).abs().max().item()


def ptxas(log: Path):
    out, name = {}, None
    for line in log.read_text().splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1) if "sae_tc_kernel" in m.group(1) else None
        elif name:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                out[name] = {"spill_bytes": int(m.group(1)) + int(m.group(2))}
            m = re.search(r"Used (\d+) registers", line)
            if m and name in out:
                out[name]["registers"] = int(m.group(1))
    out["serialized"] = sorted({m.group(1) for line in log.read_text().splitlines()
                                if (m := re.search(r"wgmma.mma_async instructions are "
                                                   r"serialized.*'(\S+)'", line))})
    return out


def main():
    from vit_prisma_tpu_torch.ops import _build
    from vit_prisma_tpu_torch.ops import sae_step as S
    procs = {Path(a).parent.name: start_build(Path(a), f"sae_tc_{Path(a).parent.name}")
             for a in sys.argv[1:]}
    lib = _build.load_library()
    tcs = {"tc": lib}
    for v, proc in procs.items():
        other = finish_build(proc, f"sae_tc_{v}")
        if other is not None:
            p, i = ctypes.c_void_p, ctypes.c_int
            other.sae_fused_fwd_tc.argtypes = [p] * 10 + [i] * 5 + [p]
            other.sae_fused_bwd_stored_tc.argtypes = [p] * 11 + [i] * 5 + [p]
            tcs[v] = other
    print(json.dumps({"card": card(), "versions": list(tcs) + ["mma_sync"],
                      "ptxas": ptxas(_build.build_dir() / "nvcc.log")}), flush=True)
    for v in tcs:
        if v != "tc":
            print(json.dumps({f"{v}_ptxas": ptxas(BUILD / f"sae_tc_{v}.log")}), flush=True)
    g = torch.Generator(device="cuda").manual_seed(4)
    for name, L, B, D, Sd in SHAPES:
        x, We, be, Wd, bd, dy, dl1 = inputs(g, L, B, D, Sd)
        rec = {"shape": name, "L": L, "B": B, "d_in": D, "d_sae": Sd,
               "route": S.sae_gemm_route(B, D, Sd, torch.bfloat16)}
        yr, l1r, nactr, hcr = S.sae_fused_forward_reference(x, We, be, Wd, bd, save_h=True)
        for v, vlib in tcs.items():
            bn = 128 if "bn128" in v else 256
            y, l1, nact, hc = fwd(vlib, True, x, We, be, Wd, bd, bn)
            again = fwd(vlib, True, x, We, be, Wd, bd, bn)
            torch.cuda.synchronize()
            own = (hc.float() > 0).sum(dim=1, dtype=torch.float32)
            f = {"y": err(y, yr), "y_tol": REL * yr.float().abs().max().item(),
                 "hc": err(hc, hcr), "hc_tol": REL * hcr.float().abs().max().item(),
                 "l1_rel": ((l1 - l1r).abs() / l1r.abs()).max().item(),
                 "nact_minus_own_mask": (nact - own).abs().max().item(),
                 "nact_abs_diff_sum_vs_plain": (nact - nactr).abs().sum().item(),
                 "bitwise_repeat": all(torch.equal(a, b) for a, b in zip((y, l1, nact, hc), again))}
            f["ok"] = (f["y"] <= f["y_tol"] and f["hc"] <= f["hc_tol"] and f["l1_rel"] <= L1_REL
                       and f["nact_minus_own_mask"] == 0 and f["bitwise_repeat"])
            rec[f"{v}_forward"] = f
            dW = bwd(vlib, True, x, hc, Wd, bd, dy, dl1)
            dW2 = bwd(vlib, True, x, hc, Wd, bd, dy, dl1)
            want = S.sae_fused_backward_stored_reference(x, hc, Wd, bd, dy, dl1)
            torch.cuda.synchronize()
            b = {k: {"err": err(a, w), "tol": GRAD_REL * w.abs().max().item()}
                 for k, a, w in zip(("dW_enc", "dW_dec", "db_enc"), dW, want)}
            b["bitwise_repeat"] = all(torch.equal(a, c) for a, c in zip(dW, dW2))
            b["ok"] = b["bitwise_repeat"] and all(e["err"] <= e["tol"] for k, e in b.items()
                                                   if isinstance(e, dict))
            rec[f"{v}_backward"] = b
            del y, l1, nact, again, dW, dW2, want
        hc = fwd(lib, True, x, We, be, Wd, bd)[3]
        flop = 2 * L * B * D * Sd
        xc = x - bd[:, None]
        dhc = torch.empty_like(hc)
        t = {}
        order = list(tcs) + ["mma_sync"]
        for v in order + order[::-1]:
            vlib, tc = (lib, False) if v == "mma_sync" else (tcs[v], True)
            t.setdefault(f"{v}_fwd_ms", []).append(
                ms(lambda: fwd(vlib, tc, x, We, be, Wd, bd, 128 if "bn128" in v else 256),
                   iters=5, warmup=1))
            t.setdefault(f"{v}_bwd_ms", []).append(
                ms(lambda: bwd(vlib, tc, x, hc, Wd, bd, dy, dl1), iters=5, warmup=1))
        t["cublas_fwd_products_ms"] = ms(lambda: (torch.matmul(xc, We), torch.matmul(hc, Wd)),
                                         iters=5, warmup=1)
        t["cublas_bwd_products_ms"] = ms(
            lambda: (torch.matmul(dy, Wd.transpose(1, 2)), torch.matmul(xc.transpose(1, 2), dhc),
                     torch.matmul(hc.transpose(1, 2), dy)), iters=5, warmup=1)
        for k in list(t):
            if isinstance(t[k], list):
                n_flop = (2 if "fwd" in k else 3) * flop
                t[k.replace("_ms", "_TFLOP_per_s")] = n_flop / min(t[k]) / 1e9
        for v, vlib in tcs.items():
            t[f"{v}_fwd_device_ms_by_kernel"] = by_kernel(
                lambda: fwd(vlib, True, x, We, be, Wd, bd, 128 if "bn128" in v else 256))
            t[f"{v}_bwd_device_ms_by_kernel"] = by_kernel(
                lambda: bwd(vlib, True, x, hc, Wd, bd, dy, dl1))
        rec["times"] = t
        print(json.dumps(rec), flush=True)
        del x, We, be, Wd, bd, dy, dl1, hc, xc, dhc, yr, hcr
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
