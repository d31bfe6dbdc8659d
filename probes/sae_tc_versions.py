"""B4 and B6, the remat B5, the TopK B8 and B9, and the gated B11 and B12,
in bf16 on their two tensor-core routes, called through the package's
library: the wgmma/TMA kernels (``sae_fused_fwd_tc``,
``sae_fused_bwd_stored_tc``, ``sae_fused_bwd_remat_tc``,
``sae_fused_fwd_topk_tc``, ``sae_fused_bwd_topk_tc``, ``sae_gated_fwd_tc``,
``sae_gated_bwd_tc``; and those of other ``sae_fused_tc.cu`` files given as
paths, each built alone and named by its directory; a header copied beside
one is included in place of the package's) against the mma.sync tiles
(``sae_fused_fwd``, ``sae_fused_bwd`` in its stored, ReLU-remat and TopK
modes, ``sae_fused_fwd_topk``, ``sae_fused_fwd_gated``,
``sae_fused_bwd_gated``) and the plain versions, at a small shape, the TopK
(and gated) slice's and the sweep's widths: every output's error against
the plain version, nact against the kernel's own mask, two calls equal to
the bit (and B12's recomputed activations equal to B11's; B5's grads equal
to B6's on B4's hc and B9's from t to B6's on B8's h, to the bit, with B5's
-0 marks counted), times from CUDA events in turns (tc, mma.sync, mma.sync,
tc), the bf16 cuBLAS products alone beside them, each wgmma version's
device time by kernel (``torch.profiler``), and ptxas's record of the new
kernels.  Prints JSON lines.  Run from the repository root on a CUDA card:
``python3 probes/sae_tc_versions.py [--only relu|gated|remat|topk]
[dir/sae_fused_tc.cu ...]``; a version whose ``sae_wgmma.cuh`` copy sets
``kBN = 128`` is named with ``bn128`` in its directory's name (B4 and B6
only)."""

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
# the gated kernels: the gated slice (bench.py:177-180) and two layers at
# the sweep's widths, as chip_smoke.py's phase 13
GATED_SHAPES = [("small", 2, 256, 256, 512), ("gated_slice", 1, 4096, 768, 12288),
                ("sweep_width", 2, 4096, 1024, 8192)]
# the TopK kernels, with k: a small shape, the TopK slice (bench.py:164-171)
# and the sweep's widths, as chip_smoke.py's phase 8
TOPK_SHAPES = [("small", 2, 256, 256, 512, 16), ("topk_slice", 1, 4096, 768, 12288, 64),
               ("sweep", 24, 4096, 1024, 8192, 64)]
FLIP_FRAC = 1e-4     # gate and magnitude flips against the plain version (GATED_FLIP_FRAC)
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


def remat_bwd(lib, tc, x, We, be, Wd, bd, dy, dl1):
    """B5 by its C entry: (dW_enc, dW_dec, db_enc) and the recomputed hc
    (on the wgmma route with its -0 marks)."""
    L, B, D = x.shape
    S = We.shape[-1]
    new = lambda *s, dtype=torch.bfloat16: torch.empty(s, dtype=dtype, device="cuda")
    xc, hc, dhc = new(L, B, D), new(L, B, S), new(L, B, S)
    dWe, dWd = new(L, D, S, dtype=torch.float32), new(L, S, D, dtype=torch.float32)
    dbe_p = new(L, B // 128, S, dtype=torch.float32)
    ins = [t.data_ptr() for t in (x, We, be, Wd, bd, dy, dl1)]
    stream = torch.cuda.current_stream().cuda_stream
    if tc:
        rc = lib.sae_fused_bwd_remat_tc(*ins, *[t.data_ptr() for t in (
            xc, hc, dhc, dWe, dWd, dbe_p)], L, B, D, S, 0, stream)
    else:  # B5's mode of sae_fused_bwd
        rc = lib.sae_fused_bwd(*ins, None, *[t.data_ptr() for t in (hc, xc, dhc, dWe, dWd, dbe_p)],
                               L, B, D, S, 1, 1, 0, stream)
    if rc:
        raise RuntimeError(f"remat backward ({'tc' if tc else 'mma.sync'}): CUDA error {rc}")
    return (dWe, dWd, dbe_p.sum(dim=1)), hc


def topk_fwd(lib, tc, x, We, be, Wd, bd, k):
    """B8 by its C entry: y, l1, nact, t, h."""
    L, B, D = x.shape
    S = We.shape[-1]
    new = lambda *s, dtype=torch.bfloat16: torch.empty(s, dtype=dtype, device="cuda")
    xc, h, y = new(L, B, D), new(L, B, S), new(L, B, D)
    t = new(L, B, 1, dtype=torch.float32)
    nact_p = new(L, B // 128, S, dtype=torch.float32)
    l1_p = new(L, B // 128, S // 128, dtype=torch.float32)
    ptrs = [v.data_ptr() for v in (x, We, be, Wd, bd, xc, h, y, t, nact_p, l1_p)]
    stream = torch.cuda.current_stream().cuda_stream
    rc = (lib.sae_fused_fwd_topk_tc(*ptrs, L, B, D, S, k, 0, stream) if tc
          else lib.sae_fused_fwd_topk(*ptrs, L, B, D, S, k, 1, 0, stream))
    if rc:
        raise RuntimeError(f"TopK forward ({'tc' if tc else 'mma.sync'}): CUDA error {rc}")
    return y, l1_p.sum(dim=(1, 2)), nact_p.sum(dim=1), t, h


def topk_bwd(lib, tc, x, We, be, Wd, bd, dy, dl1, t):
    """B9 by its C entry: (dW_enc, dW_dec, db_enc)."""
    L, B, D = x.shape
    S = We.shape[-1]
    new = lambda *s, dtype=torch.bfloat16: torch.empty(s, dtype=dtype, device="cuda")
    xc, h, dhc = new(L, B, D), new(L, B, S), new(L, B, S)
    dWe, dWd = new(L, D, S, dtype=torch.float32), new(L, S, D, dtype=torch.float32)
    dbe_p = new(L, B // 128, S, dtype=torch.float32)
    ins = [v.data_ptr() for v in (x, We, be, Wd, bd, dy, dl1, t)]
    stream = torch.cuda.current_stream().cuda_stream
    if tc:
        rc = lib.sae_fused_bwd_topk_tc(*ins, *[v.data_ptr() for v in (
            xc, h, dhc, dWe, dWd, dbe_p)], L, B, D, S, 0, stream)
    else:  # B9's mode of sae_fused_bwd
        rc = lib.sae_fused_bwd(*ins, *[v.data_ptr() for v in (h, xc, dhc, dWe, dWd, dbe_p)],
                               L, B, D, S, 1, 2, 0, stream)
    if rc:
        raise RuntimeError(f"TopK backward ({'tc' if tc else 'mma.sync'}): CUDA error {rc}")
    return dWe, dWd, dbe_p.sum(dim=1)


def gated_inputs(g, L, B, D, S):
    x, We, bg, Wd, bd, dy, dl1 = inputs(g, L, B, D, S)
    r = lambda *shape, sc: (torch.randn(*shape, generator=g, device="cuda") * sc).bfloat16()
    rmag, bm, dvia = r(L, S, sc=0.1), r(L, S, sc=0.01), r(L, B, D, sc=1e-3)
    return (x, We, bg, rmag, bm, Wd, bd), dy, dvia, dl1


def gated_fwd(lib, tc, args, e, wdn, bn=256):
    """B11 by its C entry (e and wdn hoisted, as the wrapper hoists them):
    y, via, l1, nact, h, hga."""
    x, We, bg, rmag, bm, Wd, bd = args
    L, B, D = x.shape
    S = We.shape[-1]
    new = lambda *s, dtype=torch.bfloat16: torch.empty(s, dtype=dtype, device="cuda")
    xc, h, y = new(L, B, D), new(L, 2 * B, S), new(L, 2 * B, D)
    nact_p = new(L, B // 128, S, dtype=torch.float32)
    l1_p = new(L, B // 128, S // (bn if tc else 128), dtype=torch.float32)
    ptrs = [t.data_ptr() for t in (x, We, bg, e, bm, Wd, bd, wdn, xc, h, y, nact_p, l1_p)]
    stream = torch.cuda.current_stream().cuda_stream
    rc = (lib.sae_gated_fwd_tc(*ptrs, L, B, D, S, 0, stream) if tc
          else lib.sae_fused_fwd_gated(*ptrs, L, B, D, S, 1, 0, stream))
    if rc:
        raise RuntimeError(f"gated forward ({'tc' if tc else 'mma.sync'}): CUDA error {rc}")
    return y[:, :B], y[:, B:], l1_p.sum(dim=(1, 2)), nact_p.sum(dim=1), h[:, :B], h[:, B:]


def gated_bwd(lib, tc, args, e, wdn, dy, dvia, dl1):
    """B12 by its C entry: (dW_enc, dW_dec, db_gate, db_mag, dr_mag), and
    the recomputed h and hga."""
    x, We, bg, rmag, bm, Wd, bd = args
    L, B, D = x.shape
    S = We.shape[-1]
    new = lambda *s, dtype=torch.bfloat16: torch.empty(s, dtype=dtype, device="cuda")
    f32 = torch.float32
    xc, dgc = new(L, B, D), new(L, B, S)
    part, sums = new(4, L, B // 128, S, dtype=f32), new(4, L, S, dtype=f32)
    dWe, dWd = new(L, D, S, dtype=f32), new(L, S, D, dtype=f32)
    ins = [t.data_ptr() for t in (x, We, bg, e, bm, Wd, bd, wdn, dy, dvia, dl1, xc)]
    outs = [t.data_ptr() for t in (dgc, part, sums, dWe, dWd)]
    stream = torch.cuda.current_stream().cuda_stream
    if tc:
        h, g = new(L, 2 * B, S), new(L, B, S, dtype=f32)
        rc = lib.sae_gated_bwd_tc(*ins, h.data_ptr(), g.data_ptr(), *outs, L, B, D, S, 0, stream)
        hc, hgac = h[:, :B], h[:, B:]
    else:
        hc, hgac = new(L, B, S), new(L, B, S)
        rc = lib.sae_fused_bwd_gated(*ins, hc.data_ptr(), hgac.data_ptr(), *outs, L, B, D, S, 1,
                                     0, stream)
    if rc:
        raise RuntimeError(f"gated backward ({'tc' if tc else 'mma.sync'}): CUDA error {rc}")
    return (dWe, dWd, sums[1], sums[2], sums[3] * e), (hc, hgac)


def by_kernel(fn, calls=5):
    """Device milliseconds a call by kernel name, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}  # by name, cut where it would hide a kernel's template arguments
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0:
            key = e.key[:110]
            out[key] = out.get(key, 0.0) + e.device_time_total / calls / 1000.0
    return out


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


def relu_shapes(lib, tcs, S):
    """B4 and B6 on every version at SHAPES."""
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


def turns(order, calls, t):
    """Each call of ``calls`` (name -> {version: fn}) timed by CUDA events for
    every version in ``order``, then in reverse order, into t[name_version_ms]."""
    for v in order + order[::-1]:
        for name, fns in calls.items():
            t.setdefault(f"{v}_{name}_ms", []).append(ms(fns[v], iters=5, warmup=1))


def remat_shapes(lib, tcs, S):
    """B5 on every version and the mma.sync tiles at SHAPES; on the wgmma
    route its grads against B6's on B4's hc, and its -0 marks counted."""
    g = torch.Generator(device="cuda").manual_seed(4)
    for name, L, B, D, Sd in SHAPES:
        x, We, be, Wd, bd, dy, dl1 = inputs(g, L, B, D, Sd)
        rec = {"shape": name, "kernels": "remat", "L": L, "B": B, "d_in": D, "d_sae": Sd,
               "route": S.sae_gemm_route(B, D, Sd, torch.bfloat16)}
        want = S.sae_fused_backward_reference(x, We, be, Wd, bd, dy, dl1)
        order = list(tcs) + ["mma_sync"]
        for v in order:
            vlib, tc = (lib, False) if v == "mma_sync" else (tcs[v], True)
            grads, hc = remat_bwd(vlib, tc, x, We, be, Wd, bd, dy, dl1)
            grads2, _ = remat_bwd(vlib, tc, x, We, be, Wd, bd, dy, dl1)
            torch.cuda.synchronize()
            b = {k: {"err": err(a, w), "tol": GRAD_REL * w.abs().max().item()}
                 for k, a, w in zip(("dW_enc", "dW_dec", "db_enc"), grads, want)}
            b["bitwise_repeat"] = all(torch.equal(a, c) for a, c in zip(grads, grads2))
            if tc:
                # B4's hc from the same mainloop; B6 on it gives B5's grads
                # wherever no entry carries a -0 mark
                hc4 = fwd(vlib, True, x, We, be, Wd, bd)[3]
                marks = hc.view(torch.int16) == -32768
                b["minus_zero_marks"] = int(marks.sum())
                b["hc_is_b4_hc_but_marks"] = torch.equal(torch.where(marks, 0, hc.view(
                    torch.int16)), hc4.view(torch.int16))
                b6 = bwd(vlib, True, x, hc4, Wd, bd, dy, dl1)
                torch.cuda.synchronize()
                b["equals_b6_on_b4_hc"] = all(torch.equal(a, c) for a, c in zip(grads, b6))
                del hc4, b6
            rec[f"{v}_backward"] = b
            del grads, grads2, hc
        hc = fwd(lib, True, x, We, be, Wd, bd)[3]
        xc = x - bd[:, None]
        dhc = torch.empty_like(hc)
        t = {}
        turns(order, {"bwd": {v: (lambda vl=(lib if v == "mma_sync" else tcs[v]),
                                  tc=v != "mma_sync": remat_bwd(vl, tc, x, We, be, Wd, bd, dy,
                                                                dl1))
                              for v in order}}, t)
        t["cublas_bwd_products_ms"] = ms(
            lambda: (torch.matmul(xc, We), torch.matmul(dy, Wd.transpose(1, 2)),
                     torch.matmul(xc.transpose(1, 2), dhc), torch.matmul(hc.transpose(1, 2), dy)),
            iters=5, warmup=1)
        flop = 2 * L * B * D * Sd
        for k in list(t):
            t[k.replace("_ms", "_TFLOP_per_s")] = 4 * flop / min(t[k] if isinstance(t[k], list)
                                                                  else [t[k]]) / 1e9
        for v in tcs:
            t[f"{v}_bwd_device_ms_by_kernel"] = by_kernel(
                lambda: remat_bwd(tcs[v], True, x, We, be, Wd, bd, dy, dl1))
        rec["times"] = t
        print(json.dumps(rec), flush=True)
        del x, We, be, Wd, bd, dy, dl1, hc, xc, dhc, want
        torch.cuda.empty_cache()


def topk_shapes(lib, tcs, S):
    """B8 and B9 on every version and the mma.sync tiles at TOPK_SHAPES: t
    the k-th of the kernel's own h, masks that differ from the plain
    version's counted, y outside the rows with a flip, nact against the own
    mask, B9 from t against B6 on h (the same route) to the bit."""
    g = torch.Generator(device="cuda").manual_seed(7)
    for name, L, B, D, Sd, k in TOPK_SHAPES:
        x, We, be, Wd, bd, dy, dl1 = inputs(g, L, B, D, Sd)
        rec = {"shape": name, "kernels": "topk", "L": L, "B": B, "d_in": D, "d_sae": Sd, "k": k,
               "route": S.sae_gemm_route(B, D, Sd, torch.bfloat16)}
        yr, l1r, nactr, tr, hr = S.sae_fused_forward_topk_reference(x, We, be, Wd, bd, k, True)
        order = list(tcs) + ["mma_sync"]
        ts = {}
        for v in order:
            vlib, tc = (lib, False) if v == "mma_sync" else (tcs[v], True)
            y, l1, nact, t, h = topk_fwd(vlib, tc, x, We, be, Wd, bd, k)
            again = topk_fwd(vlib, tc, x, We, be, Wd, bd, k)
            dW9 = topk_bwd(vlib, tc, x, We, be, Wd, bd, dy, dl1, t)
            dW9b = topk_bwd(vlib, tc, x, We, be, Wd, bd, dy, dl1, t)
            # B6 on B8's h, on the same route
            dW6 = (bwd(vlib, True, x, h, Wd, bd, dy, dl1) if tc else
                   bwd(lib, False, x, h, Wd, bd, dy, dl1))
            torch.cuda.synchronize()
            mask = h.float() > 0
            flip = mask != (hr.float() > 0)
            rows = flip.any(dim=-1)
            ye = (y.float() - yr.float()).abs()[~rows]
            f = {"y_unflipped_rows": ye.max().item() if ye.numel() else None,
                 "y_tol": REL * yr.float().abs().max().item(),
                 "mask_flips": int(flip.sum()), "rows_with_flips": int(rows.sum()),
                 "t_rows_differ_from_plain": int((t != tr).sum()),
                 "t_is_k_th_of_own_h": torch.equal(t, S._row_threshold(h, k)),
                 "nact_minus_own_mask": (nact - mask.sum(dim=1, dtype=torch.float32))
                 .abs().max().item(),
                 "l1_abs_err": (l1 - l1r).abs().max().item(),
                 "bitwise_repeat": all(torch.equal(a, c) for a, c in
                                       zip((y, l1, nact, t, h), again)),
                 "b9_bitwise_repeat": all(torch.equal(a, c) for a, c in zip(dW9, dW9b)),
                 "b9_from_t_equals_b6_on_h": all(torch.equal(a, c) for a, c in zip(dW9, dW6))}
            f["ok"] = (f["t_is_k_th_of_own_h"] and f["nact_minus_own_mask"] == 0
                       and f["bitwise_repeat"] and f["b9_bitwise_repeat"]
                       and f["b9_from_t_equals_b6_on_h"] and f["mask_flips"] <= FLIP_FRAC
                       * h.numel())
            rec[f"{v}_topk"] = f
            ts[v] = t
            del y, l1, nact, h, again, dW9, dW9b, dW6
        tt = {}
        fwd_fns = {v: (lambda vl=(lib if v == "mma_sync" else tcs[v]), tc=v != "mma_sync":
                       topk_fwd(vl, tc, x, We, be, Wd, bd, k)) for v in order}
        bwd_fns = {v: (lambda vl=(lib if v == "mma_sync" else tcs[v]), tc=v != "mma_sync",
                       t=ts[v]: topk_bwd(vl, tc, x, We, be, Wd, bd, dy, dl1, t)) for v in order}
        turns(order, {"fwd": fwd_fns, "bwd": bwd_fns}, tt)
        xc = x - bd[:, None]
        dhc = torch.empty_like(hr)
        tt["cublas_fwd_products_ms"] = ms(lambda: (torch.matmul(xc, We), torch.matmul(hr, Wd)),
                                          iters=5, warmup=1)
        tt["cublas_bwd_products_ms"] = ms(
            lambda: (torch.matmul(xc, We), torch.matmul(dy, Wd.transpose(1, 2)),
                     torch.matmul(xc.transpose(1, 2), dhc), torch.matmul(hr.transpose(1, 2), dy)),
            iters=5, warmup=1)
        flop = 2 * L * B * D * Sd
        for key in list(tt):
            vals = tt[key] if isinstance(tt[key], list) else [tt[key]]
            tt[key.replace("_ms", "_TFLOP_per_s")] = (2 if "fwd" in key else 4) * flop \
                / min(vals) / 1e9
        for v in tcs:
            tt[f"{v}_fwd_device_ms_by_kernel"] = by_kernel(fwd_fns[v])
            tt[f"{v}_bwd_device_ms_by_kernel"] = by_kernel(bwd_fns[v])
        rec["times"] = tt
        print(json.dumps(rec), flush=True)
        del x, We, be, Wd, bd, dy, dl1, yr, hr, tr, xc, dhc, ts
        torch.cuda.empty_cache()


def gated_shapes(lib, tcs, S):
    """B11 and B12 on every version and the mma.sync tiles at GATED_SHAPES."""
    g = torch.Generator(device="cuda").manual_seed(8)
    for name, L, B, D, Sd in GATED_SHAPES:
        args, dy, dvia, dl1 = gated_inputs(g, L, B, D, Sd)
        e, wdn = S._gated_hoisted_card(args[3], args[5])
        rec = {"shape": name, "kernels": "gated", "L": L, "B": B, "d_in": D, "d_sae": Sd,
               "route": S.sae_gemm_route(B, D, Sd, torch.bfloat16)}
        yr, viar, l1r, nactr, hcr, hgacr = S.sae_gated_fused_forward_reference(*args, save_h=True)
        want = S.sae_gated_fused_backward_reference(*args, dy, dvia, dl1)
        order = list(tcs) + ["mma_sync"]
        bns = {v: 128 if "bn128" in v else 256 for v in order}
        for v in order:
            vlib, tc = (lib, False) if v == "mma_sync" else (tcs[v], True)
            y, via, l1, nact, hc, hgac = gated_fwd(vlib, tc, args, e, wdn, bns[v])
            again = gated_fwd(vlib, tc, args, e, wdn, bns[v])
            grads, acts = gated_bwd(vlib, tc, args, e, wdn, dy, dvia, dl1)
            grads2, _ = gated_bwd(vlib, tc, args, e, wdn, dy, dvia, dl1)
            torch.cuda.synchronize()
            flips = ((hgac.float() > 0) != (hgacr.float() > 0)) | (
                (hc.float() > 0) != (hcr.float() > 0))
            f = {"y": err(y, yr), "y_tol": REL * yr.float().abs().max().item(),
                 "via": err(via, viar), "via_tol": REL * viar.float().abs().max().item(),
                 "mask_flips": int(flips.sum()), "flip_frac": flips.float().mean().item(),
                 "l1_rel": ((l1 - l1r).abs() / l1r.abs()).max().item(),
                 "nact_minus_own_mask": (nact - (hc.float() > 0).sum(
                     dim=1, dtype=torch.float32)).abs().max().item(),
                 "bitwise_repeat": all(torch.equal(a, b) for a, b in
                                       zip((y, via, l1, nact, hc, hgac), again)),
                 "b12_acts_equal_b11": torch.equal(acts[0], hc) and torch.equal(acts[1], hgac)}
            b = {k: {"err": err(a, w), "tol": GRAD_REL * w.abs().max().item()}
                 for k, a, w in zip(("dW_enc", "dW_dec", "db_gate", "db_mag", "dr_mag"),
                                    grads, want)}
            b["bitwise_repeat"] = all(torch.equal(a, c) for a, c in zip(grads, grads2))
            f["ok"] = (f["flip_frac"] <= FLIP_FRAC and f["nact_minus_own_mask"] == 0
                       and f["bitwise_repeat"] and f["b12_acts_equal_b11"])
            rec[f"{v}_forward"], rec[f"{v}_backward"] = f, b
            del y, via, l1, nact, hc, hgac, again, grads, grads2, acts
        flop = 2 * L * B * D * Sd
        t = {}
        for v in order + order[::-1]:
            vlib, tc = (lib, False) if v == "mma_sync" else (tcs[v], True)
            t.setdefault(f"{v}_fwd_ms", []).append(
                ms(lambda: gated_fwd(vlib, tc, args, e, wdn, bns[v]), iters=5, warmup=1))
            t.setdefault(f"{v}_bwd_ms", []).append(
                ms(lambda: gated_bwd(vlib, tc, args, e, wdn, dy, dvia, dl1), iters=5, warmup=1))
        x, We, Wd, bd = args[0], args[1], args[5], args[6]
        xc, WdT = x - bd[:, None], Wd.transpose(1, 2)
        t["cublas_fwd_products_ms"] = ms(
            lambda: (torch.matmul(xc, We), torch.matmul(hcr, Wd), torch.matmul(hgacr, Wd)),
            iters=5, warmup=1)
        t["cublas_bwd_products_ms"] = ms(
            lambda: (torch.matmul(xc, We), torch.matmul(dy, WdT), torch.matmul(dvia, WdT),
                     torch.matmul(xc.transpose(1, 2), hgacr), torch.matmul(hcr.transpose(1, 2), dy),
                     torch.matmul(hgacr.transpose(1, 2), dvia)), iters=5, warmup=1)
        for k in list(t):
            if isinstance(t[k], list):
                n_flop = (3 if "fwd" in k else 6) * flop
                t[k.replace("_ms", "_TFLOP_per_s")] = n_flop / min(t[k]) / 1e9
        for v in order:
            vlib, tc = (lib, False) if v == "mma_sync" else (tcs[v], True)
            t[f"{v}_fwd_device_ms_by_kernel"] = by_kernel(
                lambda: gated_fwd(vlib, tc, args, e, wdn, bns[v]))
            t[f"{v}_bwd_device_ms_by_kernel"] = by_kernel(
                lambda: gated_bwd(vlib, tc, args, e, wdn, dy, dvia, dl1))
        rec["times"] = t
        print(json.dumps(rec), flush=True)
        del args, dy, dvia, dl1, e, wdn, yr, viar, hcr, hgacr, want, xc, WdT, x, We, Wd, bd
        torch.cuda.empty_cache()


def main():
    from vit_prisma_tpu_torch.ops import _build
    from vit_prisma_tpu_torch.ops import sae_step as S
    args = sys.argv[1:]
    only = None
    if args and args[0].startswith("--only"):
        only = args[0].split("=", 1)[1] if "=" in args[0] else args[1]
        args = args[1:] if "=" in args[0] else args[2:]
    procs = {Path(a).parent.name: start_build(Path(a), f"sae_tc_{Path(a).parent.name}")
             for a in args}
    lib = _build.load_library()
    tcs = {"tc": lib}
    for v, proc in procs.items():
        other = finish_build(proc, f"sae_tc_{v}")
        if other is not None:
            p, i = ctypes.c_void_p, ctypes.c_int
            other.sae_fused_fwd_tc.argtypes = [p] * 10 + [i] * 5 + [p]
            other.sae_fused_bwd_stored_tc.argtypes = [p] * 11 + [i] * 5 + [p]
            other.sae_gated_fwd_tc.argtypes = [p] * 13 + [i] * 5 + [p]
            other.sae_gated_bwd_tc.argtypes = [p] * 19 + [i] * 5 + [p]
            other.sae_fused_bwd_remat_tc.argtypes = [p] * 13 + [i] * 5 + [p]
            other.sae_fused_fwd_topk_tc.argtypes = [p] * 11 + [i] * 6 + [p]
            other.sae_fused_bwd_topk_tc.argtypes = [p] * 14 + [i] * 5 + [p]
            tcs[v] = other
    print(json.dumps({"card": card(), "versions": list(tcs) + ["mma_sync"],
                      "ptxas": ptxas(_build.build_dir() / "nvcc.log")}), flush=True)
    for v in tcs:
        if v != "tc":
            print(json.dumps({f"{v}_ptxas": ptxas(BUILD / f"sae_tc_{v}.log")}), flush=True)
    if only in (None, "gated"):
        gated_shapes(lib, tcs, S)
    if only in (None, "relu"):
        relu_shapes(lib, tcs, S)
    if only in (None, "remat"):
        remat_shapes(lib, tcs, S)
    if only in (None, "topk"):
        topk_shapes(lib, tcs, S)


if __name__ == "__main__":
    main()
