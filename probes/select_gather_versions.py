"""B3 (``take_rows``) and B10 (``kth_value``) as the package builds them
against other versions of ``csrc/take_rows.cu`` or ``csrc/kth_value.cu``
(each built alone; a version is timed in the kernels it exports), called
through their C interfaces without the wrappers' checks: outputs equal to
``index_select`` or to the package's bits, and times from CUDA events in
turns (package, others, others reversed, package).  B3 at the 16-byte
aligned shapes of chip_smoke.py's ``TAKE_ROWS_SHAPES``, B10 at its
``KTH_SHAPES`` on its rows (ties and negative rows included).  Prints JSON
lines.  Run from the repository root on a CUDA card:
``python3 probes/select_gather_versions.py [other.cu ...]``."""

import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _common import card, finish_build, ms, start_build  # noqa: E402

import chip_smoke  # noqa: E402  (the repository root is on the path via _common)


def gather(lib, x, idx):
    out = torch.empty((idx.numel(),) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    rc = lib.take_rows(x.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.numel(),
                       x[0].numel() * x.element_size(), int(idx.dtype == torch.int64), 16,
                       0, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"take_rows: CUDA error {rc}")
    return out


def kth(lib, x, k):
    t = torch.empty(x.shape[0], 1, dtype=torch.float32, device=x.device)
    rc = lib.kth_value(x.data_ptr(), t.data_ptr(), x.shape[0], x.shape[1], k,
                       int(x.dtype == torch.bfloat16), 0, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"kth_value: CUDA error {rc}")
    return t


def turns(versions, call):
    """Each version's time in turns: forward, then reversed; the mean a version."""
    names = list(versions)
    times = {n: [] for n in names}
    for n in names + names[::-1]:
        times[n].append(ms(lambda: call(versions[n]), iters=20, warmup=3))
    return {n: sum(v) / len(v) for n, v in times.items()}


def main():
    import ctypes
    from vit_prisma_tpu_torch.ops import _build
    others = [Path(a) for a in sys.argv[1:]]
    procs = [start_build(src, f"sg_{i}") for i, src in enumerate(others)]
    package = _build.load_library()
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    b3, b10 = {"package": package}, {"package": package}
    for n, (src, proc) in enumerate(zip(others, procs)):
        lib = finish_build(proc, f"sg_{n}")
        if lib is None:
            print(json.dumps({"version": str(src), "built": False}))
            continue
        name = f"{src.parent.name}/{src.name}"
        if hasattr(lib, "take_rows"):
            lib.take_rows.argtypes = [p, p, p, ll, ll, i, i, i, p]
            b3[name] = lib
        if hasattr(lib, "kth_value"):
            lib.kth_value.argtypes = [p, p, ll, i, i, i, i, p]
            b10[name] = lib
    info = {"card": card()}
    print(info["card"])
    g = torch.Generator(device="cuda").manual_seed(1)
    if len(b3) > 1:
        for name, n, row, dtype, m, offset in chip_smoke.TAKE_ROWS_SHAPES:
            x = torch.randn((n,) + row, generator=g, device="cuda").to(dtype)
            if x[0].numel() * x.element_size() % 16 or m is not None:
                continue
            idx = torch.randperm(n, generator=g, device="cuda")
            want = torch.index_select(x, 0, idx)
            equal = {v: torch.equal(gather(lib, x, idx), want) for v, lib in b3.items()}
            t = turns(b3, lambda lib: gather(lib, x, idx))
            t["index_select"] = ms(lambda: torch.index_select(x, 0, idx), iters=20, warmup=3)
            moved = 2 * x.numel() * x.element_size()
            print(json.dumps({**info, "kernel": "take_rows", "shape": name, "equal": equal,
                              "ms": t, "hbm_share": {v: moved / (s * 1e-3) / 3.35e12
                                                     for v, s in t.items()}}), flush=True)
            del x, idx, want
            torch.cuda.empty_cache()
    if len(b10) > 1:
        for name, R, D, dtype in chip_smoke.KTH_SHAPES:
            x = chip_smoke._kth_rows(g, R, D, dtype, "randn")
            want = kth(package, x, chip_smoke.TOPK_K).view(torch.int32)
            equal = {v: torch.equal(kth(lib, x, chip_smoke.TOPK_K).view(torch.int32), want)
                     for v, lib in b10.items()}
            t = turns(b10, lambda lib: kth(lib, x, chip_smoke.TOPK_K))
            print(json.dumps({**info, "kernel": "kth_value", "shape": name, "equal": equal,
                              "ms": t}), flush=True)
            del x, want


if __name__ == "__main__":
    main()
