"""B16's bf16 kernel as the package builds it against other versions of
``csrc/attention_block.cu`` (paths given as arguments, each built alone),
at CLIP ViT-B/32 batch 256 (T 50, D 768, 12 heads): each version's error
against the plain version at batches 1, 2, 3, 255 and 256, its outputs
equal to the bit across batches and slots, whether it equals the package's
build, and its time from CUDA events in turns (a, b, ..., ..., b, a, a, b).
Prints JSON lines.  Run from the repository root on a CUDA card:
``python3 probes/block_versions.py [other/attention_block.cu ...]``."""

import ctypes
import json
import math
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _common import card, finish_build, ms, start_build  # noqa: E402


def run(lib, x, Wqkv, bqkv, Wo, N):
    B, T, D = x.shape
    out = torch.empty_like(x)
    zbuf = torch.empty(B, 64, Wo.shape[0], dtype=x.dtype, device=x.device)
    rc = lib.attention_block_fwd(x.data_ptr(), Wqkv.data_ptr(), bqkv.data_ptr(), Wo.data_ptr(),
                                 zbuf.data_ptr(), out.data_ptr(), B, T, D, N, 0.125, 1, 0,
                                 torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"attention_block_fwd: CUDA error {rc}")
    return out


def main():
    from vit_prisma_tpu_torch.ops import _build
    from vit_prisma_tpu_torch.ops import attention as A
    procs = {f"v{i}": start_build(Path(p), f"block_v{i}") for i, p in enumerate(sys.argv[1:], 1)}
    libs = {"package": _build.load_library()}
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, proc in procs.items():
        lib = finish_build(proc, f"block_{name}")
        if lib is not None:
            lib.attention_block_fwd.argtypes = [p] * 6 + [i] * 4 + [f, i, i, p]
            libs[name] = lib
    print(json.dumps({"card": card(), "versions": {"package": "csrc/attention_block.cu",
                                                   **dict(zip(procs, sys.argv[1:]))}}))
    g = torch.Generator(device="cuda").manual_seed(13)
    T, D, N = 50, 768, 12
    NH = N * 64
    x = torch.randn(256, T, D, generator=g, device="cuda").bfloat16()
    w = ((torch.randn(D, 3 * NH, generator=g, device="cuda") * D ** -0.5).bfloat16(),
         (torch.randn(3 * NH, generator=g, device="cuda") * 0.1).bfloat16(),
         (torch.randn(NH, D, generator=g, device="cuda") * NH ** -0.5).bfloat16())
    full = {}
    for name, lib in libs.items():
        full[name] = run(lib, x, *w, N)
        rec = {"version": name}
        for B in (1, 2, 3, 255, 256):
            out = run(lib, x[:B], *w, N)
            want = A.fused_attention_block_plain(x[:B], *w, N, 0.125)
            err = (out.float() - want.float()).abs().max().item()
            tol = 4 * 2.0 ** (math.floor(math.log2(want.float().abs().max().item())) - 7)
            rec[f"batch_{B}"] = {"max_abs_err": err, "within_4_ulps": err <= tol,
                                 "equal_to_batch_256": bool(torch.equal(out, full[name][:B]))}
        rec["image_1_alone_equal"] = bool(torch.equal(run(lib, x[1:2], *w, N), full[name][1:2]))
        rec["equal_to_package"] = bool(torch.equal(full[name], full["package"]))
        print(json.dumps(rec))
    names = list(libs)
    times = {n: [] for n in names}
    for n in names + names[::-1] + names:
        times[n].append(ms(lambda: run(libs[n], x, *w, N)))
    print(json.dumps({"ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
