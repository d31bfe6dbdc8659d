"""Check csrc/hopper_gemm.cuh alone on the card: build probes/gemm_tile.cu
and hold one [128 x 256] tile at K 64, 256 and 768 against torch.matmul in
float32.  Prints one JSON line.  Run from the repository root on a CUDA
card: ``python3 probes/gemm_tile.py``."""

import ctypes
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _common import card, finish_build, start_build  # noqa: E402


def main():
    lib = finish_build(start_build(Path(__file__).with_suffix(".cu"), "gemm_tile"), "gemm_tile")
    if lib is None:
        return 1
    lib.gemm_tile.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    g = torch.Generator(device="cuda").manual_seed(0)
    res = {"card": card()}
    for K in (64, 256, 768):
        A = torch.randn(128, K, generator=g, device="cuda").bfloat16()
        B = torch.randn(K, 256, generator=g, device="cuda").bfloat16()
        C = torch.empty(128, 256, device="cuda")
        rc = lib.gemm_tile(A.data_ptr(), B.data_ptr(), C.data_ptr(), K)
        torch.cuda.synchronize()
        res[f"K{K}"] = {"rc": rc, "max_abs_err": (C - A.float() @ B.float()).abs().max().item()}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
