"""clock64 stamps through B16's bf16 kernel: an instrumented copy of
``csrc/attention_block.cu`` records, for block 0 and thread 0 of each
consumer warpgroup, the SM clock before and after each head's QKV
products, before the mix, after the scores and softmax, after p v (z
staged), after each output tile's products and at the end; run at CLIP
ViT-B/32 batch 256.  Prints the stamps and the mean cycles a head of each
step as JSON lines.  Run from the repository root on a CUDA card:
``python3 probes/block_trace.py``."""

import ctypes
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _common import BUILD, CSRC, card, finish_build, start_build  # noqa: E402

STAMP = "if (blockIdx.x == 0 && t == 0) g_stamps[slot * 1024 + (ns++)] = clock64();\n"
# (marker, insert after it?) in block_tc_kernel, in order of execution
MARKS = [("      float acc[kN / 2];\n      gemm(acc, kq);", False),
         ("      gemm(acc, kq);\n", True),
         ("      // the mix: this warp's 16 query rows", False),
         ("      hg::named_sync(1 + slot, 128);  // every warp is done with k\n", True),
         ("      hg::fence_proxy_async_smem();\n      hg::named_sync(1 + slot, 128);\n"
          "      if (t == 0) {\n        hg::tma_store_3d(&zmap", False),
         ("      gemm(acc, ko);\n", True),
         ("    if (t == 0) hg::bulk_wait_read();  // the staging outlives", False)]
STEPS = ["qkv_products", "epilogue", "scores_softmax", "pv_z"]


def instrument(src: str) -> str:
    src = src.replace("namespace {", "__device__ long long g_stamps[2048];\nnamespace {", 1)
    k0 = src.index("block_tc_kernel(const __grid_constant__")
    at = src.index("    int it = 0;\n    auto release", k0)
    src = src[:at] + "    int ns = 0;\n" + src[at:]
    for marker, after in MARKS:
        i = src.index(marker, k0) + (len(marker) if after else 0)
        indent = marker[:len(marker) - len(marker.lstrip())]
        src = src[:i] + indent + STAMP + src[i:]
    return src + ('\nextern "C" int read_stamps(long long* host) {\n'
                  '  return cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));\n}\n')


def main():
    BUILD.mkdir(parents=True, exist_ok=True)
    path = BUILD / "block_trace.cu"
    path.write_text(instrument((CSRC / "attention_block.cu").read_text()))
    lib = finish_build(start_build(path, "block_trace"), "block_trace")
    if lib is None:
        return 1
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.attention_block_fwd.argtypes = [p] * 6 + [i] * 4 + [f, i, i, p]
    lib.read_stamps.argtypes = [p]
    g = torch.Generator(device="cuda").manual_seed(13)
    B, T, D, N = 256, 50, 768, 12
    NH = N * 64
    x = torch.randn(B, T, D, generator=g, device="cuda").bfloat16()
    Wqkv = (torch.randn(D, 3 * NH, generator=g, device="cuda") * D ** -0.5).bfloat16()
    bqkv = (torch.randn(3 * NH, generator=g, device="cuda") * 0.1).bfloat16()
    Wo = (torch.randn(NH, D, generator=g, device="cuda") * NH ** -0.5).bfloat16()
    out = torch.empty_like(x)
    zbuf = torch.empty(B, 64, NH, dtype=x.dtype, device="cuda")
    for _ in range(5):
        lib.attention_block_fwd(x.data_ptr(), Wqkv.data_ptr(), bqkv.data_ptr(), Wo.data_ptr(),
                                zbuf.data_ptr(), out.data_ptr(), B, T, D, N, 0.125, 1, 0,
                                torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * 2048)()
    lib.read_stamps(ctypes.cast(buf, ctypes.c_void_p))
    print(json.dumps({"card": card()}))
    for slot in range(2):
        v = [buf[slot * 1024 + k] for k in range(1024)]
        n = max(k for k in range(1024) if v[k]) + 1
        c = [v[k] - v[0] for k in range(n)]
        # per head: before products, after, before the mix, after softmax, before the z store
        heads = [c[5 * h:5 * h + 5] for h in range(N)]
        steps = {s: sum(hd[k + 1] - hd[k] for hd in heads[1:]) / (N - 1) for k, s in enumerate(STEPS)}
        print(json.dumps({"slot": slot, "cycles": c, "mean_cycles_a_head_after_the_first": steps,
                          "output_phase_cycles": c[5 * N:]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
