"""B16's float32 route as the package builds it (3xTF32 on tf32 wgmma,
``block_tf32_kernel``) against other versions of ``attention_block.cu``:
each directory given holds a copy of ``vit_prisma_tpu_torch/csrc`` (a
parent commit's, unpacked with ``git archive`` into the gitignored
``archive_run/``, for the FFMA kernel; or edited copies), and every
version's ``attention_block.cu`` is built alone, the package's too.  At
CLIP ViT-B/32 (chip_smoke.py's BLOCK_GEOMETRY, batch 256): each version's
error against the plain version and against ``attn_block_reference``
(relative to max(1, absmax)) at batches 1, 2, 3, 255 and 256, its outputs
equal to the bit across batches and slots, times from CUDA events in turns
(package, others, others reversed, package), ``F.linear`` + SDPA +
``F.linear`` beside, the bound at chip_smoke.py's peaks, the kernel names
``torch.profiler`` sees, and each version's ptxas registers and spills.
``--check`` stops after the errors and the ptxas records.  Prints JSON
lines.  Run from the repository root on a CUDA card:
``python3 probes/block_f32_versions.py [--check] [DIR ...]``."""

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
SCALE = chip_smoke.BLOCK_INV_SCALE


def run(lib, x, Wqkv, bqkv, Wo, N):
    """One float32 call; the scratch is the package's size (the parent's
    kernel uses only its z rows)."""
    from vit_prisma_tpu_torch.ops.attention import _attn_block_scratch
    B, T, D = x.shape
    out = torch.empty_like(x)
    zbuf = torch.empty(_attn_block_scratch(B, D, Wo.shape[0], x.dtype), dtype=x.dtype,
                       device=x.device)
    rc = lib.attention_block_fwd(x.data_ptr(), Wqkv.data_ptr(), bqkv.data_ptr(), Wo.data_ptr(),
                                 zbuf.data_ptr(), out.data_ptr(), B, T, D, N, SCALE, 0, 0,
                                 torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"attention_block_fwd: CUDA error {rc}")
    return out


def ptxas_f32(log):
    """Registers and spill bytes of a build's float32 kernel (the 3xTF32
    one, or a parent's FFMA ``block_f32_kernel<float>``), and ptxas's
    wgmma serialization warnings."""
    out, fn = {}, None
    text = Path(log).read_text().splitlines()
    for line in text:
        m = re.search(r"Function properties for \S*?(block_tf32_kernel|block_f32_kernel"
                      r"|split_k_major_kernel)", line)
        if "Function properties for" in line:
            fn = m.group(1) if m else None
        elif fn and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            out[fn] = {"spill_bytes": int(m.group(1)) + int(m.group(2))}
        elif fn and (m := re.search(r"Used (\d+) registers", line)):
            out[fn]["registers"] = int(m.group(1))
    return {"kernels": out,
            "wgmma_serialized": [l.strip()[:160] for l in text if "wgmma" in l and "serialized" in l]}


def main():
    from vit_prisma_tpu_torch.ops import attention as A
    torch.backends.cuda.matmul.allow_tf32 = False
    args = sys.argv[1:]
    check = "--check" in args
    dirs = {"package": PACKAGE, **{f"{i}:{Path(a).name}": Path(a)
                                   for i, a in enumerate(x for x in args if x != "--check")}}
    procs = {name: start_build(d / "attention_block.cu", f"block_f32_{j}")
             for j, (name, d) in enumerate(dirs.items())}
    libs = {}
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for j, (name, proc) in enumerate(procs.items()):
        lib = finish_build(proc, f"block_f32_{j}")
        print(json.dumps({"version": name, "built": lib is not None,
                          "ptxas": ptxas_f32(BUILD / f"block_f32_{j}.log")}), flush=True)
        if lib is not None:
            lib.attention_block_fwd.argtypes = [p] * 6 + [i] * 4 + [f, i, i, p]
            libs[name] = lib
    print(json.dumps({"card": card(), "versions": list(libs)}), flush=True)
    g = torch.Generator(device="cuda").manual_seed(13)
    B, T, D, N = chip_smoke.BLOCK_GEOMETRY
    NH = N * 64
    x, Wqkv, bqkv, Wo = chip_smoke._block_inputs(g, B, T, D, N, torch.float32)
    w = (Wqkv, bqkv, Wo)
    full = {n: run(lib, x, *w, N) for n, lib in libs.items()}
    for name, lib in libs.items():
        rec = {"version": name}
        for b in (1, 2, 3, 255, 256):
            out = run(lib, x[:b], *w, N)
            want = A.fused_attention_block_plain(x[:b], *w, N, SCALE)
            ref = A.attn_block_reference(x[:b], *w, N, SCALE)
            rec[f"batch_{b}"] = {
                "rel_err": (out - want).abs().max().item() / max(1.0, want.abs().max().item()),
                "rel_err_reference": (out - ref).abs().max().item()
                / max(1.0, ref.abs().max().item()),
                "equal_to_batch_256": bool(torch.equal(out, full[name][:b]))}
        rec["image_1_alone_equal"] = bool(torch.equal(run(lib, x[1:2], *w, N), full[name][1:2]))
        rec["rel_tol"] = chip_smoke.BLOCK_F32_REL
        print(json.dumps(rec), flush=True)
    if check:
        return 0
    names = list(libs)
    times = {n: [] for n in names}
    for n in names + names[::-1]:
        times[n].append(ms(lambda: run(libs[n], x, *w, N), iters=20, warmup=3))
    WqkvT, WoT = Wqkv.t().contiguous(), Wo.t().contiguous()

    def library():
        qkv = F.linear(x, WqkvT, bqkv).view(B, T, 3, N, 64).permute(2, 0, 3, 1, 4)
        z = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2], scale=SCALE)
        return F.linear(z.transpose(1, 2).reshape(B, T, NH), WoT)
    flops = 2 * B * T * D * 3 * NH + 2 * B * T * NH * D + 4 * B * N * T * T * 64
    print(json.dumps({
        "ms": times, "library_ms": ms(library, iters=20, warmup=3),
        "kernels": [k[:70] for k in chip_smoke.kernel_names(lambda: run(libs["package"], x, *w, N))],
        "TFLOP_s": {n: flops / (min(v) * 1e-3) / 1e12 for n, v in times.items()},
        "bound": chip_smoke.bound((2 * x.numel() + Wqkv.numel() + bqkv.numel() + Wo.numel()) * 4,
                                  [("f32_product", flops), ("fp32", 5 * B * N * T * T)])}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
