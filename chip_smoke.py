#!/usr/bin/env python3
"""Check that the PyTorch port builds, runs and agrees on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line with the card's name and power limit:

1. build: compile the CUDA kernels from ``vit_prisma_tpu_torch/csrc``;
2. kernel: every kernel against its plain PyTorch version on the card, at
   the shapes the model gives it, with both times from CUDA events;
3. slice: the CLIP ViT-B/32 resid_post cached forward (12 layers, 768 wide,
   random weights from seed 0) on the card against the same weights on the
   CPU in float32, and in bfloat16 against the einsum attention path;
4. serve: a bfloat16 ``CompiledForward`` at batch 256 answers three
   requests; this is the main path whose kernel launches are counted.  Then
   the served images per second with the kernel and with the einsum path.

It imports no JAX, catches no failure, and exits non-zero when there is no
CUDA card or any check fails.  The last line is
``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time

import torch

KERNEL_SOURCE = "vit_prisma_tpu_torch/csrc/attention_mix_tnh.cu"
KERNEL_REPLACES = "vit_prisma_tpu/ops/attention.py:250"
# Kernel against plain, elementwise max abs error (inputs ~N(0,1)): float32
# differs only in summation order; bfloat16 may round p or z one ulp apart.
KERNEL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# name, B, T, N, H, causal: CLIP B/32 at serving batch, the CLIP text tower
# (causal), CLIP L/14.
KERNEL_SHAPES = [
    ("b32", 256, 50, 12, 64, False),
    ("text_causal", 256, 77, 8, 64, True),
    ("l14", 256, 257, 16, 64, False),
]
# Slice on the card against the CPU, both float32: atol = SLICE_F32_REL *
# max(1, absmax of the CPU value), to absorb GEMM summation order over 12
# layers.
SLICE_F32_REL = 1e-3
# bfloat16 kernel path against the bfloat16 einsum path: the einsum path
# rounds scores and the softmax to bfloat16, the kernel keeps them float32,
# so the two differ by bfloat16 rounding carried through 12 layers.
SLICE_BF16_REL = 5e-2
SERVE_BATCH = 256
SERVE_REQUESTS = (256, 300, 7)


def RESID_POST(name: str) -> bool:
    return "resid_post" in name


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def cuda_us(fn, iters=20, warmup=3) -> float:
    """Mean device time of ``fn`` in microseconds, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1000.0 / iters


def check_close(name, got, want, atol) -> float:
    err = (got.float().cpu() - want.float().cpu()).abs().max().item()
    if not err <= atol:  # also catches NaN
        raise AssertionError(f"{name}: max abs err {err} > {atol}")
    return err


def rel_atol(rel, want) -> float:
    return rel * max(1.0, want.float().abs().max().item())


def phase_build(info):
    from vit_prisma_tpu_torch.ops import _build
    cached = (_build.build_dir() / _build.LIB_NAME).exists()
    t0 = time.perf_counter()
    lib = _build.build()
    seconds = time.perf_counter() - t0
    _build.load_library()
    log = (lib.parent / "nvcc.log").read_text().splitlines()
    emit({"phase": "build", **info, "seconds": seconds, "cached": cached,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "ptxas": [l.strip() for l in log if "registers" in l or "spill" in l]})


def phase_kernels(info):
    from vit_prisma_tpu_torch.ops.attention import (
        attention_mix_tnh, attention_mix_tnh_reference)
    g = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for name, B, T, N, H, causal in KERNEL_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            shape = (B, T, N * H)
            q = (torch.randn(shape, generator=g, device="cuda") * H ** -0.5).to(dtype)
            k = torch.randn(shape, generator=g, device="cuda").to(dtype)
            v = torch.randn(shape, generator=g, device="cuda").to(dtype)
            z = attention_mix_tnh(q, k, v, N, causal)
            want = attention_mix_tnh_reference(q, k, v, N, causal)
            torch.cuda.synchronize()
            if z.dtype != dtype or z.shape != q.shape:
                raise AssertionError(f"{name} {dtype}: z is {z.dtype} {tuple(z.shape)}")
            err = check_close(f"{name} {dtype}", z, want, KERNEL_TOL[dtype])
            us = cuda_us(lambda: attention_mix_tnh(q, k, v, N, causal))
            plain_us = cuda_us(lambda: attention_mix_tnh_reference(q, k, v, N, causal))
            rec = {"phase": "kernel", **info, "kernel": "attention_mix_tnh",
                   "shape": name, "B": B, "T": T, "N": N, "H": H,
                   "causal": causal, "dtype": str(dtype).split(".")[1],
                   "max_abs_err": err, "tol": KERNEL_TOL[dtype],
                   "us": us, "plain_us": plain_us}
            results[(name, dtype)] = rec
            emit(rec)
            del q, k, v, z, want
    return results


def phase_slice(info):
    from vit_prisma_tpu_torch import HookedViT, get_model_config
    from vit_prisma_tpu_torch.ops.attention import attention_mix_tnh
    cfg = get_model_config("openai/clip-vit-base-patch32")
    model = HookedViT(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    images = torch.randn(4, 3, 224, 224, generator=torch.Generator().manual_seed(1))

    attention_mix_tnh.launches = 0
    out, cache = model.run_with_cache(images.cuda(), names_filter=RESID_POST)
    torch.cuda.synchronize()
    launches_f32 = attention_mix_tnh.launches
    if launches_f32 != cfg.n_layers:
        raise AssertionError(f"f32 forward launched the kernel {launches_f32} times")

    cpu = HookedViT(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    ref_out, ref_cache = cpu.run_with_cache(images, names_filter=RESID_POST)
    if list(cache) != list(ref_cache) or len(cache) != cfg.n_layers:
        raise AssertionError(f"cache keys differ: {list(cache)}")
    f32_errs = {"logits": check_close("f32 logits", out, ref_out,
                                      rel_atol(SLICE_F32_REL, ref_out))}
    for k in ref_cache:
        f32_errs[k] = check_close(f"f32 {k}", cache[k], ref_cache[k],
                                  rel_atol(SLICE_F32_REL, ref_cache[k]))

    bf16 = cfg.replace(dtype="bfloat16")
    fused = HookedViT(bf16, device="cuda")
    plain = HookedViT(bf16.replace(use_fused_attention=False), device="cuda")
    fused.load_state_dict(model.state_dict())
    plain.load_state_dict(model.state_dict())
    x = images.cuda().bfloat16()
    attention_mix_tnh.launches = 0
    out_k, cache_k = fused.run_with_cache(x, names_filter=RESID_POST)
    torch.cuda.synchronize()
    launches_bf16 = attention_mix_tnh.launches
    out_p, cache_p = plain.run_with_cache(x, names_filter=RESID_POST)
    torch.cuda.synchronize()
    if launches_bf16 != cfg.n_layers or attention_mix_tnh.launches != cfg.n_layers:
        raise AssertionError(f"bf16 launches {launches_bf16}, "
                             f"{attention_mix_tnh.launches}")
    bf16_errs = {"logits": check_close("bf16 logits", out_k, out_p,
                                       rel_atol(SLICE_BF16_REL, out_p))}
    # each bf16 path against the float32 CPU run, for the record
    vs_f32 = {"kernel": (out_k.float().cpu() - ref_out).abs().max().item(),
              "plain": (out_p.float().cpu() - ref_out).abs().max().item()}
    for k in cache_p:
        bf16_errs[k] = check_close(f"bf16 {k}", cache_k[k], cache_p[k],
                                   rel_atol(SLICE_BF16_REL, cache_p[k]))
    emit({"phase": "slice", **info, "model": cfg.model_name,
          "n_layers": cfg.n_layers, "d_model": cfg.d_model, "batch": 4,
          "launches_per_forward": {"f32": launches_f32, "bf16": launches_bf16},
          "f32_vs_cpu_max_abs_err": f32_errs, "f32_rel_tol": SLICE_F32_REL,
          "bf16_kernel_vs_plain_max_abs_err": bf16_errs,
          "bf16_rel_tol": SLICE_BF16_REL,
          "bf16_logits_vs_f32_cpu_max_abs_err": vs_f32,
          "logits_absmax": ref_out.abs().max().item()})
    return fused, plain


def phase_serve(info, fused, plain):
    from vit_prisma_tpu_torch import CompiledForward
    from vit_prisma_tpu_torch.ops.attention import attention_mix_tnh
    cfg = fused.cfg
    server = CompiledForward(fused, batch_size=SERVE_BATCH, names_filter=RESID_POST)
    g = torch.Generator().manual_seed(2)
    requests = [torch.randn(n, 3, 224, 224, generator=g) for n in SERVE_REQUESTS]

    # The main path: the server answers the requests.
    attention_mix_tnh.launches = 0
    answers = [server(r) for r in requests]
    torch.cuda.synchronize()
    launches = attention_mix_tnh.launches
    n_batches = sum(-(-n // SERVE_BATCH) for n in SERVE_REQUESTS)
    if launches != n_batches * cfg.n_layers:
        raise AssertionError(f"serving launched the kernel {launches} times, "
                             f"expected {n_batches * cfg.n_layers}")
    for n, (out, cache) in zip(SERVE_REQUESTS, answers):
        if tuple(out.shape) != (n, cfg.n_classes) or len(cache) != cfg.n_layers:
            raise AssertionError(f"request {n}: out {tuple(out.shape)}, "
                                 f"{len(cache)} cache entries")
        for k, a in cache.items():
            if tuple(a.shape) != (n, cfg.n_tokens, cfg.d_model):
                raise AssertionError(f"request {n}: {k} {tuple(a.shape)}")
        if not torch.isfinite(out).all():
            raise AssertionError(f"request {n}: non-finite output")
    # The padded request's rows are the unpadded forward's rows.
    small_out, _ = fused.run_with_cache(requests[2].cuda().bfloat16(),
                                        names_filter=RESID_POST)
    pad_err = check_close("padded request", answers[2][0], small_out,
                          rel_atol(SLICE_BF16_REL, small_out))

    # Served img/s at batch 256, kernel against einsum path, in turns.
    batch = torch.randn(8 * SERVE_BATCH, 3, 224, 224, device="cuda",
                        dtype=torch.bfloat16)
    servers = {"kernel": server,
               "plain": CompiledForward(plain, batch_size=SERVE_BATCH,
                                        names_filter=RESID_POST)}
    runs = {"kernel": [], "plain": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        servers[which](batch)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            servers[which](batch)
        torch.cuda.synchronize()
        runs[which].append(3 * batch.shape[0] / (time.perf_counter() - t0))
    emit({"phase": "serve", **info, "batch_size": SERVE_BATCH,
          "requests": list(SERVE_REQUESTS), "launches": launches,
          "padded_request_max_abs_err": pad_err,
          "img_per_s_kernel": runs["kernel"], "img_per_s_plain": runs["plain"]})
    return launches


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card; none is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name_power = card()
    info = {"card": name_power}

    phase_build(info)
    kernels = phase_kernels(info)
    fused, plain = phase_slice(info)
    launches = phase_serve(info, fused, plain)

    main_shape = kernels[("b32", torch.bfloat16)]
    print(name_power)
    emit({"kernels": [{
        "name": "attention_mix_tnh", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": main_shape["max_abs_err"],
        "ms": main_shape["us"] / 1000.0, "plain_ms": main_shape["plain_us"] / 1000.0}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    sys.exit(main())
