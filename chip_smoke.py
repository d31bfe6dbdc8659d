#!/usr/bin/env python3
"""Check that the PyTorch port builds, runs and agrees on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing JSON lines with the card's name and power limit:

1. build: compile the CUDA kernels from ``vit_prisma_tpu_torch/csrc``, one
   nvcc process per source, all started together;
2. kernel: every kernel against its plain PyTorch version on the card, at
   the shapes its path gives it, with both times from CUDA events: B1
   (``attention_mix_tnh``) at the ViT shapes, B3 (``take_rows``) at the
   activation store's shape, B7 (``adam_update``) at the default SAE's
   four tensors with float32 and bfloat16 moments;
3. slice: the CLIP ViT-B/32 resid_post cached forward (12 layers, 768 wide,
   random weights from seed 0) on the card against the same weights on the
   CPU in float32, and in bfloat16 against the einsum attention path;
4. serve: a bfloat16 ``CompiledForward`` at batch 256 answers three
   requests; this is the first main path, whose B1 launches are counted.
   Then the served images per second with the kernel and with the einsum
   path;
5. train: the second main path, SAE training at ``SAERunnerConfig``'s
   defaults (B/32 layer-9 resid_post, 768 -> 12,288, batch 4096, float32)
   with a 4-batch buffer: ``HookedViT`` -> ``VisionActivationsStore`` ->
   ``VisionSAETrainer.run(max_steps=120)``, which crosses one refill.  The
   B1, B3 and B7 launches are counted and must be exact; training tokens
   per second and peak device memory are printed;
6. step check: from the trained state, three steps on three batches on the
   card and on the CPU in float32; grads, params, moments and counters are
   compared.

It imports no JAX, catches no failure, and exits non-zero when there is no
CUDA card or any check fails.  The last line is
``{"ok": true, "device": {...}}``.
"""

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

KERNEL_SOURCE = "vit_prisma_tpu_torch/csrc/attention_mix_tnh.cu"
KERNEL_REPLACES = "vit_prisma_tpu/ops/attention.py:250"
TAKE_ROWS_SOURCE = "vit_prisma_tpu_torch/csrc/take_rows.cu"
TAKE_ROWS_REPLACES = "vit_prisma_tpu/ops/shuffle.py:63"
ADAM_SOURCE = "vit_prisma_tpu_torch/csrc/adam_update.cu"
ADAM_REPLACES = "vit_prisma_tpu/ops/opt_step.py:85"
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
# B3 at the store's shape: the train phase's buffer, 4 x 4096 x 50 = 819,200
# rows of 768, in float32 and bfloat16.  The gather is exact: it must be
# bitwise equal.
TAKE_ROWS_SHAPES = [("store_f32", 819_200, 768, torch.float32),
                    ("store_bf16", 819_200, 768, torch.bfloat16)]
# B7 at the default SAE's tensors, stacked [1, R, C] as the step passes them.
ADAM_SHAPES = [("W_enc", (1, 768, 12288), False), ("W_dec", (1, 12288, 768), True),
               ("b_enc", (1, 1, 12288), False), ("b_dec", (1, 1, 768), False)]
# B7 against plain.  Both run one correctly rounded float32 operation per
# step of the math, in the same order; they differ only through W_dec's row
# dot, summed in another order, which moves g by ulps.  So p must agree
# within 1e-5 of the largest update (p_new - p), and float32 moments within
# 1e-6 of their absmax.  A bfloat16 moment whose float32 value moved by an
# ulp may round to the neighbouring bfloat16 value: one bf16 ulp, at most
# 2^-7 of the tensor's absmax.
ADAM_UPDATE_TOL = 1e-5
ADAM_TOL = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -7}
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# The train phase: SAERunnerConfig's defaults except a 4-batch buffer (the
# 20-batch default is a 16.4M-row, 50 GB buffer whose fill does not fit a
# smoke run), on 1,024 random images cycled by the store's index iterator.
TRAIN_BUFFER_BATCHES = 4
TRAIN_IMAGES = 1024
TRAIN_STEPS = 120
STEP_CHECK_STEPS = 3
# Step check, card against CPU from one state, float32 with TF32 off.  A
# pre-activation within GEMM rounding of 0 may switch its ReLU on one device
# only; such features are counted, and their W_enc columns and b_enc entries
# are held to their own bounds.
# Step 1's grads: GEMMs over 4,096 rows and 768 or 12,288 terms summed in
# other orders, within 1e-4 of each tensor's absmax outside switched
# features.
STEP_GRAD_REL = 1e-4
# After 3 steps, outside switched features: params within 1e-6 (the update
# is lr * m/sqrt(v) with lr 2.4e-4 here, and m, v differ relatively by the
# grads' 1e-4 at most), moments within 1e-4 of their absmax.
STEP_PARAM_ATOL = 1e-6
STEP_MOMENT_REL = 1e-4
# In switched features one row's term of the column's grad is in or out, a
# change of a few per cent of the column's grad: params within 2e-5 (3 steps
# x lr x a few per cent), moments within 2e-2 of their absmax.
STEP_SWITCHED_PARAM_ATOL = 2e-5
STEP_SWITCHED_MOMENT_REL = 2e-2
# Counts of steps and tokens must be equal.  A feature's act-freq count may
# differ only by the ReLU switches counted above, and its fired counter only
# where such a switch was its one activation.
STEP_EXACT = ("adam_count", "schedule_count", "step", "n_training_tokens",
              "n_frac_active_tokens")


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


def phase_sae_kernels(info):
    """B3 and B7 against their plain versions on the card."""
    from vit_prisma_tpu_torch.ops.opt_step import adam_update, adam_update_reference
    from vit_prisma_tpu_torch.ops.shuffle import take_rows, take_rows_reference
    g = torch.Generator(device="cuda").manual_seed(1)
    results = {}
    for name, n, d, dtype in TAKE_ROWS_SHAPES:
        x = torch.randn(n, d, generator=g, device="cuda").to(dtype)
        idx = torch.randperm(n, generator=g, device="cuda")
        out = take_rows(x, idx)
        want = take_rows_reference(x, idx)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        if out.dtype != dtype or out.shape != want.shape or not torch.equal(out, want):
            raise AssertionError(f"take_rows {name}: {out.dtype} {tuple(out.shape)}, "
                                 f"not bitwise equal (max abs err {err})")
        us = cuda_us(lambda: take_rows(x, idx))
        plain_us = cuda_us(lambda: take_rows_reference(x, idx))
        moved = 2 * x.numel() * x.element_size()
        rec = {"phase": "kernel", **info, "kernel": "take_rows", "shape": name,
               "rows": n, "row_bytes": d * x.element_size(),
               "dtype": str(dtype).split(".")[1], "max_abs_err": err, "tol": 0.0,
               "us": us, "plain_us": plain_us, "GB_moved": moved / 1e9,
               "hbm_share": moved / (us * 1e-6) / HBM_BYTES_PER_S,
               "plain_hbm_share": moved / (plain_us * 1e-6) / HBM_BYTES_PER_S}
        results[("take_rows", name)] = rec
        emit(rec)
        del x, idx, out, want

    # Inputs shaped like step 121 of the default run: unit W_dec rows,
    # grads ~1e-3, moments as 120 earlier steps leave them (mu ~1e-4, nu ~
    # (1 - b2^120) E[g^2]), lr 1e-3 * 121/500 in warm-up.
    kw = dict(b1=ADAM_B1, b2=ADAM_B2, eps=ADAM_EPS)
    scal = torch.tensor([[0.8, 1e-3 * 121 / 500, 1 / (1 - ADAM_B1 ** 121),
                          1 / math.sqrt(1 - ADAM_B2 ** 121)]], device="cuda")
    for name, shape, project in ADAM_SHAPES:
        for mdt in (torch.float32, torch.bfloat16):
            p = torch.randn(shape, generator=g, device="cuda") * 0.03
            if project:
                p = p / torch.linalg.norm(p, dim=-1, keepdim=True)
            grad = torch.randn(shape, generator=g, device="cuda") * 1e-3
            mu = (torch.randn(shape, generator=g, device="cuda") * 1e-4).to(mdt)
            nu = (1 - ADAM_B2 ** 120) * (1e-3 * (
                1 + 0.3 * torch.randn(shape, generator=g, device="cuda"))).square()
            nu = nu.to(mdt)
            got = adam_update(p, grad, mu, nu, scal, project=project, **kw)
            want = adam_update_reference(p, grad, mu, nu, scal, project=project, **kw)
            torch.cuda.synchronize()
            errs = {}
            scales = ((want[0] - p).abs().max().item(), want[1].float().abs().max().item(),
                      want[2].float().abs().max().item())
            for which, a, b, tol, scale in zip(("p", "mu", "nu"), got, want,
                                               (ADAM_UPDATE_TOL, ADAM_TOL[mdt], ADAM_TOL[mdt]),
                                               scales):
                if a.dtype != b.dtype or a.shape != b.shape:
                    raise AssertionError(f"adam_update {name} {which}: {a.dtype} "
                                         f"{tuple(a.shape)}")
                errs[which] = check_close(f"adam_update {name} {which}", a, b, tol * scale)
            us = cuda_us(lambda: adam_update(p, grad, mu, nu, scal, project=project, **kw))
            plain_us = cuda_us(lambda: adam_update_reference(p, grad, mu, nu, scal,
                                                             project=project, **kw))
            moved = p.numel() * (12 + 4 * mu.element_size())
            rec = {"phase": "kernel", **info, "kernel": "adam_update", "shape": name,
                   "dims": list(shape), "project": project,
                   "moments": str(mdt).split(".")[1], "max_abs_err": errs,
                   "max_update": scales[0],
                   "rel_tol": {"p_vs_update": ADAM_UPDATE_TOL, "moments": ADAM_TOL[mdt]},
                   "us": us, "plain_us": plain_us, "MB_moved": moved / 1e6,
                   "hbm_share": moved / (us * 1e-6) / HBM_BYTES_PER_S}
            results[("adam_update", name, mdt)] = rec
            emit(rec)
            del p, grad, mu, nu, got, want
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


def _record_logs(trainer):
    """Keep every set of metrics the trainer reads at its log cadence."""
    log, inner = [], trainer.log_metrics

    def log_metrics(metrics, step=None):
        vals = inner(metrics, step)
        log.append(vals)
        return vals
    trainer.log_metrics = log_metrics
    return log


def _time_refills(store):
    """Wall time of each refill (harvest + mix), synchronized."""
    times, inner = [], store._refill_half

    def refill():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inner()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    store._refill_half = refill
    return times


def phase_train(info):
    """The slice's main path: harvest -> store -> trainer.run on the card."""
    from vit_prisma_tpu_torch import HookedViT, get_model_config
    from vit_prisma_tpu_torch.ops.attention import attention_mix_tnh
    from vit_prisma_tpu_torch.ops.opt_step import adam_update
    from vit_prisma_tpu_torch.ops.shuffle import take_rows
    from vit_prisma_tpu_torch.sae import (SAERunnerConfig, VisionActivationsStore,
                                          VisionSAETrainer)
    cfg = SAERunnerConfig(n_batches_in_buffer=TRAIN_BUFFER_BATCHES)
    model = HookedViT(get_model_config(cfg.model_name), device="cuda",
                      generator=torch.Generator().manual_seed(0))
    images = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (TRAIN_IMAGES, 3, cfg.image_size, cfg.image_size), dtype=np.float32)).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # The main path, with every count set to 0 just before it.
    attention_mix_tnh.launches = take_rows.launches = adam_update.launches = 0
    t0 = time.perf_counter()
    store = VisionActivationsStore(cfg, model, images)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    trainer = VisionSAETrainer(cfg, model, store)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0 - fill_s
    refills = _time_refills(store)
    log = _record_logs(trainer)
    t1 = time.perf_counter()
    sae = trainer.run(max_steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t1
    launches = {"attention_mix_tnh": attention_mix_tnh.launches,
                "take_rows": take_rows.launches, "adam_update": adam_update.launches}

    per_batch = store.tokens_per_store_batch
    harvests = -(-cfg.tokens_per_buffer // per_batch) + \
        len(refills) * -(-(cfg.tokens_per_buffer // 2) // per_batch)
    expected = {"attention_mix_tnh": (cfg.hook_point_layer + 1) * harvests,
                "take_rows": 1 + len(refills), "adam_update": 4 * TRAIN_STEPS}
    if len(refills) != 1 or launches != expected:
        raise AssertionError(f"train launches {launches}, expected {expected}, "
                             f"{len(refills)} refills")
    if len(log) != TRAIN_STEPS // cfg.wandb_log_frequency:
        raise AssertionError(f"{len(log)} metric reads")
    for vals in log:
        if not all(math.isfinite(v) for v in vals.values()):
            raise AssertionError(f"non-finite metrics {vals}")
    last = log[-1]
    if not last["l0"] > 0:
        raise AssertionError(f"L0 is {last['l0']}")
    if int(trainer.state.step) != TRAIN_STEPS or tuple(sae.W_dec.shape) != (cfg.d_sae, cfg.d_in):
        raise AssertionError(f"step {int(trainer.state.step)}, W_dec {tuple(sae.W_dec.shape)}")
    if not all(torch.isfinite(v).all() for v in sae.params.values()):
        raise AssertionError("non-finite SAE parameters")
    tokens = TRAIN_STEPS * cfg.train_batch_size
    emit({"phase": "train", **info, "model": cfg.model_name,
          "weights": "random, seed 0 (pretrained weights are not in the repository)",
          "dataset": f"{TRAIN_IMAGES} random float32 {cfg.image_size}px images, numpy seed 3, on the card",
          "changed_from_defaults": {"n_batches_in_buffer": [20, TRAIN_BUFFER_BATCHES]},
          "hook_point": cfg.hook_point, "d_in": cfg.d_in, "d_sae": cfg.d_sae,
          "train_batch_size": cfg.train_batch_size, "dtype": cfg.dtype,
          "buffer_rows": cfg.tokens_per_buffer, "steps": TRAIN_STEPS,
          "launches": launches, "expected_launches": expected,
          "harvest_batches": harvests, "store_fill_s": fill_s, "trainer_init_s": init_s,
          "run_s": run_s, "refill_s": refills,
          "tokens_per_s_run": tokens / run_s,
          "tokens_per_s_without_refill": tokens / (run_s - sum(refills)),
          "peak_memory_GB": torch.cuda.max_memory_allocated() / 1e9,
          "metrics_first": log[0], "metrics_last": last})
    return trainer, store, cfg, launches


def _state_to(state, device):
    from vit_prisma_tpu_torch.ops.opt_step import ScaleByAdamState, ScaleByScheduleState
    adam, sched = state.opt_state
    move = lambda d: {k: v.to(device) for k, v in d.items()}
    return state._replace(
        params=move(state.params),
        opt_state=(ScaleByAdamState(adam.count.to(device), move(adam.mu), move(adam.nu)),
                   ScaleByScheduleState(sched.count.to(device))),
        **{f: getattr(state, f).to(device) for f in (
            "act_freq_scores", "n_forward_passes_since_fired", "n_frac_active_tokens",
            "step", "n_training_tokens")})


def phase_step_check(info, trainer, store, cfg):
    """Three steps from one state on the card and on the CPU, float32."""
    from vit_prisma_tpu_torch.sae.convert import train_state_to_numpy
    from vit_prisma_tpu_torch.sae.sae import encode, set_decoder_norm_to_unit_norm
    from vit_prisma_tpu_torch.sae.train import loss_and_grads, sae_train_step
    batches = [store.next_batch() for _ in range(STEP_CHECK_STEPS)]
    card, cpu = trainer.state, _state_to(trainer.state, "cpu")
    flips, switched, grad_errs = 0, torch.zeros(cfg.d_sae, dtype=torch.bool), []
    for b in batches:
        pg = set_decoder_norm_to_unit_norm(card.params)
        pc = set_decoder_norm_to_unit_norm(cpu.params)
        gg, _ = loss_and_grads(pg, b, cfg)
        gc, _ = loss_and_grads(pc, b.cpu(), cfg)
        flip = (encode(pg, cfg, b)[2] > 0).cpu() != (encode(pc, cfg, b.cpu())[2] > 0)
        flips += int(flip.sum())
        hit = flip.any(0)
        switched |= hit
        errs = {}
        for k in gc:
            d = (gg[k].cpu() - gc[k]).abs()
            scale = gc[k].abs().max().item()
            clean = d[..., ~hit] if k in ("W_enc", "b_enc") else d
            errs[k] = {"rel": d.max().item() / scale,
                       "rel_unswitched": clean.max().item() / scale}
        grad_errs.append(errs)
        card, _ = sae_train_step(card, b, cfg)
        cpu, _ = sae_train_step(cpu, b.cpu(), cfg)
    got, want = train_state_to_numpy(card), train_state_to_numpy(cpu)
    mask = switched.numpy()
    errs, scales = {}, {}
    for k in want:
        d = np.abs(got[k].astype(np.float64) - want[k])
        scales[k] = float(np.abs(want[k]).max())
        if k.endswith(("/W_enc", "/b_enc")):
            errs[k] = {"unswitched": float(d[..., ~mask].max()),
                       "switched": float(d[..., mask].max()) if mask.any() else 0.0}
        else:
            errs[k] = {"unswitched": float(d.max()), "switched": 0.0}
    emit({"phase": "step_check", **info, "steps": STEP_CHECK_STEPS,
          "start_step": int(trainer.state.step), "relu_switches": flips,
          "switched_features": int(switched.sum()), "grad_rel_err": grad_errs,
          "state_max_abs_err": errs, "state_absmax": scales,
          "act_freq_abs_diff_sum": float(np.abs(got["act_freq_scores"]
                                                - want["act_freq_scores"]).sum()),
          "counters_exact": bool(all(np.array_equal(got[k], want[k]) for k in (
              *STEP_EXACT, "act_freq_scores", "n_forward_passes_since_fired")))})
    return grad_errs, errs, scales, flips, int(switched.sum()), got, want


def check_steps(grad_errs, errs, scales, flips, switched, got, want):
    for k, e in grad_errs[0].items():
        if not e["rel_unswitched"] <= STEP_GRAD_REL:
            raise AssertionError(f"step-1 grad {k}: rel err {e} > {STEP_GRAD_REL}")
    for k, e in errs.items():
        if k.startswith("params/"):
            bounds = (STEP_PARAM_ATOL, STEP_SWITCHED_PARAM_ATOL)
        elif k.startswith(("mu/", "nu/")):
            bounds = (STEP_MOMENT_REL * scales[k], STEP_SWITCHED_MOMENT_REL * scales[k])
        else:
            continue
        if not (e["unswitched"] <= bounds[0] and e["switched"] <= bounds[1]):
            raise AssertionError(f"{k}: max abs err {e} > {bounds}")
    for k in STEP_EXACT:
        if not np.array_equal(got[k], want[k]):
            raise AssertionError(f"{k}: {got[k]} on the card, {want[k]} on the CPU")
    act = np.abs(got["act_freq_scores"] - want["act_freq_scores"]).sum()
    fired = int((got["n_forward_passes_since_fired"]
                 != want["n_forward_passes_since_fired"]).sum())
    if act > flips or fired > switched:
        raise AssertionError(f"counters: act-freq differs by {act} with {flips} "
                             f"ReLU switches; {fired} fired counters differ")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card; none is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name_power = card()
    info = {"card": name_power}

    phase_build(info)
    kernels = phase_kernels(info)
    sae_kernels = phase_sae_kernels(info)
    fused, plain = phase_slice(info)
    launches = phase_serve(info, fused, plain)
    del fused, plain
    trainer, store, cfg, train_launches = phase_train(info)
    check_steps(*phase_step_check(info, trainer, store, cfg))

    main_shape = kernels[("b32", torch.bfloat16)]
    gather = sae_kernels[("take_rows", "store_f32")]
    adam = [sae_kernels[("adam_update", name, torch.float32)] for name, _, _ in ADAM_SHAPES]
    print(name_power)
    emit({"kernels": [{
        "name": "attention_mix_tnh", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": main_shape["max_abs_err"],
        "ms": main_shape["us"] / 1000.0, "plain_ms": main_shape["plain_us"] / 1000.0}, {
        "name": "take_rows", "route": "cuda", "source": TAKE_ROWS_SOURCE,
        "replaces": TAKE_ROWS_REPLACES, "launches": train_launches["take_rows"],
        "max_abs_err": gather["max_abs_err"],
        "ms": gather["us"] / 1000.0, "plain_ms": gather["plain_us"] / 1000.0}, {
        # one train step's four tensors, float32 moments
        "name": "adam_update", "route": "cuda", "source": ADAM_SOURCE,
        "replaces": ADAM_REPLACES, "launches": train_launches["adam_update"],
        "max_abs_err": max(max(r["max_abs_err"].values()) for r in adam),
        "ms": sum(r["us"] for r in adam) / 1000.0,
        "plain_ms": sum(r["plain_us"] for r in adam) / 1000.0}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    sys.exit(main())
