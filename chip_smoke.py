#!/usr/bin/env python3
"""Check that the PyTorch port builds, runs and agrees on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing JSON lines with the card's name and power limit:

1. build: compile the CUDA kernels from ``vit_prisma_tpu_torch/csrc``, one
   nvcc process per source, all started together;
2. kernel: every kernel against its plain PyTorch version on the card, at
   the shapes its path gives it, with both times from CUDA events, the
   time of one library call computing the same function where there is one
   (never used by the port) and the kernel's bound (bytes over the memory
   rate or operations over their peak rate): B1 (``attention_mix_tnh``) at
   the ViT shapes beside ``scaled_dot_product_attention``, B3
   (``take_rows``) at the activation store's shape beside
   ``index_select``, B7 (``adam_update``) at the default SAE's four tensors
   with float32 and bfloat16 moments, B10 (``kth_value``) at the generic
   TopK step's [4096, 12288] and at d_sae 65,536 in both dtypes, bitwise,
   beside ``torch.kthvalue``;
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
   ``VisionSAETrainer.run(max_steps=120)``, which crosses one refill.  Every
   kernel's launches are counted and must be exact; training tokens per
   second and peak device memory are printed;
6. step check: from the trained state, three steps on three batches on the
   card and on the CPU in float32; grads, params, moments and counters are
   compared;
7. SAE kernels: B4 (``sae_fused_forward``), B5 (``sae_fused_backward``) and
   B6 (``sae_fused_backward_stored``) against their plain versions at the
   all-layer sweep's shape in bfloat16 (24 SAEs, batch 4096, 1024 -> 8192)
   and at two layers in float32, with times and TFLOP/s; then B4+B6 against
   B4+B5 through ``sae_fused_apply`` at the sweep's shape in both dtypes,
   times and peak memory, the measurement behind always keeping hc;
8. TopK kernels: B8 (``sae_fused_forward_topk``), B9
   (``sae_fused_backward_topk``) and B6 on B8's masked h against their plain
   versions at the TopK slice's shape (1 x 4096, 768 -> 12,288, k = 64) in
   both dtypes and at the sweep's shape in bfloat16; masks that differ from
   the plain version's are counted and bounded, and the kernels' own
   invariants are exact; then B8+B6 against B8+B9 through
   ``sae_fused_apply_topk``;
9. TopK train: the fourth main path, phase 5's set-up with bench.py's
   bfloat16 TopK row (k = 64, bf16 compute, float32 masters):
   ``run(max_steps=120)`` through B8 and B6 on every step, exact launches;
   then a few steps with ``fused_store_acts=False`` through B9, and where
   the time goes: fused and generic steps timed with CUDA events on
   buffered batches, and ``torch.profiler``'s device time by kernel over
   three steps of each and over one refill, with the device's idle share;
10. TopK step check: three fused steps against three generic steps (B10)
    from the trained state in float32, and ``SparseAutoencoder.encode``
    (B10) against B8's masked h;
11. sweep: the third main path, the CLIP ViT-L/14 24-SAE sweep of the JAX
    package's benchmark (bf16 model with random weights, 96 random float32
    images on the card): ``HookedViT`` -> sweep ``VisionActivationsStore`` ->
    ``SAESweepTrainer.run(max_steps=18)`` -> ``train_cycles(2)``, then one
    cycle with ``fused_store_acts=False`` (the remat backward, B5).  Launch
    counts exact; SAE-tokens per second and peak memory;
12. sweep step check: three fused steps against three steps of the generic
    per-layer path from one state, in bfloat16 at 24 layers and in float32
    at two;
13. gated kernels: B11 (``sae_gated_fused_forward``) and B12
    (``sae_gated_fused_backward``) against their plain versions at the
    gated slice's shape (1 x 4096, 768 -> 12,288) in both dtypes and at two
    layers of the sweep's widths (2 x 4096, 1024 -> 8192) in bfloat16;
    gate and magnitude masks that differ from the plain version's are
    counted and bounded, and nact equals the kernel's own mask count;
14. gated train: the fifth main path, phase 5's set-up with bench.py's
    gated row (bf16 compute, float32 masters): ``run(max_steps=120)``
    through B11 and B12 on every step, exact launches, then where a gated
    step's time goes (``torch.profiler``, as phase 9);
15. gated step check: three fused steps against three generic steps from
    the trained state in float32.

The line before the last lists every kernel with its launches on its main
path, its error, times, bound and library time.  It imports no JAX,
catches no failure, and exits non-zero when there is no CUDA card or any
check fails.  The last line is
``{"ok": true, "device": {...}}``.
"""

import gc
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
SAE_FWD_SOURCE = "vit_prisma_tpu_torch/csrc/sae_fused_fwd.cu"
SAE_BWD_SOURCE = "vit_prisma_tpu_torch/csrc/sae_fused_bwd.cu"
SAE_REPLACES = {"sae_fused_forward": "vit_prisma_tpu/ops/sae_step.py:148",
                "sae_fused_backward": "vit_prisma_tpu/ops/sae_step.py:250",
                "sae_fused_backward_stored": "vit_prisma_tpu/ops/sae_step.py:389"}
KTH_SOURCE = "vit_prisma_tpu_torch/csrc/kth_value.cu"
KTH_REPLACES = "vit_prisma_tpu/ops/topk.py:78"
TOPK_FWD_SOURCE = "vit_prisma_tpu_torch/csrc/sae_fused_fwd_topk.cu"
GATED_SOURCES = {"sae_gated_fused_forward": "vit_prisma_tpu_torch/csrc/sae_fused_fwd_gated.cu",
                 "sae_gated_fused_backward": "vit_prisma_tpu_torch/csrc/sae_fused_bwd_gated.cu"}
GATED_REPLACES = {"sae_gated_fused_forward": "vit_prisma_tpu/ops/sae_step.py:1001",
                  "sae_gated_fused_backward": "vit_prisma_tpu/ops/sae_step.py:1116"}
TOPK_REPLACES = {"sae_fused_forward_topk": "vit_prisma_tpu/ops/sae_step.py:656",
                 "sae_fused_backward_topk": "vit_prisma_tpu/ops/sae_step.py:763"}
# Peak rates of one H100 SXM (NVIDIA's data sheet, dense, 700 W) for the
# bound of each kernel: the larger of its bytes over the memory rate and its
# operations over the peak rate of their type (bf16 products on the tensor
# cores; float32 products, compares and elementwise work on the CUDA cores,
# since TF32 would round float32 inputs).
PEAK_OPS = {"bf16_tensor": 989e12, "fp32": 67e12}
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
# B10 against its plain version (the same bitwise search in torch ops): t
# bitwise equal, so x >= t too.  At the shapes the TopK path gives it (the
# generic step's [4096, 12288] pre-activations) and at the widest d_sae the
# repo's configs reach (1024 x 64 = 65,536: rows beyond shared memory in
# float32), with every fourth row shifted negative and, in float32, every
# other row quantized to quarters so that the k-th value is tied.
KTH_SHAPES = [("slice_f32", 4096, 12288, torch.float32),
              ("slice_bf16", 4096, 12288, torch.bfloat16),
              ("wide_f32", 256, 65536, torch.float32),
              ("wide_bf16", 256, 65536, torch.bfloat16)]
TOPK_K = 64
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
# B4-B6 against their plain versions: name, L, B, d_in, d_sae, dtype.
SAE_STEP_SHAPES = [("sweep_bf16", 24, 4096, 1024, 8192, torch.bfloat16),
                   ("two_layers_f32", 2, 4096, 1024, 8192, torch.float32)]
# Kept hc (B6) against recomputed hc (B5), timed through sae_fused_apply in
# bfloat16 and float32 at the sweep's shape: L, B, d_in, d_sae.
SAVE_ACTS_SHAPE = (24, 4096, 1024, 8192)
# Kernel and plain version multiply the same c-typed operands with float32
# accumulation, in other summation orders.  So:
# * a pre-activation within float32 rounding of 0 may switch its ReLU: such
#   entries are counted; nact must equal the kernel's own mask count
#   exactly, and the plain nact within the switches of each feature;
# * bfloat16 hc and y may round one ulp apart: within 2^-7 of the tensor's
#   absmax (two ulps); float32 within 1e-5 of it (reordered sums of up to
#   8,192 terms); l1 within 1e-5 relative;
# * the grads, relative to each tensor's absmax, outside the features with a
#   switched ReLU: 2e-3 in bfloat16 (dh rounds to bf16 one ulp apart where
#   its float32 value moved), 1e-5 in float32; inside them B5's grads differ
#   by the switched rows' terms, held within 5e-2.
SAE_REL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}
SAE_GRAD_REL = {torch.bfloat16: 2e-3, torch.float32: 1e-5}
SAE_SWITCHED_GRAD_REL = 5e-2
SAE_L1_REL = 1e-5
# B8, B9 and B6 on B8's h against their plain versions: name, L, B, d_in,
# d_sae, dtype.  The TopK slice (bench.py:164-171, k = 64) in both dtypes
# and the all-layer sweep's shape in bfloat16.
TOPK_SHAPES = [("slice_bf16", 1, 4096, 768, 12288, torch.bfloat16),
               ("slice_f32", 1, 4096, 768, 12288, torch.float32),
               ("sweep_bf16", 24, 4096, 1024, 8192, torch.bfloat16)]
# The kernel and the plain version round hp to c after float32 sums taken in
# other orders, so an hp within a rounding of the row's k-th value or of 0
# may fall on the other side of the mask in one of them.  Such entries are
# counted; at most TOPK_FLIP_FRAC of all entries may flip, and at most
# TOPK_FLIP_ROW_FRAC of the rows may hold one, so that y is checked on most
# rows.  Outside the rows with a flip, y is held to SAE_REL; l1 within the
# flipped entries' values plus SAE_L1_REL; nact within each feature's flips;
# the grads within
# SAE_GRAD_REL outside the features with a flip and TOPK_SWITCHED_GRAD_REL
# in them.  The kernel's own invariants are exact: nact equals its own mask
# count, t is the k-th largest of its own h, and B9 from t gives B6's grads
# from h bit for bit (the same active set and the same products).
TOPK_FLIP_FRAC = 1e-4
TOPK_FLIP_ROW_FRAC = 1e-2
# A TopK feature is active in about k B / d_sae rows (21 at the slice shape,
# 32 at the sweep's), not in half of them as a ReLU feature, so one row in or
# out of a switched feature moves its gradient column by a few tenths of the
# largest column's: within 0.25 of the absmax there.
TOPK_SWITCHED_GRAD_REL = 0.25
# B8+B6 against B8+B9 through sae_fused_apply_topk at the TopK slice shape.
TOPK_SAVE_ACTS_SHAPE = (1, 4096, 768, 12288)
# The TopK train phase: phase 5's set-up with the TopK config of bench.py's
# bf16 row; then REMAT_STEPS steps with fused_store_acts=False (B9).
TOPK_REMAT_STEPS = 4
# Where a TopK step's time goes, after the train phase: TOPK_PROFILE_STEPS
# steps timed back to back on batches already in the buffer, fused and
# generic, then torch.profiler over three steps of each and over one refill;
# the TOPK_PROFILE_TOP kernels by device time are printed.
TOPK_PROFILE_STEPS = 20
TOPK_PROFILE_TOP = 10
# TopK step check: fused (B8, B6) against generic (B10) steps from the
# trained state in float32.  Both paths mask float32 pre-activations summed
# in other orders, so an entry within rounding of its row's k-th value may
# switch; those features are counted and held to the switched bounds of
# phase 6 (STEP_SWITCHED_*), every other feature to its unswitched bounds.
# encode's activations against B8's masked h: the same, entry by entry.
TOPK_ENCODE_REL = 1e-5
# The sweep: the JAX package's BASELINE config 5 (bench.py:189-214) with the
# port's L/14 registry entry in bfloat16 (random weights, seed 0) and 96
# random float32 images on the card instead of the uint8 wire (queue A, item
# 6), and its metrics read every 3 steps.  K = 6 steps per dispatch span one
# half-buffer.
SWEEP_MODEL = "openai/clip-vit-large-patch14"
SWEEP_IMAGES = 96
SWEEP_STEPS = 18
SWEEP_CYCLES = 2
SWEEP_CHECK_LAYERS = {torch.bfloat16: 24, torch.float32: 2}
# Every layer must fire at the first read, and every layer but these at
# every read.  On these random weights layers 3-7 stop firing within 30
# steps: from one initial state on the same rows, the fused bf16 step, the
# generic per-layer bf16 step and the fused float32 step lose these same
# layers, with L0 per layer within 1.2% of each other over the first 9
# steps and within 16% (0.12 where below 1) up to step 48 (PERF.md).  In
# this phase's 30 steps the others stay above 0, lowest layer 2 at 0.015 by
# step 30, and repeated runs read the same values bit for bit.
SWEEP_L0_EXEMPT = (3, 4, 5, 6, 7)
# Fused against generic sweep steps (the JAX package's
# test_fused_step_matches_generic, here on the card at full width).
# float32: the two paths differ by summation order only; params within that
# test's 2e-5, step-1 metrics within 2e-4 relative.  bfloat16: the generic
# path rounds hpre, h and y to bf16 where the kernels keep float32, so the
# step-1 metrics (one bf16 rounding of each term, 2^-8 relative) agree
# within 5e-3 relative.  A gradient whose sign differs moves a weight 2 lr
# (2e-3) the other way per step, so after 3 steps a weight is at most 6 lr
# off; such flips are rare, and 99.9% of each tensor's weights stay within
# 5% of lr (5e-5).
SWEEP_CHECK_TOL = {
    torch.float32: {"param_max": 2e-5, "param_p999": 2e-5, "step1_metric_rel": 2e-4},
    torch.bfloat16: {"param_max": 6e-3, "param_p999": 5e-5, "step1_metric_rel": 5e-3}}
# B11 and B12 against their plain versions: name, L, B, d_in, d_sae, dtype.
# The gated slice (bench.py:177-180) in both dtypes, and two layers at the
# sweep's widths in bfloat16.
GATED_SHAPES = [("slice_bf16", 1, 4096, 768, 12288, torch.bfloat16),
                ("slice_f32", 1, 4096, 768, 12288, torch.float32),
                ("sweep_bf16", 2, 4096, 1024, 8192, torch.bfloat16)]
# Kernel and plain version round hg = g + b_gate and hm = g e + b_mag to c
# after float32 sums taken in other orders, so an hg or hm within a rounding
# of 0 may fall on the other side of the gate or magnitude mask in one of
# them.  Such entries are counted: at most GATED_FLIP_FRAC of all entries,
# on at most TOPK_FLIP_ROW_FRAC of the rows.  Outside the rows with a flip
# y and via are held to SAE_REL; l1 within SAE_L1_REL plus the flipped gate
# entries' values; nact within each feature's magnitude flips and equal to
# the kernel's own mask count; the grads within SAE_GRAD_REL outside the
# features with a flip and SAE_SWITCHED_GRAD_REL in them.
GATED_FLIP_FRAC = 1e-4


def RESID_POST(name: str) -> bool:
    return "resid_post" in name


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def release() -> None:
    """Free what earlier phases left before a phase measures its peak
    memory: their trainers and stores sit in reference cycles (the wrapped
    ``log_metrics`` and refill), which only the garbage collector breaks."""
    gc.collect()
    torch.cuda.empty_cache()


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


def bound(nbytes, ops=()) -> dict:
    """The least time the card could take for a call: its bytes (each input
    read once, each output written once) over the memory rate, or its
    operations over the peak rates of their types, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(n / PEAK_OPS[kind] for kind, n in ops)
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


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
            # the library call on head-major copies made beforehand (untimed)
            qh, kh, vh = (a.reshape(B, T, N, H).transpose(1, 2).contiguous() for a in (q, k, v))
            library_us = cuda_us(lambda: torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, is_causal=causal, scale=1.0))
            gemm = "bf16_tensor" if dtype == torch.bfloat16 else "fp32"
            rec = {"phase": "kernel", **info, "kernel": "attention_mix_tnh",
                   "shape": name, "B": B, "T": T, "N": N, "H": H,
                   "causal": causal, "dtype": str(dtype).split(".")[1],
                   "max_abs_err": err, "tol": KERNEL_TOL[dtype],
                   "us": us, "plain_us": plain_us, "library_us": library_us,
                   **bound(4 * q.numel() * q.element_size(),
                           [(gemm, 4 * B * N * T * T * H), ("fp32", 5 * B * N * T * T)])}
            results[(name, dtype)] = rec
            emit(rec)
            del q, k, v, z, want, qh, kh, vh
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
        library_us = cuda_us(lambda: torch.index_select(x, 0, idx))
        moved = 2 * x.numel() * x.element_size()
        rec = {"phase": "kernel", **info, "kernel": "take_rows", "shape": name,
               "rows": n, "row_bytes": d * x.element_size(),
               "dtype": str(dtype).split(".")[1], "max_abs_err": err, "tol": 0.0,
               "us": us, "plain_us": plain_us, "library_us": library_us,
               "GB_moved": moved / 1e9,
               "hbm_share": moved / (us * 1e-6) / HBM_BYTES_PER_S,
               "plain_hbm_share": moved / (plain_us * 1e-6) / HBM_BYTES_PER_S,
               **bound(moved + idx.numel() * idx.element_size())}
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
                   "hbm_share": moved / (us * 1e-6) / HBM_BYTES_PER_S,
                   # clip scale, projection dot, two moments, bias
                   # corrections, sqrt, divide, update: ~15 per element
                   **bound(moved, [("fp32", 15 * p.numel())])}
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

    def refill(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inner(*args, **kwargs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    store._refill_half = refill
    return times


def phase_train(info, cfg=None, phase="train"):
    """A training main path: harvest -> store -> trainer.run on the card;
    the default SAE (phase 5) or, with ``cfg``, the TopK or gated slice."""
    from vit_prisma_tpu_torch import HookedViT, get_model_config
    from vit_prisma_tpu_torch.sae import (SAERunnerConfig, VisionActivationsStore,
                                          VisionSAETrainer)
    cfg = cfg or SAERunnerConfig(n_batches_in_buffer=TRAIN_BUFFER_BATCHES)
    counters = _sae_counters()
    model = HookedViT(get_model_config(cfg.model_name), device="cuda",
                      generator=torch.Generator().manual_seed(0))
    images = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (TRAIN_IMAGES, 3, cfg.image_size, cfg.image_size), dtype=np.float32)).cuda()
    torch.cuda.synchronize()
    release()
    torch.cuda.reset_peak_memory_stats()

    # The main path, with every count set to 0 just before it.
    _zero_counts(counters)
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
    launches = {k: f.launches for k, f in counters.items()}

    per_batch = store.tokens_per_store_batch
    harvests = -(-cfg.tokens_per_buffer // per_batch) + \
        len(refills) * -(-(cfg.tokens_per_buffer // 2) // per_batch)
    expected = dict.fromkeys(counters, 0)
    expected.update({"attention_mix_tnh": (cfg.hook_point_layer + 1) * harvests,
                     "take_rows": 1 + len(refills),
                     "adam_update": len(trainer.state.params) * TRAIN_STEPS})
    if cfg.architecture == "gated":  # the fused step at L = 1: B11, then B12
        expected["sae_gated_fused_forward"] = expected["sae_gated_fused_backward"] = TRAIN_STEPS
    elif cfg.activation_fn_str == "topk":  # the fused step at L = 1: B8, then B6 or B9
        expected["sae_fused_forward_topk"] = TRAIN_STEPS
        expected["sae_fused_backward_topk" if cfg.fused_store_acts is False
                 else "sae_fused_backward_stored"] = TRAIN_STEPS
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
    changed = {"n_batches_in_buffer": [20, TRAIN_BUFFER_BATCHES]}
    if cfg.activation_fn_str == "topk":
        changed.update(activation_fn_str=["relu", "topk"], k=TOPK_K,
                       compute_dtype=[None, cfg.compute_dtype])
    if cfg.architecture == "gated":
        changed.update(architecture=["standard", "gated"],
                       compute_dtype=[None, cfg.compute_dtype])
    emit({"phase": phase, **info, "model": cfg.model_name,
          "weights": "random, seed 0 (pretrained weights are not in the repository)",
          "dataset": f"{TRAIN_IMAGES} random float32 {cfg.image_size}px images, numpy seed 3, on the card",
          "changed_from_defaults": changed,
          "hook_point": cfg.hook_point, "d_in": cfg.d_in, "d_sae": cfg.d_sae,
          "train_batch_size": cfg.train_batch_size, "dtype": cfg.dtype,
          "compute_dtype": cfg.compute_dtype,
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


def _sae_inputs(g, L, B, D, S, dtype):
    """Inputs shaped like a sweep step's: unit-scale activations, weights of
    the SAE init's scale (rows of norm about 1), a loss gradient dy."""
    r = lambda *shape, sc=1.0: (torch.randn(*shape, generator=g, device="cuda") * sc).to(dtype)
    return (r(L, B, D), r(L, D, S, sc=D ** -0.5), r(L, S, sc=0.01), r(L, S, D, sc=D ** -0.5),
            r(L, D, sc=0.1), r(L, B, D, sc=1e-3),
            torch.rand(L, generator=g, device="cuda") * 1e-3)


def _grad_errs(name, got, want, switched, dtype, switched_rel=SAE_SWITCHED_GRAD_REL,
               keys=("dW_enc", "dW_dec", "db_enc")):
    """Max abs errors of the grads ``keys`` (the ReLU and TopK backwards'
    three, or B12's five) outside and inside the features whose mask
    switched; raises past the bounds."""
    errs = {}
    for k, a, b in zip(keys, got, want):
        d = (a - b).abs()
        scale = b.abs().max().item()
        # the feature axis: last for dW_enc [L, D, S] and the [L, S] bias
        # grads, the middle for dW_dec [L, S, D]
        sw = switched[:, None, :] if k == "dW_enc" else (
            switched[:, :, None] if k == "dW_dec" else switched)
        sw = sw.expand_as(d)
        clean = d[~sw].max().item() if (~sw).any() else 0.0
        dirty = d[sw].max().item() if sw.any() else 0.0
        errs[k] = {"unswitched": clean, "switched": dirty, "absmax": scale}
        if not (clean <= SAE_GRAD_REL[dtype] * scale and dirty <= switched_rel * scale):
            raise AssertionError(f"{name} {k}: {errs[k]}")
    return errs


def phase_sae_step_kernels(info):
    """B4, B5 and B6 against their plain versions at the sweep's shapes."""
    from vit_prisma_tpu_torch.ops import sae_step as S
    g = torch.Generator(device="cuda").manual_seed(4)
    results = {}
    for name, L, B, D, Sd, dtype in SAE_STEP_SHAPES:
        x, We, be, Wd, bd, dy, dl1 = _sae_inputs(g, L, B, D, Sd, dtype)
        y, l1, nact, hc = S.sae_fused_forward(x, We, be, Wd, bd, save_h=True)
        torch.cuda.synchronize()
        yr, l1r, nactr, hcr = S.sae_fused_forward_reference(x, We, be, Wd, bd, save_h=True)
        mask = hc.float() > 0
        mask_plain = (S._mm(x - bd[:, None], We) + be.float()[:, None]) > 0
        flip = mask != mask_plain
        switched = flip.any(dim=1)  # [L, S]
        per_feature = flip.sum(dim=1, dtype=torch.float32)
        own_count = mask.sum(dim=1, dtype=torch.float32)
        fwd = {"y": check_close(f"{name} y", y, yr, rel_atol(SAE_REL[dtype], yr)),
               "hc": check_close(f"{name} hc", hc, hcr, rel_atol(SAE_REL[dtype], hcr)),
               "l1_rel": ((l1 - l1r).abs() / l1r.abs()).max().item(),
               "relu_switches": int(flip.sum()),
               "nact_minus_own_mask": (nact - own_count).abs().max().item(),
               "nact_abs_diff_sum": (nact - nactr).abs().sum().item()}
        if not (fwd["l1_rel"] <= SAE_L1_REL and fwd["nact_minus_own_mask"] == 0
                and bool(((nact - nactr).abs() <= per_feature).all())):
            raise AssertionError(f"{name} forward: {fwd}")
        del yr, hcr, mask, mask_plain, flip
        bwd = {
            "sae_fused_backward_stored": _grad_errs(
                f"{name} B6", S.sae_fused_backward_stored(x, hc, Wd, bd, dy, dl1),
                S.sae_fused_backward_stored_reference(x, hc, Wd, bd, dy, dl1),
                torch.zeros_like(switched), dtype),
            "sae_fused_backward": _grad_errs(
                f"{name} B5", S.sae_fused_backward(x, We, be, Wd, bd, dy, dl1),
                S.sae_fused_backward_reference(x, We, be, Wd, bd, dy, dl1), switched, dtype)}
        flop = 2 * L * B * D * Sd
        ms = lambda fn, it: cuda_us(fn, iters=it, warmup=1) / 1000.0
        calls = {
            "sae_fused_forward": (lambda: S.sae_fused_forward(x, We, be, Wd, bd, save_h=True),
                                  lambda: S.sae_fused_forward_reference(x, We, be, Wd, bd, True),
                                  2 * flop),
            "sae_fused_backward_stored": (
                lambda: S.sae_fused_backward_stored(x, hc, Wd, bd, dy, dl1),
                lambda: S.sae_fused_backward_stored_reference(x, hc, Wd, bd, dy, dl1), 3 * flop),
            "sae_fused_backward": (
                lambda: S.sae_fused_backward(x, We, be, Wd, bd, dy, dl1),
                lambda: S.sae_fused_backward_reference(x, We, be, Wd, bd, dy, dl1), 4 * flop)}
        eb = x.element_size()
        w_bytes = (2 * L * D * Sd + L * Sd + L * D) * eb  # W_enc, W_dec, b_enc, b_dec
        g_bytes = (2 * L * D * Sd + L * Sd) * 4           # float32 dW_enc, dW_dec, db_enc
        nbytes = {"sae_fused_forward": 2 * L * B * D * eb + w_bytes + L * B * Sd * eb
                  + L * Sd * 4 + L * 4,
                  "sae_fused_backward_stored": (2 * L * B * D + L * B * Sd + L * Sd * D + L * D)
                  * eb + L * 4 + g_bytes,
                  "sae_fused_backward": 2 * L * B * D * eb + w_bytes + L * 4 + g_bytes}
        gemm = "bf16_tensor" if dtype == torch.bfloat16 else "fp32"
        for kernel, (fn, plain, n_flop) in calls.items():
            t, plain_t = ms(fn, 5), ms(plain, 2)
            err = (fwd["y"] if kernel == "sae_fused_forward" else
                   max(e["unswitched"] for e in bwd[kernel].values()))
            rec = {"phase": "kernel", **info, "kernel": kernel, "shape": name,
                   "L": L, "B": B, "d_in": D, "d_sae": Sd, "dtype": str(dtype).split(".")[1],
                   "max_abs_err": err, "ms": t, "plain_ms": plain_t,
                   "TFLOP": n_flop / 1e12, "TFLOP_per_s": n_flop / t / 1e9,
                   "plain_TFLOP_per_s": n_flop / plain_t / 1e9,
                   **bound(nbytes[kernel], [(gemm, n_flop)])}
            if kernel == "sae_fused_forward":
                rec["forward"] = fwd
            else:
                rec["grad_errs"] = bwd[kernel]
            results[(kernel, name)] = rec
            emit(rec)
        del x, We, be, Wd, bd, dy, y, hc
        torch.cuda.empty_cache()
    for dtype in (torch.bfloat16, torch.float32):
        emit({"phase": "save_acts", **info, **_stored_against_remat(
            g, S.sae_fused_apply, SAVE_ACTS_SHAPE, dtype, ("B4_plus_B6", "B4_plus_B5"))})
    return results


def _stored_against_remat(g, apply, shape, dtype, keys):
    """``apply``'s (``sae_fused_apply`` or ``sae_fused_apply_topk``) forward
    and backward at ``shape`` with the activations kept (``save_acts=True``,
    B6 backward) and recomputed (B5 or B9): CUDA-event time, TFLOP/s and
    peak memory above the inputs.  The measurement behind keeping them."""
    L, B, D, Sd = shape
    x, We, be, Wd, bd, dy, dl1 = _sae_inputs(g, L, B, D, Sd, dtype)
    params = [p.requires_grad_(True) for p in (We, be, Wd, bd)]

    def step(save_acts):
        y, l1, _ = apply(x, *params, save_acts=save_acts)
        return torch.autograd.grad((y, l1), params, (dy, dl1))
    out = {"L": L, "B": B, "d_in": D, "d_sae": Sd, "dtype": str(dtype).split(".")[1],
           "hc_GB": L * B * Sd * x.element_size() / 1e9}
    flop = 2 * L * B * D * Sd
    for save_acts, key, n_flop in ((True, keys[0], 5 * flop), (False, keys[1], 6 * flop)):
        step(save_acts)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step(save_acts)
        out[f"{key}_peak_GB_above_inputs"] = (torch.cuda.max_memory_allocated() - base) / 1e9
        out[f"{key}_ms"] = cuda_us(lambda: step(save_acts), iters=3, warmup=0) / 1000.0
        out[f"{key}_TFLOP_per_s"] = n_flop / out[f"{key}_ms"] / 1e9
    out["stored_faster"] = out[f"{keys[0]}_ms"] < out[f"{keys[1]}_ms"]
    del x, We, be, Wd, bd, dy, params
    torch.cuda.empty_cache()
    return out


def phase_kth_value(info):
    """B10 against its plain version, bitwise, with torch.kthvalue's time
    beside it."""
    from vit_prisma_tpu_torch.ops.topk import kth_value, kth_value_reference
    g = torch.Generator(device="cuda").manual_seed(6)
    results = {}
    for name, R, D, dtype in KTH_SHAPES:
        x = torch.randn(R, D, generator=g, device="cuda")
        x[::4] -= 10.0  # rows whose k-th value is negative
        if dtype == torch.float32:
            x[1::2] = torch.round(x[1::2] * 4) / 4  # rows whose k-th value is tied
        x = x.to(dtype)
        t = kth_value(x, TOPK_K)
        want = kth_value_reference(x, TOPK_K)
        torch.cuda.synchronize()
        if (tuple(t.shape) != (R, 1) or t.dtype != torch.float32
                or not torch.equal(t.view(torch.int32), want.view(torch.int32))):
            raise AssertionError(f"kth_value {name}: {t.dtype} {tuple(t.shape)}, "
                                 f"{int((t != want).sum())} rows differ from plain")
        kept = (x >= t).sum(dim=1)
        # the k-th value itself where the search is exact (every float32 row,
        # bfloat16 rows with a non-negative k-th value), else a separator
        values = torch.kthvalue(x, D - TOPK_K + 1, dim=1).values.float()
        exact = values >= 0 if dtype == torch.bfloat16 else torch.ones_like(values, dtype=bool)
        if not (bool((kept >= TOPK_K).all()) and torch.equal(t[:, 0][exact], values[exact])
                and bool(((x.float() >= values[:, None]) == (x >= t)).all())):
            raise AssertionError(f"kth_value {name}: the mask x >= t is not the top k")
        ms = lambda fn: cuda_us(fn, iters=10, warmup=2) / 1000.0
        n_bits = 16 if dtype == torch.bfloat16 else 32
        rec = {"phase": "kernel", **info, "kernel": "kth_value", "shape": name,
               "rows": R, "D": D, "k": TOPK_K, "dtype": str(dtype).split(".")[1],
               "max_abs_err": 0.0, "tol": "bitwise", "staged_in_shared_memory":
                   D * x.element_size() <= 96 * 1024,
               "rows_with_ties_kept": int((kept > TOPK_K).sum()),
               "ms": ms(lambda: kth_value(x, TOPK_K)),
               "plain_ms": ms(lambda: kth_value_reference(x, TOPK_K)),
               "library_ms": ms(lambda: torch.kthvalue(x, D - TOPK_K + 1, dim=1)),
               **bound(x.numel() * x.element_size() + R * 4, [("fp32", n_bits * x.numel())])}
        results[name] = rec
        emit(rec)
        del x, t, want, values
    return results


def phase_topk_kernels(info):
    """B8, B9 and B6 on B8's h against their plain versions at the TopK
    slice's and the sweep's shapes; then B8+B6 against B8+B9."""
    from functools import partial
    from vit_prisma_tpu_torch.ops import sae_step as S
    g = torch.Generator(device="cuda").manual_seed(7)
    results = {}
    for name, L, B, D, Sd, dtype in TOPK_SHAPES:
        x, We, be, Wd, bd, dy, dl1 = _sae_inputs(g, L, B, D, Sd, dtype)
        y, l1, nact, t, h = S.sae_fused_forward_topk(x, We, be, Wd, bd, TOPK_K, save_h=True)
        torch.cuda.synchronize()
        yr, l1r, nactr, tr, hr = S.sae_fused_forward_topk_reference(x, We, be, Wd, bd, TOPK_K,
                                                                     save_h=True)
        mask = h.float() > 0
        flip = mask != (hr.float() > 0)
        flip_rows = flip.any(dim=-1)
        per_feature = flip.sum(dim=1, dtype=torch.float32)
        own_count = mask.sum(dim=1, dtype=torch.float32)
        y_err = (y.float() - yr.float()).abs()[~flip_rows]
        l1_bound = (flip.sum(dim=(1, 2)).float() * hr.float().abs().amax(dim=(1, 2))
                    + SAE_L1_REL * l1r.abs())
        fwd = {"y_unflipped_rows": y_err.max().item() if y_err.numel() else math.inf,
               "y_tol": rel_atol(SAE_REL[dtype], yr),
               "mask_flips": int(flip.sum()), "flip_frac": flip.float().mean().item(),
               "rows_with_flips": int(flip_rows.sum()),
               "row_flip_frac": flip_rows.float().mean().item(),
               "t_rows_differ": int((t != tr).sum()),
               "nact_minus_own_mask": (nact - own_count).abs().max().item(),
               "nact_abs_diff_sum": (nact - nactr).abs().sum().item(),
               "t_is_k_th_of_own_h": bool(torch.equal(t, S._row_threshold(h, TOPK_K))),
               "rows_keeping_more_than_k": int((mask.sum(dim=-1) > TOPK_K).sum()),
               "rows_keeping_fewer_than_k": int((mask.sum(dim=-1) < TOPK_K).sum()),
               "l1_abs_err": (l1 - l1r).abs().max().item(),
               "l1_tol": l1_bound.max().item()}
        if not (fwd["y_unflipped_rows"] <= fwd["y_tol"] and fwd["flip_frac"] <= TOPK_FLIP_FRAC
                and fwd["row_flip_frac"] <= TOPK_FLIP_ROW_FRAC
                and fwd["nact_minus_own_mask"] == 0 and fwd["t_is_k_th_of_own_h"]
                and bool(((l1 - l1r).abs() <= l1_bound).all())
                and bool(((nact - nactr).abs() <= per_feature).all())):
            raise AssertionError(f"{name} TopK forward: {fwd}")
        del yr, hr, flip, flip_rows
        # B9 recomputes hp and masks it with B8's t; the plain B9 does the same
        # with its own products, so a mask may differ where hp rounds apart
        _, hp_plain = S._hp(x, We, be, bd)
        switched9 = (S._topk_mask(hp_plain, t)[0] != mask).any(dim=1)
        del hp_plain
        dWs = S.sae_fused_backward_stored(x, h, Wd, bd, dy, dl1)
        dW9 = S.sae_fused_backward_topk(x, We, be, Wd, bd, dy, dl1, t)
        torch.cuda.synchronize()
        b9_is_b6 = all(torch.equal(a, b) for a, b in zip(dWs, dW9))
        if not b9_is_b6:
            raise AssertionError(f"{name}: B9 from t does not give B6's grads from h")
        bwd = {"sae_fused_backward_stored": _grad_errs(
                   f"{name} B6", dWs, S.sae_fused_backward_stored_reference(x, h, Wd, bd, dy, dl1),
                   torch.zeros_like(switched9), dtype),
               "sae_fused_backward_topk": _grad_errs(
                   f"{name} B9", dW9,
                   S.sae_fused_backward_topk_reference(x, We, be, Wd, bd, dy, dl1, t),
                   switched9, dtype, TOPK_SWITCHED_GRAD_REL)}
        del dWs, dW9
        flop = 2 * L * B * D * Sd
        eb = x.element_size()
        n_bits = 16 if dtype == torch.bfloat16 else 32
        gemm = "bf16_tensor" if dtype == torch.bfloat16 else "fp32"
        w_bytes = (2 * L * D * Sd + L * Sd + L * D) * eb
        g_bytes = (2 * L * D * Sd + L * Sd) * 4
        ms = lambda fn, it: cuda_us(fn, iters=it, warmup=1) / 1000.0
        calls = {
            "sae_fused_forward_topk": (
                lambda: S.sae_fused_forward_topk(x, We, be, Wd, bd, TOPK_K, save_h=True),
                lambda: S.sae_fused_forward_topk_reference(x, We, be, Wd, bd, TOPK_K, True),
                2 * L * B * D * eb + w_bytes + L * B * Sd * eb + L * B * 4 + L * Sd * 4 + L * 4,
                [(gemm, 2 * flop), ("fp32", (n_bits - 1) * L * B * Sd)]),
            "sae_fused_backward_topk": (
                lambda: S.sae_fused_backward_topk(x, We, be, Wd, bd, dy, dl1, t),
                lambda: S.sae_fused_backward_topk_reference(x, We, be, Wd, bd, dy, dl1, t),
                2 * L * B * D * eb + w_bytes + L * B * 4 + L * 4 + g_bytes, [(gemm, 4 * flop)]),
            "sae_fused_backward_stored": (
                lambda: S.sae_fused_backward_stored(x, h, Wd, bd, dy, dl1),
                lambda: S.sae_fused_backward_stored_reference(x, h, Wd, bd, dy, dl1),
                (2 * L * B * D + L * B * Sd + L * Sd * D + L * D) * eb + L * 4 + g_bytes,
                [(gemm, 3 * flop)])}
        for kernel, (fn, plain, nbytes, ops) in calls.items():
            k_ms, plain_ms = ms(fn, 5), ms(plain, 2)
            n_flop = ops[0][1]  # the products
            rec = {"phase": "kernel", **info, "kernel": kernel, "shape": name, "path": "topk",
                   "L": L, "B": B, "d_in": D, "d_sae": Sd, "k": TOPK_K,
                   "dtype": str(dtype).split(".")[1],
                   "max_abs_err": (fwd["y_unflipped_rows"] if kernel == "sae_fused_forward_topk"
                                   else max(e["unswitched"] for e in bwd[kernel].values())),
                   "ms": k_ms, "plain_ms": plain_ms, "TFLOP": n_flop / 1e12,
                   "TFLOP_per_s": n_flop / k_ms / 1e9, **bound(nbytes, ops)}
            if kernel == "sae_fused_forward_topk":
                rec["forward"] = fwd
            else:
                rec["grad_errs"] = bwd[kernel]
                rec["B9_equals_B6_on_h"] = b9_is_b6
            results[(kernel, name)] = rec
            emit(rec)
        del x, We, be, Wd, bd, dy, y, h, t, mask
        torch.cuda.empty_cache()
    apply = partial(S.sae_fused_apply_topk, k=TOPK_K)
    for dtype in (torch.bfloat16, torch.float32):
        emit({"phase": "save_acts_topk", **info, "k": TOPK_K, **_stored_against_remat(
            g, apply, TOPK_SAVE_ACTS_SHAPE, dtype, ("B8_plus_B6", "B8_plus_B9"))})
    return results


def topk_config():
    """The TopK slice: bench.py's exact-bf16 TopK row (k = 64, bf16 compute,
    float32 masters) at SAERunnerConfig's default widths, with phase 5's
    4-batch buffer."""
    from vit_prisma_tpu_torch.sae import SAERunnerConfig
    return SAERunnerConfig(activation_fn_str="topk", activation_fn_kwargs=(("k", TOPK_K),),
                           compute_dtype="bfloat16", n_batches_in_buffer=TRAIN_BUFFER_BATCHES)


def phase_topk_remat(info, trainer, store, cfg):
    """TOPK_REMAT_STEPS steps through the same entry point with
    ``fused_store_acts=False``: B8 and B9 once a step, B6 never."""
    from vit_prisma_tpu_torch.sae import VisionSAETrainer
    counters = _sae_counters()
    remat = VisionSAETrainer(cfg.replace(fused_store_acts=False), trainer.model, store)
    remat.load_state(trainer.state)
    _zero_counts(counters)
    t0 = time.perf_counter()
    remat.run(max_steps=TOPK_REMAT_STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counters.items()}
    expected = {"sae_fused_forward_topk": TOPK_REMAT_STEPS,
                "sae_fused_backward_topk": TOPK_REMAT_STEPS, "sae_fused_backward_stored": 0,
                "sae_fused_forward": 0, "sae_fused_backward": 0, "kth_value": 0,
                "adam_update": 4 * TOPK_REMAT_STEPS}
    if any(launches[k] != v for k, v in expected.items()):
        raise AssertionError(f"TopK remat steps launched {launches}, expected {expected}")
    if not all(torch.isfinite(v).all() for v in remat.state.params.values()):
        raise AssertionError("non-finite SAE parameters after the remat steps")
    emit({"phase": "topk_remat", **info, "steps": TOPK_REMAT_STEPS, "launches": launches,
          "expected_launches": expected, "seconds": seconds})
    return launches


def _profile(fn):
    """Device time by kernel over one call of ``fn`` (synchronized), the
    device's busy total and the wall time, in milliseconds."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1000.0 * (time.perf_counter() - t0)
    # the device's own events (kernels, copies, sets), not the host ops that
    # launched them, whose device totals would count them twice
    rows = sorted(((e.key, e.device_time_total / 1000.0, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.device_time_total > 0), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall_ms), "kernels_total": len(rows),
            "kernels": [{"name": k[:90], "ms": ms, "calls": n}
                        for k, ms, n in rows[:TOPK_PROFILE_TOP]]}


def phase_step_profile(info, trainer, store, cfg, phase):
    """Where a TopK or gated train step's time goes, from the trained state
    on batches already in the buffer: the fused step (TopK: B8, B6; gated:
    B11, B12) and the generic step, each timed over TOPK_PROFILE_STEPS steps
    with CUDA events and profiled over three; then one refill (harvest +
    mix) profiled."""
    from vit_prisma_tpu_torch.sae.train import sae_train_step
    bs = cfg.train_batch_size
    batches = [store.buffer[i * bs:(i + 1) * bs] for i in range(store.buffer.shape[0] // bs)]
    shape = {"architecture": cfg.architecture, "activation": cfg.activation_fn_str,
             "d_in": cfg.d_in, "d_sae": cfg.d_sae, "compute_dtype": cfg.compute_dtype,
             "train_batch_size": bs}
    if cfg.activation_fn_str == "topk":
        shape["k"] = cfg.topk_k

    def steps(c, n):
        state = trainer.state
        for j in range(n):
            state, _ = sae_train_step(state, batches[j % len(batches)], c)

    for name, c in (("fused", cfg), ("generic", cfg.replace(fused_sae_step=False))):
        steps(c, 2)  # warm-up
        step_ms = cuda_us(lambda: steps(c, TOPK_PROFILE_STEPS), iters=1, warmup=0) \
            / 1000.0 / TOPK_PROFILE_STEPS
        prof = _profile(lambda: steps(c, 3))
        # the profiler slows the host, so its wall time overstates idling:
        # the share that counts is of the steps timed without it
        emit({"phase": phase, **info, **shape, "what": f"{name} train step",
              "steps_timed": TOPK_PROFILE_STEPS, "ms_per_step": step_ms,
              "tokens_per_s": bs / step_ms * 1000.0,
              "device_busy_ms_per_step": prof["device_busy_ms"] / 3,
              "idle_share_of_timed_steps": max(0.0, 1.0 - prof["device_busy_ms"] / 3 / step_ms),
              "profile_of_3_steps": prof})
    emit({"phase": phase, **info, **shape, "what": "one refill (harvest + mix)",
          "profile": _profile(store._refill_half)})


def _topk_masks(state, x, cfg, fused):
    """The active set [B, d_sae] that a step from ``state`` counts: kernel
    B8's masked h on the fused path, ``encode`` (B10) on the generic path."""
    from vit_prisma_tpu_torch.ops.sae_step import sae_fused_forward_topk
    from vit_prisma_tpu_torch.sae.sae import encode, set_decoder_norm_to_unit_norm
    p = set_decoder_norm_to_unit_norm(state.params)
    if fused:
        lift = {k: v[None] for k, v in p.items()}
        return sae_fused_forward_topk(x[None], lift["W_enc"], lift["b_enc"], lift["W_dec"],
                                      lift["b_dec"], cfg.topk_k, save_h=True)[4][0] > 0
    return encode(p, cfg, x)[1] > 0


def phase_topk_step_check(info, trainer, store, cfg):
    """From the trained TopK state, three fused steps (B8, B6) against three
    generic steps (B10) in float32; then ``SparseAutoencoder.encode`` (B10)
    against B8's masked h."""
    from vit_prisma_tpu_torch.ops.sae_step import sae_fused_forward_topk
    from vit_prisma_tpu_torch.sae.convert import train_state_to_numpy
    from vit_prisma_tpu_torch.sae.train import sae_train_step
    c = cfg.replace(compute_dtype=None)
    batches = [store.next_batch() for _ in range(STEP_CHECK_STEPS)]
    counters = _sae_counters()
    states = {True: [trainer.state], False: [trainer.state]}
    launches = {}
    for fused in (False, True):  # the generic path's launches are counted alone
        _zero_counts(counters)
        for b in batches:
            states[fused].append(sae_train_step(states[fused][-1], b,
                                                c.replace(fused_sae_step=fused))[0])
        torch.cuda.synchronize()
        launches[fused] = {k: f.launches for k, f in counters.items()}
    if (launches[False]["kth_value"] != STEP_CHECK_STEPS
            or launches[False]["sae_fused_forward_topk"] != 0
            or launches[True]["sae_fused_forward_topk"] != STEP_CHECK_STEPS
            or launches[True]["kth_value"] != 0):
        raise AssertionError(f"TopK step check launches: generic {launches[False]}, "
                             f"fused {launches[True]}")
    flips, switched = 0, torch.zeros(cfg.d_sae, dtype=torch.bool, device="cuda")
    for j, b in enumerate(batches):
        flip = _topk_masks(states[True][j], b, c, True) != _topk_masks(states[False][j], b, c,
                                                                     False)
        flips += int(flip.sum())
        switched |= flip.any(dim=0)
    got, want = train_state_to_numpy(states[True][-1]), train_state_to_numpy(states[False][-1])
    mask = switched.cpu().numpy()
    errs, scales = {}, {}
    for k in want:
        d = np.abs(got[k].astype(np.float64) - want[k])
        scales[k] = float(np.abs(want[k]).max())
        if k.endswith(("/W_enc", "/b_enc", "/W_dec")):
            sw = mask[:, None] if k.endswith("/W_dec") else mask
            sw = np.broadcast_to(sw, d.shape)
            errs[k] = {"unswitched": float(d[~sw].max()) if (~sw).any() else 0.0,
                       "switched": float(d[sw].max()) if sw.any() else 0.0}
        else:
            errs[k] = {"unswitched": float(d.max()), "switched": 0.0}

    # encode of the trained SAE (B10) against B8's masked h, both float32
    sae = trainer.sae
    x = batches[0]
    _zero_counts(counters)
    feats = sae.encode(x)
    torch.cuda.synchronize()
    encode_launches = counters["kth_value"].launches
    p = {k: v.detach()[None] for k, v in sae.params.items()}
    h8 = sae_fused_forward_topk(x[None], p["W_enc"], p["b_enc"], p["W_dec"], p["b_dec"],
                                cfg.topk_k, save_h=True)[4][0]
    enc_flip = (feats > 0) != (h8 > 0)
    ok_rows = ~enc_flip.any(dim=-1)
    enc_err = (feats - h8).abs()[ok_rows].max().item() if ok_rows.any() else math.inf
    enc = {"launches": encode_launches, "mask_flips": int(enc_flip.sum()),
           "rows_with_flips": int((~ok_rows).sum()), "max_abs_err_unflipped_rows": enc_err,
           "tol": rel_atol(TOPK_ENCODE_REL, h8), "l0": (feats > 0).float().sum(-1).mean().item()}
    if not (encode_launches == 1 and enc_err <= enc["tol"]
            and enc["mask_flips"] <= TOPK_FLIP_FRAC * feats.numel()
            and enc["rows_with_flips"] <= TOPK_FLIP_ROW_FRAC * x.shape[0]):
        raise AssertionError(f"encode against B8: {enc}")
    rec = {"phase": "topk_step_check", **info, "steps": STEP_CHECK_STEPS, "dtype": "float32",
           "start_step": int(trainer.state.step), "threshold_switches": flips,
           "switched_features": int(switched.sum()), "launches_generic": launches[False],
           "launches_fused": launches[True], "state_max_abs_err": errs,
           "state_absmax": scales,
           "act_freq_abs_diff_sum": float(np.abs(got["act_freq_scores"]
                                                 - want["act_freq_scores"]).sum()),
           "encode_vs_B8": enc}
    emit(rec)
    check_steps([{}], errs, scales, flips, int(switched.sum()), got, want)
    return launches[False]["kth_value"] + encode_launches


def sweep_config():
    from vit_prisma_tpu_torch.sae import SAERunnerConfig
    return SAERunnerConfig(
        model_name=SWEEP_MODEL, d_in=1024, expansion_factor=8, context_size=257,
        sweep_layers=tuple(range(24)), layer_subtype="hook_resid_post",
        store_batch_size=48, n_batches_in_buffer=2, train_batch_size=4096,
        steps_per_dispatch=6, compute_dtype="bfloat16", lr=1e-3,
        lr_scheduler_name="constant", b_dec_init_method="zeros",
        log_to_wandb=False, buffer_tokens_override=49_152, wandb_log_frequency=3)


def _sae_counters():
    """Every kernel wrapper of the port, by name, for its launch count."""
    from vit_prisma_tpu_torch.ops.attention import attention_mix_tnh
    from vit_prisma_tpu_torch.ops.opt_step import adam_update
    from vit_prisma_tpu_torch.ops import sae_step as S
    from vit_prisma_tpu_torch.ops.shuffle import take_rows
    from vit_prisma_tpu_torch.ops.topk import kth_value
    return {f.__name__: f for f in (
        attention_mix_tnh, take_rows, S.sae_fused_forward, S.sae_fused_backward,
        S.sae_fused_backward_stored, adam_update, S.sae_fused_forward_topk,
        S.sae_fused_backward_topk, kth_value, S.sae_gated_fused_forward,
        S.sae_gated_fused_backward)}


def _zero_counts(counters):
    for f in counters.values():
        f.launches = 0


def _check_sweep_metrics(metrics_list, layers):
    """Finite loss, L0 and EV for every layer, and L0 > 0 at every read for
    every layer outside ``SWEEP_L0_EXEMPT``."""
    for vals in metrics_list:
        for k in ("loss", "l0", "explained_variance"):
            if len(vals[k]) != len(layers) or not all(math.isfinite(v) for v in vals[k]):
                raise AssertionError(f"{k}: {vals[k]}")
        if not all(v > 0 for l, v in zip(layers, vals["l0"]) if l not in SWEEP_L0_EXEMPT):
            raise AssertionError(f"L0 {vals['l0']} (layers {SWEEP_L0_EXEMPT} exempt)")


def phase_sweep(info):
    """The slice's main path: the L/14 24-SAE sweep on the card."""
    from vit_prisma_tpu_torch import HookedViT, get_model_config
    from vit_prisma_tpu_torch.sae import SAESweepTrainer, VisionActivationsStore
    cfg = sweep_config()
    L = len(cfg.sweep_layers)
    model = HookedViT(get_model_config(SWEEP_MODEL, dtype="bfloat16"), device="cuda",
                      generator=torch.Generator().manual_seed(0))
    images = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (SWEEP_IMAGES, 3, cfg.image_size, cfg.image_size), dtype=np.float32)).to("cuda")
    counters = _sae_counters()
    torch.cuda.synchronize()
    release()
    torch.cuda.reset_peak_memory_stats()

    # The main path, with every count set to 0 just before it.
    _zero_counts(counters)
    t0 = time.perf_counter()
    store = VisionActivationsStore(cfg, model, images)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    trainer = SAESweepTrainer(cfg, model, store)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0 - fill_s
    refills = _time_refills(store)
    log = _record_logs(trainer)
    t1 = time.perf_counter()
    saes = trainer.run(max_steps=SWEEP_STEPS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t1
    run_refills = len(refills)
    t2 = time.perf_counter()
    cycle_metrics = trainer.train_cycles(SWEEP_CYCLES)
    torch.cuda.synchronize()
    cycles_s = time.perf_counter() - t2
    launches = {k: f.launches for k, f in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    refills = list(refills)  # the main path's; later refills are not its

    K = cfg.steps_per_dispatch
    steps = SWEEP_STEPS + SWEEP_CYCLES * K
    per_batch = store.tokens_per_store_batch
    harvests = -(-cfg.tokens_per_buffer // per_batch) + \
        len(refills) * -(-(cfg.tokens_per_buffer // 2) // per_batch)
    backward = ("sae_fused_backward" if cfg.fused_store_acts is False
                else "sae_fused_backward_stored")
    expected = dict.fromkeys(counters, 0)
    expected.update({"attention_mix_tnh": (max(cfg.sweep_layers) + 1) * harvests,
                     "take_rows": 1 + len(refills), "sae_fused_forward": steps,
                     "adam_update": 4 * steps})
    expected[backward] = steps
    formulas = {"attention_mix_tnh": "(last sweep layer + 1) x harvest batches",
                "take_rows": "1 + refills", "sae_fused_forward": "steps",
                backward: "steps (fused_store_acts picks the backward)",
                "adam_update": "4 tensors x steps"}
    # run() serves the fill's first half, then refills every K steps; each
    # cycle refills once
    if len(refills) != SWEEP_STEPS // K - 1 + SWEEP_CYCLES or launches != expected:
        raise AssertionError(f"sweep launches {launches}, expected {expected}, "
                             f"{len(refills)} refills")
    host = [trainer.log_metrics(type(cycle_metrics)(*(f[j] for f in cycle_metrics)))
            for j in range(K)]
    per_layer = lambda vals, k: [vals[f"layer_{l}/{k}"] for l in cfg.sweep_layers]
    _check_sweep_metrics([{k: per_layer(v, k) for k in ("loss", "l0", "explained_variance")}
                          for v in log + host], cfg.sweep_layers)
    if not all(v > 0 for v in per_layer(log[0], "l0")):  # every layer fires at first
        raise AssertionError(f"L0 at the first read {per_layer(log[0], 'l0')}")
    if int(trainer.state.step[0]) != steps or len(saes) != L:
        raise AssertionError(f"step {trainer.state.step.tolist()}, {len(saes)} SAEs")
    if not all(torch.isfinite(v).all() for v in trainer.state.params.values()):
        raise AssertionError("non-finite SAE parameters")

    # The remat backward (B5) through the same entry points: one cycle with
    # fused_store_acts=False, counts set to 0 just before it.
    remat = SAESweepTrainer(cfg.replace(fused_store_acts=False), model, store)
    remat.load_state(trainer.state)
    _zero_counts(counters)
    t3 = time.perf_counter()
    remat_metrics = remat.train_cycles(1)
    torch.cuda.synchronize()
    remat_s = time.perf_counter() - t3
    remat_launches = {k: f.launches for k, f in counters.items()}
    if (remat_launches["sae_fused_backward"] != K or remat_launches["sae_fused_forward"] != K
            or remat_launches["sae_fused_backward_stored"] != 0):
        raise AssertionError(f"remat cycle launches {remat_launches}")
    remat_host = trainer.log_metrics(type(remat_metrics)(*(f[-1] for f in remat_metrics)))
    _check_sweep_metrics([{k: per_layer(remat_host, k)
                           for k in ("loss", "l0", "explained_variance")}], cfg.sweep_layers)

    # the multi-step loop's [K, B, L, d] -> [K, L, B, d] transpose, alone
    block = store.next_batches(K)
    transpose_ms = cuda_us(lambda: block.transpose(1, 2).contiguous(), iters=5) / 1000.0
    sae_tokens = steps * cfg.train_batch_size * L
    train_s = run_s + cycles_s
    emit({"phase": "sweep", **info, "model": SWEEP_MODEL,
          "weights": "random, seed 0, bfloat16 (pretrained weights are not in the repository)",
          "dataset": f"{SWEEP_IMAGES} random float32 {cfg.image_size}px images, numpy seed 5, "
                     "on the card",
          "changed_from_bench_py_189_214": {
              "model": "the port's openai/clip-vit-large-patch14 registry entry in bf16",
              "images": "float32 on the card, not the uint8 wire with device_norm "
                        "(ROADMAP queue A, item 6)",
              "prefetch": "none in the port (the harvest runs at refill time)",
              "wandb_log_frequency": "3, not 10: per-layer metrics read every 3 steps"},
          "layers": L, "d_in": cfg.d_in, "d_sae": cfg.d_sae,
          "train_batch_size": cfg.train_batch_size, "compute_dtype": cfg.compute_dtype,
          "buffer_rows": cfg.tokens_per_buffer, "steps": steps,
          "run_steps": SWEEP_STEPS, "cycles": SWEEP_CYCLES, "backward": backward,
          "launches": launches, "expected_launches": expected, "formulas": formulas,
          "harvest_batches": harvests, "refills_in_run": run_refills,
          "store_fill_s": fill_s, "trainer_init_s": init_s, "run_s": run_s,
          "cycles_s": cycles_s, "refill_s": refills,
          "sae_tokens_per_s": sae_tokens / train_s,
          "sae_tokens_per_s_with_fill_and_init": sae_tokens / (fill_s + init_s + train_s),
          "sae_tokens_per_s_without_refill": sae_tokens / (train_s - sum(refills)),
          "step_ms_without_refill": 1000 * (train_s - sum(refills)) / steps,
          "peak_memory_GB": peak_gb, "transpose_ms": transpose_ms,
          "remat_cycle": {"launches": remat_launches, "seconds": remat_s,
                          "mean_loss_last_step": remat_host["loss"]},
          "metrics_logged": [{k: v[k] for k in ("loss", "l0", "explained_variance")}
                             for v in log],
          "l0_per_layer_logged": [per_layer(v, "l0") for v in log],
          "l0_checked_above_0_except_layers": list(SWEEP_L0_EXEMPT),
          "ev_per_layer_logged": [per_layer(v, "explained_variance") for v in log],
          "metrics_last": {k: host[-1][k] for k in ("loss", "l0", "explained_variance")}})
    return trainer, store, cfg, launches, remat_launches


def _layer_slice(state, layers):
    from vit_prisma_tpu_torch.sae.train import _map_state
    return _map_state(lambda a: a[:layers].clone(), state)


def _path_masks(state, x, cfg, fused):
    """The active-set mask [L, B, S] that a step from ``state`` counts:
    kernel B4's (float32 pre-activations) on the fused path, the bf16 or
    float32 ``encode`` of each layer on the generic path."""
    from vit_prisma_tpu_torch.ops.sae_step import sae_fused_forward
    from vit_prisma_tpu_torch.sae.sae import encode, set_decoder_norm_to_unit_norm
    dt = cfg.compute_torch_dtype or cfg.torch_dtype
    p = {k: v.to(dt) for k, v in set_decoder_norm_to_unit_norm(state.params).items()}
    if fused:
        hc = sae_fused_forward(x.to(dt), p["W_enc"], p["b_enc"], p["W_dec"], p["b_dec"],
                               save_h=True)[3]
        return hc.float() > 0
    return torch.stack([encode({k: v[l] for k, v in p.items()}, cfg, x[l])[1] > 0
                        for l in range(x.shape[0])])


def phase_sweep_step_check(info, trainer, store, cfg):
    """Three fused sweep steps against three generic ones from one state."""
    from vit_prisma_tpu_torch.sae.convert import train_state_to_numpy
    from vit_prisma_tpu_torch.sae.train import sae_sweep_train_step
    batches = torch.stack([store.next_batch() for _ in range(3)])
    out = {}
    for dtype, layers in SWEEP_CHECK_LAYERS.items():
        c = cfg.replace(sweep_layers=tuple(range(layers)),
                        compute_dtype="bfloat16" if dtype == torch.bfloat16 else None)
        xs = batches[:, :, :layers].float() if dtype == torch.float32 else batches[:, :, :layers]
        states = {True: _layer_slice(trainer.state, layers),
                  False: _layer_slice(trainer.state, layers)}
        switches = torch.zeros(layers, cfg.d_sae, device="cuda")
        metrics = {True: [], False: []}
        for b in xs:
            x = b.transpose(0, 1).contiguous()
            switches += (_path_masks(states[True], x, c, True)
                         != _path_masks(states[False], x, c, False)).sum(dim=1)
            for fused in (True, False):
                states[fused], m = sae_sweep_train_step(states[fused], b,
                                                        c.replace(fused_sae_step=fused))
                metrics[fused].append(m)
        got, want = train_state_to_numpy(states[True]), train_state_to_numpy(states[False])
        sw = switches.cpu().numpy()
        errs = {}
        for k in want:
            if k.startswith(("params/", "mu/", "nu/")):
                d = np.abs(got[k].astype(np.float64) - want[k])
                errs[k] = {"max": float(d.max()), "p999": float(np.quantile(d, 0.999)),
                           "median": float(np.median(d)), "absmax": float(np.abs(want[k]).max())}
        act = np.abs(got["act_freq_scores"] - want["act_freq_scores"])
        fired = got["n_forward_passes_since_fired"] != want["n_forward_passes_since_fired"]
        metric_errs = {}
        for f in ("loss", "mse_loss", "l1_loss", "l0", "explained_variance"):
            a = torch.stack([getattr(m, f) for m in metrics[True]]).float()
            b = torch.stack([getattr(m, f) for m in metrics[False]]).float()
            # relative, except EV, whose value may lie near 0: against max(1, |EV|)
            floor = 1.0 if f == "explained_variance" else 1e-6
            metric_errs[f] = ((a - b).abs() / b.abs().clamp(min=floor)).max(dim=1).values.tolist()
        rec = {"phase": "sweep_step_check", **info, "dtype": str(dtype).split(".")[1],
               "layers": layers, "steps": 3, "relu_switches": float(sw.sum()),
               "act_freq_within_switches": bool((act <= sw).all()),
               "fired_differ_only_where_switched": bool((~fired | (sw > 0)).all()),
               "exact": {k: bool(np.array_equal(got[k], want[k])) for k in (
                   "adam_count", "schedule_count", "step", "n_training_tokens",
                   "n_frac_active_tokens")},
               "state_abs_err": errs, "metric_rel_err_per_step": metric_errs}
        emit(rec)
        out[dtype] = rec
        del states
    return out


def check_sweep_steps(recs):
    for dtype, rec in recs.items():
        if not (rec["act_freq_within_switches"] and rec["fired_differ_only_where_switched"]
                and all(rec["exact"].values())):
            raise AssertionError(f"sweep step check {dtype}: counters {rec}")
        bounds = SWEEP_CHECK_TOL[dtype]
        for k, e in rec["state_abs_err"].items():
            if k.startswith("params/") and not (e["max"] <= bounds["param_max"]
                                                and e["p999"] <= bounds["param_p999"]):
                raise AssertionError(f"sweep step check {dtype} {k}: {e} vs {bounds}")
        for f, errs in rec["metric_rel_err_per_step"].items():
            if not errs[0] <= bounds["step1_metric_rel"]:
                raise AssertionError(f"sweep step check {dtype} {f}: {errs}")


def _gated_masks_plain(x, We, bg, rmag, bm, bd):
    """The plain version's gate and magnitude masks [L, B, S], from its own
    products (B12's plain version recomputes the same)."""
    from vit_prisma_tpu_torch.ops import sae_step as S
    _, _, hg, hm = S._gated_pre(x, We, bg, torch.exp(rmag.float()), bm, bd)
    return hg > 0, (hg > 0) & (hm > 0), hg


def phase_gated_kernels(info):
    """B11 and B12 against their plain versions at the gated slice's shape
    and two layers of the sweep's widths."""
    from vit_prisma_tpu_torch.ops import sae_step as S
    g = torch.Generator(device="cuda").manual_seed(8)
    results = {}
    for name, L, B, D, Sd, dtype in GATED_SHAPES:
        x, We, bg, Wd, bd, dy, dl1 = _sae_inputs(g, L, B, D, Sd, dtype)
        r = lambda *shape, sc: (torch.randn(*shape, generator=g, device="cuda") * sc).to(dtype)
        rmag, bm, dvia = r(L, Sd, sc=0.1), r(L, Sd, sc=0.01), r(L, B, D, sc=1e-3)
        args = (x, We, bg, rmag, bm, Wd, bd)
        y, via, l1, nact, hc, hgac = S.sae_gated_fused_forward(*args, save_h=True)
        torch.cuda.synchronize()
        yr, viar, l1r, nactr = S.sae_gated_fused_forward_reference(*args)
        gate_k, mag_k = hgac.float() > 0, hc.float() > 0
        gate_p, mag_p, hg_p = _gated_masks_plain(x, We, bg, rmag, bm, bd)
        gflip, mflip = gate_k != gate_p, mag_k != mag_p
        del gate_p, mag_p, hc, hgac
        flip = gflip | mflip
        flip_rows = flip.any(dim=-1)
        switched = flip.any(dim=1)  # [L, S]
        wdn = S._gated_hoisted(rmag, Wd)[1]
        flipped_hg = (hg_p.abs() * gflip).amax(dim=(1, 2))
        l1_bound = SAE_L1_REL * l1r.abs() + gflip.sum(dim=(1, 2)) * flipped_hg * wdn.amax(dim=1)
        y_err = (y.float() - yr.float()).abs()[~flip_rows]
        via_err = (via.float() - viar.float()).abs()[~flip_rows]
        fwd = {"y_unflipped_rows": y_err.max().item() if y_err.numel() else math.inf,
               "via_unflipped_rows": via_err.max().item() if via_err.numel() else math.inf,
               "y_tol": rel_atol(SAE_REL[dtype], yr), "via_tol": rel_atol(SAE_REL[dtype], viar),
               "gate_flips": int(gflip.sum()), "magnitude_flips": int(mflip.sum()),
               "flip_frac": flip.float().mean().item(),
               "rows_with_flips": int(flip_rows.sum()),
               "row_flip_frac": flip_rows.float().mean().item(),
               "nact_minus_own_mask": (nact - mag_k.sum(dim=1, dtype=torch.float32)
                                       ).abs().max().item(),
               "nact_abs_diff_sum": (nact - nactr).abs().sum().item(),
               "active_frac": mag_k.float().mean().item(),
               "gate_open_frac": gate_k.float().mean().item(),
               "l1_abs_err": (l1 - l1r).abs().max().item(), "l1_tol": l1_bound.max().item()}
        if not (fwd["y_unflipped_rows"] <= fwd["y_tol"]
                and fwd["via_unflipped_rows"] <= fwd["via_tol"]
                and fwd["flip_frac"] <= GATED_FLIP_FRAC
                and fwd["row_flip_frac"] <= TOPK_FLIP_ROW_FRAC
                and fwd["nact_minus_own_mask"] == 0
                and bool(((l1 - l1r).abs() <= l1_bound).all())
                and bool(((nact - nactr).abs() <= mflip.sum(dim=1)).all())):
            raise AssertionError(f"{name} gated forward: {fwd}")
        del yr, viar, gflip, mflip, flip, flip_rows, hg_p, gate_k, mag_k
        grads = S.sae_gated_fused_backward(*args, dy, dvia, dl1)
        torch.cuda.synchronize()
        bwd = _grad_errs(f"{name} B12", grads,
                         S.sae_gated_fused_backward_reference(*args, dy, dvia, dl1), switched,
                         dtype, keys=("dW_enc", "dW_dec", "db_gate", "db_mag", "dr_mag"))
        del grads
        flop = 2 * L * B * D * Sd
        eb = x.element_size()
        gemm = "bf16_tensor" if dtype == torch.bfloat16 else "fp32"
        w_bytes = (2 * L * D * Sd + 3 * L * Sd + L * D) * eb  # W_enc, W_dec, 3 biases, b_dec
        ms = lambda fn, it: cuda_us(fn, iters=it, warmup=1) / 1000.0
        calls = {
            "sae_gated_fused_forward": (
                lambda: S.sae_gated_fused_forward(*args),
                lambda: S.sae_gated_fused_forward_reference(*args),
                3 * L * B * D * eb + w_bytes + L * 4 + L * Sd * 4, 3 * flop),
            "sae_gated_fused_backward": (
                lambda: S.sae_gated_fused_backward(*args, dy, dvia, dl1),
                lambda: S.sae_gated_fused_backward_reference(*args, dy, dvia, dl1),
                3 * L * B * D * eb + w_bytes + L * 4 + (2 * L * D * Sd + 3 * L * Sd) * 4,
                6 * flop)}
        for kernel, (fn, plain, nbytes, n_flop) in calls.items():
            k_ms, plain_ms = ms(fn, 5), ms(plain, 2)
            rec = {"phase": "kernel", **info, "kernel": kernel, "shape": name, "path": "gated",
                   "L": L, "B": B, "d_in": D, "d_sae": Sd, "dtype": str(dtype).split(".")[1],
                   "max_abs_err": (max(fwd["y_unflipped_rows"], fwd["via_unflipped_rows"])
                                   if kernel == "sae_gated_fused_forward"
                                   else max(e["unswitched"] for e in bwd.values())),
                   "ms": k_ms, "plain_ms": plain_ms, "TFLOP": n_flop / 1e12,
                   "TFLOP_per_s": n_flop / k_ms / 1e9,
                   "plain_TFLOP_per_s": n_flop / plain_ms / 1e9,
                   **bound(nbytes, [(gemm, n_flop)])}
            if kernel == "sae_gated_fused_forward":
                rec["forward"] = fwd
            else:
                rec["grad_errs"] = bwd
            results[(kernel, name)] = rec
            emit(rec)
        del x, We, bg, rmag, bm, Wd, bd, dy, dvia, y, via, args
        torch.cuda.empty_cache()
    return results


def gated_config():
    """The gated slice: bench.py's gated row (bf16 compute, float32 masters)
    at SAERunnerConfig's default widths, with phase 5's 4-batch buffer."""
    from vit_prisma_tpu_torch.sae import SAERunnerConfig
    return SAERunnerConfig(architecture="gated", compute_dtype="bfloat16",
                           n_batches_in_buffer=TRAIN_BUFFER_BATCHES)


def _gated_step_masks(state, x, cfg, fused):
    """The gate and magnitude masks [B, d_sae] that a step from ``state``
    computes: kernel B11's on the fused path, ``encode``'s (the reference's
    two products) on the generic path."""
    from vit_prisma_tpu_torch.ops.sae_step import sae_gated_fused_forward
    from vit_prisma_tpu_torch.sae.sae import encode, set_decoder_norm_to_unit_norm
    p = set_decoder_norm_to_unit_norm(state.params)
    if fused:
        q = {k: v[None] for k, v in p.items()}
        out = sae_gated_fused_forward(x[None], q["W_enc"], q["b_gate"], q["r_mag"], q["b_mag"],
                                      q["W_dec"], q["b_dec"], save_h=True)
        return out[5][0] > 0, out[4][0] > 0
    _, feats, gate_pre, _ = encode(p, cfg, x)
    return gate_pre > 0, feats > 0


def phase_gated_step_check(info, trainer, store, cfg):
    """From the trained gated state, three fused steps (B11, B12) against
    three generic steps in float32."""
    from vit_prisma_tpu_torch.sae.convert import train_state_to_numpy
    from vit_prisma_tpu_torch.sae.train import sae_train_step
    c = cfg.replace(compute_dtype=None)
    batches = [store.next_batch() for _ in range(STEP_CHECK_STEPS)]
    counters = _sae_counters()
    states = {True: [trainer.state], False: [trainer.state]}
    launches = {}
    for fused in (False, True):
        _zero_counts(counters)
        for b in batches:
            states[fused].append(sae_train_step(states[fused][-1], b,
                                                c.replace(fused_sae_step=fused))[0])
        torch.cuda.synchronize()
        launches[fused] = {k: f.launches for k, f in counters.items()}
    if (launches[False]["sae_gated_fused_forward"] != 0
            or launches[True]["sae_gated_fused_forward"] != STEP_CHECK_STEPS
            or launches[True]["sae_gated_fused_backward"] != STEP_CHECK_STEPS):
        raise AssertionError(f"gated step check launches: generic {launches[False]}, "
                             f"fused {launches[True]}")
    flips, switched = 0, torch.zeros(cfg.d_sae, dtype=torch.bool, device="cuda")
    for j, b in enumerate(batches):
        for a, w in zip(_gated_step_masks(states[True][j], b, c, True),
                        _gated_step_masks(states[False][j], b, c, False)):
            flip = a != w
            flips += int(flip.sum())
            switched |= flip.any(dim=0)
    got, want = train_state_to_numpy(states[True][-1]), train_state_to_numpy(states[False][-1])
    mask = switched.cpu().numpy()
    errs, scales = {}, {}
    for k in want:
        d = np.abs(got[k].astype(np.float64) - want[k])
        scales[k] = float(np.abs(want[k]).max())
        if k.endswith(("/W_enc", "/W_dec", "/b_gate", "/r_mag", "/b_mag")):
            sw = np.broadcast_to(mask[:, None] if k.endswith("/W_dec") else mask, d.shape)
            errs[k] = {"unswitched": float(d[~sw].max()) if (~sw).any() else 0.0,
                       "switched": float(d[sw].max()) if sw.any() else 0.0}
        else:
            errs[k] = {"unswitched": float(d.max()), "switched": 0.0}
    b_enc_zero = all(not np.any(a[k]) for a in (got, want)
                     for k in ("params/b_enc", "mu/b_enc", "nu/b_enc"))
    emit({"phase": "gated_step_check", **info, "steps": STEP_CHECK_STEPS, "dtype": "float32",
          "start_step": int(trainer.state.step), "mask_switches": flips,
          "switched_features": int(switched.sum()), "launches_generic": launches[False],
          "launches_fused": launches[True], "state_max_abs_err": errs,
          "state_absmax": scales, "b_enc_and_moments_zero": b_enc_zero,
          "act_freq_abs_diff_sum": float(np.abs(got["act_freq_scores"]
                                                - want["act_freq_scores"]).sum())})
    if not b_enc_zero:
        raise AssertionError("the gated b_enc or its moments left 0")
    check_steps([{}], errs, scales, flips, int(switched.sum()), got, want)


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
    kth = phase_kth_value(info)
    fused, plain = phase_slice(info)
    launches = phase_serve(info, fused, plain)
    del fused, plain
    trainer, store, cfg, train_launches = phase_train(info)
    check_steps(*phase_step_check(info, trainer, store, cfg))
    del trainer, store
    release()
    sae_step_kernels = phase_sae_step_kernels(info)
    topk_kernels = phase_topk_kernels(info)
    trainer, store, cfg, topk_launches = phase_train(info, topk_config(), "topk_train")
    topk_remat_launches = phase_topk_remat(info, trainer, store, cfg)
    kth_launches = phase_topk_step_check(info, trainer, store, cfg)
    phase_step_profile(info, trainer, store, cfg, "topk_profile")
    del trainer, store
    release()
    sweep, sweep_store, sweep_cfg, sweep_launches, remat_launches = phase_sweep(info)
    check_sweep_steps(phase_sweep_step_check(info, sweep, sweep_store, sweep_cfg))
    del sweep, sweep_store
    release()
    gated_kernels = phase_gated_kernels(info)
    trainer, store, cfg, gated_launches = phase_train(info, gated_config(), "gated_train")
    phase_step_profile(info, trainer, store, cfg, "gated_profile")
    phase_gated_step_check(info, trainer, store, cfg)
    del trainer, store

    def entry(name, source, replaces, launches, rec, ms_key="ms", scale=1.0):
        """One kernel's line: launches from its main path, the rest measured
        at the shape that path gives it."""
        lib = rec.get("library_" + ms_key)
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": rec["max_abs_err"],
                "ms": rec[ms_key] * scale, "plain_ms": rec["plain_" + ms_key] * scale,
                "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                "library_ms": None if lib is None else lib * scale}

    adam = [sae_kernels[("adam_update", name, torch.float32)] for name, _, _ in ADAM_SHAPES]
    adam_bytes = sum(r["MB_moved"] for r in adam) * 1e6
    adam_ops = sum(15 * math.prod(r["dims"]) for r in adam)
    adam_rec = {"max_abs_err": max(max(r["max_abs_err"].values()) for r in adam),
                "us": sum(r["us"] for r in adam), "plain_us": sum(r["plain_us"] for r in adam),
                **bound(adam_bytes, [("fp32", adam_ops)])}
    sweep_rec = lambda k: sae_step_kernels[(k, "sweep_bf16")]
    topk_rec = lambda k: topk_kernels[(k, "slice_bf16")]
    line = [
        entry("attention_mix_tnh", KERNEL_SOURCE, KERNEL_REPLACES, launches,
              kernels[("b32", torch.bfloat16)], "us", 1e-3),
        entry("take_rows", TAKE_ROWS_SOURCE, TAKE_ROWS_REPLACES, train_launches["take_rows"],
              sae_kernels[("take_rows", "store_f32")], "us", 1e-3),
        # one train step's four tensors, float32 moments
        entry("adam_update", ADAM_SOURCE, ADAM_REPLACES, train_launches["adam_update"],
              adam_rec, "us", 1e-3),
        # at the sweep's bf16 shape; launches from the sweep's main path (B5:
        # from its remat cycle; B6: the sweep's and the TopK slice's)
        entry("sae_fused_forward", SAE_FWD_SOURCE, SAE_REPLACES["sae_fused_forward"],
              sweep_launches["sae_fused_forward"], sweep_rec("sae_fused_forward")),
        entry("sae_fused_backward", SAE_BWD_SOURCE, SAE_REPLACES["sae_fused_backward"],
              remat_launches["sae_fused_backward"], sweep_rec("sae_fused_backward")),
        entry("sae_fused_backward_stored", SAE_BWD_SOURCE,
              SAE_REPLACES["sae_fused_backward_stored"],
              sweep_launches["sae_fused_backward_stored"]
              + topk_launches["sae_fused_backward_stored"],
              sweep_rec("sae_fused_backward_stored")),
        # at the TopK slice's bf16 shape; launches from its train path (B9:
        # from its remat steps)
        entry("sae_fused_forward_topk", TOPK_FWD_SOURCE, TOPK_REPLACES["sae_fused_forward_topk"],
              topk_launches["sae_fused_forward_topk"], topk_rec("sae_fused_forward_topk")),
        entry("sae_fused_backward_topk", SAE_BWD_SOURCE,
              TOPK_REPLACES["sae_fused_backward_topk"],
              topk_remat_launches["sae_fused_backward_topk"],
              topk_rec("sae_fused_backward_topk")),
        # the generic TopK step's float32 [4096, 12288]; launches from the
        # generic steps and encode of the TopK step check
        entry("kth_value", KTH_SOURCE, KTH_REPLACES, kth_launches, kth["slice_f32"])]
    # at the gated slice's bf16 shape; launches from its train path
    line += [entry(k, GATED_SOURCES[k], GATED_REPLACES[k], gated_launches[k],
                   gated_kernels[(k, "slice_bf16")]) for k in GATED_SOURCES]
    missing = [e["name"] for e in line if not e["launches"] > 0]
    if missing:
        raise AssertionError(f"kernels not launched on their main paths: {missing}")
    print(name_power)
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    sys.exit(main())
