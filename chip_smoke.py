#!/usr/bin/env python3
"""Check that the PyTorch port builds, runs and agrees on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing JSON lines with the card's name and power limit:

1. build: compile the CUDA kernels from ``vit_prisma_tpu_torch/csrc``, one
   nvcc process per source, all started together; the registers of the
   mix's tensor-core kernels (bfloat16, and the float32 3xTF32 ones of B1,
   B15 and B2), none of which may spill;
2. kernel: every kernel against its plain PyTorch version on the card, at
   the shapes its path gives it, with both times from CUDA events, the
   time of one library call computing the same function where there is one
   (never used by the port) and the kernel's bound (bytes over the memory
   rate or operations over their peak rate, a float32 product as three
   TF32 products): B1 (``attention_mix_tnh``) at the ViT shapes, the
   default SAE harvest's, the route gate's last T and a padded head width
   (88), in both dtypes (on the tensor cores: bfloat16, and float32 as
   3xTF32), item 0 alone equal to item 0 of the batch to the bit, the
   float32 records with their route and the kernels ``torch.profiler``
   saw, beside ``scaled_dot_product_attention``; then
   ``mix_kernels``, the path of B15 (``attention_mix``) and B16
   (``fused_attention_block``), the JAX package's two kernels without a
   caller: each entry point once at B/32 in bfloat16, forward and backward,
   with exact launches, then B15 against its plain version at B/32 (both
   dtypes) and CLIP L/14, equal to B1 on the same data transposed, B16
   against its kernel-rounding plain version at B/32 in both dtypes and
   against the JAX reference's twin in float32 (both dtypes also at an odd
   batch, and each image equal to the bit to itself run alone, whatever
   its slot; ptxas's registers and spills; the reckoned L2 and
   device-memory bytes; float32's kernels by name, 3xTF32 only), gradients through both
   wrappers against the plain versions' autograd, beside SDPA and
   ``F.linear`` + SDPA + ``F.linear``; B3
   (``take_rows``) at the activation stores' shapes (the default SAE's in
   both dtypes, the sweep's 49,152-byte rows) and on 3-byte rows and an
   unaligned view with repeated indices, bitwise, with the kernel's own
   device time beside the whole call's (the wrapper's index check syncs the
   host) and ``index_select``'s; B7 (``adam_update``) at the default SAE's
   four tensors with float32 and bfloat16 moments and at the sweep's four
   stacked tensors (24 SAEs, 1024 -> 8192) with float32 moments; B10 (``kth_value``) at
   the generic TopK step's [4096, 12288] and at d_sae 65,536 in both
   dtypes, and at the edges of its routes (one block, a cluster, streamed),
   k = 1 and k = D, rows of one value, of signed zeros and with NaNs,
   bitwise, with the route taken, ptxas's registers and spills, beside
   ``torch.kthvalue``;
3. slice: the CLIP ViT-B/32 resid_post cached forward (12 layers, 768 wide,
   random weights from seed 0) on the card against the same weights on the
   CPU in float32, and in bfloat16 against the einsum attention path;
4. serve: a bfloat16 ``CompiledForward`` at batch 256 answers three
   requests; this is the first main path, whose B1 launches are counted:
   the server runs one CUDA graph, so its launches are its warm-up
   forward's and its replays', each exact (the wrappers' counters move at
   the warm-up and the capture alone; ``torch.profiler`` counts one
   replay's kernels by name).  Then the served images per second with the
   kernel and with the einsum path;
4a. text: the CLIP text tower of ``openai/clip-vit-base-patch32`` (12 x
   512, 8 heads, vocab 49,408, context 77) loaded through
   ``load_hooked_model(model_type="text")`` from an HF ``CLIPModel`` state
   dict drawn from seed 0 (``hf_clip_state_dict``, both towers), raw and
   processed (f32, processed against raw); a BPE merge table learned from
   the 8,000 prompts (the first 100 ImageNet names x 80 templates; the public
   table is not in the repository); the bf16 forward at batch 256 with
   B1's causal launches exact (12), prompts per second in turns with the
   einsum bypass, once with the LN fusion (B14 24, B1 12); f32 at batch 8
   against the CPU; ``run_with_cache(incl_bwd=True)`` over the 12
   resid_post hooks (B1 12, B2 11) against the einsum path, f32 gradients
   against the CPU; ``zero_shot_classifier`` in f32 and bf16 (B1 12 for
   each of 200 forwards) with the tokenizer's seconds apart, unit
   columns, the truncated prompts counted and 2 classes against the CPU;
   ``zero_shot_eval`` of the B/32 vision tower (bf16, same state dict)
   over 2,048 images at batch 256, plain and with a forward hook, each
   equal to a plain top-k count on the same logits.  Its f32 classifier is
   ``sae_eval``'s class embeddings;
5. train: the second main path, SAE training at ``SAERunnerConfig``'s
   defaults (B/32 layer-9 resid_post, 768 -> 12,288, batch 4096, float32)
   with a 2-batch buffer: ``HookedViT`` -> ``VisionActivationsStore`` ->
   ``VisionSAETrainer.run(max_steps=60)``, which crosses one refill.  Every
   kernel's launches are counted and must be exact; training tokens per
   second and peak device memory are printed;
6. step check: from the trained state, three steps on three batches on the
   card and on the CPU in float32; grads, params, moments and counters are
   compared; then ``sae_eval``: that SAE's evals (``process_dataset`` over
   2,048 random images at batch 256 with phase 4a's zero-shot classifier as
   the class embeddings, ``trainer.validate()``, ``evaluate()``
   into ``smoke_out/sae_eval`` with its top images, and a heatmap), exact
   launches (B1 36 an eval batch, 10 a top-image batch), eval images per
   second, CE recovered, L0, alive fraction, peak memory, and one batch of 8
   against the CPU in float32 with its ReLU switches counted;
6a. data: the image pipeline into the store: the host's CPU count, g++,
   libjpeg and PIL; where
   the host has libjpeg (``DATA_JPEG``), the native library's build
   seconds, each fixture JPEG's decode against ``tests/fixtures/jpeg/
   MANIFEST.json`` and ``NativeBatchLoader``'s images per second (4,096
   paths, batch 32, 224 px, both wires, 4 and min(CPUs, 16) workers); the
   default SAE (phase 5's config with a 1-batch buffer: fill 4,096 images,
   2,048 a refill) fed from a host stream (the loader, else 2,048 seeded
   uint8 images and their float32 normalization) three ways, the float32
   wire and the uint8 wire with and without prefetch: fill and refill
   seconds, bytes sent a refill (exact), SAE tokens per second over 30
   steps across the refill, exact launches (B1, B3, B7); prefetch on and off
   to the bit and uint8 against float32 rows on small stores; a uint8
   device-resident dataset with a seeded augment through ``train_cycles``
   equal to the stepwise path to the bit (exact launches); six float16
   shards in a temporary directory (deleted) and ``CachedActivationsStore``
   across a refill that spans two shards, against the float16 harvest;
6b. sae_variants: the SAE variants at B/32 width (random weights from seed
   0, float32): a transcoder from ``blocks.9.hook_resid_mid`` to
   ``blocks.9.hook_mlp_out`` (768 -> 12,288 -> 768, ``W_skip``, batch 4096)
   through the two-hook store (``[409,600, 2, 768]``, rows of 6,144 bytes)
   and ``VisionSAETrainer.run(max_steps=60)`` across one refill, exact
   launches (B1 10 a store batch, B3 one a mix, B7 6 a step), fill and
   refill seconds, SAE tokens per second with and without the refill, and a
   step against the CPU; ghost grads on the default ReLU SAE with a seeded
   quarter of its features dead (the ghost loss, W_dec's alive rows'
   gradients equal to those without ghost grads to the bit, its dead rows'
   moved, pre-activations past exp's overflow counted, a step against the
   CPU); a step under each normalization against the CPU;
   ``topk_use_approx`` (no B8, B9 or B10 launch, exactly k active a row); a
   reference-format checkpoint and a legacy SAELens-v2 dump written at full
   width, loaded onto the card and stepped;
7. SAE kernels: B4 (``sae_fused_forward``), B5 (``sae_fused_backward``) and
   B6 (``sae_fused_backward_stored``) against their plain versions at the
   all-layer sweep's shape (24 SAEs, batch 4096, 1024 -> 8192) and the TopK
   slice's (1 x 4096, 768 -> 12,288) in bfloat16, at two layers in float32
   and at a ViT-S width (384 -> 6144) in bfloat16, with times and TFLOP/s;
   each with the route it took (the bf16 Hopper route, wgmma/TMA, at the
   first two, the mma.sync tiles at ViT-S: checked against the wrapper's
   picker), two calls equal to the bit, the cuBLAS time of its products
   alone beside it and ptxas's record of the Hopper kernels (no spills, no
   serialized wgmma); on the Hopper route B5's recomputed hc is B4's but for
   its -0 marks (counted), and where it marks none B5's grads are B6's on
   B4's hc, to the bit; then B4+B6 against B4+B5 through
   ``sae_fused_apply`` at the sweep's shape in both dtypes, times and peak
   memory, the measurement behind always keeping hc; where B5 marks entries
   its grads are held to the plain backward on its own mask;
7a. remat_marks: B5's -0 marks forced (float32 hpre a subnormal in (0,
   2^-134] at chosen entries) at the TopK slice's and the sweep's widths in
   bf16: B5 marks exactly those entries (so the wgmma accumulators keep
   such values), B4 stores +0 there, and B5's grads match the plain
   backward on its own mask and the plain version;
8. TopK kernels: B8 (``sae_fused_forward_topk``), B9
   (``sae_fused_backward_topk``) and B6 on B8's masked h against their plain
   versions at the TopK slice's shape (1 x 4096, 768 -> 12,288, k = 64) in
   both dtypes, at the sweep's shape in bfloat16 and at a ViT-S width (1 x
   4096, 384 -> 6144) in bfloat16, each with its route (Hopper at the first
   and third, mma.sync at ViT-S, checked against the picker), two calls
   equal to the bit and its products' cuBLAS time, as in phase 7; masks
   that differ from the plain version's are counted and bounded, and the
   kernels' own invariants are exact (nact is the kernel's own mask count,
   t the k-th largest of its own h, and B9 from t gives B6's grads from h
   on the same route, to the bit); then B8+B6 against B8+B9 through
   ``sae_fused_apply_topk``;
9. TopK train: the fourth main path, phase 5's set-up with bench.py's
   bfloat16 TopK row (k = 64, bf16 compute, float32 masters):
   with a 1-batch buffer, ``run(max_steps=30)`` (one refill) through B8 and
   B6 on every step, exact launches
   and routes; then a few steps with ``fused_store_acts=False`` through B9
   (on B8's route); bench.py's TopK recipe at its float32 compute dtype
   (``topk_train_f32``: B8, B6 and B9 on 3xTF32) through the trainer on
   the same store, its steps timed and profiled; and where the time goes:
   fused and generic steps timed
   with CUDA events on buffered batches, and ``torch.profiler``'s device
   time by kernel over three steps of each (with the SAE kernels' share)
   and over one refill, with the device's idle share;
10. TopK step check: three fused steps against three generic steps (B10)
    from the trained state in float32, B10's active sets held to B8's
    within the flip bounds and then pinned to them, so that the whole state
    meets the unswitched bounds, and ``SparseAutoencoder.encode``
    (B10) against B8's masked h; then ``checkpoint``: the TopK row's steps
    on buffered batches, ``save_train_state`` after five, a fresh trainer
    with ``load_state``, five more, equal to ten uninterrupted steps to the
    bit (params, moments, counters; exact launches of B8, B6, B7); SAE files
    in float32 and bfloat16 round trip to the bit; the sweep's
    ``save_checkpoints`` of 24 SAEs timed, all in a temporary directory;
11. sweep: the third main path, the CLIP ViT-L/14 24-SAE sweep of the JAX
    package's benchmark (bf16 model with random weights, 96 random float32
    images on the card): ``HookedViT`` -> sweep ``VisionActivationsStore`` ->
    ``SAESweepTrainer.run(max_steps=18)`` -> ``train_cycles(2)``, then one
    cycle with ``fused_store_acts=False`` (the remat backward, B5).  Launch
    counts and routes exact (the Hopper route, in the remat cycle too);
    SAE-tokens per second and peak memory; ``torch.profiler``'s
    breakdown of one refill, with B1's share, and of sweep steps on buffered
    batches (device time by kernel, the Hopper SAE kernels' share, the idle
    share of steps timed with CUDA events);
12. sweep step check: three fused steps against three steps of the generic
    per-layer path from one state, in bfloat16 at 4 layers and in float32
    at two; then ``sweep_eval``: the sweep trainer's ``validate()`` and
    ``evaluate()`` over its 96 images at batch 32 (B1 exactly 300 a batch:
    24 for the clean forward, 276 for the prefix-shared suffixes), per-layer
    CE recovered and L0, layers 0 and 12 against ``make_eval_step`` with
    that layer's SAE alone, and ``torch.profiler``'s breakdown of one eval
    step, with B1's share;
13. gated kernels: B11 (``sae_gated_fused_forward``) and B12
    (``sae_gated_fused_backward``) against their plain versions at the
    gated slice's shape (1 x 4096, 768 -> 12,288) in both dtypes, at two
    layers of the sweep's widths (2 x 4096, 1024 -> 8192) in bfloat16 and
    at a ViT-S width (384 -> 6144) that keeps the bf16 mma.sync tiles;
    gate and magnitude masks that differ from the plain version's are
    counted and bounded, and nact equals the kernel's own mask count; the
    route each took against the picker (the bf16 Hopper route, wgmma/TMA,
    at the slice and sweep widths), two calls equal to the bit, B12's
    recomputed c(h) and c(hga) equal to B11's to the bit, the cuBLAS time
    of their products alone beside them and ptxas's record of the gated
    Hopper kernels;
14. gated train: the fifth main path, phase 5's set-up with bench.py's
    gated row (bf16 compute, float32 masters), a 1-batch buffer:
    ``run(max_steps=30)``
    through B11 and B12 on every step, exact launches and routes, then
    where a gated step's time goes (``torch.profiler``'s device time by
    kernel, as phase 9);
15. gated step check: three fused steps against three generic steps from
    the trained state in float32;
16. grad kernels: B2 (``attention_mix_tnh_bwd``) against its plain version
    at the B/32 grad paths' shape, CLIP L/14's, the causal text tower's, the
    last T of the gate (causal too) and H 88, in both dtypes (a bf16 head
    past 128 too), batch independence to the bit, the float32 records with
    their route and the kernels ``torch.profiler`` saw, beside the backward
    of ``scaled_dot_product_attention``; B2's gate against B1's;
17. attribution: the sixth main path, demo 06 at full width (bench.py's
    grad-path config, bf16, batch 256): ``run_with_cache(incl_bwd=True)``
    over the 12 resid_post hooks with exact launches, images per second and
    peak memory, the zeroed-gradient intervention, the kernels against the
    einsum path, and float32 gradients against the CPU;
18. vit_train: the seventh main path, the supervised trainer at bench.py's
    row (AdamW, bf16, batch 256): ``make_train_step`` with exact launches,
    images per second, peak memory and ``torch.profiler``'s breakdown; then
    ``train()`` end to end with a checkpoint and a resume from it;
19. vit_train check: three float32 steps at batch 8 on the card and on the
    CPU from one state: gradients, parameters and AdamW moments;
20. sae_attribution: demo 07 at B/32 full width, an error-term ReLU SAE
    spliced at layer 9: the clean forward kept, feature gradients against
    the CPU, exact launches;
21. ln_gemm kernels: B14 (``ln_matmul``) against its plain version at B/32
    serving's QKV and MLP-in shapes in both dtypes, at CLIP L/14-336's
    MLP-in and (unfolded, as LNPre passes it) QKV in bfloat16 and its
    float32 MLP-in at the l14_336_f32 phase's two batches, and at a
    640-column edge (the bf16 kernel's narrow tile, a ragged last row) in
    both dtypes, with ptxas's registers and spills of both routes, the
    float32 calls' kernels by name (3xTF32 only) and a float32 call's
    first 128 rows alone equal to the bit to the same rows of the whole,
    beside the unfused ``F.layer_norm`` and ``torch.matmul``;
22. flash kernels: B13's forward and both backward passes
    (``flash_attention_padded``, ``_bwd_dkv``, ``_bwd_dq``) against their
    plain versions at CLIP L/14-336's serving and attribution shapes and
    causal, and at the video towers' shapes (ViViT-B, 8 x 12 heads, Tp
    3200, H 64; V-JEPA huge, 4 x 16 heads, Tp 1664, H 80), beside
    ``scaled_dot_product_attention``'s forward and backward;
23. serve_ln_fused: phase 4's server with ``use_fused_ln_gemm``, the eighth
    main path: exact launches (B14 24, B1 12 a forward and a replay), the answers
    against the unfused forward, served images per second of both in turns
    and ``torch.profiler``'s breakdown of one forward each;
24. serve_l14_336: CLIP ViT-L/14 at 336 pixels (T = 577), bf16, fused LN,
    ``CompiledForward`` at batch 64, the ninth main path: exact launches
    (B13 24, B14 24, B1 0 a forward), images per second (and, in turns,
    without the LN fusion), peak memory, ``torch.profiler``'s breakdown of
    one batch, the cache against the einsum path, and float32 against the
    CPU through all 24 layers;
25. attribution_l14_336: the tenth main path, ``run_with_cache(incl_bwd=
    True)`` over its 24 resid_post hooks, bf16, batch 32: exact launches
    (B13 forward 24, each backward pass 23, B14 24), images per second, peak
    memory, gradients against the einsum path, and float32 gradients
    against the CPU at 4 layers;
25b. l14_336_f32: the same model in float32 (B13's and B14's 3xTF32
    routes) at full width and depth, the eleventh main path: the cached
    forward over its 24 resid_post hooks at the store batch of 32 and the
    ``incl_bwd`` attribution at batch 8, each with exact launches (B13 24;
    24 forward, 23 each backward pass; B14 24), images per second, and
    B13's and B14's device time and share of one warmed call by the 3xTF32
    kernels' names;
26. video: ViViT-B (12 x 768, 32 frames, T 3137, batch 8 clips) and V-JEPA
    huge (32 x 1280, 16 frames, T 1568, d_head 80, no class token, batch
    4) at full width in bf16: ``run_with_cache`` over the resid_post hooks
    with B13 exactly once a layer on its two routes (wgmma at H 64,
    mma.sync at H 80: the picker and the profiler's kernel names), each
    layer's attention output and block output against the einsum path's
    from the same residual, clips per second, TFLOP/s, peak memory; ViViT-B
    cut to two layers in float32 against the CPU;
27. serve_graph: the graphed ``CompiledForward`` against the eager forward
    of the same padded batches, to the bit, at B/32 (fused LN, batch 256)
    and L/14-336 (batch 64), launches exact per replay, served images per
    second in turns (eager, graph, graph, eager) of 5 batches with each
    batch's time, SM clock and power, the idle share of one graphed batch,
    whose kernels counted by name are the launches per replay (as in phases
    4, 23 and 24);
    then ``export_forward`` -> ``load_forward`` at B/32 against the eager
    einsum forward at batch 1, 7 and 256.
28. analysis: CLIP ViT-B/32 at full width loaded through
    ``load_hooked_model`` from an HF ``CLIPModel``-layout state dict drawn
    from a seed, raw, processed (``fold_ln``, ``center_writing_weights``,
    ``fold_value_biases``) and refactored
    (``refactor_factored_attn_matrices``): the processed and refactored
    forwards on B1's route against the raw one; ``run_with_cache`` to an
    ``ActivationCache`` at batch 8 in float32 and bfloat16 with its
    invariants (heads + remainder = the last resid_post, the remainder =
    the MLPs + b_O + the first resid_pre, neuron results + b_out = mlp_out
    in every layer, the LayerNorm-scaled last residual =
    ``ln_final.hook_normalized``); ``get_full_resid_decomposition
    (expand_neurons=True, apply_ln=True)`` at batch 1 (37,009 components)
    with its time and peak memory, summing to the scaled difference of the
    last resid_post and the first resid_pre; the logit lens over 1,000
    seed-drawn class directions with the ImageNet names against a plain
    einsum and the CPU; B1's launches exactly 12 for each forward on its
    route (the caches with ``hook_z`` take the einsum attention); and
    ``save_local`` -> ``from_local`` on the card to the bit in both dtypes.

The line before the last lists every kernel with its launches on its main
path, its error, times, bound and library time.  It imports no JAX,
catches no failure, and exits non-zero when there is no CUDA card or any
check fails.  The last line is
``{"ok": true, "device": {...}}``.
"""

import dataclasses
import gc
import json
import math
import os
import re
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
# B4's and B6's bf16 Hopper route (sae_gemm_route "wgmma"): its source and
# the kernel's name in ptxas's record
SAE_TC_SOURCE = "vit_prisma_tpu_torch/csrc/sae_fused_tc.cu"
SAE_TC_KERNEL = "sae_tc_kernel"
# The float32 route of every SAE kernel family (sae_gemm_route "tf32x3":
# 3xTF32 on tf32 wgmma): its source, the kernel's name in ptxas's record and
# its modes (0 encoder, 1 decoder, 2 dh, 3 weight gradients, 4 B8's TopK
# encoder, 5 B9's remat encoder, 6 B11's gated encoder, 7 B12's gated remat
# encoder, 8 B12's dg passes, 9 B12's weight gradients), the names of its
# launches (the kernel and the split pre-passes; B8's select and counts),
# its C entry points for B8, B9, B11 and B12, and the mma.sync tiles of
# sae_gemm.cuh, sae_fused_fwd_topk.cu and sae_fused_bwd.cu that no float32
# call may launch
SAE_TF32_SOURCE = "vit_prisma_tpu_torch/csrc/sae_fused_tf32.cu"
SAE_TF32_KERNEL = "sae_tf32_kernel"
SAE_TF32_MODES = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9)
SAE_TF32_TOPK_MODES = (4, 5)
SAE_TF32_GATED_MODES = (6, 7, 8, 9)
SAE_TF32_KERNELS = (SAE_TF32_KERNEL, "split_t_kernel", "split_rows_kernel")
SAE_TF32_TOPK_FWD_KERNELS = (SAE_TF32_KERNEL, "split_t_kernel", "radix_select_kernel",
                             "count_kernel")
SAE_TF32_TOPK_ENTRIES = {"sae_fused_forward_topk": "sae_fused_fwd_topk_tf32",
                         "sae_fused_backward_topk": "sae_fused_bwd_topk_tf32"}
SAE_TF32_GATED_ENTRIES = {"sae_gated_fused_forward": "sae_gated_fwd_tf32",
                          "sae_gated_fused_backward": "sae_gated_bwd_tf32"}
SAE_FFMA_KERNELS = ("encoder_kernel", "encoder_topk_kernel", "threshold_kernel", "dh_kernel",
                    "wgrad_kernel", "decoder_kernel")
# The route each kernel family takes in float32 at every shape the picker
# takes: 3xTF32 in every family (ReLU B4-B6, TopK B8 and B9, gated B11 and
# B12)
SAE_F32_ROUTES = {"relu": "tf32x3", "topk": "tf32x3", "gated": "tf32x3"}
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
# operations over the peak rate of their type: bf16 products on the tensor
# cores; a float32 product ("f32_product") as three TF32 products on the
# tensor cores, the least the card takes for float32 accuracy (3xTF32: one
# TF32 product would round float32 inputs); compares and elementwise work on
# the CUDA cores.
PEAK_OPS = {"bf16_tensor": 989e12, "tf32_tensor": 495e12, "fp32": 67e12}
# Kernel against plain, elementwise max abs error (inputs ~N(0,1)): float32
# differs only in summation order; bfloat16 may round p or z one ulp apart.
KERNEL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# name, B, T, N, H, causal: CLIP B/32 at serving batch, the CLIP text tower
# (causal), CLIP L/14, the last T of the route gate at H 64, a head width
# the tensor-core kernels pad (88 -> 96: the registry's EVA giant/14, T 257,
# N 16), and the default SAE harvest's (B/32 at the store batch of 32,
# float32 by SAERunnerConfig's default).
KERNEL_SHAPES = [
    ("b32", 256, 50, 12, 64, False),
    ("harvest", 32, 50, 12, 64, False),
    ("text_causal", 256, 77, 8, 64, True),
    ("l14", 256, 257, 16, 64, False),
    ("gate_edge", 16, 411, 12, 64, False),
    ("head88", 64, 257, 16, 88, False),
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
# B3 at the store's shape: a 4-batch buffer of the default SAE, 4 x 4096 x 50
# = 819,200 rows of 768, in float32 and bfloat16; the sweep store's buffer
# (49,152 rows of [24, 1024] bfloat16, 49,152 bytes each); the transcoder
# store's (sae_variants: 409,600 rows of [2, 768] float32, 6,144 bytes
# each); and, with M != N and repeated
# indices, rows of 3 bytes and an unaligned view (x[1:] of bfloat16 rows of
# 767), which take 1- and 2-byte accesses.  name, N, row shape, dtype, M (None:
# a permutation of N), offset (x[offset:] of N + offset rows).  The gather is
# exact: it must be bitwise equal.
TAKE_ROWS_SHAPES = [("store_f32", 819_200, (768,), torch.float32, None, 0),
                    ("store_bf16", 819_200, (768,), torch.bfloat16, None, 0),
                    ("sweep_bf16", 49_152, (24, 1024), torch.bfloat16, None, 0),
                    ("transcoder_f32", 409_600, (2, 768), torch.float32, None, 0),
                    ("odd_u8", 819_200, (3,), torch.uint8, 1_000_003, 0),
                    ("unaligned_bf16", 819_200, (767,), torch.bfloat16, 600_001, 1)]
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
# B10's edges, each bitwise against the plain version: the widest row of each
# route and one more (kth_value_route: one block, a cluster, streamed) per
# dtype, k = 1 and k = D, rows of one repeated value, rows of +0.0 and -0.0,
# and rows with NaNs (held to the plain version only: torch.kthvalue orders
# NaN otherwise).  name, rows, D, dtype, k (None: TOPK_K), fill.
KTH_EDGES = [(f"{route}_{dt}_{D}", 8, D, dtype, None, "randn")
             for dt, dtype, widths in (("f32", torch.float32, (16384, 16385, 131072, 131073)),
                                       ("bf16", torch.bfloat16, (32768, 32769, 262144, 262145)))
             for route, D in zip(("block", "cluster", "cluster", "streamed"), widths)] + [
    ("k1_f32", 64, 12288, torch.float32, 1, "randn"),
    ("kD_f32", 64, 12288, torch.float32, 12288, "randn"),
    ("k1_bf16", 64, 65536, torch.bfloat16, 1, "randn"),
    ("kD_bf16", 64, 65536, torch.bfloat16, 65536, "randn"),
    ("equal_f32", 16, 65536, torch.float32, None, "equal"),
    ("equal_bf16", 16, 12288, torch.bfloat16, None, "equal"),
    ("signed_zeros_f32", 16, 12288, torch.float32, None, "zeros"),
    ("signed_zeros_bf16", 16, 65536, torch.bfloat16, None, "zeros"),
    ("nan_f32", 16, 16385, torch.float32, None, "nan"),
    ("nan_bf16", 16, 12288, torch.bfloat16, None, "nan")]
# The train phase: SAERunnerConfig's defaults except a 2-batch buffer (the
# 20-batch default is a 16.4M-row, 50 GB buffer whose fill does not fit a
# smoke run), on 1,024 random images cycled by the store's index iterator;
# 60 steps, the refill at step 51.  The TopK and gated slices take a 1-batch
# buffer and 30 steps (the refill at step 26): their kernels run every step,
# and their step profiles profile one refill.
TRAIN_BUFFER_BATCHES = 2
TRAIN_IMAGES = 1024
TRAIN_STEPS = 60
SLICE_BUFFER_BATCHES = 1
SLICE_STEPS = 30
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
# B4-B6 against their plain versions: name, L, B, d_in, d_sae, dtype.  The
# sweep's shape and the TopK slice's (bench.py:164-171) in bf16 and in f32
# (the float32 route, 3xTF32), and two layers of a ViT-S width (d_in 384, a
# multiple of 128 but not of 256, at expansion 16) in bf16.
SAE_STEP_SHAPES = [("sweep_bf16", 24, 4096, 1024, 8192, torch.bfloat16),
                   ("topk_slice_bf16", 1, 4096, 768, 12288, torch.bfloat16),
                   ("sweep_f32", 24, 4096, 1024, 8192, torch.float32),
                   ("topk_slice_f32", 1, 4096, 768, 12288, torch.float32),
                   ("vit_s_bf16", 2, 4096, 384, 6144, torch.bfloat16)]
# The float32 shapes at which the first 128 rows alone and layer 0 alone are
# checked against the whole call, bit for bit.
SAE_F32_ALONE_SHAPES = ("sweep_f32",)
# The shapes at which B4 and B6 must take the bf16 Hopper route (wgmma/TMA,
# csrc/sae_fused_tc.cu): the sweep's and the TopK slice's; and the one at
# which they must keep the bf16 mma.sync tiles (csrc/sae_fused_fwd.cu,
# csrc/sae_fused_bwd.cu's stored mode), which such widths take.
SAE_TC_SHAPES = ("sweep_bf16", "topk_slice_bf16", "slice_bf16")
SAE_MMA_SYNC_SHAPES = ("vit_s_bf16",)
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
# d_sae, dtype.  The TopK slice (bench.py:164-171, k = 64) and the all-layer
# sweep's widths in both dtypes (the Hopper route in bf16, 3xTF32 in
# float32), and a ViT-S width (d_in 384, a multiple of 128 but not of 256,
# at expansion 16) in bfloat16, which keeps the mma.sync tiles.
TOPK_SHAPES = [("slice_bf16", 1, 4096, 768, 12288, torch.bfloat16),
               ("slice_f32", 1, 4096, 768, 12288, torch.float32),
               ("sweep_bf16", 24, 4096, 1024, 8192, torch.bfloat16),
               ("sweep_f32", 24, 4096, 1024, 8192, torch.float32),
               ("vit_s_bf16", 1, 4096, 384, 6144, torch.bfloat16)]
# The float32 shape whose B8 and B9 kernels the profiler lists (one window).
TOPK_F32_PROFILED_SHAPE = "slice_f32"
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
# The float32 TopK row: bench.py's TopK recipe at its own float32 compute
# dtype (bench.py:164-166: no compute_dtype; topk_config() with it unset),
# trained through VisionSAETrainer from the TopK train phase's state on its
# store, which serves these steps without a refill (no second harvest): one
# step of run() (B8, B6), then TOPK_F32_REPEATS runs of TOPK_F32_STEPS of the
# trainer's train_step on batches in the buffer, each timed by synchronized
# wall time, TOPK_F32_PROFILED more under torch.profiler (device time and
# the idle share of that window), then TOPK_F32_REMAT_STEPS with
# fused_store_acts=False (B8, B9).
TOPK_F32_STEPS = 30
TOPK_F32_REPEATS = 3
TOPK_F32_PROFILED = 6
TOPK_F32_REMAT_STEPS = 2
# The float32 gated row (gated_train_f32) takes the float32 TopK row's
# steps, repeats and profiled window.
# Where a TopK step's time goes, after the train phase: TOPK_PROFILE_STEPS
# steps timed back to back on batches already in the buffer, fused and
# generic, then torch.profiler over three steps of each and over one refill;
# the TOPK_PROFILE_TOP kernels by device time are printed.
TOPK_PROFILE_STEPS = 20
TOPK_PROFILE_TOP = 10
# The gated step's profile lists more kernels (B11's and B12's Hopper route
# launches eight a step), with the share of those whose names hold these.
GATED_PROFILE_TOP = 24
GATED_PROFILE_KERNELS = ("sae_tc_kernel", "center_kernel", "partial_sums_kernel")
# The TopK step's SAE kernels on the Hopper route (B8: center, encoder,
# select, counts, decoder; B6: center, dh, weight gradients): their share.
TOPK_PROFILE_KERNELS = ("sae_tc_kernel", "center_kernel", "radix_select_kernel",
                        "count_kernel")
# TopK step check: fused (B8, B6) against generic (B10) steps from the
# trained state in float32.  Both paths mask float32 pre-activations summed
# in other orders (3xTF32 against cuBLAS), so an entry within rounding of its
# row's k-th value may switch; a TopK switch sits at the row's threshold, so
# it would move the row's reconstruction and every co-active feature's
# grads.  So B10's own active set is held to B8's within the kernel phase's
# flip bounds (TOPK_FLIP_FRAC, TOPK_FLIP_ROW_FRAC), and the generic step then
# takes B8's active set: every entry of the state is held to phase 6's
# unswitched bounds and the counters must be equal.
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
SWEEP_CHECK_LAYERS = {torch.bfloat16: 4, torch.float32: 2}
# Where a sweep step's time goes, after the main path: SWEEP_PROFILE_STEPS
# steps timed with CUDA events on batches already in the buffer, then
# torch.profiler over three.
SWEEP_PROFILE_STEPS = 10
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
# The gated slice (bench.py:177-180) and two layers at the sweep's widths in
# both dtypes, and one at a ViT-S width (d_in 384, a multiple of 128 but not
# of 256, at expansion 16) in bfloat16.  In bf16 the first two take the
# Hopper route (wgmma/TMA, csrc/sae_fused_tc.cu) and the last the mma.sync
# tiles (SAE_TC_SHAPES and SAE_MMA_SYNC_SHAPES hold their names); float32
# takes 3xTF32 (csrc/sae_fused_tf32.cu).
GATED_SHAPES = [("slice_bf16", 1, 4096, 768, 12288, torch.bfloat16),
                ("slice_f32", 1, 4096, 768, 12288, torch.float32),
                ("sweep_bf16", 2, 4096, 1024, 8192, torch.bfloat16),
                ("sweep_f32", 2, 4096, 1024, 8192, torch.float32),
                ("vit_s_bf16", 1, 4096, 384, 6144, torch.bfloat16)]
# The instantiations of sae_tc_kernel (by Mode in csrc/sae_fused_tc.cu) that
# B11 and B12 add: the gated encoder, its remat twin, dg, the gated wgrad and
# B11's 192-wide decoder.
GATED_TC_MODES = (4, 5, 6, 7, 8)
# Those that B5, B8 and B9 add: B5's remat encoder (hc with its -0 marks),
# B8's TopK encoder, B9's encoder masked against t, and B5's dh reading its
# mask from hc's bits.
REMAT_TOPK_TC_MODES = (9, 10, 11, 12)
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
GRAD_SOURCE = "vit_prisma_tpu_torch/csrc/attention_mix_tnh_bwd.cu"
GRAD_REPLACES = "vit_prisma_tpu/ops/attention.py:425"
# B2 against its plain version: name, B, T, N, H, causal, dtypes.  The B/32
# grad paths' shape, CLIP L/14's harvest shape, the CLIP text tower's
# (causal), and the last T that B1's gate takes at H = 64, where both of B2's
# passes run at 4 warps; CLIP L/14's token count at a head width that the
# bf16 kernel pads (88 to 96 columns; 257 rows to 272); and a bf16 head too
# wide for the tensor-core passes.
GRAD_KERNEL_SHAPES = [
    ("b32", 256, 50, 12, 64, False, (torch.bfloat16, torch.float32)),
    ("l14", 48, 257, 16, 64, False, (torch.bfloat16, torch.float32)),
    ("text_causal", 256, 77, 8, 64, True, (torch.bfloat16, torch.float32)),
    ("gate_edge", 4, 411, 2, 64, False, (torch.bfloat16, torch.float32)),
    ("gate_edge_causal", 4, 411, 2, 64, True, (torch.bfloat16, torch.float32)),
    ("l14_h88", 48, 257, 16, 88, False, (torch.bfloat16, torch.float32)),
    # a bf16 head past the tensor-core route (128 < H <= 256): the FFMA passes
    ("wide_head", 16, 50, 4, 160, False, (torch.bfloat16,)),
]
# The bf16 route's two passes (tensor cores), for ptxas's record.
GRAD_TC_KERNELS = ("bwd_rows_tc_kernel", "bwd_cols_tc_kernel")
# The float32 tensor-core route's kernels (3xTF32; mix_route "tf32x3"): B1's
# and B15's forward, B2's two passes.  Each has one instantiation a padded
# head width (16 to 128) and none may spill; the profiler must see them, and
# the FFMA kernels only past 128.
# The modules whose wrappers a kernel-name check calls by name.
ATTENTION = "vit_prisma_tpu_torch.ops.attention"
SAE_STEP = "vit_prisma_tpu_torch.ops.sae_step"
MIX_TF32_KERNELS = ("mix_tf32_kernel", "bwd_rows_tf32_kernel", "bwd_cols_tf32_kernel")
MIX_FFMA_KERNELS = ("mix_fwd_kernel", "mix_tnh_bwd_rows_kernel", "mix_tnh_bwd_cols_kernel")
# Each gradient within rel * max(1, its absmax) of the plain version's.
# float32: the two differ in summation order only.  bfloat16: both round ds
# to bfloat16 after float32 sums taken in other orders, so an entry may round
# one ulp apart, and so may each output: 2^-8 relative each, well inside 2e-2.
GRAD_KERNEL_REL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# The grad paths run the JAX package's grad-path benchmark config
# (bench.py:56-61, :98-133): CLIP ViT-B/32 geometry, quick_gelu,
# layer_norm_pre, 512 class logits, bf16, batch 256, random weights from
# seed 0.  Attribution takes demo 06's metric (a logit difference) over the
# 12 resid_post hooks.
GRAD_BATCH = 256
ATTRIB_CLASSES = (17, 42)
GRAD_TIMED = 3
# Card against CPU in float32 at batch 4: logits within rel * max(1,
# absmax), as the slice's activations, and each gradient within rel of its
# own absmax (GEMM summation order over 12 layers, here both ways).
GRAD_F32_REL = 1e-3
GRAD_F32_BATCH = 4
# bf16 B1 and B2 against the bf16 einsum path, each gradient relative to its
# absmax: that path rounds the scores, the softmax and their gradients to
# bf16 where the kernels keep float32, so the two differ by bf16 rounding
# carried through 12 layers down and back up: twice the forward's
# SLICE_BF16_REL.
GRAD_BF16_REL = 2 * SLICE_BF16_REL
# vit_train: bench.py's row (optax.adamw(1e-4): a constant rate, weight
# decay 1e-4), a warm-up step and GRAD_TRAIN_STEPS timed steps on one fixed
# batch, then torch.profiler over 3 steps.
GRAD_TRAIN_LR = 1e-4
GRAD_TRAIN_STEPS = 20
# train() end to end: FIT_IMAGES random 224-px images with labels from seed
# 0 (a fifth held out), batch FIT_BATCH, FIT_STEPS steps with a checkpoint
# at the last; then a resume from it for 2 more steps.
FIT_IMAGES = 1024
FIT_BATCH = 128
FIT_STEPS = 8
FIT_LR = 1e-3
# vit_train_check: 3 steps at batch 8 in float32, card against CPU, from one
# state.  Step 1's gradients within GRAD_F32_REL of each tensor's absmax.
# AdamW divides each gradient by its own running scale, so an entry whose
# gradient is small against the tensor's sees its float32 error grow to a
# large share of its update: an update is about lr per step whatever the
# gradient's size, so after 3 steps a parameter can be up to ~6 lr apart
# (b_K, whose exact gradient is 0 since it shifts each row of scores by a
# constant, is all such noise).  So every parameter within 6 lr, and all
# but 1e-3 of all entries (b_K's 0.01% included) within 1e-2 lr; the first
# moments, linear in the gradients, within GRAD_F32_REL of their absmax,
# the second moments within twice that (b_K's excepted).
TRAIN_CHECK_BATCH = 8
TRAIN_CHECK_TOL = {"param_max_lr": 6.0, "param_close_lr": 1e-2, "param_far_share": 1e-3,
                   "exp_avg_rel": GRAD_F32_REL, "exp_avg_sq_rel": 2 * GRAD_F32_REL}
# sae_attribution: demo 07 at B/32 full width in float32: a ReLU SAE 768 ->
# 12,288 at layer 9 resid_post (SAERunnerConfig's), error term on, batch
# SAE_ATTRIB_BATCH.  The error-term forward equals the clean one within
# float32 rounding of recon + (x - recon), carried through 3 layers: 1e-4 of
# max(1, absmax).  hook_hidden_post_grad and hook_sae_out_grad on the card
# against the CPU on the first GRAD_F32_BATCH images: GRAD_F32_REL.
SAE_ATTRIB_BATCH = 16
SPLICE_REL = 1e-4

LN_SOURCE = "vit_prisma_tpu_torch/csrc/ln_matmul.cu"
LN_REPLACES = "vit_prisma_tpu/ops/ln_matmul.py:81"
FLASH_SOURCES = {"flash_attention_padded": "vit_prisma_tpu_torch/csrc/flash_attention_fwd.cu",
                 "flash_attention_padded_bwd_dkv": "vit_prisma_tpu_torch/csrc/flash_attention_bwd.cu",
                 "flash_attention_padded_bwd_dq": "vit_prisma_tpu_torch/csrc/flash_attention_bwd.cu"}
# The library's kernels, reached from these lines: the forward from
# _flash_call, both backward passes from _flash_bwd_sharded (the VJP).
FLASH_REPLACES = {"flash_attention_padded": "vit_prisma_tpu/ops/attention.py:546",
                  "flash_attention_padded_bwd_dkv": "vit_prisma_tpu/ops/attention.py:631",
                  "flash_attention_padded_bwd_dq": "vit_prisma_tpu/ops/attention.py:631"}
# B14 against its plain version: name, R, S, D, C, dtypes.  B/32 at serving
# batch 256 (R = 256 x 50), QKV and MLP-in; the B/32 text tower at the text
# phase's batch 256 (R = 256 x 77), QKV and MLP-in; CLIP L/14-336 at batch
# 64 (R = 64 x 577, ragged against the 128-row tile), MLP-in, and its QKV
# with W unfolded as an LNPre model passes it; its float32 MLP-in at the
# l14_336_f32 phase's batches (the store batch 32, R = 18,464, and the
# attribution's 8, R = 4,616).
LN_SHAPES = [("b32_qkv", 12_800, 3, 768, 768, (torch.bfloat16, torch.float32)),
             ("b32_mlp_in", 12_800, 1, 768, 3072, (torch.bfloat16, torch.float32)),
             ("text_qkv", 19_712, 3, 512, 512, (torch.bfloat16,)),
             ("text_mlp_in", 19_712, 1, 512, 2048, (torch.bfloat16,)),
             ("l14_336_mlp_in", 36_928, 1, 1024, 4096, (torch.bfloat16,)),
             ("l14_336_qkv_lnpre", 36_928, 3, 1024, 1024, (torch.bfloat16,)),
             ("l14_336_f32_store", 18_464, 1, 1024, 4096, (torch.float32,)),
             ("l14_336_f32_attrib", 4_616, 1, 1024, 4096, (torch.float32,)),
             # C a multiple of 128 but not of 256 (the bf16 kernel's narrow
             # column tile), R one row past a 128-row tile
             ("edge", 12_801, 1, 768, 640, (torch.bfloat16, torch.float32))]
# The kernels of B14's routes by name: ptxas's records (no spill) and the
# profiled names of each float32 call (the 3xTF32 GEMM once a launch, with
# its W pre-pass; the FFMA kernel it replaced, ln_gemm_kernel, never).
LN_TC_KERNEL = "ln_gemm_tc_kernel"
LN_TF32_KERNEL = "ln_gemm_tf32_kernel"
LN_SPLIT_KERNEL = "split_k_major_kernel"
LN_FFMA_KERNEL = "ln_gemm_kernel"
# The float32 shape whose first 128 rows, alone, must equal the same rows
# of the whole call to the bit.
LN_ROWS_SHAPE = "l14_336_f32_store"
# Kernel against plain, relative to max(1, absmax): float32 differs by the
# LayerNorm's and the GEMM's summation orders only; bfloat16 rounds xn and
# the output after float32 sums taken in other orders, so an entry may land
# one or two bf16 ulps apart (2^-8 relative each).
LN_REL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -6}
# B13 against its plain versions: name, B, N, T, H, causal, dtypes.  CLIP
# L/14-336 at serving batch 64 and at attribution batch 32 (T = 577, padded
# to Tp = 640), a causal stack of the same width, the attribution shape at
# the widest head the bf16 Hopper kernels take, and a bf16 head width they
# do not take.  float32 (the 3xTF32 route, every width) at each but ViViT-B.
F32_BF16 = (torch.bfloat16, torch.float32)
FLASH_SHAPES = [("l14_336_serve", 64, 16, 577, 64, False, F32_BF16),
                ("l14_336_attrib", 32, 16, 577, 64, False, F32_BF16),
                ("causal", 8, 16, 577, 64, True, F32_BF16),
                ("l14_336_attrib_h128", 32, 16, 577, 128, False, F32_BF16),
                # a bf16 width routed to the mma.sync kernels
                ("h32", 8, 16, 577, 32, False, F32_BF16),
                # the video towers' forwards: ViViT-B at batch 8 (Tp 3200,
                # the wgmma route), V-JEPA huge at batch 4 (H 80, Tp 1664,
                # the mma.sync route)
                ("vivit_b", 8, 12, 3137, 64, False, (torch.bfloat16,)),
                ("vjepa_h", 4, 16, 1568, 80, False, F32_BF16)]
# The Hopper kernels of the bf16 route (wgmma) and the float32 route's
# (3xTF32 mma.sync, one instantiation a head width 16 to 128), for ptxas's
# record: neither may spill.
FLASH_TC_KERNELS = ("fwd_tc_kernel", "bwd_dkv_tc_kernel", "bwd_dq_tc_kernel")
FLASH_TF32_KERNELS = ("fwd_tf32_kernel", "dkv_tf32_kernel", "dq_tf32_kernel")
# z and each gradient within rel of max(1, its absmax): float32 differs in
# summation order (and the online softmax's rescaling) only; bfloat16 rounds
# p (and ds) to bf16 after float32 sums taken in other orders, as B1 and B2.
FLASH_REL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# serve_ln_fused: phase 4's server with use_fused_ln_gemm (B/32 bf16, batch
# 256, the same three requests); logits and cache against the unfused
# forward within SLICE_BF16_REL (the fold rounds ln_w W to bf16, and xn
# rounds before the GEMM where the unfused LayerNorm rounds its affine
# output).
L336_MODEL = "openai/clip-vit-large-patch14-336"
L336_BATCH = 64
L336_REQUESTS = (64, 70)
L336_TIMED = 3
# CLIP L/14-336, bf16, against the einsum path (no flash, no LN fusion): as
# SLICE_BF16_REL, carried through 24 layers instead of 12.
L336_BF16_REL = 2 * SLICE_BF16_REL
# Card against CPU in float32 at batch 1 through all 24 layers (GEMM and
# attention summation order, both ways): SLICE_F32_REL.
L336_ATTRIB_BATCH = 32
# l14_336_f32: the float32 cached forward at the store batch, the float32
# attribution at a batch that leaves the gradients' memory small, each
# timed over a few calls after a warm-up.
L336_F32_STORE_BATCH = 32
L336_F32_ATTRIB_BATCH = 8
L336_F32_TIMED = 2
L336_GRAD_F32_LAYERS = 4
L336_GRAD_F32_BATCH = 2
# bf16 gradients against the einsum path's: GRAD_BF16_REL over twice the
# layers.
L336_GRAD_BF16_REL = 2 * GRAD_BF16_REL

# B15 and B16, the JAX package's two kernels without a caller on any path:
# their path is the op-level entry points at the geometry of the JAX
# package's scripts/bench_fused_attn.py (CLIP ViT-B/32, batch 256).
MIX_SOURCE = "vit_prisma_tpu_torch/csrc/attention_mix.cu"
MIX_REPLACES = "vit_prisma_tpu/ops/attention.py:109"
BLOCK_SOURCE = "vit_prisma_tpu_torch/csrc/attention_block.cu"
BLOCK_REPLACES = "vit_prisma_tpu/ops/attention.py:726"
# (name, B, N, T, H, dtypes): B/32 and CLIP L/14 head-major
MIX_SHAPES = [("b32", 256, 12, 50, 64, (torch.bfloat16, torch.float32)),
              ("l14", 64, 16, 257, 64, (torch.bfloat16,))]
# (B, T, D, N) of B16's block at B/32; the scale 1/sqrt(64)
BLOCK_GEOMETRY = (256, 50, 768, 12)
BLOCK_INV_SCALE = 0.125
# B16 against its kernel-rounding plain version: float32 relative to
# max(1, |out|max) (sum orders of the three products); bfloat16 in ulps of
# bfloat16 at |out|max (a sum order, or the bf16 kernel's ex2 and 1 / l in
# p, can flip a rounding of qkv, p or z, which moves out by an ulp or so;
# the CPU twin agrees with JAX's within 2)
BLOCK_F32_REL = 1e-5
BLOCK_BF16_ULPS = 4
# the bf16 kernel takes two images a block: an odd batch leaves a lone image
# in the last block; an image's output must equal, to the bit, its output
# alone (batch 1, slot 0), whatever its batch or slot
BLOCK_ODD_BATCH = 255
BLOCK_TC_KERNEL = "block_tc_kernel"
# the float32 route's kernel (ptxas's record, no spill; by name once a call)
# and the FFMA kernel it replaced (never by name)
BLOCK_TF32_KERNEL = "block_tf32_kernel"
BLOCK_FFMA_KERNEL = "block_f32_kernel"
# gradients through the wrappers against autograd of the plain versions,
# relative to max(1, |grad|max): float32 (B16's weight grads sum 12,800
# rows), bfloat16 as GRAD_KERNEL_REL
MIX_GRAD_REL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
BLOCK_GRAD_REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

# SAE evals and validation at full width.  B/32: the default SAE trained by
# the train phase over 2,048 random images in batches of 256; L/14: the
# sweep trainer over its 96 images at batch 32.  Labels are random from seed
# 0 over the text phase's ZS_CLASSES classes, whose zero-shot classifier
# gives the B/32 evals' class embeddings; the sweep's are random [ZS_CLASSES,
# d_out] from seed 0 (no weights are in the repository).
EVAL_IMAGES = 2048
EVAL_BATCH = 256
EVAL_OUT_DIR = "smoke_out/sae_eval"  # gitignored
# card against CPU, one batch of 8 in float32: the losses as SLICE_F32_REL
# (relative to max(1, |loss|)); ReLU switches (features firing on one side
# only, each moving one act_count and one image's L0 by 1) at most this
# share of the batch's token x feature pre-activations
EVAL_CHECK_BATCH = 8
EVAL_FLIP_FRAC = 1e-4
SWEEP_EVAL_BATCH = 32
SWEEP_EVAL_CHECK_LAYERS = (0, 12)
# the sweep step's per-layer losses against make_eval_step with that
# layer's SAE alone (bf16 model: the suffix runs at batch 2B, the single
# step at B), relative to max(1, |loss|)
SWEEP_EVAL_LOSS_REL = 2.0 ** -7

# B7 at the sweep's shape: the 24 SAEs' W_enc, W_dec, b_enc and b_dec at
# 1024 -> 8192, stacked [L, R, C] as the sweep step passes them (four
# launches a step), float32 masters and moments.
ADAM_SWEEP_SHAPES = [("sweep_W_enc", (24, 1024, 8192), False),
                     ("sweep_W_dec", (24, 8192, 1024), True),
                     ("sweep_b_enc", (24, 1, 8192), False),
                     ("sweep_b_dec", (24, 1, 1024), False)]

# Video towers at full width, bf16, random weights from seed 0 and clips
# from a seeded generator on the card.  ViViT-B (JAX registry.py:273): 12 x
# 768, 32 frames in tubelets of 2, T = 16 * 196 + 1 = 3137 (Tp 3200), H 64:
# B13's wgmma route.  V-JEPA huge (:325): 32 x 1280, 16 frames, T = 1568
# (Tp 1664), H 80, no class token: B13's mma.sync route.
VIVIT_MODEL = "google/vivit-b-16x2-kinetics400"
VJEPA_MODEL = "vjepa_v1_vit_huge"
VIVIT_BATCH = 8
VJEPA_BATCH = 4
VIDEO_TIMED = 3
# bf16 kernel path against the bf16 einsum path, one layer at a time from
# the same residual (no earlier layer's rounding carried): SLICE_BF16_REL of
# each hook's absmax, for the attention output and the block's output.
VIDEO_BF16_REL = SLICE_BF16_REL
# ViViT-B cut to 2 layers in float32 at batch 1, card (B13's 3xTF32 route)
# against the CPU: SLICE_F32_REL.
VIDEO_F32_LAYERS = 2

# serve_graph: CompiledForward's CUDA graph against the eager forward of the
# same padded batches, to the bit, at B/32 (bf16, fused LN, batch 256) and
# L/14-336 (batch 64); served images per second in turns (eager, graph,
# graph, eager) of GRAPH_TURN_BATCHES batches each, every batch's time, SM
# clock and power draw recorded.
GRAPH_TURN_BATCHES = 5
GRAPH_ORDER = ("eager", "graph", "graph", "eager")
# export_forward -> load_forward at B/32 bf16 against the eager einsum
# forward (the artifact's routes): within two bf16 ulps of each output's
# absmax (the exported program's ops are the eager ones; a fused or
# reordered op may round once more).
EXPORT_BF16_REL = 2.0 ** -7
EXPORT_BATCHES = (1, 7, SERVE_BATCH)

# checkpoint: the TopK slice's bf16 row, N steps, save_train_state, a fresh
# trainer, load_state, M steps, against N + M uninterrupted steps on the
# same buffered batches, to the bit.
CKPT_STEPS = (5, 5)

# B5's -0 marks on the card: name, L, B, d_in, d_sae (bf16).  In every layer
# MARK_ROWS rows of x equal b_dec except at column 0 (where b_dec is 0),
# which holds 2^-60; W_enc's row 0 holds 2^-76 m (m = 1 + j/128) at
# MARK_FEATURES features and -2^-76 m at as many others, all with b_enc 0.
# So hpre there is +-2^-136 m: a float32 subnormal in (0, 2^-134] that
# rounds to +0 in bf16, which B5 must mark (and only where it is positive).
REMAT_MARK_SHAPES = [("topk_slice_bf16", 1, 4096, 768, 12288),
                     ("sweep_bf16", 24, 4096, 1024, 8192)]
MARK_ROWS = 64
MARK_FEATURES = 128

# analysis: CLIP ViT-B/32 at full width loaded through load_hooked_model from
# an HF CLIPModel-layout vision state dict drawn from a seed, raw and
# processed; cached forwards to an ActivationCache at ANALYSIS_BATCH in both
# dtypes, the full residual decomposition at batch 1, the logit lens over
# ANALYSIS_CLASSES seed-drawn class directions.  Tolerances, of max(1,
# absmax): float32 1e-4 (processing and the analyses reorder float32 sums
# over up to 36,865 components); bfloat16 3e-2 (a neuron's product and the
# LayerNorm's centring round to bf16 before the sum, where the forward
# accumulates in float32: a few bf16 ulps of the absmax).
ANALYSIS_MODEL = "openai/clip-vit-base-patch32"
ANALYSIS_BATCH = 8
ANALYSIS_CLASSES = 1000
ANALYSIS_F32_REL = 1e-4
ANALYSIS_BF16_REL = 3e-2
# processed (folded, centred, refactored) against raw weights, and the card
# against the CPU: other roundings of the weights or other GEMM orders
# carried through 12 layers, as the slice's SLICE_F32_REL
ANALYSIS_PROCESSED_REL = 1e-3
ANALYSIS_CPU_BATCH = 2

# text: the CLIP text tower of openai/clip-vit-base-patch32 (12 x 512, 8
# heads, MLP 2048, vocab 49,408, context 77) loaded through
# load_hooked_model(model_type="text") from the same HF CLIPModel state dict
# as the vision tower (seed 0), raw and processed; a BPE merge table trained
# on the 8,000 prompts (the first ZS_CLASSES ImageNet names x 80
# templates), since the
# public table is not in the repository.  The forward at TEXT_BATCH in
# bf16: B1's causal route (12 a forward), in turns with the einsum bypass,
# and once with the LN fusion (B14 24, B1 12); the gradient cache over the
# 12 resid_post hooks (B2 11); the zero-shot classifier in f32 and bf16
# (B1 12 for each of its 200 forwards), 2 classes against the CPU; then
# zero_shot_eval of the B/32 vision tower (bf16) over ZS_IMAGES seeded images.
TEXT_MODEL = "openai/clip-vit-base-patch32"
TEXT_BATCH = 256
TEXT_TIMED = 10
TEXT_TURNS = ("kernel", "einsum", "einsum", "kernel")
# the card against the CPU in float32: forward and gradients at this batch
TEXT_CPU_BATCH = 8
# The text tower's outputs and the classifier's columns are unit vectors
# of 512 (entries near 0.044), so every text check is relative to the
# compared value's own absmax, with no floor of 1 (text_atol).
# The card against the CPU in float32 (outputs and the classifier): GEMM
# summation order only.  A TF32 forward of the same model, measured beside
# it, must land past the limit, or the check could not tell float32 from
# TF32.
TEXT_F32_REL = 1e-5
# processed (folded, centred) against raw weights in float32 on the card:
# the folding reorders float32 sums over 12 layers
TEXT_PROCESSED_REL = 3e-5
# bf16: the kernel path against the einsum path (that path rounds scores and
# the softmax to bf16, the kernel keeps them float32), the fused LN against
# the unfused forward, and the bf16 classifier against the f32 one: bf16
# rounding carried through 12 layers.  The bidirectional tower on the same
# weights (what an attention that dropped the causal mask would give),
# measured beside it, must land past the limit.
TEXT_BF16_REL = 5e-2
# classifier columns: unit norm within float32 rounding of a mean of 80
# unit vectors renormalized (f32), within bf16's (bf16)
ZS_NORM_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
ZS_CLASSES = 100
ZS_CPU_CLASSES = 2
ZS_IMAGES = 2048
ZS_BATCH = 256


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


# The wall seconds of each phase run by ``timed``, in order; ``emit`` gives
# every record the seconds since its phase began.
PHASE_SECONDS = {}
_PHASE_START = [None]


def emit(record: dict) -> None:
    if _PHASE_START[0] is not None:
        record = {**record, "phase_wall_s": time.perf_counter() - _PHASE_START[0]}
    print(json.dumps(record), flush=True)


def timed(fn, *args, name=None, **kwargs):
    """Run the phase ``fn`` and keep its wall seconds in ``PHASE_SECONDS``
    under ``name`` (the function's name without ``phase_`` when None)."""
    name = name or fn.__name__.removeprefix("phase_")
    _PHASE_START[0] = t0 = time.perf_counter()
    try:
        return fn(*args, **kwargs)
    finally:
        PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) + time.perf_counter() - t0
        _PHASE_START[0] = None


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


# Idle seconds a profiler window keeps on each side of the calls it times,
# window by window of one measurement.  The profiler drops each device event
# that its clock places outside the window, and windows with no idle margin
# lost the calls at one end: some (3 of 10 kernels, 1 of 12, 3 of 12), or all
# of them (eight and four windows in a row of a few milliseconds, on two
# hosts), more often the longer the process had run.  A window that lost
# events is taken again with a wider margin.
PROFILE_PADS_S = (0.0, 0.02, 0.2, 1.0)
# "what: margin" of each measurement that needed a margin, for the summary
PROFILE_PADDED = []


def _device_events(fn, calls, pad=0.0):
    """The device's events (kernels, copies) over ``calls`` calls of ``fn``
    in one ``torch.profiler`` window: a first cycle of calls while device
    tracing starts (a window that began cold saw 4 of 10 calls on one host),
    then the cycle that is kept, with ``pad`` idle seconds before and after
    its calls.  The window traces the host as well: windows that traced the
    card alone came back with no device event more often."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for cycle in range(2):
            if cycle and pad:
                time.sleep(pad)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            if cycle and pad:
                time.sleep(pad)
            prof.step()
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith("ProfilerStep")]


def device_us_by_name(fn, calls=10, warmup=2, one_call_short=False) -> dict:
    """Device time of ``fn`` in microseconds a call by kernel (or copy)
    name, from ``torch.profiler`` over ``calls`` calls.  The profiler now
    and then returns a window with no device events, or with some lost (a
    kernel counted fewer times than there were calls); such a window is
    measured again with the next margin of ``PROFILE_PADS_S``, and a last
    one that is still short raises.  With ``one_call_short`` (for a library
    call made through autograd's engine alone) a window that lost whole
    calls, the same ones kernel by kernel, and kept at least half of them,
    is taken over the calls it kept."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for pad in PROFILE_PADS_S:
        events = _device_events(fn, calls, pad)
        # every call's kernels; for SDPA's backward through autograd's engine
        # also fewer whole calls: it lost all the device events of one call
        # of the kept cycle, the same one kernel by kernel, on two hosts, and
        # of four calls on a third (PR 20), and the time a call is then taken
        # over the calls kept
        for kept in range(calls, calls // 2 - 1, -1) if one_call_short else (calls,):
            if events and kept > 0 and all(e.count % kept == 0 for e in events):
                if pad:
                    PROFILE_PADDED.append(f"{events[0].key[:60]}: {pad}")
                return {e.key: e.device_time_total / kept for e in events}
    raise ProfilerLostEvents(f"torch.profiler lost device events in {len(PROFILE_PADS_S)} "
                             f"windows: {[(e.key[:60], e.count) for e in events]}")


class ProfilerLostEvents(AssertionError):
    """No window of ``device_us_by_name`` kept every call's device events."""


# device times that CUDA events took because every profiler window lost
# device events; the summary line lists them
CUDA_EVENT_FALLBACKS = []


def device_us(fn, calls=10, warmup=2, one_call_short=False) -> float:
    """Device time of ``fn`` in microseconds a call: its kernels' (and
    copies') times summed by ``torch.profiler``.  A library call whose host
    side outruns its kernels (autograd's engine at small shapes; CUDA events
    then time the host, 1.6x apart between calls) is charged its device work
    alone, as a kernel is.  Where every window lost device events, the
    time is taken from CUDA events instead, and the call is recorded in
    ``CUDA_EVENT_FALLBACKS``."""
    try:
        return sum(device_us_by_name(fn, calls, warmup,
                                     one_call_short=one_call_short).values())
    except ProfilerLostEvents:
        where = sys._getframe(1)
        CUDA_EVENT_FALLBACKS.append(f"{where.f_code.co_name}:{where.f_lineno}")
        return cuda_us(fn, iters=calls, warmup=warmup)


def check_close(name, got, want, atol) -> float:
    err = (got.float().cpu() - want.float().cpu()).abs().max().item()
    if not err <= atol:  # also catches NaN
        raise AssertionError(f"{name}: max abs err {err} > {atol}")
    return err


def rel_atol(rel, want) -> float:
    return rel * max(1.0, want.float().abs().max().item())


def text_atol(rel, want) -> float:
    """rel of ``want``'s own absmax, for values well below 1."""
    return rel * want.float().abs().max().item()


def bound(nbytes, ops=()) -> dict:
    """The least time the card could take for a call: its bytes (each input
    read once, each output written once) over the memory rate, or its
    operations over the peak rate of their type, whichever is larger.  The
    tensor cores and the float32 units run at once, so the operations' time
    is the slowest type's, each type's operations summed; a float32 product
    counts as three TF32 products."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    per_kind = {}
    for kind, n in ops:
        if kind == "f32_product":
            kind, n = "tf32_tensor", 3 * n
        per_kind[kind] = per_kind.get(kind, 0) + n
    t_ops = max((n / PEAK_OPS[kind] for kind, n in per_kind.items()), default=0.0)
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
    # the bfloat16 mix kernel's instantiations (one per padded head width):
    # registers and spills, none allowed
    tc = {}
    kernel = None
    for line in log:
        m = re.search(r"Function properties for \S*mix_tc_kernelILi(\d+)E", line)
        if m or "Function properties for" in line:
            kernel = f"padded_head_{m.group(1)}" if m else None
        elif kernel:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                tc[kernel] = {"spill_bytes": int(m.group(1)) + int(m.group(2))}
            m = re.search(r"Used (\d+) registers", line)
            if m and kernel in tc:
                tc[kernel]["registers"] = int(m.group(1))
    if len(tc) != 8 or any(r["spill_bytes"] or "registers" not in r for r in tc.values()):
        raise AssertionError(f"mix_tc_kernel: expected 8 instantiations, no spills: {tc}")
    # the float32 tensor-core kernels likewise: 8 padded head widths each
    tf32 = {kern: ptxas(kern) for kern in MIX_TF32_KERNELS}
    if any(len(recs) != 8 or any(r["spill_bytes"] or "registers" not in r for r in recs.values())
           for recs in tf32.values()):
        raise AssertionError(f"3xTF32 kernels: expected 8 instantiations each, no spills: {tf32}")
    emit({"phase": "build", **info, "seconds": seconds, "cached": cached,
          "torch": torch.__version__, "cuda": torch.version.cuda, "mix_tc_ptxas": tc,
          "mix_tf32_ptxas": {kern: {name[-40:]: r["registers"] for name, r in recs.items()}
                             for kern, recs in tf32.items()},
          "ptxas": [l.strip() for l in log if "registers" in l or "spill" in l]})


def ptxas(kernel: str) -> dict:
    """Registers and spill bytes of each compiled function whose mangled
    name holds ``kernel``, from the build's ``nvcc.log`` (``-Xptxas -v``),
    and whether ptxas serialized its wgmma instructions (a warning that
    cost the bf16 kernels 10-15% where it appeared)."""
    from vit_prisma_tpu_torch.ops import _build
    found, name = {}, None
    log = (_build.build_dir() / "nvcc.log").read_text().splitlines()
    serialized = {m.group(1) for line in log
                  if (m := re.search(r"wgmma.mma_async instructions are serialized.*'(\S+)'", line))}
    for line in log:
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1) if kernel in m.group(1) else None
        elif name:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                found[name] = {"spill_bytes": int(m.group(1)) + int(m.group(2))}
            m = re.search(r"Used (\d+) registers", line)
            if m and name in found:
                found[name]["registers"] = int(m.group(1))
                found[name]["wgmma_serialized"] = name in serialized
    if not found:
        raise AssertionError(f"ptxas: no function {kernel} in nvcc.log")
    return found


def kernel_names(fn, calls=3, pad=0.0):
    """Names of the device kernels ``torch.profiler`` sees in ``calls``
    calls of ``fn``, in a window opened as device_us_by_name opens its own
    (one warm cycle, one kept, ``pad`` idle seconds on each side of its
    calls; a window may lose calls)."""
    fn()
    torch.cuda.synchronize()
    return sorted({e.key for e in _device_events(fn, calls, pad)})


# Where a kernel-name check retaken in a process of its own finds its calls'
# inputs (gitignored), and how long that process may take.
NAMES_OUT = "smoke_out/names"
NAMES_CHILD_TIMEOUT_S = 300
# the kernel-name checks that were retaken in a process of their own; the
# summary line lists them
NAMES_RETAKEN = []


def _calls_fn(calls):
    """One function making each call of ``calls``: ("module:attribute",
    args, kwargs) each."""
    import importlib
    fns = [(getattr(importlib.import_module(op.split(":")[0]), op.split(":")[1]), args, kw)
           for op, args, kw in calls]
    return lambda: [f(*args, **kw) for f, args, kw in fns]


def _names_windows(calls, want, other):
    """(names, missing, wrong) of the first profiler window over ``calls``
    that saw every kernel of ``want`` or one of ``other``, taking the
    margins of ``PROFILE_PADS_S`` in turn, else of the last window."""
    fn = _calls_fn(calls)
    for pad in PROFILE_PADS_S:
        names = kernel_names(fn, pad=pad)
        missing = [k for k in want if not any(k in n for n in names)]
        wrong = [n for n in names if any(k in n for k in other)]
        if wrong or not missing:
            break
    return names, missing, wrong


def _names_child(path, want, other, q):
    """``_names_windows`` in a process of its own over the calls saved at
    ``path``, their tensors moved to the card; puts (True, its result) or
    (False, the error) on ``q``."""
    try:
        calls = [(op, [a.cuda() if torch.is_tensor(a) else a for a in args], kw)
                 for op, args, kw in torch.load(path, weights_only=False)]
        q.put((True, _names_windows(calls, want, other)))
    except BaseException as e:
        q.put((False, f"{type(e).__name__}: {e}"))


def _names_fresh(what, calls, want, other):
    """``_names_windows`` over ``calls`` in a new process, which starts
    with no profiler window opened."""
    import queue

    import torch.multiprocessing as mp
    os.makedirs(NAMES_OUT, exist_ok=True)
    path = os.path.join(NAMES_OUT, f"calls_{os.getpid()}.pt")
    torch.save([(op, [a.cpu() if torch.is_tensor(a) else a for a in args], kw)
                for op, args, kw in calls], path)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    proc = ctx.Process(target=_names_child, args=(path, want, other, q))
    proc.start()
    deadline = time.monotonic() + NAMES_CHILD_TIMEOUT_S
    ok, value = False, f"no answer within {NAMES_CHILD_TIMEOUT_S} s"
    try:
        while time.monotonic() < deadline:
            try:
                ok, value = q.get(timeout=1.0)
                break
            except queue.Empty:
                if not proc.is_alive():
                    try:
                        ok, value = q.get(timeout=1.0)
                    except queue.Empty:
                        value = f"the process exited with code {proc.exitcode}, no answer"
                    break
    finally:
        proc.join(timeout=30)
        if proc.is_alive():
            proc.kill()
            proc.join()
        os.remove(path)
    if not ok:
        raise AssertionError(f"{what}: the kernel-name check in a process of its own failed: "
                             f"{value}")
    NAMES_RETAKEN.append(what)
    return value


def names_seen(what, calls, want, other):
    """Names of the kernels ``torch.profiler`` sees in ``calls``
    (("module:attribute", args, kwargs) each), raising unless every kernel
    of ``want`` is among them and none of ``other`` is.  A window that
    missed one of ``want`` is taken again with the next margin of
    ``PROFILE_PADS_S``.  The windows a process opens come back empty more
    often the more it has opened (four in a row late in whole runs, where
    the same check had passed at other shapes), so where every window
    missed one, the windows are taken again in a new process over the same
    inputs."""
    names, missing, wrong = _names_windows(calls, want, other)
    if missing and not wrong:
        names, missing, wrong = _names_fresh(what, calls, want, other)
    if missing or wrong:
        raise AssertionError(f"{what}: the profiler saw {names}: {missing} missing, "
                             f"{wrong} of the other route")
    return [n[:90] for n in names]


def profiled_kernels(what, calls, route, kinds):
    """Names of the kernels ``torch.profiler`` sees in ``calls`` (a float32
    mix; see ``names_seen``), raising unless the route's kernels of
    ``kinds`` (indices into MIX_TF32_KERNELS and MIX_FFMA_KERNELS: 0 the
    forward, 1 and 2 B2's passes) are among them and the other route's are
    not."""
    want, other = ((MIX_TF32_KERNELS, MIX_FFMA_KERNELS) if route == "tf32x3"
                   else (MIX_FFMA_KERNELS, MIX_TF32_KERNELS))
    return names_seen(what, calls, [want[i] for i in kinds], other)


def phase_kernels(info):
    from vit_prisma_tpu_torch.ops.attention import (
        attention_mix_tnh, attention_mix_tnh_reference, mix_route)
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
            # a (head, batch item) result depends on its own inputs alone
            alone = attention_mix_tnh(q[:1], k[:1], v[:1], N, causal)
            torch.cuda.synchronize()
            if not torch.equal(alone[0], z[0]):
                raise AssertionError(f"{name} {dtype}: item 0 alone differs from item 0 "
                                     "of the batch")
            us = cuda_us(lambda: attention_mix_tnh(q, k, v, N, causal))
            plain_us = cuda_us(lambda: attention_mix_tnh_reference(q, k, v, N, causal))
            # the library call on head-major copies made beforehand (untimed)
            qh, kh, vh = (a.reshape(B, T, N, H).transpose(1, 2).contiguous() for a in (q, k, v))
            library_us = cuda_us(lambda: torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, is_causal=causal, scale=1.0))
            gemm = "bf16_tensor" if dtype == torch.bfloat16 else "f32_product"
            pairs = T * (T + 1) // 2 if causal else T * T  # the (query, key) pairs kept
            rec = {"phase": "kernel", **info, "kernel": "attention_mix_tnh",
                   "shape": name, "B": B, "T": T, "N": N, "H": H,
                   "causal": causal, "dtype": str(dtype).split(".")[1],
                   "max_abs_err": err, "tol": KERNEL_TOL[dtype],
                   "us": us, "plain_us": plain_us, "library_us": library_us,
                   "batch_independent": True, "route": mix_route(H, dtype),
                   **bound(4 * q.numel() * q.element_size(),
                           [(gemm, 4 * B * N * pairs * H), ("fp32", 5 * B * N * pairs)])}
            if dtype == torch.float32:
                rec["profiled_kernels"] = profiled_kernels(
                    f"B1 {name}", [(f"{ATTENTION}:attention_mix_tnh", (q, k, v, N, causal), {})],
                    rec["route"], (0,))
            results[(name, dtype)] = rec
            emit(rec)
            del q, k, v, z, want, qh, kh, vh, alone
    return results


def phase_take_rows(info):
    """B3 against its plain version, bitwise, at every shape of
    TAKE_ROWS_SHAPES: the whole call's event time (the wrapper's index check
    syncs the host before it launches), the kernel's own device time, and
    ``index_select``'s device and event times."""
    from vit_prisma_tpu_torch.ops.shuffle import _vector_bytes, take_rows, take_rows_reference
    g = torch.Generator(device="cuda").manual_seed(1)
    results = {}
    for name, n, row, dtype, m, offset in TAKE_ROWS_SHAPES:
        if dtype.is_floating_point:
            x = torch.randn((n + offset,) + row, generator=g, device="cuda").to(dtype)
        else:
            x = torch.randint(0, 256, (n + offset,) + row, generator=g, device="cuda",
                              dtype=dtype)
        x = x[offset:]
        idx = (torch.randperm(n, generator=g, device="cuda") if m is None else
               torch.randint(0, n, (m,), generator=g, device="cuda", dtype=torch.int32))
        out = take_rows(x, idx)
        want = take_rows_reference(x, idx)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        if out.dtype != dtype or out.shape != want.shape or not torch.equal(out, want):
            raise AssertionError(f"take_rows {name}: {out.dtype} {tuple(out.shape)}, "
                                 f"not bitwise equal (max abs err {err})")
        us = cuda_us(lambda: take_rows(x, idx))
        by_name = device_us_by_name(lambda: take_rows(x, idx))
        kernel_us = sum(v for k, v in by_name.items() if "take_rows" in k)
        plain_us = cuda_us(lambda: take_rows_reference(x, idx))
        library_us = cuda_us(lambda: torch.index_select(x, 0, idx))
        library_device_us = device_us(lambda: torch.index_select(x, 0, idx))
        row_bytes = x[0].numel() * x.element_size()
        moved = 2 * out.numel() * x.element_size()
        rec = {"phase": "kernel", **info, "kernel": "take_rows", "shape": name,
               "rows": n, "out_rows": idx.numel(), "row_bytes": row_bytes,
               "x_offset_bytes": x.data_ptr() % 16, "index": str(idx.dtype).split(".")[1],
               "vec_bytes": _vector_bytes(row_bytes, x.data_ptr(), out.data_ptr()),
               "dtype": str(dtype).split(".")[1], "max_abs_err": err, "tol": 0.0,
               "us": us, "kernel_us": kernel_us, "call_device_us": sum(by_name.values()),
               "check_share": 1.0 - kernel_us / us,
               "plain_us": plain_us, "library_us": library_us,
               "library_device_us": library_device_us, "GB_moved": moved / 1e9,
               "hbm_share": moved / (kernel_us * 1e-6) / HBM_BYTES_PER_S,
               "library_hbm_share": moved / (library_device_us * 1e-6) / HBM_BYTES_PER_S,
               **bound(moved + idx.numel() * idx.element_size())}
        results[("take_rows", name)] = rec
        emit(rec)
        del x, idx, out, want
        torch.cuda.empty_cache()
    return results


def phase_sae_kernels(info):
    """B3 and B7 against their plain versions on the card (B7 at the
    default SAE's tensors in both moment dtypes and at the sweep's, float32
    moments)."""
    from vit_prisma_tpu_torch.ops.opt_step import adam_update, adam_update_reference
    results = phase_take_rows(info)
    g = torch.Generator(device="cuda").manual_seed(2)

    # Inputs shaped like step 121 of the default run: unit W_dec rows,
    # grads ~1e-3, moments as 120 earlier steps leave them (mu ~1e-4, nu ~
    # (1 - b2^120) E[g^2]), lr 1e-3 * 121/500 in warm-up.
    kw = dict(b1=ADAM_B1, b2=ADAM_B2, eps=ADAM_EPS)
    scal = torch.tensor([[0.8, 1e-3 * 121 / 500, 1 / (1 - ADAM_B1 ** 121),
                          1 / math.sqrt(1 - ADAM_B2 ** 121)]], device="cuda")
    both = (torch.float32, torch.bfloat16)
    for name, shape, project, mdts in ([(*a, both) for a in ADAM_SHAPES]
                                       + [(*a, (torch.float32,)) for a in ADAM_SWEEP_SHAPES]):
        for mdt in mdts:
            p = torch.randn(shape, generator=g, device="cuda") * 0.03
            if project:
                p = p / torch.linalg.norm(p, dim=-1, keepdim=True)
            grad = torch.randn(shape, generator=g, device="cuda") * 1e-3
            mu = (torch.randn(shape, generator=g, device="cuda") * 1e-4).to(mdt)
            nu = (1 - ADAM_B2 ** 120) * (1e-3 * (
                1 + 0.3 * torch.randn(shape, generator=g, device="cuda"))).square()
            nu = nu.to(mdt)
            sc = scal.expand(shape[0], 4).contiguous()  # one row of scalars a layer
            got = adam_update(p, grad, mu, nu, sc, project=project, **kw)
            want = adam_update_reference(p, grad, mu, nu, sc, project=project, **kw)
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
            us = cuda_us(lambda: adam_update(p, grad, mu, nu, sc, project=project, **kw))
            plain_us = cuda_us(lambda: adam_update_reference(p, grad, mu, nu, sc,
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
    out, cache = model.run_with_cache(images.cuda(), names_filter=RESID_POST,
                                      return_cache_object=False)
    torch.cuda.synchronize()
    launches_f32 = attention_mix_tnh.launches
    if launches_f32 != cfg.n_layers:
        raise AssertionError(f"f32 forward launched the kernel {launches_f32} times")

    cpu = HookedViT(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    ref_out, ref_cache = cpu.run_with_cache(images, names_filter=RESID_POST,
                                            return_cache_object=False)
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
    out_k, cache_k = fused.run_with_cache(x, names_filter=RESID_POST, return_cache_object=False)
    torch.cuda.synchronize()
    launches_bf16 = attention_mix_tnh.launches
    out_p, cache_p = plain.run_with_cache(x, names_filter=RESID_POST, return_cache_object=False)
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
    cfg = fused.cfg
    server = CompiledForward(fused, batch_size=SERVE_BATCH, names_filter=RESID_POST)
    g = torch.Generator().manual_seed(2)
    requests = [torch.randn(n, 3, 224, 224, generator=g) for n in SERVE_REQUESTS]

    # The main path: the server answers the requests (its CUDA graph
    # captured at the first), with every count set to 0 just before it.
    counters = _sae_counters()
    _zero_counts(counters)
    answers = [server(r) for r in requests]
    torch.cuda.synchronize()
    n_batches = sum(-(-n // SERVE_BATCH) for n in SERVE_REQUESTS)
    launches = _served_launches("serve", server, counters,
                                {"attention_mix_tnh": cfg.n_layers}, n_batches,
                                {k: f.launches for k, f in counters.items()})
    launches = launches["attention_mix_tnh"]
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
                                        names_filter=RESID_POST, return_cache_object=False)
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
    prof = _profile_replay("serve", server, batch[:SERVE_BATCH])
    emit({"phase": "serve", **info, "batch_size": SERVE_BATCH,
          "requests": list(SERVE_REQUESTS), "launches": launches,
          "padded_request_max_abs_err": pad_err,
          "img_per_s_kernel": runs["kernel"], "img_per_s_plain": runs["plain"],
          "profile_of_one_graphed_batch": prof})
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


def _cfg_route(cfg):
    """The routes the picker gives a config's SAE kernels (its train batch,
    widths and compute dtype), by wrapper: each takes its family's."""
    from vit_prisma_tpu_torch.ops.sae_step import sae_kernel_routes
    return sae_kernel_routes(cfg.train_batch_size, cfg.d_in, cfg.d_sae,
                             getattr(torch, cfg.compute_dtype or cfg.dtype))


def phase_train(info, cfg=None, phase="train", steps=TRAIN_STEPS):
    """A training main path: harvest -> store -> trainer.run(steps) on the
    card; the default SAE (phase 5) or, with ``cfg``, the TopK or gated
    slice."""
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
    routes_before = _route_counts(counters)
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
    sae = trainer.run(max_steps=steps)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t1
    launches = {k: f.launches for k, f in counters.items()}

    per_batch = store.tokens_per_store_batch
    harvests = -(-cfg.tokens_per_buffer // per_batch) + \
        len(refills) * -(-(cfg.tokens_per_buffer // 2) // per_batch)
    expected = dict.fromkeys(counters, 0)
    expected.update({"attention_mix_tnh": (cfg.hook_point_layer + 1) * harvests,
                     "take_rows": 1 + len(refills),
                     "adam_update": len(trainer.state.params) * steps})
    if cfg.architecture == "gated":  # the fused step at L = 1: B11, then B12
        expected["sae_gated_fused_forward"] = expected["sae_gated_fused_backward"] = steps
    elif cfg.activation_fn_str == "topk":  # the fused step at L = 1: B8, then B6 or B9
        expected["sae_fused_forward_topk"] = steps
        expected["sae_fused_backward_topk" if cfg.fused_store_acts is False
                 else "sae_fused_backward_stored"] = steps
    if len(refills) != 1 or launches != expected:
        raise AssertionError(f"train launches {launches}, expected {expected}, "
                             f"{len(refills)} refills")
    # the routed SAE kernels' launches all on the route the picker gives the
    # slice's shape (the gated and TopK slices in bf16: the Hopper route)
    routes = _check_routes(phase, counters, routes_before, launches, _cfg_route(cfg))
    if len(log) != steps // cfg.wandb_log_frequency:
        raise AssertionError(f"{len(log)} metric reads")
    for vals in log:
        if not all(math.isfinite(v) for v in vals.values()):
            raise AssertionError(f"non-finite metrics {vals}")
    last = log[-1]
    if not last["l0"] > 0:
        raise AssertionError(f"L0 is {last['l0']}")
    if int(trainer.state.step) != steps or tuple(sae.W_dec.shape) != (cfg.d_sae, cfg.d_in):
        raise AssertionError(f"step {int(trainer.state.step)}, W_dec {tuple(sae.W_dec.shape)}")
    if not all(torch.isfinite(v).all() for v in sae.params.values()):
        raise AssertionError("non-finite SAE parameters")
    tokens = steps * cfg.train_batch_size
    changed = {"n_batches_in_buffer": [20, cfg.n_batches_in_buffer]}
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
          "buffer_rows": cfg.tokens_per_buffer, "steps": steps,
          "launches": launches, "expected_launches": expected,
          "routes": routes,
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


def _routed(fn, *args, **kwargs):
    """One call of a routed SAE wrapper (B4-B6, B8, B9, B11, B12): its
    outputs and the route its tally (``fn.routes``) counted."""
    before = dict(fn.routes)
    out = fn(*args, **kwargs)
    taken = [r for r, n in fn.routes.items() if n != before[r]]
    if len(taken) != 1:
        raise AssertionError(f"{fn.__name__}: routes counted {taken}")
    return out, taken[0]


def _route_record(name, B, D, Sd, dtype, taken, family="relu"):
    """The route a routed SAE wrapper's call (of kernel ``family``) took
    against the picker; in bf16 it must be the Hopper route at SAE_TC_SHAPES
    and the mma.sync tiles at SAE_MMA_SYNC_SHAPES, in f32 the family's
    SAE_F32_ROUTES route."""
    from vit_prisma_tpu_torch.ops.sae_step import sae_gemm_route
    want = sae_gemm_route(B, D, Sd, dtype, family)
    rec = {"route": taken, "route_picker": want}
    must = {**dict.fromkeys(SAE_TC_SHAPES, "wgmma"),
            **dict.fromkeys(SAE_MMA_SYNC_SHAPES, "mma_sync")}
    if dtype == torch.float32:
        must = dict.fromkeys([name], SAE_F32_ROUTES[family])
    if taken != want or must.get(name, taken) != taken:
        raise AssertionError(f"{name} {dtype}: route {rec}")
    return rec


def _tf32_ptxas(modes):
    """ptxas's record of the float32 route's kernel: every mode of
    SAE_TF32_MODES built, with no spills and no serialized wgmma; the
    records of ``modes``."""
    rec = ptxas(SAE_TF32_KERNEL)
    if len(rec) != len(SAE_TF32_MODES) or any(r["spill_bytes"] or r["wgmma_serialized"]
                                               for r in rec.values()):
        raise AssertionError(f"{SAE_TF32_KERNEL}: {rec}")
    return {m: r for m, r in rec.items()
            if any(f"{SAE_TF32_KERNEL}ILi{mode}E" in m for mode in modes)}


def _f32_profiled(what, calls, want):
    """Names of the kernels torch.profiler sees in ``calls`` (float32 B4,
    B5, B6, B8 or B9 calls; see ``names_seen``), raising unless every
    kernel of ``want`` is among them and no FFMA tile (SAE_FFMA_KERNELS)
    is."""
    return names_seen(what, calls, want, SAE_FFMA_KERNELS)


def _bitwise_repeat(name, fn):
    """Two calls of ``fn`` give the same bits in every output."""
    a, b = fn(), fn()
    torch.cuda.synchronize()
    if not all(torch.equal(u, v) for u, v in zip(a, b)):
        raise AssertionError(f"{name}: two calls differ")
    return True


def _cublas_products(products, n_flop):
    """The bf16 (or f32) cuBLAS time of a kernel's products alone
    (``torch.matmul`` on the same operands): for scale, not the same
    function."""
    ms = cuda_us(lambda: [torch.matmul(a, b) for a, b in products], iters=5, warmup=1) / 1000.0
    return {"cublas_products_ms": ms, "cublas_products_TFLOP_per_s": n_flop / ms / 1e9,
            "cublas_products_note": "cuBLAS products, not the same function",
            "cublas_products": len(products)}


def _tc_ptxas():
    """ptxas's record of the Hopper route's kernels: no spills, no
    serialized wgmma."""
    rec = ptxas(SAE_TC_KERNEL)
    if any(r["spill_bytes"] or r["wgmma_serialized"] for r in rec.values()):
        raise AssertionError(f"{SAE_TC_KERNEL}: {rec}")
    return rec


def _remat_hc(x, We, be, Wd, bd, dy, dl1, route="wgmma"):
    """hc as B5 recomputes it (the Hopper route: B4's, with -0 marks; the
    float32 route: B4's): its C entry called with this phase's own scratch
    buffers (the wrapper keeps them to itself)."""
    from vit_prisma_tpu_torch.ops import _build
    from vit_prisma_tpu_torch.ops.sae_step import _tf32_scratch_floats
    L, B, D = x.shape
    Sd = We.shape[-1]
    new = lambda *shape, dtype=x.dtype: torch.empty(shape, dtype=dtype, device="cuda")
    xc, hc, dhc = new(L, B, D), new(L, B, Sd), new(L, B, Sd)
    scratch = (xc, hc, dhc)
    if route == "tf32x3":
        scratch += (new(_tf32_scratch_floats(True, L, B, D, Sd), dtype=torch.float32),)
    dWe, dWd = new(L, D, Sd, dtype=torch.float32), new(L, Sd, D, dtype=torch.float32)
    dbe_part = new(L, B // 128, Sd, dtype=torch.float32)
    lib, stream = _build.load_library(), torch.cuda.current_stream().cuda_stream
    entry = "sae_fused_bwd_remat_tc" if route == "wgmma" else "sae_fused_bwd_remat_tf32"
    rc = getattr(lib, entry)(*(t.data_ptr() for t in (
        x, We, be, Wd, bd, dy, dl1, *scratch, dWe, dWd, dbe_part)), L, B, D, Sd, 0, stream)
    _build.check(lib, rc, entry)
    torch.cuda.synchronize()
    return hc


def _remat_against_stored(name, args, hc4, dW5, dW6, route):
    """On the Hopper route B5 recomputes B4's encoder with B4's own mainloop
    and launches, so its hc is B4's but for the -0 marks of entries whose
    float32 hpre > 0 rounds to +0 in bf16; wherever it marks none its grads
    are B6's on B4's hc, to the bit, and where it marks some they are the
    plain backward's on its own mask (hc nonzero or marked) within
    SAE_GRAD_REL.  On the float32 route B5 runs B4's encoder kernel again
    and B6's launches: its hc is B4's and its grads B6's on B4's hc, to the
    bit.  None on the other routes."""
    from vit_prisma_tpu_torch.ops import sae_step as S
    if route == "tf32x3":
        rec = {"hc_is_b4_hc": torch.equal(_remat_hc(*args, route=route), hc4),
               "grads_equal_b6_on_b4_hc": all(torch.equal(a, b) for a, b in zip(dW5, dW6))}
        if not all(rec.values()):
            raise AssertionError(f"{name}: B5 against B6 on B4's hc {rec}")
        return rec
    if route != "wgmma":
        return None
    hc5 = _remat_hc(*args).view(torch.int16)
    marks = hc5 == -32768  # bits 0x8000: -0
    rec = {"minus_zero_marks": int(marks.sum()),
           "hc_is_b4_hc_outside_marks": torch.equal(torch.where(marks, 0, hc5),
                                                    hc4.view(torch.int16)),
           "grads_equal_b6_on_b4_hc": all(torch.equal(a, b) for a, b in zip(dW5, dW6))}
    if rec["minus_zero_marks"]:
        x, We, be, Wd, bd, dy, dl1 = args
        own = S._backward_from_mask(x - bd[:, None], hc4, hc5 != 0, Wd, dy, dl1)
        rec["grads_vs_plain_on_own_mask"] = _grad_errs(
            f"{name} B5 marked", dW5, own, torch.zeros(hc4.shape[0], hc4.shape[2],
                                                       dtype=torch.bool, device="cuda"),
            x.dtype)
    if not (rec["hc_is_b4_hc_outside_marks"]
            and (rec["minus_zero_marks"] > 0 or rec["grads_equal_b6_on_b4_hc"])):
        raise AssertionError(f"{name}: B5 against B6 on B4's hc {rec}")
    return rec


def _f32_alone(name, x, We, be, Wd, bd, dy, dl1, y, nact, hc, dW6):
    """The float32 route at one shape: B4 on the first 128 rows alone gives
    the whole call's y and hc rows to the bit, and B4 and B6 on layer 0
    alone give layer 0's y, hc, nact, dW_enc and dW_dec to the bit (db_enc
    and l1 are the wrappers' torch sums of the kernels' tile partials, whose
    order torch picks by shape: recorded, not required)."""
    from vit_prisma_tpu_torch.ops import sae_step as S
    rows = S.sae_fused_forward(x[:, :128].contiguous(), We, be, Wd, bd, save_h=True)
    one = lambda *ts: [t[:1].contiguous() for t in ts]
    y0, _, n0, hc0 = S.sae_fused_forward(*one(x, We, be, Wd, bd), save_h=True)
    g0 = S.sae_fused_backward_stored(*one(x, hc, Wd, bd, dy, dl1))
    torch.cuda.synchronize()
    rec = {"rows_128_y_hc": torch.equal(rows[0], y[:, :128]) and torch.equal(rows[3], hc[:, :128]),
           "layer_0_y_hc_nact": (torch.equal(y0, y[:1]) and torch.equal(hc0, hc[:1])
                                 and torch.equal(n0, nact[:1])),
           "layer_0_dW_enc_dW_dec": torch.equal(g0[0], dW6[0][:1]) and torch.equal(g0[1],
                                                                               dW6[1][:1]),
           "layer_0_db_enc_equal": torch.equal(g0[2], dW6[2][:1])}
    if not all(v for k, v in rec.items() if k != "layer_0_db_enc_equal"):
        raise AssertionError(f"{name}: rows or layer 0 alone differ {rec}")
    return rec


def phase_sae_step_kernels(info):
    """B4, B5 and B6 against their plain versions at SAE_STEP_SHAPES (the
    sweep's, the TopK slice's, and a width that keeps the bf16 mma.sync
    tiles): the route each took, two calls equal to the bit, B5's grads
    equal to B6's on B4's hc on the Hopper route, and the cuBLAS time of
    their products beside them."""
    from vit_prisma_tpu_torch.ops import sae_step as S
    g = torch.Generator(device="cuda").manual_seed(4)
    tc_ptxas = _tc_ptxas()
    new_ptxas = _modes_ptxas(REMAT_TOPK_TC_MODES)
    f32_ptxas = _tf32_ptxas((0, 1, 2, 3))
    results = {}
    for name, L, B, D, Sd, dtype in SAE_STEP_SHAPES:
        x, We, be, Wd, bd, dy, dl1 = _sae_inputs(g, L, B, D, Sd, dtype)
        (y, l1, nact, hc), route4 = _routed(S.sae_fused_forward, x, We, be, Wd, bd, save_h=True)
        torch.cuda.synchronize()
        routes = {"sae_fused_forward": _route_record(name, B, D, Sd, dtype, route4)}
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
        dW6, route6 = _routed(S.sae_fused_backward_stored, x, hc, Wd, bd, dy, dl1)
        routes["sae_fused_backward_stored"] = _route_record(name, B, D, Sd, dtype, route6)
        dW5, route5 = _routed(S.sae_fused_backward, x, We, be, Wd, bd, dy, dl1)
        torch.cuda.synchronize()
        routes["sae_fused_backward"] = _route_record(name, B, D, Sd, dtype, route5)
        b5_vs_b6 = _remat_against_stored(name, (x, We, be, Wd, bd, dy, dl1), hc, dW5, dW6,
                                         route5)
        repeat = {
            "sae_fused_forward": _bitwise_repeat(
                f"{name} B4", lambda: S.sae_fused_forward(x, We, be, Wd, bd, save_h=True)),
            "sae_fused_backward_stored": _bitwise_repeat(
                f"{name} B6", lambda: S.sae_fused_backward_stored(x, hc, Wd, bd, dy, dl1)),
            "sae_fused_backward": _bitwise_repeat(
                f"{name} B5", lambda: S.sae_fused_backward(x, We, be, Wd, bd, dy, dl1))}
        bwd = {
            "sae_fused_backward_stored": _grad_errs(
                f"{name} B6", dW6,
                S.sae_fused_backward_stored_reference(x, hc, Wd, bd, dy, dl1),
                torch.zeros_like(switched), dtype),
            "sae_fused_backward": _grad_errs(
                f"{name} B5", dW5,
                S.sae_fused_backward_reference(x, We, be, Wd, bd, dy, dl1), switched, dtype)}
        del dW5
        alone = profiled = None
        if name in SAE_F32_ALONE_SHAPES:
            alone = _f32_alone(name, x, We, be, Wd, bd, dy, dl1, y, nact, hc, dW6)
            # B4, B6 and B5 in one profiler window (each window a process
            # opens makes the later ones likelier to come back empty): only
            # the float32 route's launches, by name
            profiled = _f32_profiled(name, [
                (f"{SAE_STEP}:sae_fused_forward", (x, We, be, Wd, bd), {"save_h": True}),
                (f"{SAE_STEP}:sae_fused_backward_stored", (x, hc, Wd, bd, dy, dl1), {}),
                (f"{SAE_STEP}:sae_fused_backward", (x, We, be, Wd, bd, dy, dl1), {})],
                SAE_TF32_KERNELS)
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
        gemm = "bf16_tensor" if dtype == torch.bfloat16 else "f32_product"
        # the products alone, on the same operands (dhc: B6's own rounding of dh)
        xc = x - bd[:, None]
        dhc = torch.where(hc > 0, S._mm(dy, Wd.transpose(1, 2)) + dl1[:, None, None],
                          0.0).to(dtype)
        cublas = {"sae_fused_forward": _cublas_products([(xc, We), (hc, Wd)], 2 * flop),
                  "sae_fused_backward_stored": _cublas_products(
                      [(dy, Wd.transpose(1, 2)), (xc.transpose(1, 2), dhc),
                       (hc.transpose(1, 2), dy)], 3 * flop),
                  "sae_fused_backward": _cublas_products(
                      [(xc, We), (dy, Wd.transpose(1, 2)), (xc.transpose(1, 2), dhc),
                       (hc.transpose(1, 2), dy)], 4 * flop)}
        del xc, dhc
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
            rec.update(routes[kernel])
            rec.update(cublas[kernel])
            rec["bitwise_repeat"] = repeat[kernel]
            if kernel == "sae_fused_backward":
                rec["b5_against_b6_on_b4_hc"] = b5_vs_b6
            if rec["route"] == "wgmma":
                rec["source"] = SAE_TC_SOURCE
                rec["ptxas"] = new_ptxas if kernel == "sae_fused_backward" else tc_ptxas
            if rec["route"] == "tf32x3":
                rec["source"] = SAE_TF32_SOURCE
                rec["ptxas"] = f32_ptxas
                rec["kernels_profiled"] = profiled
                rec["first_rows_and_layer_0_alone"] = alone
            results[(kernel, name)] = rec
            emit(rec)
        del x, We, be, Wd, bd, dy, y, hc, dW6
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


def _kth_rows(g, R, D, dtype, fill):
    """Rows for B10: N(0, 1) with every fourth row shifted negative and, in
    float32, every other row quantized to quarters (tied k-th values); or
    rows of one value each, of +0.0 and -0.0 mixed, or with NaNs."""
    x = torch.randn(R, D, generator=g, device="cuda")
    if fill == "randn":
        x[::4] -= 10.0  # rows whose k-th value is negative
        if dtype == torch.float32:
            x[1::2] = torch.round(x[1::2] * 4) / 4  # rows whose k-th value is tied
    elif fill == "equal":
        x = torch.round(x[:, :1] * 4).expand(R, D).contiguous() / 4
    elif fill == "zeros":
        x = torch.where(x > 0, 0.0, -0.0)
        x[1::2, ::7] = 1.0  # rows whose top keys are positive, then zeros
    elif fill == "nan":
        x[torch.rand(R, D, generator=g, device="cuda") < 0.01] = float("nan")
        x[1::2, ::3] = -float("nan")
    return x.to(dtype)


def phase_kth_value(info):
    """B10 against its plain version, bitwise, at KTH_SHAPES (with
    torch.kthvalue's event and device times beside it) and at KTH_EDGES;
    each record names the route and cluster the kernel took, and the
    kernel's own route function agrees with its Python mirror."""
    import ctypes
    from vit_prisma_tpu_torch.ops import _build
    from vit_prisma_tpu_torch.ops.topk import kth_value, kth_value_reference, kth_value_route
    lib = _build.load_library()
    g = torch.Generator(device="cuda").manual_seed(6)
    regs = ptxas("radix_select_kernel")
    results = {}
    for name, R, D, dtype, k, fill in ([(n, R, D, dt, None, "randn") for n, R, D, dt in KTH_SHAPES]
                                       + KTH_EDGES):
        k = TOPK_K if k is None else k
        route = kth_value_route(D, dtype)
        plan = (ctypes.c_int * 4)()
        _build.check(lib, lib.kth_value_plan(D, 0 if dtype == torch.float32 else 1, plan),
                     "kth_value_plan")
        if list(plan) != [route["cluster"], route["part"], int(route["route"] != "streamed"),
                          route["stage_bytes"]]:
            raise AssertionError(f"kth_value {name}: the kernel's plan {list(plan)} is not "
                                 f"its Python mirror's {route}")
        x = _kth_rows(g, R, D, dtype, fill)
        t = kth_value(x, k)
        want = kth_value_reference(x, k)
        torch.cuda.synchronize()
        if (tuple(t.shape) != (R, 1) or t.dtype != torch.float32
                or not torch.equal(t.view(torch.int32), want.view(torch.int32))):
            raise AssertionError(f"kth_value {name}: {t.dtype} {tuple(t.shape)}, "
                                 f"{int((t.view(torch.int32) != want.view(torch.int32)).sum())}"
                                 f" rows differ from plain")
        rec = {"phase": "kernel", **info, "kernel": "kth_value", "shape": name,
               "rows": R, "D": D, "k": k, "dtype": str(dtype).split(".")[1], "fill": fill,
               "route": route["route"], "cluster": route["cluster"],
               "stage_bytes": route["stage_bytes"], "max_abs_err": 0.0, "tol": "bitwise"}
        ms = lambda fn: cuda_us(fn, iters=10, warmup=2) / 1000.0
        if fill != "nan":
            kept = (x >= t).sum(dim=1)
            # the k-th value itself where the search is exact (every float32
            # row, bfloat16 rows whose k-th value has a clear sign bit), else
            # a separator (also below -0.0)
            values = torch.kthvalue(x, D - k + 1, dim=1).values.float()
            exact = (~torch.signbit(values) if dtype == torch.bfloat16
                     else torch.ones_like(values, dtype=bool))
            if not (bool((kept >= k).all()) and torch.equal(t[:, 0][exact], values[exact])
                    and bool(((x.float() >= values[:, None]) == (x >= t)).all())):
                raise AssertionError(f"kth_value {name}: the mask x >= t is not the top k")
            rec["rows_with_ties_kept"] = int((kept > k).sum())
        if fill == "randn" and k == TOPK_K:
            # a key map, a prefix compare and a count a key in each digit pass
            passes = 2 if dtype == torch.bfloat16 else 4
            library = lambda: torch.kthvalue(x, D - k + 1, dim=1)
            rec.update({"ms": ms(lambda: kth_value(x, k)),
                        "device_ms": device_us(lambda: kth_value(x, k)) / 1000.0,
                        "plain_ms": ms(lambda: kth_value_reference(x, k)),
                        "library_ms": ms(library),
                        # torch.kthvalue's kernel, like SDPA's backward, was
                        # lost from every profiler window of some calls (2 to
                        # 5 of 10): its device time is taken over the calls
                        # a window kept, when it kept half
                        "library_device_ms": device_us(library, one_call_short=True) / 1000.0,
                        **bound(x.numel() * x.element_size() + R * 4,
                                [("fp32", 3 * passes * x.numel())])})
        if name in {n for n, *_ in KTH_SHAPES}:
            rec["ptxas"] = regs
        results[name] = rec
        emit(rec)
        del x, t, want
    torch.cuda.empty_cache()
    return results


def phase_topk_kernels(info):
    """B8, B9 and B6 on B8's h against their plain versions at the TopK
    slice's and the sweep's shapes in both dtypes and a width that keeps the
    bf16 mma.sync tiles: the route each took, two calls equal to the bit, t
    the bitwise search on the kernel's own h, +0 and never -0 in h, B9 from
    t equal to B6 on B8's h on the same route, and the cuBLAS time of their
    products beside them; in float32 the kernels the profiler sees (no FFMA
    tile) and ptxas's record of the TopK modes; then B8+B6 against
    B8+B9."""
    from functools import partial
    from vit_prisma_tpu_torch.ops import sae_step as S
    g = torch.Generator(device="cuda").manual_seed(7)
    new_ptxas = _modes_ptxas(REMAT_TOPK_TC_MODES)
    f32_ptxas = _tf32_ptxas(SAE_TF32_TOPK_MODES)
    results = {}
    for name, L, B, D, Sd, dtype in TOPK_SHAPES:
        x, We, be, Wd, bd, dy, dl1 = _sae_inputs(g, L, B, D, Sd, dtype)
        (y, l1, nact, t, h), route8 = _routed(S.sae_fused_forward_topk, x, We, be, Wd, bd,
                                              TOPK_K, save_h=True)
        torch.cuda.synchronize()
        routes = {"sae_fused_forward_topk": _route_record(name, B, D, Sd, dtype, route8,
                                                          "topk")}
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
               "h_minus_zeros": int(torch.signbit(h.float()).sum()),
               "rows_keeping_more_than_k": int((mask.sum(dim=-1) > TOPK_K).sum()),
               "rows_keeping_fewer_than_k": int((mask.sum(dim=-1) < TOPK_K).sum()),
               "l1_abs_err": (l1 - l1r).abs().max().item(),
               "l1_tol": l1_bound.max().item()}
        if not (fwd["y_unflipped_rows"] <= fwd["y_tol"] and fwd["flip_frac"] <= TOPK_FLIP_FRAC
                and fwd["row_flip_frac"] <= TOPK_FLIP_ROW_FRAC
                and fwd["nact_minus_own_mask"] == 0 and fwd["t_is_k_th_of_own_h"]
                and fwd["h_minus_zeros"] == 0
                and bool(((l1 - l1r).abs() <= l1_bound).all())
                and bool(((nact - nactr).abs() <= per_feature).all())):
            raise AssertionError(f"{name} TopK forward: {fwd}")
        # B9 is held to its plain version from the plain forward's own t:
        # each recomputes its forward's active set, so the two differ only in
        # the features where the forward's masks flipped (counted and bounded
        # above).  The kernel's t on the plain hp would not do: each row's
        # k-th entry lies at t exactly in the kernel's numbers, so wherever
        # the plain products round it apart (3xTF32 against cuBLAS's float32:
        # most rows) it falls below t in half of them; recorded
        switched9 = flip.any(dim=1)
        _, hp_plain = S._hp(x, We, be, bd)
        fwd["rows_plain_hp_off_kernel_t"] = int(
            (S._topk_mask(hp_plain, t)[0] != mask).any(dim=-1).sum())
        del yr, hr, flip, flip_rows, hp_plain
        dWs, route6 = _routed(S.sae_fused_backward_stored, x, h, Wd, bd, dy, dl1)
        routes["sae_fused_backward_stored"] = _route_record(name, B, D, Sd, dtype, route6)
        dW9, route9 = _routed(S.sae_fused_backward_topk, x, We, be, Wd, bd, dy, dl1, t)
        torch.cuda.synchronize()
        routes["sae_fused_backward_topk"] = _route_record(name, B, D, Sd, dtype, route9,
                                                          "topk")
        # B9 takes B8's route (and so B6's, whose launches it shares): from t
        # it recomputes B8's h to the bit and gives B6's grads from that h,
        # bit for bit (the same active set and the same products)
        b9_is_b6 = all(torch.equal(a, b) for a, b in zip(dWs, dW9))
        if not b9_is_b6:
            raise AssertionError(f"{name}: B9 from t does not give B6's grads from h")
        repeat = {
            "sae_fused_forward_topk": _bitwise_repeat(
                f"{name} B8", lambda: S.sae_fused_forward_topk(x, We, be, Wd, bd, TOPK_K,
                                                               save_h=True)),
            "sae_fused_backward_stored": _bitwise_repeat(
                f"{name} B6 on h", lambda: S.sae_fused_backward_stored(x, h, Wd, bd, dy, dl1)),
            "sae_fused_backward_topk": _bitwise_repeat(
                f"{name} B9", lambda: S.sae_fused_backward_topk(x, We, be, Wd, bd, dy, dl1, t))}
        bwd = {"sae_fused_backward_stored": _grad_errs(
                   f"{name} B6", dWs, S.sae_fused_backward_stored_reference(x, h, Wd, bd, dy, dl1),
                   torch.zeros_like(switched9), dtype),
               "sae_fused_backward_topk": _grad_errs(
                   f"{name} B9", dW9,
                   S.sae_fused_backward_topk_reference(x, We, be, Wd, bd, dy, dl1, tr),
                   switched9, dtype, TOPK_SWITCHED_GRAD_REL)}
        del dWs, dW9
        flop = 2 * L * B * D * Sd
        eb = x.element_size()
        n_bits = 16 if dtype == torch.bfloat16 else 32
        gemm = "bf16_tensor" if dtype == torch.bfloat16 else "f32_product"
        # the threshold's operations on the route taken: the radix select's
        # 8-bit digit passes (a key map, a prefix compare and a count a key;
        # two in bf16, four in float32) on the Hopper and float32 routes, the
        # bitwise search's n_bits - 1 compares else
        select_ops = (3 * (n_bits // 8) if route8 in ("wgmma", "tf32x3") else n_bits - 1) \
            * L * B * Sd
        w_bytes = (2 * L * D * Sd + L * Sd + L * D) * eb
        g_bytes = (2 * L * D * Sd + L * Sd) * 4
        ms = lambda fn, it: cuda_us(fn, iters=it, warmup=1) / 1000.0
        calls = {
            "sae_fused_forward_topk": (
                lambda: S.sae_fused_forward_topk(x, We, be, Wd, bd, TOPK_K, save_h=True),
                lambda: S.sae_fused_forward_topk_reference(x, We, be, Wd, bd, TOPK_K, True),
                2 * L * B * D * eb + w_bytes + L * B * Sd * eb + L * B * 4 + L * Sd * 4 + L * 4,
                [(gemm, 2 * flop), ("fp32", select_ops)]),
            "sae_fused_backward_topk": (
                lambda: S.sae_fused_backward_topk(x, We, be, Wd, bd, dy, dl1, t),
                lambda: S.sae_fused_backward_topk_reference(x, We, be, Wd, bd, dy, dl1, t),
                2 * L * B * D * eb + w_bytes + L * B * 4 + L * 4 + g_bytes, [(gemm, 4 * flop)]),
            "sae_fused_backward_stored": (
                lambda: S.sae_fused_backward_stored(x, h, Wd, bd, dy, dl1),
                lambda: S.sae_fused_backward_stored_reference(x, h, Wd, bd, dy, dl1),
                (2 * L * B * D + L * B * Sd + L * Sd * D + L * D) * eb + L * 4 + g_bytes,
                [(gemm, 3 * flop)])}
        xc = x - bd[:, None]
        dhc = torch.where(h.float() > 0, S._mm(dy, Wd.transpose(1, 2)) + dl1[:, None, None],
                          0.0).to(dtype)
        cublas = {"sae_fused_forward_topk": _cublas_products([(xc, We), (h, Wd)], 2 * flop),
                  "sae_fused_backward_stored": _cublas_products(
                      [(dy, Wd.transpose(1, 2)), (xc.transpose(1, 2), dhc),
                       (h.transpose(1, 2), dy)], 3 * flop),
                  "sae_fused_backward_topk": _cublas_products(
                      [(xc, We), (dy, Wd.transpose(1, 2)), (xc.transpose(1, 2), dhc),
                       (h.transpose(1, 2), dy)], 4 * flop)}
        del xc, dhc
        # float32 B8 and B9: the kernels one profiler window over a call of
        # each sees (no FFMA tile), at the TopK slice alone: every window
        # opened in the process makes a later one likelier to come back
        # empty, and the route tally shows the sweep's calls on the same C
        # entries
        f32_names = (_f32_profiled(
            f"{name} B8 and B9",
            [(f"{SAE_STEP}:sae_fused_forward_topk", (x, We, be, Wd, bd, TOPK_K), {"save_h": True}),
             (f"{SAE_STEP}:sae_fused_backward_topk", (x, We, be, Wd, bd, dy, dl1, t), {})],
            SAE_TF32_TOPK_FWD_KERNELS + SAE_TF32_KERNELS)
            if name == TOPK_F32_PROFILED_SHAPE else None)
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
                rec["B9_compared_with"] = "B6 through its wrapper, on the same route"
                rec["B9_plain_from"] = "the plain forward's t"
            rec.update(routes[kernel])
            rec.update(cublas[kernel])
            rec["bitwise_repeat"] = repeat[kernel]
            if rec["route"] == "wgmma":
                rec["source"] = SAE_TC_SOURCE
                if kernel != "sae_fused_backward_stored":
                    rec["ptxas"] = new_ptxas
            if dtype == torch.float32:
                # B8, B9 and B6 on B8's h on the float32 route; B8's and B9's
                # tf32 entries, ptxas's record of their two modes and the
                # kernels the profiler saw
                rec["source"] = SAE_TF32_SOURCE
                if kernel in SAE_TF32_TOPK_ENTRIES:
                    rec["entry"] = SAE_TF32_TOPK_ENTRIES[kernel]
                    rec["ptxas"] = f32_ptxas
                    if f32_names is not None:
                        rec["kernels_profiled_with_b8_b9"] = f32_names
            results[(kernel, name)] = rec
            emit(rec)
        del x, We, be, Wd, bd, dy, y, h, t, tr, mask
        torch.cuda.empty_cache()
    apply = partial(S.sae_fused_apply_topk, k=TOPK_K)
    for dtype in (torch.bfloat16, torch.float32):
        emit({"phase": "save_acts_topk", **info, "k": TOPK_K, **_stored_against_remat(
            g, apply, TOPK_SAVE_ACTS_SHAPE, dtype, ("B8_plus_B6", "B8_plus_B9"))})
    return results


def topk_config():
    """The TopK slice: bench.py's exact-bf16 TopK row (k = 64, bf16 compute,
    float32 masters) at SAERunnerConfig's default widths, with a 1-batch
    buffer."""
    from vit_prisma_tpu_torch.sae import SAERunnerConfig
    return SAERunnerConfig(activation_fn_str="topk", activation_fn_kwargs=(("k", TOPK_K),),
                           compute_dtype="bfloat16", n_batches_in_buffer=SLICE_BUFFER_BATCHES)


def phase_topk_remat(info, trainer, store, cfg, steps=TOPK_REMAT_STEPS, phase="topk_remat"):
    """``steps`` steps through the same entry point with
    ``fused_store_acts=False``: B8 and B9 once a step, B6 never."""
    from vit_prisma_tpu_torch.sae import VisionSAETrainer
    counters = _sae_counters()
    remat = VisionSAETrainer(cfg.replace(fused_store_acts=False), trainer.model, store)
    remat.load_state(trainer.state)
    _zero_counts(counters)
    routes_before = _route_counts(counters)
    t0 = time.perf_counter()
    remat.run(max_steps=steps)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counters.items()}
    expected = {"sae_fused_forward_topk": steps,
                "sae_fused_backward_topk": steps, "sae_fused_backward_stored": 0,
                "sae_fused_forward": 0, "sae_fused_backward": 0, "kth_value": 0,
                "adam_update": 4 * steps}
    if any(launches[k] != v for k, v in expected.items()):
        raise AssertionError(f"TopK remat steps launched {launches}, expected {expected}")
    # B8 and B9 on the picker's route (the TopK slice: in bf16 the Hopper
    # route, in float32 3xTF32)
    routes = _check_routes("TopK remat steps", counters, routes_before, launches,
                           _cfg_route(cfg))
    if not all(torch.isfinite(v).all() for v in remat.state.params.values()):
        raise AssertionError("non-finite SAE parameters after the remat steps")
    emit({"phase": phase, **info, "steps": steps, "launches": launches,
          "expected_launches": expected, "routes": routes, "seconds": seconds})
    return launches


def phase_topk_train_f32(info, trainer, store, cfg):
    """bench.py's TopK recipe at its float32 compute dtype (``cfg`` with
    ``compute_dtype`` unset) through VisionSAETrainer on the card, from the
    TopK train phase's state on its store, which serves every step here
    without a refill: one step of ``run`` (B8, B6 on 3xTF32), then
    TOPK_F32_REPEATS runs of TOPK_F32_STEPS of the trainer's ``train_step``
    on batches in the buffer, each by synchronized wall time, and
    TOPK_F32_PROFILED more under torch.profiler (device time, idle share of
    that window); launches counted by route.  Then phase_topk_remat's check
    of TOPK_F32_REMAT_STEPS with ``fused_store_acts=False`` (B8, B9).
    Returns the launches of both runs."""
    from vit_prisma_tpu_torch.sae import VisionSAETrainer
    c = cfg.replace(compute_dtype=None)
    want_routes = _cfg_route(c)
    if any(want_routes[k] != "tf32x3" for k in ("sae_fused_forward_topk",
                                                  "sae_fused_backward_topk",
                                                  "sae_fused_backward_stored")):
        raise AssertionError(f"float32 TopK routes {want_routes}")
    counters = _sae_counters()
    refills = _time_refills(store)
    f32 = VisionSAETrainer(c, trainer.model, store)
    f32.load_state(trainer.state)
    bs = c.train_batch_size
    batches = [store.buffer[i * bs:(i + 1) * bs] for i in range(TOPK_F32_STEPS)]
    _zero_counts(counters)
    routes_before = _route_counts(counters)
    f32.run(max_steps=1)  # warm-up
    seconds = []
    for _ in range(TOPK_F32_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            f32.train_step(b)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    steps = 1 + TOPK_F32_REPEATS * TOPK_F32_STEPS  # each profiler window adds 2 TOPK_F32_PROFILED
    # the step's device time by part over TOPK_F32_PROFILED steps, after as
    # many in an unkept profiler cycle (a cold window lost the first step's
    # B8): B8's and B6's launches by mode, the split pre-passes, the select,
    # the counts, B7, cuBLAS and elementwise work.  A window that lost device
    # events (a launch of B8 or B6 counted other than once a step) is taken
    # again with the next margin of PROFILE_PADS_S.
    parts = (*(f"{SAE_TF32_KERNEL}<{m}>" for m in SAE_TF32_MODES), "split_t_kernel",
             "split_rows_kernel", "center_kernel", "radix_select_kernel", "count_kernel",
             "adam_", "gemm", "elementwise", "reduce")
    per_step = {**{f"{SAE_TF32_KERNEL}<{m}>": 1 for m in (1, 2, 3, 4)}, "split_t_kernel": 4,
                "split_rows_kernel": 1, "center_kernel": 1, "radix_select_kernel": 1,
                "count_kernel": 1}
    for tries, pad in enumerate(PROFILE_PADS_S, 1):
        prof = _profile(lambda: [f32.train_step(b) for b in batches[:TOPK_F32_PROFILED]],
                        share_of=TOPK_PROFILE_KERNELS + SAE_TF32_KERNELS, top=TOPK_PROFILE_TOP,
                        time_of=parts, calls_of=parts, pad=pad, warm=True)
        steps += 2 * TOPK_F32_PROFILED
        if all(prof["calls_of"][k] == n * TOPK_F32_PROFILED for k, n in per_step.items()):
            break
    else:
        raise AssertionError(f"torch.profiler lost device events in {tries} windows of the "
                             f"float32 TopK step: {prof['calls_of']}")
    launches = {k: f.launches for k, f in counters.items()}
    expected = dict.fromkeys(counters, 0)
    expected.update({"sae_fused_forward_topk": steps, "sae_fused_backward_stored": steps,
                     "adam_update": len(f32.state.params) * steps})
    if launches != expected:
        raise AssertionError(f"float32 TopK steps launched {launches}, expected {expected}")
    routes = _check_routes("float32 TopK steps", counters, routes_before, launches, want_routes)
    if not all(torch.isfinite(v).all() for v in f32.state.params.values()):
        raise AssertionError("non-finite SAE parameters after the float32 TopK steps")
    ms = sorted(1000.0 * t / TOPK_F32_STEPS for t in seconds)
    emit({"phase": "topk_train_f32", **info, "model": c.model_name,
          "recipe": "bench.py's TopK row at its float32 compute dtype (k 64, no compute_dtype)",
          "d_in": c.d_in, "d_sae": c.d_sae, "k": c.topk_k, "train_batch_size": bs,
          "dtype": c.dtype, "compute_dtype": c.compute_dtype,
          "store": "the TopK train phase's, no refill", "start_step": int(trainer.state.step),
          "timed": f"{TOPK_F32_REPEATS} runs of {TOPK_F32_STEPS} train_step calls",
          "seconds": seconds, "ms_per_step_wall": ms,
          "sae_tokens_per_s": [1000.0 * bs / m for m in reversed(ms)],
          "profiled_steps": TOPK_F32_PROFILED, "profile_windows": tries,
          "device_busy_ms_per_step": prof["device_busy_ms"] / TOPK_F32_PROFILED,
          "wall_ms_per_profiled_step": prof["wall_ms"] / TOPK_F32_PROFILED,
          "idle_share_profiled": prof["idle_share"], "profile": prof,
          "launches": launches, "expected_launches": expected, "routes": routes})
    remat_launches = phase_topk_remat(info, f32, store, c, TOPK_F32_REMAT_STEPS,
                                      "topk_remat_f32")
    if refills:
        raise AssertionError(f"the float32 TopK steps refilled the store {len(refills)} times")
    return {k: launches[k] + remat_launches[k] for k in launches}


# the device kernels of B1 and B15 (attention_mix_core.cuh), by name
MIX_KERNEL_NAMES = ("mix_tc_kernel", "mix_tf32_kernel", "mix_fwd_kernel")


def _profile(fn, share_of=(), warm=False, top=TOPK_PROFILE_TOP, calls_of=(), pad=0.0,
             time_of=()):
    """Device time by kernel over one call of ``fn`` (synchronized), the
    device's busy total and the wall time, in milliseconds; with
    ``share_of``, also the time and calls of every kernel whose name
    contains one of those strings; with ``calls_of`` (``time_of``), the
    calls (device ms) of the kernels whose names contain each string.  ``warm``: one more call
    first, in a profiler cycle that is not kept, while device tracing
    starts.  ``pad``: idle seconds on each side of the timed call (see
    ``PROFILE_PADS_S``)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1) if warm
                 else None) as prof:
        if warm:
            fn()
            torch.cuda.synchronize()
            prof.step()
        time.sleep(pad)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1000.0 * (time.perf_counter() - t0)
        time.sleep(pad)
        if warm:
            prof.step()
    # the device's own events (kernels, copies, sets), not the host ops that
    # launched them, whose device totals would count them twice (nor the
    # schedule's step annotation, which spans them all)
    rows = sorted(((e.key, e.device_time_total / 1000.0, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.device_time_total > 0 and not e.key.startswith("ProfilerStep")),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    out = {"wall_ms": wall_ms, "device_busy_ms": busy, "pad_s": pad,
           "idle_share": max(0.0, 1.0 - busy / wall_ms), "kernels_total": len(rows),
           "kernels": [{"name": k[:90], "ms": ms, "calls": n}
                       for k, ms, n in rows[:top]]}
    if share_of:
        hit = [r for r in rows if any(s in r[0] for s in share_of)]
        out["share_of"] = {"names": list(share_of), "ms": sum(r[1] for r in hit),
                           "calls": sum(r[2] for r in hit),
                           "share_of_busy": sum(r[1] for r in hit) / busy if busy else 0.0}
    if calls_of:
        out["calls_of"] = {c: sum(r[2] for r in rows if c in r[0]) for c in calls_of}
    if time_of:
        out["time_of"] = {c: sum(r[1] for r in rows if c in r[0]) for c in time_of}
    return out


def phase_step_profile(info, trainer, store, cfg, phase):
    """Where a TopK or gated train step's time goes, from the trained state
    on batches already in the buffer: the fused step (TopK: B8, B6; gated:
    B11, B12) and the generic step, each timed over TOPK_PROFILE_STEPS steps
    with CUDA events and profiled over three; then, for TopK, one refill
    (harvest + mix) profiled (the gated slice's store and harvest are the
    same)."""
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
        # every kernel by device time, with the SAE kernels' share (gated: B11's
        # and B12's launches, sae_tc_kernel, center, partial sums; TopK: B8's
        # and B6's, sae_tc_kernel, center, the select and the counts)
        prof = (_profile(lambda: steps(c, 3), share_of=GATED_PROFILE_KERNELS,
                         top=GATED_PROFILE_TOP)
                if cfg.architecture == "gated"
                else _profile(lambda: steps(c, 3), share_of=TOPK_PROFILE_KERNELS))
        # the profiler slows the host, so its wall time overstates idling:
        # the share that counts is of the steps timed without it
        emit({"phase": phase, **info, **shape, "what": f"{name} train step",
              "steps_timed": TOPK_PROFILE_STEPS, "ms_per_step": step_ms,
              "tokens_per_s": bs / step_ms * 1000.0,
              "device_busy_ms_per_step": prof["device_busy_ms"] / 3,
              "idle_share_of_timed_steps": max(0.0, 1.0 - prof["device_busy_ms"] / 3 / step_ms),
              "profile_of_3_steps": prof})
    if cfg.architecture != "gated":  # the gated store's refill is the TopK one's
        emit({"phase": phase, **info, **shape, "what": "one refill (harvest + mix)",
              "profile": _profile(store._refill_half, share_of=MIX_KERNEL_NAMES)})


def _b8_mask(state, x, cfg):
    """The active set [B, d_sae] that a fused step from ``state`` counts:
    kernel B8's masked h (two calls give the same bits)."""
    from vit_prisma_tpu_torch.ops.sae_step import sae_fused_forward_topk
    from vit_prisma_tpu_torch.sae.sae import set_decoder_norm_to_unit_norm
    p = {k: v[None] for k, v in set_decoder_norm_to_unit_norm(state.params).items()}
    return sae_fused_forward_topk(x[None], p["W_enc"], p["b_enc"], p["W_dec"], p["b_dec"],
                                  cfg.topk_k, save_h=True)[4][0] > 0


def phase_topk_step_check(info, trainer, store, cfg):
    """From the trained TopK state, three fused steps (B8, B6) against three
    generic steps (B10) in float32, the generic steps' active sets pinned to
    the fused steps' (B8's masks); then ``SparseAutoencoder.encode`` (B10)
    against B8's masked h."""
    from vit_prisma_tpu_torch.ops.sae_step import sae_fused_forward_topk
    from vit_prisma_tpu_torch.sae import sae as sae_module
    from vit_prisma_tpu_torch.sae.convert import train_state_to_numpy
    from vit_prisma_tpu_torch.sae.train import sae_train_step
    c = cfg.replace(compute_dtype=None)
    batches = [store.next_batch() for _ in range(STEP_CHECK_STEPS)]
    counters = _sae_counters()
    states = {True: [trainer.state], False: [trainer.state]}
    launches = {}
    _zero_counts(counters)
    for b in batches:
        states[True].append(sae_train_step(states[True][-1], b, c)[0])
    torch.cuda.synchronize()
    launches[True] = {k: f.launches for k, f in counters.items()}
    pins = [_b8_mask(states[True][j], b, c) for j, b in enumerate(batches)]
    # The generic step's activation runs B10 as always, and its own active
    # set is held to B8's within the flip bounds; the step then goes on with
    # B8's active set, so that both paths sum the same terms.
    own_activation, switches = sae_module.topk_mask_activation, []

    def pinned_activation(x, k):
        pin = pins[len(switches)]
        flip = (own_activation(x.detach(), k) > 0) != pin
        switches.append({"entries": int(flip.sum()), "rows": int(flip.any(dim=-1).sum())})
        return torch.where(pin, torch.relu(x), torch.zeros((), dtype=x.dtype, device=x.device))

    _zero_counts(counters)
    sae_module.topk_mask_activation = pinned_activation
    try:
        for b in batches:
            states[False].append(sae_train_step(states[False][-1], b,
                                                c.replace(fused_sae_step=False))[0])
        torch.cuda.synchronize()
    finally:
        sae_module.topk_mask_activation = own_activation
    launches[False] = {k: f.launches for k, f in counters.items()}
    if (launches[False]["kth_value"] != STEP_CHECK_STEPS
            or launches[False]["sae_fused_forward_topk"] != 0
            or launches[True]["sae_fused_forward_topk"] != STEP_CHECK_STEPS
            or launches[True]["kth_value"] != 0 or len(switches) != STEP_CHECK_STEPS):
        raise AssertionError(f"TopK step check launches: generic {launches[False]}, "
                             f"fused {launches[True]}, generic activations {len(switches)}")
    if any(s["entries"] > TOPK_FLIP_FRAC * b.shape[0] * c.d_sae
           or s["rows"] > TOPK_FLIP_ROW_FRAC * b.shape[0] for s in switches):
        raise AssertionError(f"B10's active sets against B8's: {switches}")
    got, want = train_state_to_numpy(states[True][-1]), train_state_to_numpy(states[False][-1])
    errs, scales = {}, {}
    for k in want:
        scales[k] = float(np.abs(want[k]).max())
        errs[k] = {"unswitched": float(np.abs(got[k].astype(np.float64) - want[k]).max()),
                   "switched": 0.0}

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
           "start_step": int(trainer.state.step), "b10_switches_against_b8": switches,
           "launches_generic": launches[False],
           "launches_fused": launches[True], "state_max_abs_err": errs,
           "state_absmax": scales,
           "act_freq_abs_diff_sum": float(np.abs(got["act_freq_scores"]
                                                 - want["act_freq_scores"]).sum()),
           "encode_vs_B8": enc}
    emit(rec)
    # one active set: every entry within the unswitched bounds, counters exact
    check_steps([{}], errs, scales, 0, 0, got, want)
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
    from vit_prisma_tpu_torch.ops import counted_kernels
    return counted_kernels()


def _zero_counts(counters):
    for f in counters.values():
        f.launches = 0


def _route_counts(counters):
    """Each routed wrapper's tally of launches by route, as it stands."""
    return {k: dict(f.routes) for k, f in counters.items() if hasattr(f, "routes")}


def _check_routes(what, counters, before, launches, routes):
    """Every launch of a routed wrapper since ``before`` (``_route_counts``)
    counted on its route in ``routes`` (``_cfg_route``: the picker's for the
    path's shape and the wrapper's family); returns the tallies that
    moved."""
    got = {k: {r: counters[k].routes[r] - n for r, n in by.items()} for k, by in before.items()}
    want = {k: {r: launches[k] if r == routes[k] else 0 for r in by} for k, by in got.items()}
    if got != want:
        raise AssertionError(f"{what} routes {got}, expected {want}")
    return {k: v for k, v in got.items() if any(v.values())}


def _check_sweep_metrics(metrics_list, layers):
    """Finite loss, L0 and EV for every layer, and L0 > 0 at every read for
    every layer outside ``SWEEP_L0_EXEMPT``."""
    for vals in metrics_list:
        for k in ("loss", "l0", "explained_variance"):
            if len(vals[k]) != len(layers) or not all(math.isfinite(v) for v in vals[k]):
                raise AssertionError(f"{k}: {vals[k]}")
        if not all(v > 0 for l, v in zip(layers, vals["l0"]) if l not in SWEEP_L0_EXEMPT):
            raise AssertionError(f"L0 {vals['l0']} (layers {SWEEP_L0_EXEMPT} exempt)")


def sweep_f32_config():
    """The sweep at the config's default compute dtype: sweep_config() with
    ``compute_dtype`` unset, so the SAEs compute in their float32 ``dtype``
    (B4, B6 and B5 on the float32 route)."""
    return sweep_config().replace(compute_dtype=None)


def phase_sweep(info, cfg=None, phase="sweep"):
    """The slice's main path: the L/14 24-SAE sweep on the card (with
    ``cfg``: the same set-up and path at sweep_f32_config())."""
    from vit_prisma_tpu_torch import HookedViT, get_model_config
    from vit_prisma_tpu_torch.sae import SAESweepTrainer, VisionActivationsStore
    cfg = cfg or sweep_config()
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
    routes_before = _route_counts(counters)
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
        raise AssertionError(f"{phase} launches {launches}, expected {expected}, "
                             f"{len(refills)} refills")
    # B4's and B6's launches on the picker's route (the sweep in bf16: Hopper;
    # in f32: 3xTF32)
    routes = _check_routes(phase, counters, routes_before, launches, _cfg_route(cfg))
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
    remat_routes_before = _route_counts(counters)
    t3 = time.perf_counter()
    remat_metrics = remat.train_cycles(1)
    torch.cuda.synchronize()
    remat_s = time.perf_counter() - t3
    remat_launches = {k: f.launches for k, f in counters.items()}
    if (remat_launches["sae_fused_backward"] != K or remat_launches["sae_fused_forward"] != K
            or remat_launches["sae_fused_backward_stored"] != 0):
        raise AssertionError(f"remat cycle launches {remat_launches}")
    # B4's and B5's launches on the picker's route (bf16: Hopper; f32: 3xTF32)
    remat_routes = _check_routes(f"{phase} remat cycle", counters, remat_routes_before,
                                 remat_launches, _cfg_route(cfg))
    remat_host = trainer.log_metrics(type(remat_metrics)(*(f[-1] for f in remat_metrics)))
    _check_sweep_metrics([{k: per_layer(remat_host, k)
                           for k in ("loss", "l0", "explained_variance")}], cfg.sweep_layers)

    # the multi-step loop's [K, B, L, d] -> [K, L, B, d] transpose, alone
    block = store.next_batches(K)
    transpose_ms = cuda_us(lambda: block.transpose(1, 2).contiguous(), iters=5) / 1000.0
    # where a refill's time goes (the L/14 harvest: B1 24 a store batch)
    # (the float32 sweep's refill is the same harvest: not profiled again)
    refill_profile = (_profile(store._refill_half, share_of=MIX_KERNEL_NAMES)
                      if phase == "sweep" else None)
    step_profile = _sweep_step_profile(trainer, store, cfg)
    sae_tokens = steps * cfg.train_batch_size * L
    train_s = run_s + cycles_s
    changed = {}
    if cfg.compute_dtype is None:
        changed["compute_dtype"] = ("unset (the SAEs compute in their float32 dtype), not "
                                    "bfloat16: the config's default")
    emit({"phase": phase, **info, "model": SWEEP_MODEL,
          "weights": "random, seed 0, bfloat16 (pretrained weights are not in the repository)",
          "dataset": f"{SWEEP_IMAGES} random float32 {cfg.image_size}px images, numpy seed 5, "
                     "on the card",
          "changed_from_bench_py_189_214": {
              "model": "the port's openai/clip-vit-large-patch14 registry entry in bf16",
              "images": "float32 on the card, not the uint8 wire with device_norm "
                        "(phase data drives that wire)",
              "prefetch": "none: the port's prefetch stages host-fed streams only, and "
                          "the harvest runs at refill time",
              "wandb_log_frequency": "3, not 10: per-layer metrics read every 3 steps",
              **changed},
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
          "refill_profile": refill_profile, "step_profile": step_profile,
          "routes": routes,
          "remat_cycle": {"launches": remat_launches, "routes": remat_routes,
                          "seconds": remat_s, "mean_loss_last_step": remat_host["loss"]},
          "metrics_logged": [{k: v[k] for k in ("loss", "l0", "explained_variance")}
                             for v in log],
          "l0_per_layer_logged": [per_layer(v, "l0") for v in log],
          "l0_checked_above_0_except_layers": list(SWEEP_L0_EXEMPT),
          "ev_per_layer_logged": [per_layer(v, "explained_variance") for v in log],
          "metrics_last": {k: host[-1][k] for k in ("loss", "l0", "explained_variance")}})
    return trainer, store, cfg, launches, remat_launches


def _sweep_step_profile(trainer, store, cfg):
    """One sweep step's time from the trained state, on three batches taken
    from the store: the mean of SWEEP_PROFILE_STEPS steps by CUDA events, and
    torch.profiler's device time by kernel over three, with the device's
    idle share of the timed steps."""
    from vit_prisma_tpu_torch.sae.train import sae_sweep_train_step
    batches = [store.next_batch() for _ in range(3)]

    def steps(n):
        state = trainer.state
        for j in range(n):
            state, _ = sae_sweep_train_step(state, batches[j % len(batches)], cfg)

    steps(2)  # warm-up
    step_ms = cuda_us(lambda: steps(SWEEP_PROFILE_STEPS), iters=1, warmup=0) \
        / 1000.0 / SWEEP_PROFILE_STEPS
    # B4 and B6 launch six kernels a step on the Hopper route (center and two
    # GEMMs each) and ten on the float32 route (B4: center, W_enc's and
    # W_dec's splits, encoder, decoder; B6: W_dec's split, dh, xc's and dy's
    # transposed splits, the weight gradients); a window that lost device
    # events (a kernel counted other than a whole number of times a step) is
    # profiled again with a wider margin, and the last such raises
    f32 = _cfg_route(cfg)["sae_fused_forward"] == "tf32x3"
    names, per_step = (((*SAE_TF32_KERNELS, "center_kernel"), 10) if f32
                       else ((SAE_TC_KERNEL, "center_kernel"), 6))
    # the float32 step's breakdown: B4's and B6's launches by mode, the split
    # pre-passes, B7, cuBLAS and elementwise work
    parts = ((*(f"{SAE_TF32_KERNEL}<{m}>" for m in range(4)), "split_t_kernel",
              "split_rows_kernel", "center_kernel", "adam_", "gemm", "elementwise", "reduce")
             if f32 else ())
    for tries, pad in enumerate(PROFILE_PADS_S, 1):
        prof = _profile(lambda: steps(3), share_of=names, warm=True, pad=pad,
                        top=24 if f32 else TOPK_PROFILE_TOP, time_of=parts, calls_of=parts)
        if (all(k["calls"] % 3 == 0 for k in prof["kernels"])
                and prof["share_of"]["calls"] == per_step * 3):
            break
    else:
        raise AssertionError(f"torch.profiler lost device events in {tries} windows of "
                             f"the sweep step: {prof['share_of']}, {prof['kernels']}")
    return {"steps_timed": SWEEP_PROFILE_STEPS, "ms_per_step": step_ms, "profile_windows": tries,
            "sae_tokens_per_s": cfg.train_batch_size * len(cfg.sweep_layers) / step_ms * 1e3,
            "device_busy_ms_per_step": prof["device_busy_ms"] / 3,
            "idle_share_of_timed_steps": max(0.0, 1.0 - prof["device_busy_ms"] / 3 / step_ms),
            "profile_of_3_steps": prof}


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


def _modes_ptxas(modes):
    """ptxas's record of the Hopper route kernel's ``modes`` (GATED_TC_MODES:
    B11's encoder and 192-wide decoder, B12's encoder, dg and wgrad;
    REMAT_TOPK_TC_MODES: B5's, B8's and B9's): each built, no spills, no
    serialized wgmma."""
    rec = {m: r for m, r in _tc_ptxas().items()
           if any(f"{SAE_TC_KERNEL}ILi{mode}E" in m for mode in modes)}
    if len(rec) != len(modes):
        raise AssertionError(f"{SAE_TC_KERNEL}: modes {modes} in {list(rec)}")
    return rec


def _gated_backward_acts(args, dy, dvia, dl1, route):
    """c(h) and c(hga) as B12 recomputes them: its C entry on ``route``
    called with this phase's own scratch buffers (the wrapper keeps them to
    itself), held until the call has returned."""
    from vit_prisma_tpu_torch.ops import _build
    from vit_prisma_tpu_torch.ops import sae_step as S
    x, We, bg, rmag, bm, Wd, bd = args
    L, B, D = x.shape
    Sd = We.shape[-1]
    e, wdn = S._gated_hoisted_card(rmag, Wd)
    new = lambda *shape, dtype=x.dtype: torch.empty(shape, dtype=dtype, device="cuda")
    f32 = torch.float32
    xc, dgc = new(L, B, D), new(L, B, Sd)
    part, sums = new(4, L, B // 128, Sd, dtype=f32), new(4, L, Sd, dtype=f32)
    dWe, dWd = new(L, D, Sd, dtype=f32), new(L, Sd, D, dtype=f32)
    ins = [t.data_ptr() for t in (x, We, bg, e, bm, Wd, bd, wdn, dy, dvia, dl1, xc)]
    outs = [t.data_ptr() for t in (dgc, part, sums, dWe, dWd)]
    lib, stream = _build.load_library(), torch.cuda.current_stream().cuda_stream
    if route in ("wgmma", "tf32x3"):
        h, gf = new(L, 2 * B, Sd), new(L, B, Sd, dtype=f32)
        if route == "wgmma":
            rc = lib.sae_gated_bwd_tc(*ins, h.data_ptr(), gf.data_ptr(), *outs, L, B, D, Sd, 0,
                                      stream)
        else:
            split = new(S._tf32_scratch_floats(True, L, B, D, Sd, "gated"), dtype=f32)
            rc = lib.sae_gated_bwd_tf32(*ins, h.data_ptr(), gf.data_ptr(), *outs,
                                        split.data_ptr(), L, B, D, Sd, 0, stream)
        hc, hgac = h[:, :B], h[:, B:]
    else:
        hc, hgac = new(L, B, Sd), new(L, B, Sd)
        rc = lib.sae_fused_bwd_gated(*ins, hc.data_ptr(), hgac.data_ptr(), *outs, L, B, D, Sd,
                                     S._DTYPE_CODES[x.dtype], 0, stream)
    _build.check(lib, rc, f"sae_gated_bwd ({route})")
    torch.cuda.synchronize()
    return hc, hgac


def phase_gated_kernels(info):
    """B11 and B12 against their plain versions at GATED_SHAPES (the gated
    slice's and two layers of the sweep's widths in both dtypes, and a width
    that keeps the bf16 mma.sync tiles): the route each took, two calls
    equal to the bit, B12's recomputed activations equal to B11's, and the
    cuBLAS time of their products beside them; ptxas's record of the Hopper
    route's gated modes and of the float32 route's (at most 168 registers,
    no spill, no serialized wgmma)."""
    from vit_prisma_tpu_torch.ops import sae_step as S
    g = torch.Generator(device="cuda").manual_seed(8)
    gated_ptxas = _modes_ptxas(GATED_TC_MODES)
    f32_ptxas = _tf32_ptxas(SAE_TF32_GATED_MODES)
    if len(f32_ptxas) != len(SAE_TF32_GATED_MODES) or any(
            r["registers"] > 168 for r in f32_ptxas.values()):
        raise AssertionError(f"{SAE_TF32_KERNEL} gated modes: {f32_ptxas}")
    results = {}
    for name, L, B, D, Sd, dtype in GATED_SHAPES:
        x, We, bg, Wd, bd, dy, dl1 = _sae_inputs(g, L, B, D, Sd, dtype)
        r = lambda *shape, sc: (torch.randn(*shape, generator=g, device="cuda") * sc).to(dtype)
        rmag, bm, dvia = r(L, Sd, sc=0.1), r(L, Sd, sc=0.01), r(L, B, D, sc=1e-3)
        args = (x, We, bg, rmag, bm, Wd, bd)
        (y, via, l1, nact, hc, hgac), route11 = _routed(S.sae_gated_fused_forward, *args,
                                                          save_h=True)
        torch.cuda.synchronize()
        routes = {"sae_gated_fused_forward": _route_record(name, B, D, Sd, dtype, route11,
                                                           "gated")}
        yr, viar, l1r, nactr = S.sae_gated_fused_forward_reference(*args)
        gate_k, mag_k = hgac.float() > 0, hc.float() > 0
        gate_p, mag_p, hg_p = _gated_masks_plain(x, We, bg, rmag, bm, bd)
        gflip, mflip = gate_k != gate_p, mag_k != mag_p
        del gate_p, mag_p
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
        grads, route12 = _routed(S.sae_gated_fused_backward, *args, dy, dvia, dl1)
        torch.cuda.synchronize()
        routes["sae_gated_fused_backward"] = _route_record(name, B, D, Sd, dtype, route12,
                                                           "gated")
        bwd = _grad_errs(f"{name} B12", grads,
                         S.sae_gated_fused_backward_reference(*args, dy, dvia, dl1), switched,
                         dtype, keys=("dW_enc", "dW_dec", "db_gate", "db_mag", "dr_mag"))
        del grads
        # B12 recomputes B11's activations, so its masks are B11's: to the bit
        hc12, hgac12 = _gated_backward_acts(args, dy, dvia, dl1, route12)
        same_acts = {"h": torch.equal(hc12, hc), "hga": torch.equal(hgac12, hgac)}
        del hc12, hgac12
        if not all(same_acts.values()):
            raise AssertionError(f"{name}: B12's recomputed activations differ from B11's "
                                 f"{same_acts}")
        repeat = {
            "sae_gated_fused_forward": _bitwise_repeat(
                f"{name} B11", lambda: S.sae_gated_fused_forward(*args, save_h=True)),
            "sae_gated_fused_backward": _bitwise_repeat(
                f"{name} B12", lambda: S.sae_gated_fused_backward(*args, dy, dvia, dl1))}
        flop = 2 * L * B * D * Sd
        eb = x.element_size()
        gemm = "bf16_tensor" if dtype == torch.bfloat16 else "f32_product"
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
        # the products alone, on operands of the same shapes and layouts (c(dg)'s
        # place is taken by c(hga): cuBLAS's time does not depend on the values)
        xc, WdT = x - bd[:, None], Wd.transpose(1, 2)
        cublas = {"sae_gated_fused_forward": _cublas_products(
                      [(xc, We), (hc, Wd), (hgac, Wd)], 3 * flop),
                  "sae_gated_fused_backward": _cublas_products(
                      [(xc, We), (dy, WdT), (dvia, WdT), (xc.transpose(1, 2), hgac),
                       (hc.transpose(1, 2), dy), (hgac.transpose(1, 2), dvia)], 6 * flop)}
        del xc, WdT
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
                   **bound(nbytes, [(gemm, n_flop)]), **routes[kernel], **cublas[kernel],
                   "bitwise_repeat": repeat[kernel],
                   "b12_recomputes_b11_acts_bitwise": same_acts}
            if kernel == "sae_gated_fused_forward":
                rec["forward"] = fwd
            else:
                rec["grad_errs"] = bwd
            if rec["route"] == "wgmma":
                rec["source"] = SAE_TC_SOURCE
                rec["ptxas"] = gated_ptxas
            elif rec["route"] == "tf32x3":
                rec.update(source=SAE_TF32_SOURCE, entry=SAE_TF32_GATED_ENTRIES[kernel],
                           ptxas=f32_ptxas)
            results[(kernel, name)] = rec
            emit(rec)
        del x, We, bg, rmag, bm, Wd, bd, dy, dvia, y, via, hc, hgac, args
        torch.cuda.empty_cache()
    return results


def phase_gated_train_f32(info, trainer, store, cfg):
    """bench.py's gated recipe at its float32 compute dtype (``cfg`` with
    ``compute_dtype`` unset, SAERunnerConfig's default) through
    VisionSAETrainer on the card, from the gated train phase's state on its
    store, which serves every step here without a refill: one step of
    ``run`` (B11, B12 on 3xTF32), then TOPK_F32_REPEATS runs of
    TOPK_F32_STEPS of the trainer's ``train_step`` on batches in the buffer,
    each by synchronized wall time, and TOPK_F32_PROFILED more under
    torch.profiler (device time, idle share, B11's and B12's launches by
    mode); launches counted by route.  Returns the launches."""
    from vit_prisma_tpu_torch.sae import VisionSAETrainer
    c = cfg.replace(compute_dtype=None)
    want_routes = _cfg_route(c)
    if any(want_routes[k] != "tf32x3" for k in SAE_TF32_GATED_ENTRIES):
        raise AssertionError(f"float32 gated routes {want_routes}")
    counters = _sae_counters()
    refills = _time_refills(store)
    f32 = VisionSAETrainer(c, trainer.model, store)
    f32.load_state(trainer.state)
    bs = c.train_batch_size
    batches = [store.buffer[i * bs:(i + 1) * bs] for i in range(TOPK_F32_STEPS)]
    _zero_counts(counters)
    routes_before = _route_counts(counters)
    f32.run(max_steps=1)  # warm-up
    seconds = []
    for _ in range(TOPK_F32_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            f32.train_step(b)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    steps = 1 + TOPK_F32_REPEATS * TOPK_F32_STEPS
    # the step's device time by part over TOPK_F32_PROFILED steps, after as
    # many in an unkept profiler cycle: B11's (center, W_enc's and W_dec's
    # splits, mode 6, the decoder) and B12's launches (center, four splits,
    # mode 7, W_dec's row split, mode 8 twice, the partial sums, mode 9), B7,
    # cuBLAS and elementwise work.  A window that lost device events is
    # taken again with the next margin of PROFILE_PADS_S.
    parts = (*(f"{SAE_TF32_KERNEL}<{m}>" for m in SAE_TF32_MODES), "split_t_kernel",
             "split_rows_kernel", "center_kernel", "partial_sums_kernel", "adam_", "gemm",
             "elementwise", "reduce")
    per_step = {f"{SAE_TF32_KERNEL}<1>": 1, f"{SAE_TF32_KERNEL}<6>": 1,
                f"{SAE_TF32_KERNEL}<7>": 1, f"{SAE_TF32_KERNEL}<8>": 2,
                f"{SAE_TF32_KERNEL}<9>": 1, "split_t_kernel": 6, "split_rows_kernel": 1,
                "center_kernel": 2, "partial_sums_kernel": 1}
    for tries, pad in enumerate(PROFILE_PADS_S, 1):
        prof = _profile(lambda: [f32.train_step(b) for b in batches[:TOPK_F32_PROFILED]],
                        share_of=SAE_TF32_KERNELS + ("center_kernel", "partial_sums_kernel"),
                        top=GATED_PROFILE_TOP, time_of=parts, calls_of=parts, pad=pad,
                        warm=True)
        steps += 2 * TOPK_F32_PROFILED
        if all(prof["calls_of"][k] == n * TOPK_F32_PROFILED for k, n in per_step.items()):
            break
    else:
        raise AssertionError(f"torch.profiler lost device events in {tries} windows of the "
                             f"float32 gated step: {prof['calls_of']}")
    launches = {k: f.launches for k, f in counters.items()}
    expected = dict.fromkeys(counters, 0)
    expected.update({"sae_gated_fused_forward": steps, "sae_gated_fused_backward": steps,
                     "adam_update": len(f32.state.params) * steps})
    if launches != expected:
        raise AssertionError(f"float32 gated steps launched {launches}, expected {expected}")
    routes = _check_routes("float32 gated steps", counters, routes_before, launches, want_routes)
    if not all(torch.isfinite(v).all() for v in f32.state.params.values()):
        raise AssertionError("non-finite SAE parameters after the float32 gated steps")
    if refills:
        raise AssertionError(f"the float32 gated steps refilled the store {len(refills)} times")
    ms = sorted(1000.0 * t / TOPK_F32_STEPS for t in seconds)
    by_mode = lambda modes: {m: prof["time_of"][f"{SAE_TF32_KERNEL}<{m}>"] / TOPK_F32_PROFILED
                             for m in modes}
    emit({"phase": "gated_train_f32", **info, "model": c.model_name,
          "recipe": "bench.py's gated row at its float32 compute dtype (no compute_dtype)",
          "d_in": c.d_in, "d_sae": c.d_sae, "train_batch_size": bs, "dtype": c.dtype,
          "compute_dtype": c.compute_dtype, "store": "the gated train phase's, no refill",
          "start_step": int(trainer.state.step),
          "timed": f"{TOPK_F32_REPEATS} runs of {TOPK_F32_STEPS} train_step calls",
          "seconds": seconds, "ms_per_step_wall": ms,
          "sae_tokens_per_s": [1000.0 * bs / m for m in reversed(ms)],
          "profiled_steps": TOPK_F32_PROFILED, "profile_windows": tries,
          "device_busy_ms_per_step": prof["device_busy_ms"] / TOPK_F32_PROFILED,
          "wall_ms_per_profiled_step": prof["wall_ms"] / TOPK_F32_PROFILED,
          "idle_share_profiled": prof["idle_share"],
          "b11_device_ms_by_mode": by_mode((6, 1)), "b12_device_ms_by_mode": by_mode((7, 8, 9)),
          "splits_ms_per_step": (prof["time_of"]["split_t_kernel"]
                                 + prof["time_of"]["split_rows_kernel"]) / TOPK_F32_PROFILED,
          "profile": prof, "launches": launches, "expected_launches": expected,
          "routes": routes})
    return launches


def gated_config():
    """The gated slice: bench.py's gated row (bf16 compute, float32 masters)
    at SAERunnerConfig's default widths, with a 1-batch buffer."""
    from vit_prisma_tpu_torch.sae import SAERunnerConfig
    return SAERunnerConfig(architecture="gated", compute_dtype="bfloat16",
                           n_batches_in_buffer=SLICE_BUFFER_BATCHES)


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


def phase_grad_kernels(info):
    """B2 against its plain version on the card, with both times, the bound
    and the backward of ``scaled_dot_product_attention`` on a retained
    graph at the same shapes; batch item 0 alone against item 0 of the
    batch, to the bit; ptxas's record of the bf16 passes; and B2's gate
    against B1's at H = 64."""
    from vit_prisma_tpu_torch.ops.attention import (
        attention_mix_tnh_bwd, attention_mix_tnh_bwd_reference, mix_route,
        mix_tnh_bwd_fits_smem, mix_tnh_fits_smem)
    gate = [T for T in range(1, 1025) if mix_tnh_fits_smem(T, 64) != mix_tnh_bwd_fits_smem(T, 64)]
    if gate or not mix_tnh_fits_smem(411, 64) or mix_tnh_fits_smem(412, 64):
        raise AssertionError(f"B2's gate differs from B1's at H = 64, T = {gate}")
    g = torch.Generator(device="cuda").manual_seed(4)
    results = {}
    for name, B, T, N, H, causal, dtypes in GRAD_KERNEL_SHAPES:
        for dtype in dtypes:
            shape = (B, T, N * H)
            q = (torch.randn(shape, generator=g, device="cuda") * H ** -0.5).to(dtype)
            k, v, dz = (torch.randn(shape, generator=g, device="cuda").to(dtype) for _ in range(3))
            got = attention_mix_tnh_bwd(q, k, v, dz, N, causal)
            want = attention_mix_tnh_bwd_reference(q, k, v, dz, N, causal)
            torch.cuda.synchronize()
            errs = {}
            for which, a, b in zip(("dq", "dk", "dv"), got, want):
                if a.dtype != dtype or a.shape != q.shape:
                    raise AssertionError(f"B2 {name} {dtype} {which}: {a.dtype} {tuple(a.shape)}")
                errs[which] = check_close(f"B2 {name} {dtype} {which}", a, b,
                                          rel_atol(GRAD_KERNEL_REL[dtype], b))
            # a (head, batch item) result depends on its own inputs alone
            alone = attention_mix_tnh_bwd(q[:1], k[:1], v[:1], dz[:1], N, causal)
            torch.cuda.synchronize()
            for which, a, b in zip(("dq", "dk", "dv"), alone, got):
                if not torch.equal(a[0], b[0]):
                    raise AssertionError(f"B2 {name} {dtype} {which}: item 0 alone differs "
                                         "from item 0 of the batch")
            us = cuda_us(lambda: attention_mix_tnh_bwd(q, k, v, dz, N, causal))
            plain_us = cuda_us(lambda: attention_mix_tnh_bwd_reference(q, k, v, dz, N, causal),
                               iters=5)
            # the kernels the profiler sees (float32), before the library's
            # windows through autograd's engine open
            profiled = (profiled_kernels(
                f"B2 {name}", [(f"{ATTENTION}:attention_mix_tnh_bwd", (q, k, v, dz, N, causal),
                                {})], mix_route(H, dtype), (1, 2))
                if dtype == torch.float32 else None)
            # the library: SDPA's backward alone, on head-major copies made
            # beforehand, through a graph kept for every call
            qh, kh, vh, dzh = (a.reshape(B, T, N, H).transpose(1, 2).contiguous()
                               for a in (q, k, v, dz))
            leaves = [a.requires_grad_(True) for a in (qh, kh, vh)]
            out = torch.nn.functional.scaled_dot_product_attention(
                *leaves, is_causal=causal, scale=1.0)
            sdpa_bwd = lambda: torch.autograd.grad(out, leaves, dzh, retain_graph=True)
            library_us = device_us(sdpa_bwd, one_call_short=True)
            library_wall_us = cuda_us(sdpa_bwd)
            del out, leaves, sdpa_bwd
            pairs = T * (T + 1) // 2 if causal else T * T
            gemm = "bf16_tensor" if dtype == torch.bfloat16 else "f32_product"
            flops = 5 * 2 * B * N * pairs * H
            rec = {"phase": "grad_kernel", **info, "kernel": "attention_mix_tnh_bwd",
                   "shape": name, "B": B, "T": T, "N": N, "H": H, "causal": causal,
                   "dtype": str(dtype).split(".")[1], "max_abs_err": max(errs.values()),
                   "max_abs_err_by_grad": errs, "rel_tol": GRAD_KERNEL_REL[dtype],
                   "batch_independent": True, "route": mix_route(H, dtype),
                   "us": us, "plain_us": plain_us,
                   # the library's device time (profiler); its event time beside
                   "library_us": library_us, "library_wall_us": library_wall_us,
                   "TFLOP_s": flops / (us * 1e-6) / 1e12,
                   "library_TFLOP_s": flops / (library_us * 1e-6) / 1e12,
                   # the Pallas kernel's cost estimate: 7 tensors moved once,
                   # five products of 2 B N T^2 H flops (the pairs this mask keeps)
                   **bound(7 * q.numel() * q.element_size(),
                           [(gemm, flops), ("fp32", 8 * B * N * pairs)])}
            if profiled is not None:
                rec["profiled_kernels"] = profiled
            results[(name, dtype)] = rec
            emit(rec)
            del q, k, v, dz, got, want, alone, qh, kh, vh, dzh
    emit({"phase": "grad_kernel_ptxas", **info,
          **{kern: ptxas(kern) for kern in GRAD_TC_KERNELS + MIX_TF32_KERNELS[1:]
             + MIX_FFMA_KERNELS[1:]}})
    return results


def grad_config(dtype="bfloat16"):
    from vit_prisma_tpu_torch import ViTConfig
    return ViTConfig(n_layers=12, d_model=768, d_head=64, n_heads=12, d_mlp=3072,
                     patch_size=32, image_size=224, n_classes=512,
                     activation_name="quick_gelu", layer_norm_pre=True,
                     return_type="class_logits", dtype=dtype)


def _grad_model(cfg, device="cuda", cls=None):
    from vit_prisma_tpu_torch import HookedViT
    return (cls or HookedViT)(cfg, device=device, generator=torch.Generator().manual_seed(0))


def _images(n, seed, device="cuda", dtype=torch.float32):
    x = np.random.default_rng(seed).standard_normal((n, 3, 224, 224), dtype=np.float32)
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def _metric(out):
    a, b = ATTRIB_CLASSES
    return (out[:, a] - out[:, b]).float().sum()


def _cache_grad_errs(got, want, rel):
    """Max abs error of every ``*_grad`` entry against ``want``'s, raising
    past rel times that gradient's absmax."""
    return {k: check_close(k, got[k], want[k], rel * want[k].float().abs().max().item())
            for k in want if k.endswith("_grad")}


def phase_attribution(info):
    """Demo 06 at full width: run_with_cache(incl_bwd=True) over the 12
    resid_post hooks, bf16, batch 256, through B1 and B2."""
    counters = _sae_counters()
    cfg = grad_config()
    model = _grad_model(cfg)
    x = _images(GRAD_BATCH, 5, dtype=torch.bfloat16)
    release()
    torch.cuda.reset_peak_memory_stats()

    # The main path, with every count set to 0 just before it.
    _zero_counts(counters)
    out, cache = model.run_with_cache(x, names_filter=RESID_POST, incl_bwd=True,
                                      loss_fn=_metric, return_cache_object=False)
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters.items()}
    # Autograd runs only the backward that the cached gradients need: layer
    # 0's attention lies upstream of every cached point, so B2 runs in
    # layers 1-11 (XLA's dead-code elimination drops the same in JAX).
    expected = dict.fromkeys(counters, 0)
    expected.update(attention_mix_tnh=cfg.n_layers, attention_mix_tnh_bwd=cfg.n_layers - 1)
    if launches != expected:
        raise AssertionError(f"attribution launches {launches}, expected {expected}")
    names = [f"blocks.{l}.hook_resid_post" for l in range(cfg.n_layers)]
    if list(cache) != names + [n + "_grad" for n in reversed(names)]:
        raise AssertionError(f"attribution keys {list(cache)}")
    for k, v in cache.items():
        if tuple(v.shape) != (GRAD_BATCH, cfg.n_tokens, cfg.d_model) or not torch.isfinite(v).all():
            raise AssertionError(f"{k}: {tuple(v.shape)}, finite {bool(torch.isfinite(v).all())}")
    if not all(cache[n + "_grad"].abs().max() > 0 for n in names):
        raise AssertionError("a resid_post gradient is all zeros")
    times = []
    for _ in range(GRAD_TIMED + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.run_with_cache(x, names_filter=RESID_POST, incl_bwd=True, loss_fn=_metric,
                             return_cache_object=False)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 1e9

    # Demo 06's backward intervention: zeroing the gradient at layer 6's
    # resid_post leaves every layer below it without gradient.
    _, cut = model.run_with_cache(
        x, names_filter=RESID_POST, incl_bwd=True, loss_fn=_metric,
        bwd_hooks=[("blocks.6.hook_resid_post", lambda g, hook: g * 0.0)],
        return_cache_object=False)
    up = cut["blocks.2.hook_resid_post_grad"].abs().max().item()
    down = cut["blocks.9.hook_resid_post_grad"].abs().max().item()
    if not (up == 0.0 and down > 0.0):
        raise AssertionError(f"zeroed grad at layer 6: layer 2 {up}, layer 9 {down}")
    if not all(torch.equal(cut[n], cache[n]) for n in names):
        raise AssertionError("a backward editor changed the forward")

    # bf16 kernels against the bf16 einsum path (no B1, no B2)
    plain = _grad_model(cfg.replace(use_fused_attention=False))
    plain.load_state_dict(model.state_dict())
    _zero_counts(counters)
    _, cache_p = plain.run_with_cache(x, names_filter=RESID_POST, incl_bwd=True,
                                      loss_fn=_metric, return_cache_object=False)
    torch.cuda.synchronize()
    if any(f.launches for f in counters.values()):
        raise AssertionError("the einsum path launched a kernel")
    bf16_errs = _cache_grad_errs(cache, cache_p, GRAD_BF16_REL)
    del plain, cache_p, cut

    # float32 on the card against the CPU, batch 4
    f32 = cfg.replace(dtype="float32")
    card_model, cpu_model = _grad_model(f32), _grad_model(f32, "cpu")
    card_model.load_state_dict(model.state_dict())
    cpu_model.load_state_dict(card_model.state_dict())
    xs = _images(GRAD_F32_BATCH, 6, "cpu")
    out_c, got = card_model.run_with_cache(xs.cuda(), names_filter=RESID_POST,
                                           incl_bwd=True, loss_fn=_metric,
                                           return_cache_object=False)
    out_r, want = cpu_model.run_with_cache(xs, names_filter=RESID_POST, incl_bwd=True,
                                           loss_fn=_metric, return_cache_object=False)
    f32_errs = {"logits": check_close("f32 logits", out_c, out_r, rel_atol(GRAD_F32_REL, out_r)),
                **_cache_grad_errs(got, want, GRAD_F32_REL)}
    emit({"phase": "attribution", **info, "config": "bench.py:56-61 (B/32 geometry, 512 classes)",
          "dtype": "bfloat16", "batch": GRAD_BATCH, "hooks": len(names),
          "metric": f"logit {ATTRIB_CLASSES[0]} - logit {ATTRIB_CLASSES[1]}, summed",
          "launches": launches, "expected_launches": expected,
          "seconds_per_call": times[1:], "img_per_s": [GRAD_BATCH / t for t in times[1:]],
          "peak_memory_GB": peak, "zeroed_at_layer_6": {"layer_2_max": up, "layer_9_max": down},
          "bf16_kernels_vs_einsum_max_abs_err": bf16_errs, "bf16_rel_tol": GRAD_BF16_REL,
          "f32_card_vs_cpu_max_abs_err": f32_errs, "f32_rel_tol": GRAD_F32_REL,
          "grad_absmax": {k: v.abs().max().item() for k, v in cache.items()
                          if k.endswith("_grad")}})
    return launches


def _train_state(model, lr, weight_decay=1e-4):
    """AdamW at a constant rate (a step schedule that never steps)."""
    from vit_prisma_tpu_torch.training.trainer import (TrainerConfig, TrainState,
                                                      _make_optimizer)
    tcfg = TrainerConfig(lr=lr, weight_decay=weight_decay, warmup_steps=0,
                         scheduler_step=10 ** 9)
    return TrainState(model, *_make_optimizer(tcfg, 1, model.parameters()))


class _StepLog:
    """A trainer callback recording the steps and epochs it sees."""

    def __init__(self):
        self.steps, self.epochs = [], []

    def on_step_end(self, step, model, metrics):
        self.steps.append(step)

    def on_epoch_end(self, epoch, model, metrics):
        self.epochs.append(epoch)


def phase_vit_train(info):
    """The supervised trainer at bench.py's row: make_train_step on one
    fixed batch (B1 and B2 in every step), where a step's time goes, then
    train() end to end with a checkpoint and a resume."""
    import tempfile
    from vit_prisma_tpu_torch.training.trainer import (TrainerConfig, load_checkpoint,
                                                      make_train_step, train)
    counters = _sae_counters()
    cfg = grad_config()
    model = _grad_model(cfg)
    x = _images(GRAD_BATCH, 7, dtype=torch.bfloat16)
    labels = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.n_classes, GRAD_BATCH)).cuda()
    state = _train_state(model, GRAD_TRAIN_LR)
    step = make_train_step(cfg, "CrossEntropy")
    release()
    torch.cuda.reset_peak_memory_stats()

    # The main path, with every count set to 0 just before it.
    _zero_counts(counters)
    state, loss0 = step(state, x, labels)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for _ in range(GRAD_TRAIN_STEPS):
        state, loss = step(state, x, labels)
        losses.append(loss)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counters.items()}
    n_steps = GRAD_TRAIN_STEPS + 1
    expected = dict.fromkeys(counters, 0)
    expected.update(attention_mix_tnh=cfg.n_layers * n_steps,
                    attention_mix_tnh_bwd=cfg.n_layers * n_steps)
    if launches != expected:
        raise AssertionError(f"vit_train launches {launches}, expected {expected}")
    losses = [float(loss0)] + [float(l) for l in losses]
    if not all(math.isfinite(l) for l in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses {losses}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    step_ms = 1e3 * seconds / GRAD_TRAIN_STEPS

    def steps(n):
        nonlocal state
        for _ in range(n):
            state, _ = step(state, x, labels)
    prof = _profile(lambda: steps(3))
    emit({"phase": "vit_train", **info, "config": "bench.py:56-61, :120-133",
          "dtype": "bfloat16", "batch": GRAD_BATCH, "optimizer": "AdamW",
          "lr": GRAD_TRAIN_LR, "steps_timed": GRAD_TRAIN_STEPS, "launches": launches,
          "expected_launches": expected, "loss_first": losses[0], "loss_last": losses[-1],
          "ms_per_step": step_ms, "img_per_s": GRAD_BATCH / step_ms * 1e3,
          "peak_memory_GB": peak,
          "device_busy_ms_per_step": prof["device_busy_ms"] / 3,
          # the profiler slows the host: the share that counts is of the
          # steps timed without it
          "idle_share_of_timed_steps": max(0.0, 1.0 - prof["device_busy_ms"] / 3 / step_ms),
          "profile_of_3_steps": prof})
    del model, state, x
    release()

    # train() end to end: a list of (image, label) pairs, one metrics pass,
    # a checkpoint at the last step, then a resume from it.
    rng = np.random.default_rng(0)
    images = rng.standard_normal((FIT_IMAGES, 3, 224, 224), dtype=np.float32)
    classes = rng.integers(0, cfg.n_classes, FIT_IMAGES)
    data = [(images[i], int(classes[i])) for i in range(FIT_IMAGES)]
    build = lambda c: _grad_model(c)
    with tempfile.TemporaryDirectory() as tmp:
        tcfg = TrainerConfig(lr=FIT_LR, batch_size=FIT_BATCH, num_epochs=3,
                             max_steps=FIT_STEPS, save_checkpoints=True,
                             save_cp_frequency=FIT_STEPS, parent_dir=tmp)
        calls = _StepLog()
        t0 = time.perf_counter()
        fitted = train(build, cfg, data, tcfg=tcfg, callbacks=[calls])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        ckpts = sorted(os.listdir(os.path.join(tmp, tcfg.save_dir)))
        path = os.path.join(tmp, tcfg.save_dir, ckpts[-1])
        ckpt = load_checkpoint(path)
        if calls.steps != list(range(1, FIT_STEPS + 1)) or ckpt["step"] != FIT_STEPS:
            raise AssertionError(f"train steps {calls.steps}, checkpoint step {ckpt['step']}")
        if not all(np.array_equal(ckpt["params"][k], v.float().cpu().numpy())
                   for k, v in fitted.state_dict().items()):
            raise AssertionError("the checkpoint's params are not the trained model's")
        resumed_calls = _StepLog()
        resumed = train(build, cfg, data, checkpoint_path=path, callbacks=[resumed_calls],
                        tcfg=dataclasses.replace(tcfg, max_steps=FIT_STEPS + 2,
                                                 save_checkpoints=False))
        drift = lambda m: max((v.float().cpu() - torch.from_numpy(ckpt["params"][k])).abs().max().item()
                              for k, v in m.state_dict().items())
        from_ckpt, from_scratch = drift(resumed), drift(build(cfg))
        if resumed_calls.steps != [FIT_STEPS + 1, FIT_STEPS + 2] or not from_ckpt < from_scratch:
            raise AssertionError(f"resume: steps {resumed_calls.steps}, drift {from_ckpt} "
                                 f"from the checkpoint, {from_scratch} from a fresh model")
    emit({"phase": "vit_train_fit", **info, "images": FIT_IMAGES, "batch": FIT_BATCH,
          "dataset": f"{FIT_IMAGES} random float32 224px images, labels of {cfg.n_classes} "
                     "classes, numpy seed 0, a list of (image, label) pairs",
          "steps": calls.steps, "seconds": fit_s, "checkpoints": ckpts,
          "checkpoint_epoch": ckpt["epoch"], "resumed_steps": resumed_calls.steps,
          "resumed_epochs": resumed_calls.epochs,
          "resumed_max_drift_from_checkpoint": from_ckpt,
          "fresh_max_drift_from_checkpoint": from_scratch})
    return launches


def phase_vit_train_check(info):
    """Three float32 steps at batch 8 on the card and on the CPU from one
    state: gradients, parameters and AdamW moments."""
    from vit_prisma_tpu_torch.training.trainer import make_train_step
    cfg = grad_config("float32")
    card_model, cpu_model = _grad_model(cfg), _grad_model(cfg, "cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in card_model.state_dict().items()})
    states = {"card": _train_state(card_model, GRAD_TRAIN_LR),
              "cpu": _train_state(cpu_model, GRAD_TRAIN_LR)}
    step = make_train_step(cfg, "CrossEntropy")
    rng = np.random.default_rng(8)
    grad_errs, losses = {}, []
    for i in range(STEP_CHECK_STEPS):
        xs = _images(TRAIN_CHECK_BATCH, 9 + i, "cpu")
        ys = torch.from_numpy(rng.integers(0, cfg.n_classes, TRAIN_CHECK_BATCH))
        _, lc = step(states["card"], xs.cuda(), ys.cuda())
        _, lr_ = step(states["cpu"], xs, ys)
        losses.append((float(lc), float(lr_)))
        if i == 0:  # step 1's gradients, still on the parameters, relative
            for (k, pc), pr in zip(card_model.named_parameters(), cpu_model.parameters()):
                grad_errs[k] = ((pc.grad.cpu() - pr.grad).abs().max().item()
                                / max(pr.grad.abs().max().item(), 1e-30))
    lr, tol = GRAD_TRAIN_LR, TRAIN_CHECK_TOL
    params, moments, far, total = {}, {}, 0, 0
    for (k, pc), pr in zip(card_model.named_parameters(), cpu_model.parameters()):
        d = (pc.detach().cpu() - pr.detach()).abs()
        n_far = int((d > tol["param_close_lr"] * lr).sum())
        far, total = far + n_far, total + d.numel()
        params[k] = {"max_lr": d.max().item() / lr, "far": n_far}
        if k.endswith("attn.b_K"):
            continue  # its gradient is rounding noise (TRAIN_CHECK_TOL's note)
        sc, sr = states["card"].optimizer.state[pc], states["cpu"].optimizer.state[pr]
        moments[k] = {m: (sc[m].cpu() - sr[m]).abs().max().item()
                      / max(sr[m].abs().max().item(), 1e-30) for m in ("exp_avg", "exp_avg_sq")}
    emit({"phase": "vit_train_check", **info, "dtype": "float32", "batch": TRAIN_CHECK_BATCH,
          "steps": STEP_CHECK_STEPS, "losses_card_cpu": losses,
          "step1_grad_rel_err": grad_errs, "grad_rel_tol": GRAD_F32_REL,
          "param_err": params, "far_share": far / total, "moment_rel_err": moments,
          "tol": {**tol, "lr": lr}})
    bad = [f"{k} grad" for k, e in grad_errs.items()
           if not k.endswith("attn.b_K") and not e <= GRAD_F32_REL]
    bad += [k for k, e in params.items() if not e["max_lr"] <= tol["param_max_lr"]]
    bad += [f"{k} {m}" for k, e in moments.items() for m, v in e.items()
            if not v <= tol[m + "_rel"]]
    if bad or not far / total <= tol["param_far_share"]:
        raise AssertionError(f"train check: {bad}, {far} of {total} entries beyond "
                             f"{tol['param_close_lr']} lr")


def phase_sae_attribution(info):
    """Demo 07 at B/32 full width: an error-term ReLU SAE spliced at layer
    9's resid_post, d metric / d feature through B1 and B2."""
    from vit_prisma_tpu_torch import HookedSAEViT
    from vit_prisma_tpu_torch.sae import SAERunnerConfig, SparseAutoencoder
    counters = _sae_counters()
    cfg = grad_config("float32")
    scfg = SAERunnerConfig(d_in=cfg.d_model, expansion_factor=16, hook_point_layer=9,
                           layer_subtype="hook_resid_post", b_dec_init_method="zeros",
                           log_to_wandb=False)
    hp = scfg.hook_point
    model = _grad_model(cfg, cls=HookedSAEViT)
    sae = SparseAutoencoder(scfg, generator=torch.Generator().manual_seed(1), device="cuda")
    x = _images(SAE_ATTRIB_BATCH, 10)
    clean = model(x)
    names = lambda n: n.startswith(hp)
    _zero_counts(counters)
    with model.saes([sae], use_error_term=True):
        out, cache = model.run_with_cache(x, names_filter=names, incl_bwd=True,
                                          loss_fn=_metric, return_cache_object=False)
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters.items()}
    # The cached points are the SAE's, at layer 9: the backward reaches them
    # through layers 10 and 11 only.
    expected = dict.fromkeys(counters, 0)
    expected.update(attention_mix_tnh=cfg.n_layers,
                    attention_mix_tnh_bwd=cfg.n_layers - 1 - scfg.hook_point_layer)
    if launches != expected:
        raise AssertionError(f"sae_attribution launches {launches}, expected {expected}")
    splice_err = check_close("error-term forward", out, clean, rel_atol(SPLICE_REL, clean))
    feats, grads = cache[f"{hp}.hook_hidden_post"], cache[f"{hp}.hook_hidden_post_grad"]
    if feats.shape != (SAE_ATTRIB_BATCH, cfg.n_tokens, scfg.d_sae) or grads.shape != feats.shape:
        raise AssertionError(f"features {tuple(feats.shape)}, grads {tuple(grads.shape)}")
    attribution = (feats * grads).abs().sum(dim=(0, 1))
    top = attribution.topk(5)

    cpu = _grad_model(cfg, "cpu", cls=HookedSAEViT)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu_sae = SparseAutoencoder(scfg, params={k: v.cpu() for k, v in sae.params.items()},
                                device="cpu")
    with cpu.saes([cpu_sae], use_error_term=True):
        _, want = cpu.run_with_cache(x[:GRAD_F32_BATCH].cpu(), names_filter=names,
                                     incl_bwd=True, loss_fn=_metric, return_cache_object=False)
    # The gradients at and after the features do not depend on which
    # pre-activations the ReLU kept; those before them do, and a
    # pre-activation within rounding of 0 may switch between the devices.
    got = {k: v[:GRAD_F32_BATCH].cpu() for k, v in cache.items()}
    after = [f"{hp}.hook_hidden_post_grad", f"{hp}.hook_sae_out_grad"]
    errs = _cache_grad_errs({k: got[k] for k in after}, {k: want[k] for k in after},
                            GRAD_F32_REL)
    switches = int(((got[f"{hp}.hook_hidden_pre"] > 0)
                    != (want[f"{hp}.hook_hidden_pre"] > 0)).sum())
    before = {k: (got[k] - want[k]).abs().max().item() for k in want
              if k.endswith("_grad") and k not in after}
    emit({"phase": "sae_attribution", **info, "model": "bench.py:56-61 geometry, float32",
          "sae": f"ReLU {scfg.d_in} -> {scfg.d_sae} at {hp}, error term",
          "batch": SAE_ATTRIB_BATCH, "launches": launches, "expected_launches": expected,
          "error_term_forward_max_abs_err": splice_err, "splice_rel_tol": SPLICE_REL,
          "card_vs_cpu_grad_max_abs_err": errs, "grad_rel_tol": GRAD_F32_REL,
          "relu_switches": switches, "upstream_grad_max_abs_err": before,
          "l0_per_token": (feats > 0).float().sum(-1).mean().item(),
          "top_features": top.indices.tolist(), "top_attribution": top.values.tolist()})
    return launches


def phase_ln_gemm_kernels(info):
    """B14 against its plain version on the card, with both times, the
    bound, and the library's unfused pair (``F.layer_norm`` without affine,
    then ``torch.matmul`` and the bias) on the same operands.  Each float32
    call's kernels by name (the 3xTF32 GEMM once, never the FFMA kernel it
    replaced), and at LN_ROWS_SHAPE the first 128 rows alone against the
    same rows of the whole call, to the bit; both routes' ptxas records, no
    spill."""
    import torch.nn.functional as F
    from vit_prisma_tpu_torch.ops.ln_matmul import (ln_matmul, ln_matmul_reference,
                                                     ln_matmul_route)
    g = torch.Generator(device="cuda").manual_seed(11)
    results = {}
    for name, R, S, D, C, dtypes in LN_SHAPES:
        for dtype in dtypes:
            x = (torch.randn(R, D, generator=g, device="cuda") * 2.0 + 0.5).to(dtype)
            W = (torch.randn(S, D, C, generator=g, device="cuda") * D ** -0.5).to(dtype)
            b = (torch.randn(S, C, generator=g, device="cuda") * 0.02).to(dtype)
            got = ln_matmul(x, W, b)
            want = ln_matmul_reference(x, W, b)
            torch.cuda.synchronize()
            if got.dtype != dtype or got.shape != (S, R, C):
                raise AssertionError(f"ln_matmul {name}: {got.dtype} {tuple(got.shape)}")
            err = check_close(f"ln_matmul {name} {dtype}", got, want, rel_atol(LN_REL[dtype], want))
            us = cuda_us(lambda: ln_matmul(x, W, b))
            plain_us = cuda_us(lambda: ln_matmul_reference(x, W, b), iters=5)
            library_us = cuda_us(lambda: torch.matmul(F.layer_norm(x, (D,)), W) + b[:, None])
            gemm = "bf16_tensor" if dtype == torch.bfloat16 else "f32_product"
            rec = {"phase": "ln_gemm_kernel", **info, "kernel": "ln_matmul", "shape": name,
                   "R": R, "S": S, "D": D, "C": C, "dtype": str(dtype).split(".")[1],
                   "route": ln_matmul_route(dtype),
                   "max_abs_err": err, "rel_tol": LN_REL[dtype],
                   "us": us, "plain_us": plain_us, "library_us": library_us,
                   "TFLOP_s": 2 * S * R * D * C / (us * 1e-6) / 1e12,
                   # x, W and b read once, the [S, R, C] output written once;
                   # the GEMMs, and ~6 float32 operations an element of x
                   # for the LayerNorm
                   **bound((R * D + S * D * C + S * C + S * R * C) * x.element_size(),
                           [(gemm, 2 * S * R * D * C), ("fp32", 6 * R * D)])}
            if dtype == torch.bfloat16:
                rec["ptxas"] = ptxas(LN_TC_KERNEL)
            else:
                rec["ptxas"] = ptxas(LN_TF32_KERNEL)
                if any(r["spill_bytes"] for r in rec["ptxas"].values()):
                    raise AssertionError(f"{LN_TF32_KERNEL} spills: {rec['ptxas']}")
                rec["profiled_kernels"] = ln_profiled(f"ln_matmul {name}",
                                                      lambda: ln_matmul(x, W, b), 1)
                if name == LN_ROWS_SHAPE:
                    rec["rows_128_alone_equal"] = bool(torch.equal(ln_matmul(x[:128], W, b),
                                                                   got[:, :128]))
                    if not rec["rows_128_alone_equal"]:
                        raise AssertionError(f"ln_matmul {name}: rows depend on R")
            results[(name, dtype)] = rec
            emit(rec)
            del x, W, b, got, want
    return results


def ln_profiled(what, fn, launches) -> dict:
    """Calls a launch of each kernel ``torch.profiler`` sees in one call of
    ``fn`` (a float32 B14 path): the 3xTF32 GEMM and its W pre-pass exactly
    ``launches`` times, the FFMA kernel never; a window that lost events is
    taken again with the next margin of ``PROFILE_PADS_S``."""
    want = {LN_TF32_KERNEL: launches, LN_SPLIT_KERNEL: launches, LN_FFMA_KERNEL: 0}
    for pad in PROFILE_PADS_S:
        prof = _profile(fn, warm=True, calls_of=tuple(want), pad=pad)
        if prof["calls_of"][LN_FFMA_KERNEL]:
            raise AssertionError(f"{what}: the FFMA kernel ran: {prof['calls_of']}")
        if prof["calls_of"] == want:
            return {"calls": prof["calls_of"], "pad_s": pad}
    raise AssertionError(f"{what}: kernels by name {prof['calls_of']}, expected {want}")


def _flash_inputs(g, B, N, T, H, dtype):
    """q (pre-scaled), k, v and a cotangent, [B, N, Tp, H] with zero padding
    rows past T, and the segment ids (1 real, 2 padding)."""
    Tp = -(-T // 128) * 128

    def rnd(scale=1.0):
        a = torch.zeros(B, N, Tp, H, device="cuda")
        a[:, :, :T] = torch.randn(B, N, T, H, generator=g, device="cuda") * scale
        return a.to(dtype)
    q, k, v = rnd(H ** -0.5), rnd(), rnd()
    dz = torch.randn(B, N, Tp, H, generator=g, device="cuda").to(dtype)
    seg = torch.where(torch.arange(Tp, device="cuda") < T, 1, 2).to(torch.int32)
    return q, k, v, dz, seg.expand(B, Tp).contiguous()


def phase_flash_kernels(info):
    """B13's forward and both backward passes against their plain versions
    on the card, with times, bounds, and ``scaled_dot_product_attention``'s
    forward and backward under the same mask; batch item 0 alone against
    item 0 of the batch, to the bit; ptxas's record of the bf16 kernels
    and of the float32 route's (3xTF32: no spill at any width), whose
    records carry the kernel names the profiler saw."""
    from vit_prisma_tpu_torch.ops import attention as A
    g = torch.Generator(device="cuda").manual_seed(12)
    results = {}
    for name, B, N, T, H, causal, dtypes in FLASH_SHAPES:
        for dtype in dtypes:
            q, k, v, dz, seg = _flash_inputs(g, B, N, T, H, dtype)
            Tp = q.shape[2]
            z, lse = A._launch_flash(q, k, v, seg, causal)
            want_z = A.flash_attention_padded_reference(q, k, v, seg, causal)
            want_lse = A.flash_lse_reference(q, k, seg, causal)
            dsum = A.flash_dsum(want_z, dz)
            args = (q, k, v, seg, dz, want_lse, dsum, causal)
            dk, dv = A._launch_flash_bwd(0, *args)
            dq = A._launch_flash_bwd(1, *args)
            want_dk, want_dv = A.flash_attention_padded_bwd_dkv_reference(*args)
            want_dq = A.flash_attention_padded_bwd_dq_reference(*args)
            torch.cuda.synchronize()
            rel = FLASH_REL[dtype]
            if not torch.isfinite(z).all():  # the padding rows too
                raise AssertionError(f"flash {name} {dtype}: non-finite z")
            errs = {"z": check_close(f"flash {name} {dtype} z", z, want_z, rel_atol(rel, want_z)),
                    "lse": check_close(f"flash {name} {dtype} lse", lse, want_lse,
                                       rel_atol(1e-5, want_lse))}
            for which, a, w in (("dq", dq, want_dq), ("dk", dk, want_dk), ("dv", dv, want_dv)):
                if a.dtype != dtype or a.shape != q.shape:
                    raise AssertionError(f"flash {name} {which}: {a.dtype} {tuple(a.shape)}")
                errs[which] = check_close(f"flash {name} {dtype} {which}", a, w, rel_atol(rel, w))
            # a (head, batch item) result depends on its own inputs alone
            one = (q[:1], k[:1], v[:1], seg[:1], dz[:1], want_lse[:1], dsum[:1], causal)
            alone = (*A._launch_flash(*one[:4], causal), *A._launch_flash_bwd(0, *one),
                     A._launch_flash_bwd(1, *one))
            torch.cuda.synchronize()
            for which, a, w in zip(("z", "lse", "dk", "dv", "dq"), alone, (z, lse, dk, dv, dq)):
                if not torch.equal(a[0], w[0]):
                    raise AssertionError(f"flash {name} {dtype} {which}: item 0 alone differs "
                                         "from item 0 of the batch")
            del one, alone
            timed = {"fwd": (lambda: A._launch_flash(q, k, v, seg, causal),
                             lambda: A.flash_attention_padded_reference(q, k, v, seg, causal)),
                     "bwd_dkv": (lambda: A._launch_flash_bwd(0, *args),
                                 lambda: A.flash_attention_padded_bwd_dkv_reference(*args)),
                     "bwd_dq": (lambda: A._launch_flash_bwd(1, *args),
                                lambda: A.flash_attention_padded_bwd_dq_reference(*args))}
            us = {k_: cuda_us(f) for k_, (f, _) in timed.items()}
            plain_us = {k_: cuda_us(p, iters=3, warmup=1) for k_, (_, p) in timed.items()}
            # the library: SDPA under the same boolean mask, forward alone
            # and its backward alone through a graph kept for every call
            keep = seg[:, None, :, None] == seg[:, None, None, :]
            if causal:
                keep = keep & torch.ones(Tp, Tp, dtype=torch.bool, device="cuda").tril()
            sdpa = lambda *a: torch.nn.functional.scaled_dot_product_attention(
                *a, attn_mask=keep, scale=1.0)
            library_fwd_us = device_us(lambda: sdpa(q, k, v))
            leaves = [a.clone().requires_grad_(True) for a in (q, k, v)]
            out = sdpa(*leaves)
            sdpa_bwd = lambda: torch.autograd.grad(out, leaves, dz, retain_graph=True)
            library_bwd_us = device_us(sdpa_bwd, one_call_short=True)
            library_bwd_wall_us = cuda_us(sdpa_bwd)
            del out, leaves, keep, sdpa_bwd
            pairs = T * (T + 1) // 2 if causal else T * T
            rec = {"phase": "flash_kernel", **info, "kernel": "flash_attention_padded",
                   "shape": name, "B": B, "N": N, "T": T, "Tp": Tp, "H": H, "causal": causal,
                   "dtype": str(dtype).split(".")[1], "max_abs_err": errs, "rel_tol": rel,
                   "batch_independent": True, "us": us, "plain_us": plain_us,
                   # the library's device time (profiler); the backward's event time beside
                   "library_us": {"fwd": library_fwd_us, "bwd": library_bwd_us},
                   "library_bwd_wall_us": library_bwd_wall_us,
                   "bound": flash_bounds(B, N, T, Tp, H, causal, dtype),
                   "TFLOP_s": {k_: FLASH_PRODUCTS[k_] * 2 * B * N * pairs * H / (u * 1e-6) / 1e12
                               for k_, u in us.items()}}
            rec["route"] = A.flash_route(H, dtype)
            if dtype == torch.float32:  # the route by the kernels' names
                rec["profiled_kernels"] = flash_profiled(
                    f"flash {name}", {k_: f for k_, (f, _) in timed.items()})
            results[(name, dtype)] = rec
            emit(rec)
            del q, k, v, dz, seg, z, lse, dq, dk, dv, want_z, want_dq, want_dk, want_dv
    emit({"phase": "flash_kernel_ptxas", **info, **{kern: ptxas(kern) for kern in FLASH_TC_KERNELS}})
    tf32 = {kern: ptxas(kern) for kern in FLASH_TF32_KERNELS}
    if any(len(recs) != 8 or any(r["spill_bytes"] or "registers" not in r for r in recs.values())
           for recs in tf32.values()):
        raise AssertionError(f"B13's 3xTF32 kernels: expected 8 instantiations each, no spills: "
                             f"{tf32}")
    emit({"phase": "flash_kernel_tf32_ptxas", **info, **tf32})
    return results


# Products of 2 Tp^2 H-like flops a pass forms (a pair: 2 H flops each):
# the forward s and P V; the dk/dv pass s^T, dp^T, p^T dZ, ds^T Q; the dq
# pass s, dp, ds K.
FLASH_PRODUCTS = {"fwd": 2, "bwd_dkv": 4, "bwd_dq": 3}


def flash_bounds(B, N, T, Tp, H, causal, dtype) -> dict:
    """Each pass's bound: its products over the pairs a real row attends
    (causal: the keys not after it; the padding rows' outputs are thrown
    away, so not counted), its softmax work, and its tensors read once and
    written once with the [B, N, Tp] vectors and the segment ids."""
    pairs = T * (T + 1) // 2 if causal else T * T
    gemm = "bf16_tensor" if dtype == torch.bfloat16 else "f32_product"
    el = B * N * Tp * H * (2 if dtype == torch.bfloat16 else 4)
    vec = B * N * Tp * 4
    ops = lambda k_, fp32: [(gemm, FLASH_PRODUCTS[k_] * 2 * B * N * pairs * H),
                            ("fp32", fp32 * B * N * pairs)]
    return {"fwd": bound(4 * el + vec + B * Tp * 4, ops("fwd", 5)),
            # six tensors: q, k, v, dz read, dk, dv written
            "bwd_dkv": bound(6 * el + 2 * vec + B * Tp * 4, ops("bwd_dkv", 6)),
            # five tensors: q, k, v, dz read, dq written
            "bwd_dq": bound(5 * el + 2 * vec + B * Tp * 4, ops("bwd_dq", 5))}


# B13's float32 kernels by pass, and the names a float32 call must not
# reach (the FFMA kernels the route replaced were flash_fwd_kernel and
# flash_bwd_*_kernel instantiated for float; the bf16 mma.sync kernels keep
# those names).
FLASH_TF32_BY_PASS = {"fwd": "fwd_tf32_kernel", "bwd_dkv": "dkv_tf32_kernel",
                      "bwd_dq": "dq_tf32_kernel"}
FLASH_OTHER_ROUTES = ("flash_fwd_kernel", "flash_bwd_dkv_kernel", "flash_bwd_dq_kernel",
                      "fwd_tc_kernel", "bwd_dkv_tc_kernel", "bwd_dq_tc_kernel")


def flash_profiled(what, calls) -> dict:
    """One call of each pass (pass -> function, run in turn) profiled in one
    warmed window, as the video phase counts B13's kernels: raising unless
    each pass's 3xTF32 kernel ran once and no kernel of another route ran.
    A window that lost events is measured again with the next margin of
    ``PROFILE_PADS_S``."""
    want = {**{FLASH_TF32_BY_PASS[p]: 1 for p in calls}, **dict.fromkeys(FLASH_OTHER_ROUTES, 0)}
    seen = []
    for pad in PROFILE_PADS_S:
        prof = _profile(lambda: [fn() for fn in calls.values()], warm=True,
                        calls_of=tuple(want), pad=pad)
        seen.append(prof["calls_of"])
        if prof["calls_of"] == want:
            return {"kernels": [k["name"] for k in prof["kernels"]], "windows": len(seen)}
    raise AssertionError(f"{what}: B13's kernels by name {seen}, expected {want}")


def phase_serve_ln_fused(info):
    """Phase 4's server with use_fused_ln_gemm: B14 in every block's ln1 ->
    QKV and ln2 -> W_in, B1 in every block; against the unfused forward, and
    served images per second of both, in turns."""
    from vit_prisma_tpu_torch import CompiledForward, HookedViT, get_model_config
    counters = _sae_counters()
    cfg = get_model_config("openai/clip-vit-base-patch32", dtype="bfloat16")
    unfused = HookedViT(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    fused = HookedViT(cfg.replace(use_fused_ln_gemm=True), device="cuda")
    fused.load_state_dict(unfused.state_dict())
    servers = {"fused": CompiledForward(fused, batch_size=SERVE_BATCH, names_filter=RESID_POST),
               "unfused": CompiledForward(unfused, batch_size=SERVE_BATCH,
                                          names_filter=RESID_POST)}
    g = torch.Generator().manual_seed(2)
    requests = [torch.randn(n, 3, 224, 224, generator=g) for n in SERVE_REQUESTS]

    # The main path, with every count set to 0 just before it.
    _zero_counts(counters)
    answers = [servers["fused"](r) for r in requests]
    torch.cuda.synchronize()
    n_batches = sum(-(-n // SERVE_BATCH) for n in SERVE_REQUESTS)
    launches = _served_launches(
        "serve_ln_fused", servers["fused"], counters,
        {"ln_matmul": 2 * cfg.n_layers, "attention_mix_tnh": cfg.n_layers}, n_batches,
        {k: f.launches for k, f in counters.items()})
    errs = {}
    for i, (n, (out, cache)) in enumerate(zip(SERVE_REQUESTS, answers)):
        want_out, want = servers["unfused"](requests[i])
        if tuple(out.shape) != (n, cfg.n_classes) or list(cache) != list(want):
            raise AssertionError(f"request {n}: out {tuple(out.shape)}, keys {list(cache)}")
        errs[n] = {"logits": check_close(f"fused ln request {n} logits", out, want_out,
                                         rel_atol(SLICE_BF16_REL, want_out)),
                   "cache": max(check_close(f"fused ln request {n} {k}", cache[k], want[k],
                                            rel_atol(SLICE_BF16_REL, want[k])) for k in want)}

    batch = torch.randn(8 * SERVE_BATCH, 3, 224, 224, device="cuda", dtype=torch.bfloat16)
    runs = {"fused": [], "unfused": []}
    for which in ("fused", "unfused", "unfused", "fused"):
        servers[which](batch)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            servers[which](batch)
        torch.cuda.synchronize()
        runs[which].append(3 * batch.shape[0] / (time.perf_counter() - t0))
    one = batch[:SERVE_BATCH]
    profiles = {"fused": _profile_replay("serve_ln_fused", servers["fused"], one),
                "unfused": _profile(lambda: servers["unfused"](one))}
    emit({"phase": "serve_ln_fused", **info, "model": cfg.model_name, "dtype": "bfloat16",
          "batch_size": SERVE_BATCH, "requests": list(SERVE_REQUESTS), "launches": launches,
          "launches_per_forward": servers["fused"].launches_per_replay,
          "vs_unfused_max_abs_err": errs, "rel_tol": SLICE_BF16_REL,
          "img_per_s_fused": runs["fused"], "img_per_s_unfused": runs["unfused"],
          "profile_of_one_forward": profiles})
    del servers, fused, unfused
    return launches


def _l336_model(dtype="bfloat16", device="cuda", **overrides):
    from vit_prisma_tpu_torch import HookedViT, get_model_config
    cfg = get_model_config(L336_MODEL, dtype=dtype, use_fused_ln_gemm=True, **overrides)
    return HookedViT(cfg, device=device, generator=torch.Generator().manual_seed(0))


def _l336_images(n, seed, device="cuda", dtype=torch.float32):
    x = np.random.default_rng(seed).standard_normal((n, 3, 336, 336), dtype=np.float32)
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def phase_serve_l14_336(info):
    """CLIP ViT-L/14 at 336 pixels (T = 577, past B1's gate), bf16, with
    use_fused_ln_gemm: a CompiledForward at batch 64 through B13 in every
    block's attention and B14 in every block's ln2 -> W_in; against the
    einsum path in bf16 and the CPU in float32."""
    from vit_prisma_tpu_torch import CompiledForward
    counters = _sae_counters()
    model = _l336_model()
    cfg = model.cfg
    server = CompiledForward(model, batch_size=L336_BATCH, names_filter=RESID_POST)
    requests = [_l336_images(n, 20 + i, "cpu") for i, n in enumerate(L336_REQUESTS)]
    release()
    torch.cuda.reset_peak_memory_stats()

    # The main path, with every count set to 0 just before it.
    _zero_counts(counters)
    answers = [server(r) for r in requests]
    torch.cuda.synchronize()
    n_batches = sum(-(-n // L336_BATCH) for n in L336_REQUESTS)
    launches = _served_launches(
        "serve_l14_336", server, counters,
        {"flash_attention_padded": cfg.n_layers, "ln_matmul": cfg.n_layers}, n_batches,
        {k: f.launches for k, f in counters.items()})
    for n, (out, cache) in zip(L336_REQUESTS, answers):
        if tuple(out.shape) != (n, cfg.n_classes) or len(cache) != cfg.n_layers:
            raise AssertionError(f"request {n}: out {tuple(out.shape)}, {len(cache)} entries")
        for k, a in cache.items():
            if tuple(a.shape) != (n, cfg.n_tokens, cfg.d_model) or not torch.isfinite(a).all():
                raise AssertionError(f"request {n}: {k} {tuple(a.shape)}")
    times = []
    batch = _l336_images(L336_BATCH, 30, dtype=torch.bfloat16)
    for _ in range(L336_TIMED + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        server(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    prof = _profile_replay("serve_l14_336", server, batch)
    # the same forward without the LN fusion (B13 still), in turns
    servers = {"fused": server, "unfused": CompiledForward(
        model.with_cfg(use_fused_ln_gemm=False), batch_size=L336_BATCH,
        names_filter=RESID_POST)}
    runs = {"fused": [], "unfused": []}
    for which in ("fused", "unfused", "unfused", "fused"):
        servers[which](batch)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(L336_TIMED):
            servers[which](batch)
        torch.cuda.synchronize()
        runs[which].append(L336_TIMED * L336_BATCH / (time.perf_counter() - t0))
    prof_unfused = _profile(lambda: servers["unfused"](batch))
    del servers

    # bf16 against the einsum path (neither B13 nor B14)
    plain = model.with_cfg(use_fused_attention=False, use_fused_ln_gemm=False)
    x = requests[1][:8].cuda().bfloat16()
    out_k, cache_k = model.run_with_cache(x, names_filter=RESID_POST, return_cache_object=False)
    out_p, cache_p = plain.run_with_cache(x, names_filter=RESID_POST, return_cache_object=False)
    bf16_errs = {"logits": check_close("l14_336 bf16 logits", out_k, out_p,
                                       rel_atol(L336_BF16_REL, out_p))}
    for k in cache_p:
        bf16_errs[k] = check_close(f"l14_336 bf16 {k}", cache_k[k], cache_p[k],
                                   rel_atol(L336_BF16_REL, cache_p[k]))
    del plain, cache_k, cache_p

    # float32, card against CPU, batch 1 through all 24 layers
    f32_card = _l336_model("float32")
    f32_card.load_state_dict(model.state_dict())
    f32_cpu = _l336_model("float32", "cpu")
    f32_cpu.load_state_dict(f32_card.state_dict())
    xs = requests[1][:1]
    _zero_counts(counters)
    out_c, got = f32_card.run_with_cache(xs.cuda(), names_filter=RESID_POST,
                                         return_cache_object=False)
    torch.cuda.synchronize()
    f32_launches = {k: f.launches for k, f in counters.items() if f.launches}
    out_r, want = f32_cpu.run_with_cache(xs, names_filter=RESID_POST, return_cache_object=False)
    f32_errs = {"logits": check_close("l14_336 f32 logits", out_c, out_r,
                                      rel_atol(SLICE_F32_REL, out_r))}
    for k in want:
        f32_errs[k] = check_close(f"l14_336 f32 {k}", got[k], want[k],
                                  rel_atol(SLICE_F32_REL, want[k]))
    emit({"phase": "serve_l14_336", **info, "model": L336_MODEL, "dtype": "bfloat16",
          "n_layers": cfg.n_layers, "T": cfg.n_tokens, "batch_size": L336_BATCH,
          "requests": list(L336_REQUESTS), "launches": launches,
          "launches_per_forward": server.launches_per_replay,
          "seconds_per_batch": times[1:], "img_per_s": [L336_BATCH / t for t in times[1:]],
          "img_per_s_fused": runs["fused"], "img_per_s_unfused": runs["unfused"],
          "peak_memory_GB": peak, "profile_of_one_batch": prof,
          "profile_of_one_unfused_batch": prof_unfused,
          "bf16_vs_einsum_max_abs_err": bf16_errs, "bf16_rel_tol": L336_BF16_REL,
          "f32_card_vs_cpu_max_abs_err": f32_errs,
          "absmax": {k: v.float().abs().max().item() for k, v in want.items()},
          "f32_launches": f32_launches, "f32_rel_tol": SLICE_F32_REL})
    del model, server, f32_card, f32_cpu
    return launches


def phase_attribution_l14_336(info):
    """run_with_cache(incl_bwd=True) over CLIP L/14-336's 24 resid_post
    hooks, bf16, batch 32, use_fused_ln_gemm: B13 forward and both backward
    passes, B14 forward (its backward and the fold's are plain autograd)."""
    counters = _sae_counters()
    model = _l336_model()
    cfg = model.cfg
    x = _l336_images(L336_ATTRIB_BATCH, 40, dtype=torch.bfloat16)
    release()
    torch.cuda.reset_peak_memory_stats()

    # The main path, with every count set to 0 just before it.
    _zero_counts(counters)
    out, cache = model.run_with_cache(x, names_filter=RESID_POST, incl_bwd=True,
                                      loss_fn=_metric, return_cache_object=False)
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters.items()}
    # layer 0's attention lies upstream of every cached point (phase 17)
    expected = dict.fromkeys(counters, 0)
    expected.update(flash_attention_padded=cfg.n_layers,
                    flash_attention_padded_bwd_dkv=cfg.n_layers - 1,
                    flash_attention_padded_bwd_dq=cfg.n_layers - 1, ln_matmul=cfg.n_layers)
    if launches != expected:
        raise AssertionError(f"attribution_l14_336 launches {launches}, expected {expected}")
    names = [f"blocks.{l}.hook_resid_post" for l in range(cfg.n_layers)]
    if list(cache) != names + [n + "_grad" for n in reversed(names)]:
        raise AssertionError(f"attribution keys {list(cache)}")
    for k, v in cache.items():
        if tuple(v.shape) != (L336_ATTRIB_BATCH, cfg.n_tokens, cfg.d_model) \
                or not torch.isfinite(v).all():
            raise AssertionError(f"{k}: {tuple(v.shape)}")
    if not all(cache[n + "_grad"].abs().max() > 0 for n in names):
        raise AssertionError("a resid_post gradient is all zeros")
    times = []
    for _ in range(GRAD_TIMED + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.run_with_cache(x, names_filter=RESID_POST, incl_bwd=True, loss_fn=_metric,
                             return_cache_object=False)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    prof = _profile(lambda: model.run_with_cache(x, names_filter=RESID_POST, incl_bwd=True,
                                                 loss_fn=_metric, return_cache_object=False))

    # bf16 against the einsum path (neither B13 nor B14)
    plain = model.with_cfg(use_fused_attention=False, use_fused_ln_gemm=False)
    _, cache_p = plain.run_with_cache(x, names_filter=RESID_POST, incl_bwd=True,
                                      loss_fn=_metric, return_cache_object=False)
    bf16_errs = _cache_grad_errs(cache, cache_p, L336_GRAD_BF16_REL)
    del plain, cache_p

    # float32 on the card against the CPU, 4 layers at full width
    f32 = dict(n_layers=L336_GRAD_F32_LAYERS)
    card_model = _l336_model("float32", **f32)
    cpu_model = _l336_model("float32", "cpu", **f32)
    cpu_model.load_state_dict({k: v.cpu() for k, v in card_model.state_dict().items()})
    xs = _l336_images(L336_GRAD_F32_BATCH, 41, "cpu")
    out_c, got = card_model.run_with_cache(xs.cuda(), names_filter=RESID_POST, incl_bwd=True,
                                           loss_fn=_metric, return_cache_object=False)
    out_r, want = cpu_model.run_with_cache(xs, names_filter=RESID_POST, incl_bwd=True,
                                           loss_fn=_metric, return_cache_object=False)
    f32_errs = {"logits": check_close("l14_336 f32 logits", out_c, out_r,
                                      rel_atol(GRAD_F32_REL, out_r)),
                **_cache_grad_errs(got, want, GRAD_F32_REL)}
    emit({"phase": "attribution_l14_336", **info, "model": L336_MODEL, "dtype": "bfloat16",
          "batch": L336_ATTRIB_BATCH, "hooks": len(names),
          "metric": f"logit {ATTRIB_CLASSES[0]} - logit {ATTRIB_CLASSES[1]}, summed",
          "launches": launches, "expected_launches": expected,
          "seconds_per_call": times[1:], "img_per_s": [L336_ATTRIB_BATCH / t for t in times[1:]],
          "peak_memory_GB": peak, "profile_of_one_call": prof,
          "bf16_vs_einsum_max_abs_err": bf16_errs, "bf16_rel_tol": L336_GRAD_BF16_REL,
          "grad_absmax": {k: v.abs().max().item() for k, v in cache.items()
                          if k.endswith("_grad")},
          "f32_card_vs_cpu_max_abs_err": f32_errs, "f32_layers": L336_GRAD_F32_LAYERS,
          "f32_rel_tol": GRAD_F32_REL})
    del model, card_model, cpu_model
    return launches


def phase_l14_336_f32(info):
    """CLIP L/14-336 in float32 at full width and depth (fused LN, random
    weights from seed 0), as a float32 harvest or attribution runs it: the
    cached forward over the 24 resid_post hooks at the store batch and
    ``run_with_cache(incl_bwd=True)`` at batch 8, each driven with every
    count set to 0 just before it and read just after (B13 24; 24 forward,
    23 each backward pass; B14 24), timed, and profiled over one warmed
    call: B13's and B14's device time and share by the 3xTF32 kernels'
    names, whose calls must be the launches, and no kernel of another
    route."""
    counters = _sae_counters()
    model = _l336_model("float32")
    cfg = model.cfg
    L = cfg.n_layers
    paths = {
        "cached_forward": (L336_F32_STORE_BATCH, lambda x: model.run_with_cache(
            x, names_filter=RESID_POST, return_cache_object=False),
            {"flash_attention_padded": L, "ln_matmul": L}),
        "attribution": (L336_F32_ATTRIB_BATCH, lambda x: model.run_with_cache(
            x, names_filter=RESID_POST, incl_bwd=True, loss_fn=_metric,
            return_cache_object=False),
            {"flash_attention_padded": L, "flash_attention_padded_bwd_dkv": L - 1,
             "flash_attention_padded_bwd_dq": L - 1, "ln_matmul": L})}
    names = tuple(FLASH_TF32_BY_PASS.values())
    results = {}
    for path, (batch, fn, expected) in paths.items():
        x = _l336_images(batch, 50)
        release()
        # The main path, with every count set to 0 just before it.
        _zero_counts(counters)
        out, cache = fn(x)
        torch.cuda.synchronize()
        launches = {k: f.launches for k, f in counters.items() if f.launches}
        if launches != expected:
            raise AssertionError(f"l14_336_f32 {path} launches {launches}, expected {expected}")
        if not torch.isfinite(out).all() or not all(torch.isfinite(v).all()
                                                    for v in cache.values()):
            raise AssertionError(f"l14_336_f32 {path}: non-finite output or cache")
        del out, cache
        times = []
        for _ in range(L336_F32_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(x)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        # B13's kernels by name in one warmed window: the float32 calls of
        # each pass, none of another route; a window that lost events is
        # measured again with a wider margin, raising after the last
        want = {FLASH_TF32_BY_PASS["fwd"]: expected["flash_attention_padded"],
                FLASH_TF32_BY_PASS["bwd_dkv"]: expected.get("flash_attention_padded_bwd_dkv", 0),
                FLASH_TF32_BY_PASS["bwd_dq"]: expected.get("flash_attention_padded_bwd_dq", 0),
                **dict.fromkeys(FLASH_OTHER_ROUTES, 0),
                LN_TF32_KERNEL: expected["ln_matmul"], LN_SPLIT_KERNEL: expected["ln_matmul"],
                LN_FFMA_KERNEL: 0}
        b14 = (LN_TF32_KERNEL, LN_SPLIT_KERNEL, "ln_stats_kernel")
        seen = []
        for pad in PROFILE_PADS_S:
            prof = _profile(lambda: fn(x), share_of=names, warm=True, calls_of=tuple(want),
                            pad=pad, time_of=b14)
            seen.append(prof["calls_of"])
            if prof["calls_of"] == want:
                break
        if prof["calls_of"] != want:
            raise AssertionError(f"l14_336_f32 {path}: B13's and B14's kernels by name {seen}, "
                                 f"expected {want}")
        prof["windows"] = len(seen)
        b14_ms = sum(prof["time_of"].values())
        results[path] = {"batch": batch, "launches": launches,
                         "seconds_per_call": times, "img_per_s": [batch / t for t in times],
                         "b13_ms": prof["share_of"]["ms"],
                         "b13_share_of_busy": prof["share_of"]["share_of_busy"],
                         "b14_ms": b14_ms, "b14_ms_by_kernel": prof["time_of"],
                         "b14_share_of_busy": b14_ms / prof["device_busy_ms"],
                         "profile_of_one_call": prof}
        del x
    emit({"phase": "l14_336_f32", **info, "model": L336_MODEL, "dtype": "float32",
          "n_layers": L, "T": cfg.n_tokens, "route": "tf32x3", "b14_route": "tf32x3",
          **results})
    del model
    return {path: r["launches"] for path, r in results.items()}


def _clips(cfg, n, seed, dtype=torch.bfloat16, device="cuda"):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(n, cfg.n_channels, cfg.video_num_frames, cfg.image_size,
                       cfg.image_size, generator=g, device=device).to(dtype)


def _forward_tflop(cfg) -> float:
    """Operations of one forward of one input, in TFLOP: the block GEMMs
    (QKV, W_O, the MLP) over T tokens and the attention's two T x T
    products, 2 per multiply-add; the embedding and head beside them are
    left out."""
    T, D, L = cfg.n_tokens, cfg.d_model, cfg.n_layers
    NH = cfg.n_heads * cfg.d_head
    gemm = 2 * T * (4 * D * NH + 2 * D * cfg.d_mlp)
    return L * (gemm + 4 * T * T * NH) / 1e12


def phase_video(info):
    """ViViT-B and V-JEPA huge at full width, bf16, random weights from seed
    0: ``run_with_cache`` over every resid_post hook, B13 (and no other
    kernel) exactly once a layer, on the route its head width takes
    (wgmma at H 64, mma.sync at H 80: the picker and the profiler's kernel
    names), each layer's attention output and block output against the
    einsum path's (``use_fused_attention=False``) from the same residual,
    clips per second, TFLOP/s and peak memory; then ViViT-B cut to
    two layers in float32 on the card (B13's 3xTF32 route) against the CPU."""
    from vit_prisma_tpu_torch import HookedViT, get_model_config
    from vit_prisma_tpu_torch.models.vit import vit_forward
    from vit_prisma_tpu_torch.ops.attention import flash_route
    from vit_prisma_tpu_torch.prisma.hooks import HookRuntime
    counters = _sae_counters()
    kernel_names = {"wgmma": "fwd_tc_kernel", "mma_sync": "flash_fwd_kernel"}
    results = {}
    for name, batch, want_route in ((VIVIT_MODEL, VIVIT_BATCH, "wgmma"),
                                    (VJEPA_MODEL, VJEPA_BATCH, "mma_sync")):
        cfg = get_model_config(name, dtype="bfloat16")
        model = HookedViT(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
        clips = _clips(cfg, batch, seed=40)
        route = flash_route(cfg.d_head, torch.bfloat16)
        if route != want_route:
            raise AssertionError(f"{name}: H {cfg.d_head} takes route {route}")
        release()
        torch.cuda.reset_peak_memory_stats()

        # The main path, with every count set to 0 just before it.
        _zero_counts(counters)
        out, cache = model.run_with_cache(clips, names_filter=RESID_POST, return_cache_object=False)
        torch.cuda.synchronize()
        launches = {k: f.launches for k, f in counters.items() if f.launches}
        if launches != {"flash_attention_padded": cfg.n_layers}:
            raise AssertionError(f"{name} launches {launches}, expected "
                                 f"{cfg.n_layers} of B13 alone")
        d_out = cfg.d_model if cfg.return_type == "pre_logits" else cfg.n_classes
        if tuple(out.shape) != (batch, d_out) or len(cache) != cfg.n_layers:
            raise AssertionError(f"{name}: out {tuple(out.shape)}, {len(cache)} entries")
        for k, a in cache.items():
            if tuple(a.shape) != (batch, cfg.n_tokens, cfg.d_model) or not torch.isfinite(a).all():
                raise AssertionError(f"{name}: {k} {tuple(a.shape)}")
        times = []
        for _ in range(VIDEO_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.run_with_cache(clips, names_filter=RESID_POST, return_cache_object=False)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 1e9
        # a window that lost device events (11 of 12 kernels in one) is
        # measured again with a wider margin, raising after the last
        want = {k: cfg.n_layers if k == kernel_names[route] else 0 for k in kernel_names.values()}
        seen = []
        for pad in PROFILE_PADS_S:
            prof = _profile(lambda: model.run_with_cache(clips, names_filter=RESID_POST,
                                                         return_cache_object=False),
                            share_of=(kernel_names[route],), warm=True,
                            calls_of=tuple(kernel_names.values()), pad=pad)
            seen.append(prof["calls_of"])
            if prof["calls_of"] == want:
                break
        if prof["calls_of"] != want:
            raise AssertionError(f"{name}: B13's kernels by name {seen}, expected "
                                 f"{cfg.n_layers} of {kernel_names[route]}")
        prof["windows"] = len(seen)

        # bf16 against the einsum path (no B13), the same weights, layer by
        # layer: block l on the kernel route from the residual the einsum
        # path feeds block l (layer 0: the clips, whose embedding is shared)
        plain = model.with_cfg(use_fused_attention=False)
        _, cache_p = plain.run_with_cache(clips, names_filter=[
            f"blocks.{l}.{h}" for l in range(cfg.n_layers)
            for h in ("hook_resid_pre", "hook_attn_out", "hook_resid_post")],
            return_cache_object=False)
        errs, limits = {}, {}
        for l in range(cfg.n_layers):
            names = [f"blocks.{l}.hook_attn_out", f"blocks.{l}.hook_resid_post"]
            rt = HookRuntime(names_filter=names)
            with torch.inference_mode():
                vit_forward(model, cfg, clips if l == 0 else cache_p[f"blocks.{l}.hook_resid_pre"],
                            rt, l + 1, start_at_layer=l)
            for k in names:
                limits[k] = rel_atol(VIDEO_BF16_REL, cache_p[k])
                errs[k] = check_close(f"{name} {k}", rt.cache[k], cache_p[k], limits[k])
            del rt
        del plain, cache_p
        tflop = _forward_tflop(cfg) * batch
        rec = {"phase": "video", **info, "model": name, "dtype": "bfloat16",
               "weights": "random, seed 0 (pretrained weights are not in the repository)",
               "clip": [cfg.n_channels, cfg.video_num_frames, cfg.image_size, cfg.image_size],
               "n_layers": cfg.n_layers, "d_model": cfg.d_model, "d_head": cfg.d_head,
               "T": cfg.n_tokens, "Tp": -(-cfg.n_tokens // 128) * 128, "batch": batch,
               "route": route, "launches": launches,
               "seconds_per_forward": times, "clips_per_s": [batch / t for t in times],
               "TFLOP_per_forward": tflop, "TFLOP_per_s": [tflop / t for t in times],
               "peak_memory_GB": peak, "profile_of_one_forward": prof,
               "vs_einsum_per_layer_max_abs_err": errs, "per_layer_limits": limits,
               "rel_tol": VIDEO_BF16_REL}
        results[name] = rec
        emit(rec)
        del model, clips, out, cache
        release()

    # float32, ViViT-B cut to two layers, card against CPU at batch 1
    cfg = get_model_config(VIVIT_MODEL, dtype="float32", n_layers=VIDEO_F32_LAYERS)
    card_m = HookedViT(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    cpu_m = HookedViT(cfg, device="cpu")
    cpu_m.load_state_dict(card_m.state_dict())
    x = _clips(cfg, 1, seed=41, dtype=torch.float32, device="cpu")
    _zero_counts(counters)
    out_c, got = card_m.run_with_cache(x.cuda(), names_filter=RESID_POST, return_cache_object=False)
    torch.cuda.synchronize()
    f32_launches = {k: f.launches for k, f in counters.items() if f.launches}
    if f32_launches != {"flash_attention_padded": VIDEO_F32_LAYERS}:
        raise AssertionError(f"ViViT f32 launches {f32_launches}")
    out_r, want = cpu_m.run_with_cache(x, names_filter=RESID_POST, return_cache_object=False)
    f32_errs = {"out": check_close("ViViT f32 out", out_c, out_r, rel_atol(SLICE_F32_REL, out_r))}
    for k in want:
        f32_errs[k] = check_close(f"ViViT f32 {k}", got[k], want[k],
                                  rel_atol(SLICE_F32_REL, want[k]))
    emit({"phase": "video_f32_check", **info, "model": VIVIT_MODEL,
          "n_layers": VIDEO_F32_LAYERS, "batch": 1, "route": flash_route(cfg.d_head, torch.float32),
          "launches": f32_launches, "card_vs_cpu_max_abs_err": f32_errs,
          "rel_tol": SLICE_F32_REL})
    del card_m, cpu_m
    return results


def _clock_power() -> dict:
    """The card's SM clock (MHz) and power draw (W) now, through NVML."""
    return {"sm_clock_MHz": float(torch.cuda.clock_rate()),
            "power_W": torch.cuda.power_draw() / 1000.0}


@torch.inference_mode()
def _eager_serve(model, bs, images):
    """What CompiledForward graphs, run eagerly: each batch of ``bs`` (the
    last zero-padded to ``bs``) through ``vit_forward`` with the resid_post
    cache, padding rows dropped."""
    from vit_prisma_tpu_torch.models.vit import vit_forward
    from vit_prisma_tpu_torch.prisma.hooks import HookRuntime
    p = next(model.parameters())
    images = images.to(p.device, p.dtype)
    outs, caches = [], []
    for i in range(0, images.shape[0], bs):
        chunk = images[i:i + bs]
        n = chunk.shape[0]
        if n < bs:
            chunk = torch.cat([chunk, chunk.new_zeros((bs - n,) + chunk.shape[1:])])
        rt = HookRuntime(names_filter=RESID_POST)
        outs.append(vit_forward(model, model.cfg, chunk, rt)[:n])
        caches.append({k: v[:n] for k, v in rt.cache.items()})
    return torch.cat(outs), {k: torch.cat([c[k] for c in caches]) for k in caches[0]}


def _served_launches(what, server, counters, per_forward, n_batches, moved):
    """A graphed server's launches: exactly ``per_forward`` (wrapper name ->
    launches; the rest 0) in its warm-up forward and in each replay, and
    ``n_batches`` replays; the wrappers' counters (``moved``: their change
    since they were set to 0) moved by the warm-up and the capture alone.
    Returns what the server launched on the card."""
    want = {k: per_forward.get(k, 0) for k in server.launches_per_replay}
    want_moved = {k: 2 * per_forward.get(k, 0) for k in counters}
    got = {"warmup": server.warmup_launches, "per_replay": server.launches_per_replay,
           "replays": server.replays, "counters_moved": moved}
    if (server.warmup_launches != want or server.launches_per_replay != want
            or server.replays != n_batches or moved != want_moved):
        raise AssertionError(f"{what}: {got}, expected per forward {per_forward}, "
                             f"{n_batches} replays")
    return server.launches


# The bf16 kernels a served forward can launch, by wrapper: the name the
# profiler gives each (B1's mma.sync mix, B14's and B13's wgmma kernels).
SERVED_KERNEL_NAMES = {"attention_mix_tnh": "mix_tc_kernel",
                       "ln_matmul": "ln_gemm_tc_kernel",
                       "flash_attention_padded": "fwd_tc_kernel"}


def _profile_replay(what, server, batch):
    """``torch.profiler`` over one graphed batch (one replay) of ``server``;
    the kernels it ran, counted by name, must be the server's launches per
    replay, so that the count the graph's replays are charged is measured."""
    if batch.shape[0] != server.batch_size or server.graph is None:
        raise AssertionError(f"{what}: profile one full batch of a captured graph")
    replays = server.replays
    want = {SERVED_KERNEL_NAMES[k]: server.launches_per_replay[k] for k in SERVED_KERNEL_NAMES}
    # a window that lost device events (9 of 12 mix kernels in one) is
    # measured again with a wider margin, raising after the last
    seen = []
    for pad in PROFILE_PADS_S:
        prof = _profile(lambda: server(batch), warm=True,
                        calls_of=tuple(SERVED_KERNEL_NAMES.values()), pad=pad)
        seen.append(prof["calls_of"])
        if prof["calls_of"] == want:
            break
    if prof["calls_of"] != want or server.replays != replays + 2 * len(seen):
        raise AssertionError(f"{what}: one replay ran {seen}, expected {want} "
                             f"(the server's launches per replay)")
    prof["windows"] = len(seen)
    return prof


def _serve_turns(fns, batch, bs):
    """Served images per second of each server in ``fns`` in GRAPH_ORDER's
    turns of GRAPH_TURN_BATCHES batches of ``bs``: each batch synchronized
    and timed, the card's SM clock and power read after it."""
    runs = {k: [] for k in fns}
    for which in GRAPH_ORDER:
        fns[which](batch)  # warm-up
        torch.cuda.synchronize()
        per = []
        for _ in range(GRAPH_TURN_BATCHES):
            t0 = time.perf_counter()
            fns[which](batch)
            torch.cuda.synchronize()
            per.append({"s": time.perf_counter() - t0, **_clock_power()})
        s = sum(b["s"] for b in per)
        runs[which].append({"img_per_s": GRAPH_TURN_BATCHES * bs / s, "batches": per})
    return runs


def phase_serve_graph(info):
    """``CompiledForward`` on its CUDA graph against the eager forward of the
    same padded batches, equal to the bit, at B/32 (bf16, fused LN, batch
    256: B14 24 and B1 12 a replay) and CLIP L/14-336 (bf16, fused LN, batch
    64: B13 24 and B14 24 a replay), launches exact per replay; served
    images per second in turns (eager, graph, graph, eager), every batch's
    time, SM clock and power; ``torch.profiler``'s idle share of one
    graphed batch; then ``export_forward`` -> ``load_forward`` at B/32
    against the eager einsum forward, at batch 1, 7 and 256."""
    from vit_prisma_tpu_torch import (CompiledForward, HookedViT, export_forward,
                                      get_model_config, load_forward)
    counters = _sae_counters()
    results = {}
    b32 = get_model_config("openai/clip-vit-base-patch32", dtype="bfloat16",
                           use_fused_ln_gemm=True)
    rows = [("b32", HookedViT(b32, device="cuda", generator=torch.Generator().manual_seed(0)),
             SERVE_BATCH, SERVE_REQUESTS,
             {"ln_matmul": 2 * b32.n_layers, "attention_mix_tnh": b32.n_layers}),
            ("l14_336", _l336_model(), L336_BATCH, L336_REQUESTS, None)]
    for name, model, bs, request_sizes, per_forward in rows:
        cfg = model.cfg
        if per_forward is None:
            per_forward = {"flash_attention_padded": cfg.n_layers, "ln_matmul": cfg.n_layers}
        g = torch.Generator().manual_seed(2)
        requests = [torch.randn(n, 3, cfg.image_size, cfg.image_size, generator=g)
                    for n in request_sizes]
        server = CompiledForward(model, batch_size=bs, names_filter=RESID_POST)
        release()
        torch.cuda.reset_peak_memory_stats()

        # The main path, with every count set to 0 just before it.
        _zero_counts(counters)
        t0 = time.perf_counter()
        answers = [server(r) for r in requests]
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        moved = {k: f.launches for k, f in counters.items()}
        n_batches = sum(-(-n // bs) for n in request_sizes)
        launches = _served_launches(f"serve_graph {name}", server, counters, per_forward,
                                    n_batches, moved)
        bitwise = {}
        for n, r, (out, cache) in zip(request_sizes, requests, answers):
            want_out, want = _eager_serve(model, bs, r)
            same = torch.equal(out, want_out) and list(cache) == list(want) and all(
                torch.equal(cache[k], want[k]) for k in want)
            if not same:
                diff = max((cache[k].float() - want[k].float()).abs().max().item()
                           for k in want)
                raise AssertionError(f"serve_graph {name} request {n}: the graph differs "
                                     f"from the eager forward (max abs {diff})")
            bitwise[n] = True
        batch = torch.randn(bs, 3, cfg.image_size, cfg.image_size, device="cuda",
                            dtype=torch.bfloat16)
        runs = _serve_turns({"eager": lambda b: _eager_serve(model, bs, b), "graph": server},
                            batch, bs)
        peak = torch.cuda.max_memory_allocated() / 1e9
        prof = _profile_replay(f"serve_graph {name}", server, batch)
        rec = {"phase": "serve_graph", **info, "model": cfg.model_name, "dtype": "bfloat16",
               "use_fused_ln_gemm": True, "batch_size": bs, "requests": list(request_sizes),
               "launches": launches, "launches_per_replay": server.launches_per_replay,
               "replays_of_the_requests": n_batches, "capture_and_requests_s": first_s,
               "graph_equals_eager_bitwise": bitwise, "turns": list(GRAPH_ORDER),
               "img_per_s_eager": [r["img_per_s"] for r in runs["eager"]],
               "img_per_s_graph": [r["img_per_s"] for r in runs["graph"]],
               "batches": runs, "peak_memory_GB": peak, "profile_of_one_graphed_batch": prof}
        results[name] = rec
        emit(rec)
        del server, answers, model
        release()

    # the exported forward (plain routes) against the eager einsum forward
    model = HookedViT(b32, device="cuda", generator=torch.Generator().manual_seed(0))
    t0 = time.perf_counter()
    data = export_forward(model, names_filter=RESID_POST)
    export_s = time.perf_counter() - t0
    fwd = load_forward(data)
    plain = model.with_cfg(use_fused_attention=False, use_fused_ln_gemm=False)
    g = torch.Generator(device="cuda").manual_seed(5)
    errs = {}
    for n in EXPORT_BATCHES:
        x = torch.randn(n, 3, 224, 224, generator=g, device="cuda").bfloat16()
        out, cache = fwd(x)
        want_out, want = plain.run_with_cache(x, names_filter=RESID_POST, return_cache_object=False)
        if list(cache) != list(want) or tuple(out.shape) != tuple(want_out.shape):
            raise AssertionError(f"export batch {n}: keys {list(cache)}, out {tuple(out.shape)}")
        e = {"out": check_close(f"export batch {n} out", out, want_out,
                                rel_atol(EXPORT_BF16_REL, want_out))}
        for k in want:
            e[k] = check_close(f"export batch {n} {k}", cache[k], want[k],
                               rel_atol(EXPORT_BF16_REL, want[k]))
        e["bitwise"] = torch.equal(out, want_out) and all(torch.equal(cache[k], want[k])
                                                          for k in want)
        errs[n] = e
    emit({"phase": "serve_export", **info, "model": b32.model_name, "dtype": "bfloat16",
          "batch_polymorphic": True, "artifact_MB": len(data) / 1e6, "export_s": export_s,
          "vs_eager_einsum_max_abs_err": errs, "rel_tol": EXPORT_BF16_REL})
    del model, plain, fwd, data
    return results


def phase_checkpoint(info, store=None):
    """The TopK slice's bf16 row (B8, B6, B7): CKPT_STEPS[0] steps,
    ``save_train_state``, a fresh trainer (other weights drawn) with
    ``load_state``, CKPT_STEPS[1] steps, against the uninterrupted steps on
    the same buffered batches (the store's, else seeded activations on the
    card), to the bit: params, moments, counters; exact launches.  Then
    ``save_model`` / ``load_from_pretrained`` in float32 and bfloat16, and
    the sweep's ``save_checkpoints`` (24 SAEs, 1024 -> 8192, float32): seconds
    and bytes.  Everything goes into a temporary directory, removed after."""
    import shutil
    import tempfile
    from vit_prisma_tpu_torch.sae import (SAESweepTrainer, SparseAutoencoder,
                                          VisionSAETrainer, load_train_state, save_train_state)
    from vit_prisma_tpu_torch.sae.convert import train_state_to_numpy
    cfg = topk_config()
    n, m = CKPT_STEPS
    bs = cfg.train_batch_size
    if store is not None:
        buf, k = store.buffer, store.buffer.shape[0] // bs
        batches = [buf[(i % k) * bs:(i % k + 1) * bs].clone() for i in range(n + m)]
    else:
        g = torch.Generator(device="cuda").manual_seed(6)
        batches = [torch.randn(bs, cfg.d_in, generator=g, device="cuda") for _ in range(n + m)]
    counters = _sae_counters()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        _zero_counts(counters)
        whole = VisionSAETrainer(cfg, device="cuda")
        for b in batches:
            whole.train_step(b)
        first = VisionSAETrainer(cfg, device="cuda")
        for b in batches[:n]:
            first.train_step(b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_train_state(os.path.join(tmp, "topk_state"), first.state, cfg)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        state, cfg_back = load_train_state(path, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        fresh = VisionSAETrainer(cfg, device="cuda",
                                 generator=torch.Generator().manual_seed(99)).load_state(state)
        for b in batches[n:]:
            fresh.train_step(b)
        torch.cuda.synchronize()
        launches = {k: f.launches for k, f in counters.items() if f.launches}
        steps = 2 * (n + m)
        expected = {"sae_fused_forward_topk": steps, "sae_fused_backward_stored": steps,
                    "adam_update": len(whole.state.params) * steps}
        if launches != expected:
            raise AssertionError(f"checkpoint launches {launches}, expected {expected}")
        want, got = train_state_to_numpy(whole.state), train_state_to_numpy(fresh.state)
        differ = [k for k in want if want[k].tobytes() != got[k].tobytes()]
        if cfg_back != cfg or differ or fresh._host_step != n + m:
            raise AssertionError(f"the resumed TopK run differs from the uninterrupted one: "
                                 f"{differ}, host step {fresh._host_step}")
        state_bytes = os.path.getsize(path)

        # SAE files: the trained SAE in float32, and in bfloat16
        sae_files = {}
        for dtype in ("float32", "bfloat16"):
            sae = fresh.sae
            if dtype == "bfloat16":
                sae = SparseAutoencoder(cfg.replace(dtype="bfloat16"),
                                        params={k: v.bfloat16() for k, v in sae.params.items()})
            p = os.path.join(tmp, f"sae_{dtype}")
            sae.save_model(p)
            back = SparseAutoencoder.load_from_pretrained(p, device="cuda")
            same = back.cfg == sae.cfg and all(
                back.params[k].dtype == v.dtype and torch.equal(back.params[k], v)
                for k, v in sae.params.items())
            if not same:
                raise AssertionError(f"SAE file round trip in {dtype} differs")
            sae_files[dtype] = {"bytes": os.path.getsize(p + ".npz"), "round_trip_bitwise": True}

        # the sweep's checkpoints: 24 SAEs of one sweep state
        sweep = SAESweepTrainer(sweep_config(), device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        paths = sweep.save_checkpoints(os.path.join(tmp, "sweep"))
        sweep_s = time.perf_counter() - t0
        sweep_bytes = sum(os.path.getsize(p + ".npz") for p in paths)
        back = SparseAutoencoder.load_from_pretrained(paths[-1], device="cuda")
        if not all(torch.equal(back.params[k], v[-1]) for k, v in sweep.state.params.items()):
            raise AssertionError("the sweep's last SAE file differs from its state")
        del sweep, back
    finally:
        shutil.rmtree(tmp)
    rec = {"phase": "checkpoint", **info, "config": "TopK slice bf16 row (k 64, bf16 compute, "
           "float32 masters)", "steps": [n, m], "launches": launches,
           "batches": "the store's buffer" if store is not None else "seeded, on the card",
           "resume_equals_uninterrupted_bitwise": True, "train_state_bytes": state_bytes,
           "save_train_state_s": save_s, "load_train_state_s": load_s,
           "sae_files": sae_files, "sweep_saes": len(paths), "sweep_save_s": sweep_s,
           "sweep_bytes": sweep_bytes, "sweep_GB_per_s": sweep_bytes / sweep_s / 1e9}
    emit(rec)
    return launches


def _mark_inputs(g, L, B, D, S):
    """_sae_inputs in bf16 with B5's -0 marks forced (REMAT_MARK_SHAPES):
    the inputs and the [L, B, S] entries that must be marked."""
    x, We, be, Wd, bd, dy, dl1 = _sae_inputs(g, L, B, D, S, torch.bfloat16)
    rows = torch.arange(0, B, B // MARK_ROWS, device="cuda")[:MARK_ROWS]
    stride = S // (2 * MARK_FEATURES)
    pos = torch.arange(MARK_FEATURES, device="cuda") * 2 * stride + 3
    neg = pos + stride
    m = 1 + torch.randint(0, 128, (L, 2 * MARK_FEATURES), generator=g, device="cuda") / 128
    bd[:, 0] = 0
    x[:, rows] = bd[:, None, :]
    x[:, rows, 0] = 2.0 ** -60
    We[:, 0, pos] = (2.0 ** -76 * m[:, :MARK_FEATURES]).bfloat16()
    We[:, 0, neg] = (-(2.0 ** -76) * m[:, MARK_FEATURES:]).bfloat16()
    be[:, pos] = 0
    be[:, neg] = 0
    want = torch.zeros(L, B, S, dtype=torch.bool, device="cuda")
    want[:, rows[:, None], pos[None, :]] = True
    return (x, We, be, Wd, bd, dy, dl1), want


def phase_remat_marks(info):
    """B5's -0 marks on the card (ROADMAP C): inputs whose float32 hpre lies
    in (0, 2^-134] at chosen entries (REMAT_MARK_SHAPES), at the TopK
    slice's and the sweep's widths in bf16.  B5 (Hopper route) marks exactly
    those entries, so the wgmma accumulators keep such float32 subnormals;
    B4 stores +0 there; its hc is B4's elsewhere; its grads equal the plain
    backward's on its own mask and the plain version's
    (``sae_fused_backward_reference``) within phase 7's tolerances."""
    from vit_prisma_tpu_torch.ops import sae_step as S
    g = torch.Generator(device="cuda").manual_seed(13)
    results = {}
    for name, L, B, D, Sd in REMAT_MARK_SHAPES:
        args, want = _mark_inputs(g, L, B, D, Sd)
        x, We, be, Wd, bd, dy, dl1 = args
        (y, l1, nact, hc4), route4 = _routed(S.sae_fused_forward, *args[:5], save_h=True)
        dW6, _ = _routed(S.sae_fused_backward_stored, x, hc4, Wd, bd, dy, dl1)
        dW5, route5 = _routed(S.sae_fused_backward, *args)
        torch.cuda.synchronize()
        if route4 != "wgmma" or route5 != "wgmma":
            raise AssertionError(f"remat_marks {name}: routes {route4}, {route5}")
        hc5 = _remat_hc(*args).view(torch.int16)
        marks = hc5 == -32768
        hpre = S._mm(x - bd[:, None], We) + be.float()[:, None]
        rec = {"minus_zero_marks": int(marks.sum()), "chosen": int(want.sum()),
               "marks_exactly_the_chosen": torch.equal(marks, want),
               "b4_hc_zero_at_the_chosen": bool((hc4.view(torch.int16)[want] == 0).all()),
               "plain_hpre_positive_at_the_chosen": bool((hpre[want] > 0).all()),
               "plain_hpre_max_at_the_chosen": hpre[want].max().item(),
               "stored_vs_remat": _remat_against_stored(name, args, hc4, dW5, dW6, route5)}
        if not (rec["marks_exactly_the_chosen"] and rec["b4_hc_zero_at_the_chosen"]):
            raise AssertionError(f"remat_marks {name}: {rec}")
        # the plain version, its mask hpre > 0 from its own float32 product
        mask_plain = hpre > 0
        switched = (mask_plain != (hc5 != 0)).any(dim=1)
        rec["switched_features"] = int(switched.sum())
        rec["grads_vs_plain"] = _grad_errs(
            f"remat_marks {name} B5", dW5,
            S.sae_fused_backward_reference(*args), switched, torch.bfloat16)
        results[name] = rec
        emit({"phase": "remat_marks", **info, "shape": name, "L": L, "B": B, "d_in": D,
              "d_sae": Sd, "dtype": "bfloat16", "route": route5,
              "rel_tol": {"grads": SAE_GRAD_REL[torch.bfloat16],
                          "switched": SAE_SWITCHED_GRAD_REL}, **rec})
        del args, want, x, We, be, Wd, bd, dy, dl1, y, hc4, dW5, dW6, hc5, hpre
        torch.cuda.empty_cache()
    return results


def _eval_inputs(model, n, image_size, image_seed):
    """n random images on the card, with labels and class embeddings
    [ZS_CLASSES, the model's output width] from seed 0."""
    with torch.inference_mode():
        d_out = model(torch.zeros(1, 3, image_size, image_size, device="cuda")).shape[-1]
    rng = np.random.default_rng(0)
    labels = torch.from_numpy(rng.integers(0, ZS_CLASSES, size=n)).cuda()
    class_emb = torch.from_numpy(rng.standard_normal((ZS_CLASSES, d_out),
                                                     dtype=np.float32)).cuda()
    images = torch.from_numpy(np.random.default_rng(image_seed).standard_normal(
        (n, 3, image_size, image_size), dtype=np.float32)).cuda()
    return images, labels, class_emb, d_out


def _draw_final_ln_bias(model, seed=0):
    """Draw ``ln_final``'s bias from a seed.  The random init's biases are
    all 0, so a zero-ablated residual stream stays exactly 0 through every
    later block to the output, and CLIP's ``normalize_output`` then divides
    0 by 0: the zero-ablated loss would be NaN, as in the JAX package
    (pretrained weights have nonzero biases).  ``ln_final`` lies after
    every hook point, so the SAEs' inputs do not change."""
    b = model.ln_final.b
    with torch.no_grad():
        b.copy_((torch.randn(b.shape, generator=torch.Generator().manual_seed(seed)) * 0.1)
                .to(b.dtype))


def _eval_batches(images, labels, bs):
    for i in range(0, images.shape[0], bs):
        yield images[i:i + bs], labels[i:i + bs], torch.arange(i, i + bs)


def phase_sae_eval(info, trainer, cfg, class_emb):
    """The SAE evals at B/32: ``process_dataset`` over 2,048 images,
    ``validate()`` once and ``evaluate()`` into EVAL_OUT_DIR, with exact
    launches (B1 36 an eval batch, 10 a top-image batch and 10 for the
    heatmap, every other kernel 0); then one batch of 8 on the card against
    the CPU in float32.  The class embeddings ``class_emb`` [ZS_CLASSES, 512] are
    the text phase's f32 zero-shot classifier, transposed.  The model's
    ``ln_final`` bias is drawn first (:func:`_draw_final_ln_bias`)."""
    from vit_prisma_tpu_torch import HookedViT
    from vit_prisma_tpu_torch.sae import SparseAutoencoder
    from vit_prisma_tpu_torch.sae import evals as E
    model, sae = trainer.model, trainer.sae
    _draw_final_ln_bias(model)
    counters = _sae_counters()
    images, labels, _, d_out = _eval_inputs(model, EVAL_IMAGES, cfg.image_size, 7)
    if tuple(class_emb.shape) != (ZS_CLASSES, d_out) or class_emb.dtype != torch.float32:
        raise AssertionError(f"class embeddings {tuple(class_emb.shape)} {class_emb.dtype}")
    trainer.eval_dataset = [(images[i], labels[i]) for i in range(EVAL_BATCH)]
    trainer.class_embeddings = class_emb
    n_batches = EVAL_IMAGES // EVAL_BATCH
    ecfg = E.EvalConfig(batch_size=EVAL_BATCH, eval_max=EVAL_IMAGES, sae_path=EVAL_OUT_DIR)
    torch.cuda.synchronize()
    release()
    torch.cuda.reset_peak_memory_stats()

    # The eval path, with every count set to 0 just before each part.
    parts = {}

    def part(name, fn):
        _zero_counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        parts[name] = {"seconds": time.perf_counter() - t0,
                       "launches": {k: f.launches for k, f in counters.items() if f.launches}}
        return out

    stats = part("process_dataset", lambda: E.process_dataset(
        model, sae, ((a, b) for a, b, _ in _eval_batches(images, labels, EVAL_BATCH)),
        class_emb, ecfg))
    vals = part("validate", trainer.validate)
    full = part("evaluate", lambda: E.evaluate(
        ecfg, sae, model, lambda: _eval_batches(images, labels, EVAL_BATCH), class_emb))
    feature = full["sampled_features"]["indices"][0]
    heat = part("heatmap", lambda: E.image_patch_heatmap(
        E.get_heatmap(images[0], model, sae, feature), model.cfg))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tops = full["top_images_per_feature"]
    expected = {"process_dataset": 36 * n_batches, "validate": 36,
                "evaluate": 36 * n_batches + (10 * n_batches if tops else 0), "heatmap": 10}
    for name, n in expected.items():
        if parts[name]["launches"] != {"attention_mix_tnh": n}:
            raise AssertionError(f"sae_eval {name} launches {parts[name]['launches']}, "
                                 f"expected attention_mix_tnh {n} and no other kernel")
    for k in ("avg_loss", "avg_reconstruction_loss", "avg_zero_abl_loss", "ce_recovered",
              "avg_l0", "avg_cos_sim", "alive_fraction"):
        if not math.isfinite(stats[k]) or abs(stats[k] - full[k]) > 1e-6 * max(1, abs(stats[k])):
            raise AssertionError(f"sae_eval {k}: {stats[k]} (evaluate: {full[k]})")
    if not all(math.isfinite(v) for v in vals.values()):
        raise AssertionError(f"validate: {vals}")
    if not stats["avg_l0"] > 0 or stats["log_frequencies_per_token"].shape != (cfg.d_sae,):
        raise AssertionError(f"sae_eval L0 {stats['avg_l0']}")
    files = ["eval_stats.json", "sparsity_TOTAL.npz", "TOTAL_sparsity_dashboard.html"]
    missing = [f for f in files if not os.path.exists(os.path.join(EVAL_OUT_DIR, f))]
    if missing or heat.shape != (cfg.image_size, cfg.image_size) or not np.isfinite(heat).all():
        raise AssertionError(f"sae_eval files missing {missing}, heatmap {heat.shape}")
    if not all(len(v) == ecfg.max_images_per_feature and len(set(i)) == len(i)
               for v, i in tops.values()):
        raise AssertionError("top images: wrong count or repeated images")

    # card against CPU: one batch of 8, float32, the same weights
    cpu_model = HookedViT(model.cfg, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu_sae = SparseAutoencoder(sae.cfg, params={k: v.cpu() for k, v in sae.params.items()})
    x, y = images[:EVAL_CHECK_BATCH], labels[:EVAL_CHECK_BATCH]
    card = E.make_eval_step(model, sae)(model, sae.params, x, y, class_emb)
    cpu = E.make_eval_step(cpu_model, cpu_sae)(cpu_model, cpu_sae.params, x.cpu(), y.cpu(),
                                               class_emb.cpu())
    loss_errs = {k: check_close(f"sae_eval card vs cpu {k}", getattr(card, k),
                                getattr(cpu, k), rel_atol(SLICE_F32_REL, getattr(cpu, k)))
                 for k in ("loss", "recons_loss", "zero_abl_loss", "cos_sim")}
    flips = (card.act_counts.cpu() - cpu.act_counts).abs().sum().item()
    l0_moves = (card.l0_image.cpu() - cpu.l0_image).abs().sum().item()
    pre = EVAL_CHECK_BATCH * model.cfg.n_tokens * sae.cfg.d_sae
    if flips > EVAL_FLIP_FRAC * pre or l0_moves > flips:
        raise AssertionError(f"sae_eval card vs cpu: {flips} ReLU switches, L0 moved {l0_moves}")
    del cpu_model, cpu_sae
    emit({"phase": "sae_eval", **info, "model": cfg.model_name, "hook_point": cfg.hook_point,
          "d_in": cfg.d_in, "d_sae": cfg.d_sae, "dtype": cfg.dtype,
          "sae": f"the train phase's ({TRAIN_STEPS} steps from random weights, seed 0)",
          "dataset": f"{EVAL_IMAGES} random float32 {cfg.image_size}px images, numpy seed 7, "
                     f"labels from numpy seed 0; [{ZS_CLASSES}, {d_out}] class embeddings: "
                     "the text phase's f32 zero-shot classifier, transposed",
          "batch": EVAL_BATCH, "parts": parts, "expected_attention_mix_tnh": expected,
          "eval_images_per_s": EVAL_IMAGES / parts["process_dataset"]["seconds"],
          "evaluate_s": parts["evaluate"]["seconds"],
          "ce_recovered": stats["ce_recovered"], "avg_loss": stats["avg_loss"],
          "avg_reconstruction_loss": stats["avg_reconstruction_loss"],
          "avg_zero_abl_loss": stats["avg_zero_abl_loss"], "avg_l0": stats["avg_l0"],
          "avg_l0_cls": stats["avg_l0_cls"], "avg_l0_image": stats["avg_l0_image"],
          "avg_cos_sim": stats["avg_cos_sim"], "alive_fraction": stats["alive_fraction"],
          "validate": vals, "sampled_features": len(full["sampled_features"]["indices"]),
          "peak_memory_GB": peak_gb,
          "card_vs_cpu": {"batch": EVAL_CHECK_BATCH, "max_abs_err": loss_errs,
                          "rel_tol": SLICE_F32_REL, "relu_switches": flips,
                          "l0_moved": l0_moves, "switch_bound": EVAL_FLIP_FRAC * pre}})
    return parts


def phase_sweep_eval(info, trainer, cfg):
    """The L/14 sweep's ``validate()`` and ``evaluate()`` over its 96 images
    at batch 32: exact launches (B1 300 a batch: 24 for the clean forward,
    276 for the prefix-shared suffixes), per-layer CE recovered and L0,
    images per second, peak memory, and two layers held against
    ``make_eval_step`` with that layer's SAE alone."""
    from vit_prisma_tpu_torch.sae import evals as E
    model = trainer.model
    _draw_final_ln_bias(model)
    L = len(trainer.layers)
    counters = _sae_counters()
    # the sweep's own images (numpy seed 5, as phase_sweep draws them)
    # seed-drawn class embeddings: L/14's output is 768 wide, the text
    # phase's classifier (B/32's text tower) 512
    images, labels, class_emb, _ = _eval_inputs(model, SWEEP_IMAGES, cfg.image_size, 5)
    trainer.eval_dataset = [(images[i], labels[i]) for i in range(SWEEP_EVAL_BATCH)]
    trainer.class_embeddings = class_emb
    n_batches = SWEEP_IMAGES // SWEEP_EVAL_BATCH
    per_batch = L + sum(L - 1 - l for l in range(L))
    torch.cuda.synchronize()
    release()
    torch.cuda.reset_peak_memory_stats()

    _zero_counts(counters)
    t0 = time.perf_counter()
    vals = trainer.validate()
    torch.cuda.synchronize()
    validate_s = time.perf_counter() - t0
    validate_launches = {k: f.launches for k, f in counters.items() if f.launches}
    _zero_counts(counters)
    t1 = time.perf_counter()
    results = trainer.evaluate(((a, b) for a, b, _ in _eval_batches(images, labels,
                                                                    SWEEP_EVAL_BATCH)),
                               eval_cfg=E.EvalConfig(batch_size=SWEEP_EVAL_BATCH))
    torch.cuda.synchronize()
    evaluate_s = time.perf_counter() - t1
    evaluate_launches = {k: f.launches for k, f in counters.items() if f.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if validate_launches != {"attention_mix_tnh": per_batch} or \
            evaluate_launches != {"attention_mix_tnh": per_batch * n_batches}:
        raise AssertionError(f"sweep_eval launches {validate_launches}, {evaluate_launches}; "
                             f"expected attention_mix_tnh {per_batch} a batch, nothing else")
    if len(results) != L or not all(
            math.isfinite(r[k]) for r in results
            for k in ("avg_loss", "avg_reconstruction_loss", "avg_zero_abl_loss", "avg_l0")):
        raise AssertionError("sweep_eval: non-finite per-layer results")

    # the shared prefix is exact: two layers against their SAE alone
    x, y = images[:SWEEP_EVAL_BATCH], labels[:SWEEP_EVAL_BATCH]
    sweep_stats = trainer._val_step(model, trainer.state.params, x, y, class_emb)
    check = {}
    for l in SWEEP_EVAL_CHECK_LAYERS:
        i = trainer.layers.index(l)
        sae = trainer.sae_for_layer(i)
        one = E.make_eval_step(model, sae)(model, sae.params, x, y, class_emb)
        check[l] = {k: check_close(f"sweep_eval layer {l} {k}", getattr(sweep_stats, k)[i],
                                   getattr(one, k),
                                   rel_atol(SWEEP_EVAL_LOSS_REL, getattr(one, k)))
                    for k in ("loss", "recons_loss", "zero_abl_loss")}
        del sae, one
    del sweep_stats
    # where a batch's time goes: one sweep eval step (evaluate() runs one a
    # batch, then reduces on the host)
    batch_profile = _profile(lambda: trainer._val_step(model, trainer.state.params, x, y,
                                                       class_emb), share_of=MIX_KERNEL_NAMES)
    emit({"phase": "sweep_eval", **info, "model": SWEEP_MODEL, "layers": L,
          "batch": SWEEP_EVAL_BATCH, "images": SWEEP_IMAGES,
          "validate_s": validate_s, "evaluate_s": evaluate_s,
          "eval_images_per_s": SWEEP_IMAGES / evaluate_s,
          "batch_ms": 1000 * evaluate_s / n_batches,
          "launches_validate": validate_launches, "launches_evaluate": evaluate_launches,
          "expected_attention_mix_tnh_per_batch": per_batch,
          "ce_recovered_per_layer": [r["ce_recovered"] for r in results],
          "l0_per_layer": [r["avg_l0"] for r in results],
          "cos_sim_per_layer": [r["avg_cos_sim"] for r in results],
          "alive_fraction_per_layer": [r["alive_fraction"] for r in results],
          "validate_mean_ce_recovered": vals["validation_metrics/substitution_score"],
          "peak_memory_GB": peak_gb, "batch_profile": batch_profile,
          "prefix_check": {"layers": list(SWEEP_EVAL_CHECK_LAYERS), "max_abs_err": check,
                           "rel_tol": SWEEP_EVAL_LOSS_REL}})
    return evaluate_launches


def _bf16_ulps(n, want) -> float:
    """n bfloat16 ulps at the largest |value| of ``want``."""
    return n * 2.0 ** (math.floor(math.log2(want.float().abs().max().item())) - 7)


def _block_inputs(g, B, T, D, N, dtype):
    """x and B16's weights, seeded on the card: x unit normal (a
    LayerNorm'd stream), the weights scaled by 1/sqrt(fan-in)."""
    NH = N * 64
    rnd = lambda *shape, scale=1.0: (torch.randn(*shape, generator=g, device="cuda")
                                     * scale).to(dtype)
    return (rnd(B, T, D), rnd(D, 3 * NH, scale=D ** -0.5), rnd(3 * NH, scale=0.1),
            rnd(NH, D, scale=NH ** -0.5))


def _fwd_bwd(fn, inputs, cot=None):
    """``fn(*inputs)`` and its gradients for the cotangent ``cot`` (ones
    when None), from one forward."""
    with torch.enable_grad():
        leaves = [a.detach().clone().requires_grad_(True) for a in inputs]
        out = fn(*leaves)
        grads = torch.autograd.grad(out, leaves, torch.ones_like(out) if cot is None else cot)
    return out.detach(), grads


def block_traffic(B, T, D, N) -> dict:
    """B16's bf16 traffic a call, reckoned from its design (bytes, not
    measured): L2 reads and writes, and device-memory bytes (x, weights and
    out once, the z scratch written back once).  PR 8's kernel (one block
    an image; x re-read for each head, padded rows re-reading row T - 1; z
    read once for each 128-column tile of out) against the wgmma kernel
    (two images a block sharing each weight tile; TMA reads only rows < T;
    z read once for each 192-column tile)."""
    NH, it = N * 64, 2
    weights = (D * 3 * NH + NH * D) * it
    z = B * 64 * NH * it
    out = (B * T * D + 3 * NH) * it  # out written, the bias read
    old = B * weights + B * N * 64 * D * it + z * (1 + D // 128) + out
    new = -(-B // 2) * weights + B * N * T * D * it + z * (1 + -(-D // 192)) + out
    dram = weights + B * T * D * it + z + out
    return {"l2_GB_pr8": old / 1e9, "l2_GB": new / 1e9, "dram_GB": dram / 1e9}


def block_traffic_f32(B, T, D, N) -> dict:
    """B16's float32 traffic a call, reckoned from its design (bytes, not
    measured): the pre-passes (the weights read once, their split hi and
    lo written once), then L2 reads: the split weights once per block of
    two images, x once per 96-column QKV pass (two a head), z once per
    128-column output pass; device-memory bytes as block_traffic counts
    them, plus the split copies written and read once."""
    NH, it = N * 64, 4
    weights = (D * 3 * NH + NH * D) * it
    x_tile = 64 * D * it  # an image's x rows, padded to 64 by TMA's zero fill
    z = B * 64 * NH * it
    l2 = -(-B // 2) * 2 * weights + B * (2 * N * x_tile + (D // 128) * 64 * NH * it)
    dram = 5 * weights + B * T * D * it * 2 + z + 3 * NH * it  # weights: read, split written, read
    return {"l2_GB": l2 / 1e9, "dram_GB": dram / 1e9}


def phase_mix_kernels(info):
    """B15 and B16, the op-level path of the JAX package's two kernels
    without a caller: first the path itself (each entry point once at the
    B/32 geometry in bfloat16, forward and backward, counts set to 0 just
    before), then each kernel against its plain version at the stated
    shapes, B15 against B1 on the same data transposed, B16 against the
    JAX reference's twin, gradients through the wrappers against the plain
    versions' autograd, and times beside SDPA (B15) and F.linear + SDPA +
    F.linear (B16)."""
    import torch.nn.functional as F
    from vit_prisma_tpu_torch.ops import attention as A
    g = torch.Generator(device="cuda").manual_seed(13)
    counters = _sae_counters()
    B, T, D, N = BLOCK_GEOMETRY
    _, Nm, Tm, Hm = MIX_SHAPES[0][1:5]
    qkv = [(torch.randn(B, Nm, Tm, Hm, generator=g, device="cuda") * s).to(torch.bfloat16)
           for s in (Hm ** -0.5, 1.0, 1.0)]
    block = _block_inputs(g, B, T, D, N, torch.bfloat16)
    torch.cuda.synchronize()

    # The path, with every count set to 0 just before it.
    _zero_counts(counters)
    z, dmix = _fwd_bwd(A.attention_mix, qkv)
    out, dblock = _fwd_bwd(lambda *a: A.fused_attention_block(*a, N, BLOCK_INV_SCALE), block)
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters.items()}
    expected = dict.fromkeys(counters, 0)
    expected.update(attention_mix=1, fused_attention_block=1)  # plain backwards, as in JAX
    if launches != expected:
        raise AssertionError(f"mix path launches {launches}, expected {expected}")
    for t in (z, out, *dmix, *dblock):
        if not torch.isfinite(t).all():
            raise AssertionError("mix path: non-finite output or gradient")
    del z, out, dmix, dblock, qkv, block

    results = {}
    for name, Bm, Nm, Tm, Hm, dtypes in MIX_SHAPES:
        for dtype in dtypes:
            q, k, v = [(torch.randn(Bm, Nm, Tm, Hm, generator=g, device="cuda") * s).to(dtype)
                       for s in (Hm ** -0.5, 1.0, 1.0)]
            z = A._launch_mix(q, k, v)
            want = A.attention_mix_reference(q, k, v)
            torch.cuda.synchronize()
            if z.dtype != dtype or z.shape != q.shape:
                raise AssertionError(f"attention_mix {name}: {z.dtype} {tuple(z.shape)}")
            err = check_close(f"attention_mix {name} {dtype}", z, want, KERNEL_TOL[dtype])
            rec = {"phase": "mix_kernel", **info, "kernel": "attention_mix", "shape": name,
                   "B": Bm, "N": Nm, "T": Tm, "H": Hm, "dtype": str(dtype).split(".")[1],
                   "max_abs_err": err, "tol": KERNEL_TOL[dtype]}
            # B1 on the same data token-major: the same device code, so
            # equal to the bit
            tnh = lambda a: a.transpose(1, 2).reshape(Bm, Tm, Nm * Hm).contiguous()
            z1 = A._launch(tnh(q), tnh(k), tnh(v), Nm, False)
            rec["equals_b1_transposed"] = bool(torch.equal(tnh(z), z1))
            if not rec["equals_b1_transposed"]:
                raise AssertionError(f"attention_mix {name} {dtype}: differs from B1")
            rec["route"] = A.mix_route(Hm, dtype)
            if dtype == torch.float32:
                rec["profiled_kernels"] = profiled_kernels(
                    f"B15 {name}", [(f"{ATTENTION}:_launch_mix", (q, k, v), {})],
                    rec["route"], (0,))
            del z1
            if name == "b32":
                dz = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
                got_g = _fwd_bwd(A.attention_mix, (q, k, v), dz)[1]
                want_g = _fwd_bwd(A.attention_mix_reference, (q, k, v), dz)[1]
                rel = MIX_GRAD_REL[dtype]
                rec["grad_max_abs_err"] = {
                    n_: check_close(f"attention_mix {name} {dtype} d{n_}", a, w, rel_atol(rel, w))
                    for n_, a, w in zip("qkv", got_g, want_g)}
                rec["grad_rel_tol"] = rel
                del dz, got_g, want_g
            rec["us"] = cuda_us(lambda: A._launch_mix(q, k, v))
            rec["plain_us"] = cuda_us(lambda: A.attention_mix_reference(q, k, v), iters=5)
            rec["library_us"] = cuda_us(lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0))
            gemm = "bf16_tensor" if dtype == torch.bfloat16 else "f32_product"
            rec.update(bound(4 * q.numel() * q.element_size(),
                             [(gemm, 4 * Bm * Nm * Tm * Tm * Hm), ("fp32", 5 * Bm * Nm * Tm * Tm)]))
            results[("attention_mix", name, dtype)] = rec
            emit(rec)
            del q, k, v, z, want

    NH = N * 64
    for dtype in (torch.bfloat16, torch.float32):
        args = _block_inputs(g, B, T, D, N, dtype)
        x, Wqkv, bqkv, Wo = args
        out = A._launch_attn_block(*args, N, BLOCK_INV_SCALE)
        want = A.fused_attention_block_plain(*args, N, BLOCK_INV_SCALE)
        torch.cuda.synchronize()
        if out.dtype != dtype or out.shape != x.shape:
            raise AssertionError(f"fused_attention_block: {out.dtype} {tuple(out.shape)}")
        tol = (rel_atol(BLOCK_F32_REL, want) if dtype == torch.float32
               else _bf16_ulps(BLOCK_BF16_ULPS, want))
        err = check_close(f"fused_attention_block {dtype}", out, want, tol)
        rec = {"phase": "mix_kernel", **info, "kernel": "fused_attention_block", "shape": "b32",
               "B": B, "T": T, "D": D, "N": N, "H": 64, "dtype": str(dtype).split(".")[1],
               "max_abs_err": err, "tol": tol,
               "tol_rule": (f"{BLOCK_F32_REL} x max(1, |out|max)" if dtype == torch.float32
                            else f"{BLOCK_BF16_ULPS} bf16 ulps at |out|max")}
        # both routes take two images a block: an odd batch against plain,
        # and batch independence to the bit: image 0 (slot 0) and image 1
        # (slot 1 of the first block) each alone, and the odd batch's lone
        # last image against the same image in the batch of 256
        odd = [a[:BLOCK_ODD_BATCH] if a is x else a for a in args]
        out_odd = A._launch_attn_block(*odd, N, BLOCK_INV_SCALE)
        want_odd = A.fused_attention_block_plain(*odd, N, BLOCK_INV_SCALE)
        rec["odd_batch"] = BLOCK_ODD_BATCH
        rec["odd_batch_max_abs_err"] = check_close(
            f"fused_attention_block {dtype} batch {BLOCK_ODD_BATCH}", out_odd, want_odd,
            rel_atol(BLOCK_F32_REL, want_odd) if dtype == torch.float32
            else _bf16_ulps(BLOCK_BF16_ULPS, want_odd))
        alone = {i: A._launch_attn_block(x[i:i + 1], *args[1:], N, BLOCK_INV_SCALE)
                 for i in (0, 1)}
        same = {f"image_{i}_alone": bool(torch.equal(o, out[i:i + 1]))
                for i, o in alone.items()}
        last = BLOCK_ODD_BATCH - 1
        same[f"image_{last}_lone_in_batch_{BLOCK_ODD_BATCH}"] = bool(
            torch.equal(out_odd[last], out[last]))
        rec["batch_independent"] = same
        if not all(same.values()):
            raise AssertionError(f"fused_attention_block {dtype}: batch dependence {same}")
        rec["route"] = A.attn_block_route(dtype)
        del odd, out_odd, want_odd, alone
        if dtype == torch.bfloat16:
            rec["ptxas"] = ptxas(BLOCK_TC_KERNEL)
            rec["traffic"] = block_traffic(B, T, D, N)
        if dtype == torch.float32:
            rec["ptxas"] = ptxas(BLOCK_TF32_KERNEL)
            if any(r["spill_bytes"] for r in rec["ptxas"].values()):
                raise AssertionError(f"{BLOCK_TF32_KERNEL} spills: {rec['ptxas']}")
            # the call's kernels by name: the 3xTF32 kernel once and the two
            # weights' pre-passes, never the FFMA kernel it replaced
            want_calls = {BLOCK_TF32_KERNEL: 1, LN_SPLIT_KERNEL: 2, BLOCK_FFMA_KERNEL: 0}
            for pad in PROFILE_PADS_S:
                prof = _profile(lambda: A._launch_attn_block(*args, N, BLOCK_INV_SCALE),
                                warm=True, calls_of=tuple(want_calls), pad=pad)
                if prof["calls_of"][BLOCK_FFMA_KERNEL] or prof["calls_of"] == want_calls:
                    break
            if prof["calls_of"] != want_calls:
                raise AssertionError(f"fused_attention_block f32: kernels by name "
                                     f"{prof['calls_of']}, expected {want_calls}")
            rec["profiled_kernels"] = {"calls": prof["calls_of"], "pad_s": pad}
            rec["traffic"] = block_traffic_f32(B, T, D, N)
            ref = A.attn_block_reference(*args, N, BLOCK_INV_SCALE)
            rec["reference_max_abs_err"] = check_close(
                "fused_attention_block vs attn_block_reference", out, ref,
                rel_atol(BLOCK_F32_REL, ref))
            del ref
        cot = torch.randn(x.shape, generator=g, device="cuda").to(dtype)
        fn = lambda *a: A.fused_attention_block(*a, N, BLOCK_INV_SCALE)
        plain = lambda *a: A.fused_attention_block_plain(*a, N, BLOCK_INV_SCALE)
        rel = BLOCK_GRAD_REL[dtype]
        rec["grad_max_abs_err"] = {
            n_: check_close(f"fused_attention_block {dtype} d{n_}", a, w, rel_atol(rel, w))
            for n_, a, w in zip(("x", "Wqkv", "bqkv", "Wo"), _fwd_bwd(fn, args, cot)[1],
                                _fwd_bwd(plain, args, cot)[1])}
        rec["grad_rel_tol"] = rel
        rec["us"] = cuda_us(lambda: A._launch_attn_block(*args, N, BLOCK_INV_SCALE))
        rec["plain_us"] = cuda_us(lambda: plain(*args), iters=5)
        WqkvT, WoT = Wqkv.t().contiguous(), Wo.t().contiguous()  # untimed, as weights would lie

        def library():
            qkv_l = F.linear(x, WqkvT, bqkv).view(B, T, 3, N, 64).permute(2, 0, 3, 1, 4)
            zl = F.scaled_dot_product_attention(qkv_l[0], qkv_l[1], qkv_l[2],
                                                scale=BLOCK_INV_SCALE)
            return F.linear(zl.transpose(1, 2).reshape(B, T, NH), WoT)
        rec["library_us"] = cuda_us(library)
        rec["library_max_abs_err"] = (library().float() - want.float()).abs().max().item()
        gemm = "bf16_tensor" if dtype == torch.bfloat16 else "f32_product"
        flops = {"qkv": 2 * B * T * D * 3 * NH, "out": 2 * B * T * NH * D,
                 "mix": 4 * B * N * T * T * 64}
        rec["GFLOP"] = {k_: v_ / 1e9 for k_, v_ in flops.items()}
        rec["TFLOP_s"] = sum(flops.values()) / (rec["us"] * 1e-6) / 1e12
        rec.update(bound((2 * x.numel() + Wqkv.numel() + bqkv.numel() + Wo.numel())
                         * x.element_size(),
                         [(gemm, sum(flops.values())), ("fp32", 5 * B * N * T * T)]))
        results[("fused_attention_block", "b32", dtype)] = rec
        emit(rec)
        del args, x, Wqkv, bqkv, Wo, out, want, cot, WqkvT, WoT
    emit({"phase": "mix_path", **info, "launches": launches, "expected_launches": expected,
          "path": "attention_mix and fused_attention_block at B/32 bf16, forward and "
                  "backward; neither has a caller on any path of either package"})
    return results, launches


def hf_clip_state_dict(cfg, text_cfg=None, seed=0):
    """An HF ``CLIPModel``-layout state dict of ``cfg``'s vision tower
    (``vision_model.*`` and ``visual_projection.weight``) and, with
    ``text_cfg``, of that text tower (``text_model.*`` and
    ``text_projection.weight``, drawn after the vision tower, which is the
    same with or without it), drawn from ``seed`` at the scales of
    transformers' CLIP init (initializer factor 1: class embedding d^-1/2,
    patch, position and token embeddings 0.02, q/k/v and fc2 d^-1/2 (2
    L)^-1/2, out_proj d^-1/2, fc1 (2 d)^-1/2, the projections d^-1/2).  That
    init's LayerNorms are the identity and its biases zero, which would
    leave nothing to fold: here LayerNorm weights are 1 + N(0, 0.1^2) and
    every bias N(0, 0.02^2)."""
    g = torch.Generator().manual_seed(seed)

    def normal(shape, std):
        return torch.randn(shape, generator=g) * std

    def ln(sd, prefix, D):
        sd[prefix + ".weight"] = 1.0 + normal(D, 0.1)
        sd[prefix + ".bias"] = normal(D, 0.02)

    def layers(sd, cfg):
        D, M, L = cfg.d_model, cfg.d_mlp, cfg.n_layers
        attn_std, fc_std = D ** -0.5 * (2 * L) ** -0.5, (2 * D) ** -0.5
        for l in range(L):
            k = f"encoder.layers.{l}"
            ln(sd, k + ".layer_norm1", D)
            ln(sd, k + ".layer_norm2", D)
            for m, std in (("q", attn_std), ("k", attn_std), ("v", attn_std),
                           ("out", D ** -0.5)):
                sd[f"{k}.self_attn.{m}_proj.weight"] = normal((D, D), std)
                sd[f"{k}.self_attn.{m}_proj.bias"] = normal(D, 0.02)
            sd[f"{k}.mlp.fc1.weight"] = normal((M, D), fc_std)
            sd[f"{k}.mlp.fc1.bias"] = normal(M, 0.02)
            sd[f"{k}.mlp.fc2.weight"] = normal((D, M), attn_std)
            sd[f"{k}.mlp.fc2.bias"] = normal(D, 0.02)

    D, P = cfg.d_model, cfg.patch_size
    sd = {"embeddings.class_embedding": normal(D, D ** -0.5),
          "embeddings.patch_embedding.weight": normal((D, cfg.n_channels, P, P), 0.02),
          "embeddings.position_embedding.weight": normal((cfg.n_tokens, D), 0.02)}
    ln(sd, "pre_layrnorm", D)  # (sic) HF's name
    layers(sd, cfg)
    ln(sd, "post_layernorm", D)
    out = {"vision_model." + k: v for k, v in sd.items()}
    out["visual_projection.weight"] = normal((cfg.n_classes, D), D ** -0.5)
    if text_cfg is not None:
        D = text_cfg.d_model
        sd = {"embeddings.token_embedding.weight": normal((text_cfg.vocab_size, D), 0.02),
              "embeddings.position_embedding.weight": normal((text_cfg.context_length, D),
                                                             0.02)}
        layers(sd, text_cfg)
        ln(sd, "final_layer_norm", D)
        out.update({"text_model." + k: v for k, v in sd.items()})
        out["text_projection.weight"] = normal((text_cfg.n_classes, D), D ** -0.5)
    return out


def _analysis_names(cfg, attn=False):
    """The hook names of a cached analysis forward: resid_pre/mid/post, the
    attention and MLP outputs, the neurons, the LayerNorm scales and
    ln_final's output; with ``attn`` each head's z as well, which takes the
    einsum attention (no B1), without it the forward runs B1."""
    names = ["ln_final.hook_scale", "ln_final.hook_normalized"]
    for l in range(cfg.n_layers):
        p = f"blocks.{l}."
        names += [p + n for n in ("hook_resid_pre", "hook_resid_mid", "hook_resid_post",
                                  "hook_attn_out", "hook_mlp_out", "mlp.hook_post",
                                  "ln1.hook_scale", "ln2.hook_scale")]
        if attn:
            names.append(p + "attn.hook_z")
    return names


def _cache_checks(cache, model, rel):
    """The invariants of one cache, each an error raising past ``rel`` of
    max(1, the reference's absmax): neuron results + b_out = mlp_out in
    every layer; the last accumulated residual, LayerNorm-scaled, =
    ln_final.hook_normalized (ln_final is the identity once folded)."""
    n = model.cfg.n_layers
    errs = {}
    for l in range(n):
        want = cache[("mlp_out", l)]
        got = cache.get_neuron_results(l).sum(-2) + model.b_out[l].detach()
        errs[f"neurons_L{l}"] = check_close(f"neurons + b_out L{l}", got, want,
                                            rel_atol(rel, want))
    want = cache["ln_final.hook_normalized"]
    got = cache.accumulated_resid(apply_ln=True)[-1]
    errs["accumulated_resid_ln_final"] = check_close(
        "accumulated_resid ln_final", got, want, rel_atol(rel, want))
    return errs


def _plain_logit_lens(cache_dict, n_layers, answers):
    """The logit lens by hand: every resid_pre and the last resid_post,
    centred, over ln_final's cached scale, onto the class directions:
    [batch, pos, layers + 1, classes]."""
    stack = torch.stack([cache_dict[f"blocks.{l}.hook_resid_pre"] for l in range(n_layers)]
                        + [cache_dict[f"blocks.{n_layers - 1}.hook_resid_post"]])
    stack = (stack - stack.mean(-1, keepdim=True)) / cache_dict["ln_final.hook_scale"]
    return torch.einsum("lbpd,od->bplo", stack, answers)


def phase_analysis(info):
    """CLIP ViT-B/32 loaded and analysed on the card: an HF CLIPModel-layout
    state dict (``hf_clip_state_dict``) through ``load_hooked_model``
    raw, processed (``fold_ln``, ``center_writing_weights``,
    ``fold_value_biases``) and also refactored
    (``refactor_factored_attn_matrices``), the processed forwards on the B1
    route against the raw one; ``run_with_cache`` to an ``ActivationCache``
    at batch 8 in float32 and bfloat16 (its first and second call timed)
    with its invariants (heads +
    remainder, neurons + b_out, the LayerNorm-scaled last residual);
    ``get_full_resid_decomposition(expand_neurons=True, apply_ln=True)`` at
    batch 1 with its shape, time and peak memory, summing to the
    LayerNorm-scaled difference of the last resid_post and the first
    resid_pre; the logit lens over 1,000 seed-drawn class directions with
    the ImageNet names against a plain einsum and the CPU; B1's launches,
    exactly n_layers for each forward on its route and none elsewhere; and
    ``save_local`` -> ``from_local`` to the bit in both dtypes."""
    import shutil
    import tempfile
    from vit_prisma_tpu_torch import HookedViT, load_hooked_model
    from vit_prisma_tpu_torch.dataloaders.imagenet_names import load_imagenet_dict
    from vit_prisma_tpu_torch.models.loading.registry import get_model_config
    from vit_prisma_tpu_torch.prisma.cache import ActivationCache
    from vit_prisma_tpu_torch.prisma.logit_lens import (get_patch_logit_dictionary,
                                                        get_patch_logit_directions)
    cfg = get_model_config(ANALYSIS_MODEL)
    sd = hf_clip_state_dict(cfg, seed=0)
    processing = dict(fold_ln=True, center_writing_weights=True, fold_value_biases=True)
    t0 = time.perf_counter()
    raw = load_hooked_model(ANALYSIS_MODEL, state_dict=sd, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    proc = load_hooked_model(ANALYSIS_MODEL, state_dict=sd, device="cuda", **processing)
    torch.cuda.synchronize()
    load_processed_s = time.perf_counter() - t0
    refac = load_hooked_model(ANALYSIS_MODEL, state_dict=sd, device="cuda",
                              refactor_factored_attn_matrices=True, **processing)
    proc_bf16 = load_hooked_model(ANALYSIS_MODEL, state_dict=sd, device="cuda",
                                  dtype="bfloat16", **processing)
    x = _images(ANALYSIS_BATCH, 51)
    answers = torch.randn(ANALYSIS_CLASSES, cfg.d_model,
                          generator=torch.Generator().manual_seed(52)).cuda()
    b1_names = _analysis_names(cfg)
    z_names = _analysis_names(cfg, attn=True)

    # The phase's path, with every count set to 0 just before it: the
    # forwards on B1's route are counted as they run.
    counters = _sae_counters()
    _zero_counts(counters)
    b1_forwards = 0
    out_raw = raw(x)
    out_proc = proc(x)
    out_refac = refac(x)
    b1_forwards += 3
    caches, cache_s = {}, {}
    for name, model in (("f32", proc), ("bf16", proc_bf16)):
        xm = x.to(model.cfg.torch_dtype)
        for when in ("first", "second"):  # the first call's warm-up apart
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, caches[name] = model.run_with_cache(xm, names_filter=b1_names)
            torch.cuda.synchronize()
            cache_s[f"{name}_{when}"] = time.perf_counter() - t0
            b1_forwards += 1
        _, caches[name + "_z"] = model.run_with_cache(xm, names_filter=z_names)
    _, one = proc.run_with_cache(x[:1], names_filter=z_names)
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters.items() if f.launches}
    expected = {"attention_mix_tnh": cfg.n_layers * b1_forwards}
    if launches != expected:
        raise AssertionError(f"analysis launches {launches}, expected {expected}")
    if not all(isinstance(c, ActivationCache) for c in caches.values()):
        raise AssertionError("run_with_cache did not return an ActivationCache")

    proc_errs = {
        "processed_vs_raw": check_close("processed vs raw", out_proc, out_raw,
                                        rel_atol(ANALYSIS_PROCESSED_REL, out_raw)),
        "refactored_vs_raw": check_close("refactored vs raw", out_refac, out_raw,
                                         rel_atol(ANALYSIS_PROCESSED_REL, out_raw))}

    # The caches' invariants, in both dtypes.
    invariants = {}
    last = f"blocks.{cfg.n_layers - 1}.hook_resid_post"
    for name, model in (("f32", proc), ("bf16", proc_bf16)):
        rel = ANALYSIS_F32_REL if name == "f32" else ANALYSIS_BF16_REL
        errs = _cache_checks(caches[name], model, rel)
        zc = caches[name + "_z"]
        heads, labels = zc.stack_head_results(incl_remainder=True, return_labels=True)
        if heads.shape[0] != cfg.n_layers * cfg.n_heads + 1 or labels[-1] != "remainder":
            raise AssertionError(f"head stack {tuple(heads.shape)}")
        errs["heads_plus_remainder"] = check_close(
            f"{name} heads + remainder", heads.float().sum(0), zc[last],
            rel_atol(rel, zc[last]))
        # the remainder is everything but the heads: the MLPs, b_O and the
        # first residual.  In bf16 the cached residual carries the rounding
        # of its 2 L additions (each at most half an ulp, 2^-9 of the
        # absmax), which the float32 sum of the parts does not
        rest = (zc[("resid_pre", 0)].float() + model.b_O.detach().float().sum(0)
                + sum(zc[("mlp_out", l)].float() for l in range(cfg.n_layers)))
        resid_rel = rel if name == "f32" else 2 * cfg.n_layers * 2.0 ** -9
        errs["remainder_is_mlps_bias_embed"] = check_close(
            f"{name} remainder", heads[-1].float(), rest, rel_atol(resid_rel, zc[last]))
        errs["resid_post_absmax"] = zc[last].float().abs().max().item()
        errs["mlp_out_absmax"] = max(zc[("mlp_out", l)].float().abs().max().item()
                                     for l in range(cfg.n_layers))
        invariants[name] = errs
        del heads, rest
    del caches
    release()

    # The full decomposition at batch 1.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    full, labels = one.get_full_resid_decomposition(expand_neurons=True, apply_ln=True,
                                                    return_labels=True)
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    full_peak = torch.cuda.max_memory_allocated() / 1e9
    full_shape = list(full.shape)
    want_shape = [cfg.n_layers * (cfg.n_heads + cfg.d_mlp) + 1, 1, cfg.n_tokens, cfg.d_model]
    if full_shape != want_shape or len(labels) != want_shape[0] or labels[-1] != "bias":
        raise AssertionError(f"full decomposition {full_shape}, {len(labels)} labels")
    total = full.sum(0)
    del full
    diff = (one[last] - one[("resid_pre", 0)])[None]
    want = one.apply_ln_to_stack(diff, layer=-1)[0]
    full_err = check_close("full decomposition sum", total, want,
                           rel_atol(ANALYSIS_F32_REL, want))
    del total, diff, want, one
    release()

    # The logit lens on the float32 cache of batch 8 (B1's route), against
    # a plain einsum and against the CPU at ANALYSIS_CPU_BATCH.
    _zero_counts(counters)
    _, lens_cache = proc.run_with_cache(x, names_filter=b1_names)
    torch.cuda.synchronize()
    lens_launches = {k: f.launches for k, f in counters.items() if f.launches}
    if lens_launches != {"attention_mix_tnh": cfg.n_layers}:
        raise AssertionError(f"logit lens launches {lens_launches}")
    t0 = time.perf_counter()
    lens, lens_labels = get_patch_logit_directions(lens_cache, answers)
    torch.cuda.synchronize()
    lens_s = time.perf_counter() - t0
    plain = _plain_logit_lens(lens_cache.cache_dict, cfg.n_layers, answers)
    lens_err = check_close("logit lens", lens, plain, rel_atol(ANALYSIS_F32_REL, plain))
    names = load_imagenet_dict()
    readout = get_patch_logit_dictionary(lens, batch_idx=0, class_names=names)
    if (len(readout) != cfg.n_tokens or any(len(v) != cfg.n_layers + 1 for v in readout.values())
            or not all(t[1] == names[t[2]] for v in readout.values() for t in v)):
        raise AssertionError("logit-lens readout malformed")
    cpu = load_hooked_model(ANALYSIS_MODEL, state_dict=sd, device="cpu", **processing)
    _, cpu_cache = cpu.run_with_cache(x[:ANALYSIS_CPU_BATCH].cpu(), names_filter=b1_names)
    cpu_lens = get_patch_logit_directions(cpu_cache, answers.cpu(), return_labels=False)
    lens_cpu_err = check_close("logit lens vs CPU", lens[:ANALYSIS_CPU_BATCH], cpu_lens,
                               rel_atol(ANALYSIS_PROCESSED_REL, cpu_lens))
    del lens_cache, lens, plain, cpu, cpu_cache, cpu_lens

    # save_local -> from_local on the card, to the bit, in both dtypes.
    tmp = tempfile.mkdtemp(prefix="chip_smoke_local_")
    round_trip = {}
    try:
        for name, model in (("f32", proc), ("bf16", proc_bf16)):
            path = os.path.join(tmp, name)
            t0 = time.perf_counter()
            model.save_local(path)
            save_s = time.perf_counter() - t0
            back = HookedViT.from_local(model.cfg, path + ".npz", device="cuda")
            same = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in
                       zip(model.state_dict().values(), back.state_dict().values()))
            if not same or list(model.state_dict()) != list(back.state_dict()):
                raise AssertionError(f"save_local -> from_local differs in {name}")
            round_trip[name] = {"bitwise": True, "bytes": os.path.getsize(path + ".npz"),
                                "save_s": save_s}
            del back
    finally:
        shutil.rmtree(tmp)

    b1 = launches["attention_mix_tnh"] + lens_launches["attention_mix_tnh"]
    emit({"phase": "analysis", **info, "model": ANALYSIS_MODEL,
          "source": "HF CLIPModel layout, seed 0 (hf_clip_state_dict)",
          "n_layers": cfg.n_layers, "d_model": cfg.d_model, "batch": ANALYSIS_BATCH,
          "load_s": load_s, "load_processed_s": load_processed_s,
          "processing": sorted(processing) + ["refactor_factored_attn_matrices"],
          "processed_max_abs_err": proc_errs, "logits_absmax": out_raw.abs().max().item(),
          "f32_rel_tol": ANALYSIS_F32_REL, "bf16_rel_tol": ANALYSIS_BF16_REL,
          "processed_and_cpu_rel_tol": ANALYSIS_PROCESSED_REL,
          "bf16_remainder_rel_tol": 2 * cfg.n_layers * 2.0 ** -9,
          "invariant_max_abs_err": invariants, "run_with_cache_s": cache_s,
          "full_decomposition": {"shape": full_shape, "s": full_s, "peak_GB": full_peak,
                                 "allocated_before_GB": base / 1e9,
                                 "GB": math.prod(full_shape) * 4 / 1e9,
                                 "sum_max_abs_err": full_err},
          "logit_lens": {"classes": ANALYSIS_CLASSES, "layers": len(lens_labels), "s": lens_s,
                         "vs_einsum_max_abs_err": lens_err,
                         "vs_cpu_max_abs_err": lens_cpu_err,
                         "patch0_last_layer": readout[0][-1][1]},
          "save_local_from_local": round_trip,
          "b1_forwards": b1_forwards + 1, "launches": {"attention_mix_tnh": b1}})
    return b1


def train_merges(classnames, templates):
    """A BPE merge table learned from the prompts ``template(name)``: the
    standard greedy training (merge the most frequent adjacent pair, ties by
    the pair's order, until every word is one symbol), over the words of the
    tokenizer's own split (cleaned, lower-cased, byte-mapped, ``</w>`` on
    the last symbol), each word counted as often as the prompts hold it: a
    template's words once per name, a name's once per template."""
    import collections
    import heapq
    from vit_prisma_tpu_torch.utils import clip_tokenizer as T
    base = T.CLIPTokenizer([])
    counts = collections.Counter()

    def add(text, n):
        for token in base._split.findall(T._clean(text).lower()):
            counts["".join(base.byte_encoder[b] for b in token.encode("utf-8"))] += n

    for t in templates:
        add(t.replace("{c}", " "), len(classnames))
    for name in classnames:
        add(name, len(templates))
    words = [list(w[:-1]) + [w[-1] + "</w>"] for w in counts]
    freq = list(counts.values())
    pairs, where = collections.Counter(), collections.defaultdict(set)
    for i, w in enumerate(words):
        for p in zip(w, w[1:]):
            pairs[p] += freq[i]
            where[p].add(i)
    heap = [(-n, p) for p, n in pairs.items()]
    heapq.heapify(heap)
    merges = []
    while heap and len(merges) < T.N_CLIP_MERGES:
        n, p = heapq.heappop(heap)
        if pairs.get(p) != -n:  # a stale entry
            continue
        merges.append(p)
        touched = set()
        for i in where.pop(p):
            for q in zip(words[i], words[i][1:]):
                pairs[q] -= freq[i]
                touched.add(q)
            words[i] = T._merge_pass(words[i], p)
            for q in zip(words[i], words[i][1:]):
                pairs[q] += freq[i]
                where[q].add(i)
                touched.add(q)
        del pairs[p]
        for q in touched - {p}:
            if pairs[q] > 0:
                heapq.heappush(heap, (-pairs[q], q))
    return merges


def _zs_plain_counts(logits, target):
    """Top-1 and top-5 hits by rank, without a sort: a row's target ranks
    after every larger logit and every equal one of a lower class index."""
    t = logits.gather(1, target[:, None])
    idx = torch.arange(logits.shape[1], device=logits.device)
    rank = ((logits > t) | ((logits == t) & (idx < target[:, None]))).sum(1)
    return [float((rank < k).sum()) for k in (1, 5)]


def phase_text(info):
    """The CLIP text tower and zero-shot classification at B/32 width: the
    text tower loaded from an HF CLIPModel state dict (``hf_clip_state_dict``
    with the text tower, seed 0) raw and processed (f32, processed against
    raw on B1's causal route); a merge table learned from the 80,000 prompts
    (``train_merges``); the bf16 forward at TEXT_BATCH with exact launches
    (B1 12), prompts per second in turns with the einsum bypass, once with
    the LN fusion (B14 24, B1 12), both bypasses the same weights
    (``with_cfg``); f32 at TEXT_CPU_BATCH against the CPU; each limit
    relative to the compared value's own absmax, and shown to fail a
    control (a TF32 forward for float32, the bidirectional tower for bf16);
    ``run_with_cache(incl_bwd=True)`` over the 12 resid_post hooks in bf16
    (B1 12, B2 11) against the einsum path, f32 gradients against the CPU;
    ``zero_shot_classifier`` over the first ZS_CLASSES ImageNet names x 80 templates
    in f32 and bf16 (B1 12 for each of its 2,000 forwards), with the
    tokenizer's and the rest's seconds, unit columns, 8 classes against
    the CPU and the bf16 classifier against the f32 one; then ``zero_shot_eval`` of the B/32 vision tower from the same
    state dict (bf16, against the f32 classifier) over ZS_IMAGES images and
    labels from a seed, plain and with a forward hook, each equal to a plain
    top-k count on the same logits.  Returns the
    f32 classifier's transpose ([ZS_CLASSES, 512]) for the SAE evals and the
    phase's launches."""
    from vit_prisma_tpu_torch import load_hooked_model
    from vit_prisma_tpu_torch.dataloaders.imagenet_names import get_imagenet_text_labels
    from vit_prisma_tpu_torch.model_eval import zero_shot as Z
    from vit_prisma_tpu_torch.models.loading.registry import get_model_config
    from vit_prisma_tpu_torch.utils.clip_tokenizer import CLIPTokenizer
    from vit_prisma_tpu_torch.utils.openai_templates import OPENAI_IMAGENET_TEMPLATE_STRINGS
    phase_t0 = time.perf_counter()
    counters = _sae_counters()
    vcfg = get_model_config(TEXT_MODEL)
    tcfg = get_model_config(TEXT_MODEL, model_type="text")
    sd = hf_clip_state_dict(vcfg, tcfg, seed=0)
    n_params = sum(v.numel() for k, v in sd.items() if k.startswith("text"))

    def load(**kw):
        return load_hooked_model(TEXT_MODEL, model_type="text", state_dict=sd, **kw)

    t0 = time.perf_counter()
    raw = load(device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    processing = dict(fold_ln=True, center_writing_weights=True, fold_value_biases=True)
    proc = load(device="cuda", **processing)

    # the tokenizer: a merge table learned from the prompts
    names = get_imagenet_text_labels()[:ZS_CLASSES]
    templates = OPENAI_IMAGENET_TEMPLATE_STRINGS
    t0 = time.perf_counter()
    tok = CLIPTokenizer(train_merges(names, templates))
    merges_s = time.perf_counter() - t0
    prompts = [t.format(c=c) for c in names[:4] for t in templates][:TEXT_BATCH]
    toks = torch.from_numpy(tok(prompts)).cuda()

    # f32: processed against raw, the card against the CPU
    out_raw, out_proc = raw(toks), proc(toks)
    processed_err = check_close("text processed vs raw", out_proc, out_raw,
                                text_atol(TEXT_PROCESSED_REL, out_raw))
    cpu = load(device="cpu")
    small = toks[:TEXT_CPU_BATCH]
    out_cpu = cpu(small.cpu())
    f32_limit = text_atol(TEXT_F32_REL, out_cpu)
    f32_cpu_err = check_close("text f32 card vs cpu", raw(small), out_cpu, f32_limit)
    # the lower-precision control: the same forward with TF32 GEMMs
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32_err = (raw(small).cpu() - out_cpu).abs().max().item()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    if not tf32_err > max(f32_limit, text_atol(TEXT_PROCESSED_REL, out_raw)):
        raise AssertionError(f"text f32 limits {f32_limit} pass a TF32 forward ({tf32_err})")
    _, got = raw.run_with_cache(small, names_filter=RESID_POST, incl_bwd=True,
                                loss_fn=_metric, return_cache_object=False)
    _, want = cpu.run_with_cache(small.cpu(), names_filter=RESID_POST, incl_bwd=True,
                                 loss_fn=_metric, return_cache_object=False)
    f32_grad_errs = _cache_grad_errs(got, want, GRAD_F32_REL)
    del proc, got, want

    # The main path: the bf16 forward, with every count set to 0 just before it.
    bf16 = load(device="cuda", dtype="bfloat16")
    release()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(counters)
    out = bf16(toks)
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters.items() if f.launches}
    if launches != {"attention_mix_tnh": tcfg.n_layers}:
        raise AssertionError(f"text forward launches {launches}")
    if tuple(out.shape) != (TEXT_BATCH, tcfg.n_classes) or not torch.isfinite(out).all():
        raise AssertionError(f"text forward {tuple(out.shape)}")
    einsum = bf16.with_cfg(use_fused_attention=False)
    fused_ln = bf16.with_cfg(use_fused_ln_gemm=True)
    _zero_counts(counters)
    out_e = einsum(toks)
    torch.cuda.synchronize()
    if any(f.launches for f in counters.values()):
        raise AssertionError("the text einsum path launched a kernel")
    out_ln = fused_ln(toks)
    torch.cuda.synchronize()
    ln_launches = {k: f.launches for k, f in counters.items() if f.launches}
    if ln_launches != {"attention_mix_tnh": tcfg.n_layers, "ln_matmul": 2 * tcfg.n_layers}:
        raise AssertionError(f"text fused-LN launches {ln_launches}")
    bf16_limit = text_atol(TEXT_BF16_REL, out_e)
    bf16_errs = {"einsum": check_close("text bf16 kernel vs einsum", out, out_e, bf16_limit),
                 "fused_ln": check_close("text bf16 fused LN vs unfused", out_ln, out,
                                         text_atol(TEXT_BF16_REL, out))}
    # the control: the same weights without the causal mask
    unmasked_err = (bf16.with_cfg(causal_attention=False)(toks).float()
                    - out_e.float()).abs().max().item()
    if not unmasked_err > bf16_limit:
        raise AssertionError(f"text bf16 limit {bf16_limit} passes the unmasked tower "
                             f"({unmasked_err})")
    models = {"kernel": bf16, "einsum": einsum, "fused_ln": fused_ln}
    turns = []
    for name in TEXT_TURNS + ("fused_ln",):
        model = models[name]
        model(toks)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TEXT_TIMED):
            model(toks)
        torch.cuda.synchronize()
        seconds = (time.perf_counter() - t0) / TEXT_TIMED
        turns.append({"path": name, "ms": seconds * 1e3, "prompts_per_s": TEXT_BATCH / seconds})

    # the gradient cache over the 12 resid_post hooks, bf16: the first call
    # counted, then GRAD_TIMED calls timed
    _zero_counts(counters)
    _, cache = bf16.run_with_cache(toks, names_filter=RESID_POST, incl_bwd=True,
                                   loss_fn=_metric, return_cache_object=False)
    torch.cuda.synchronize()
    grad_launches = {k: f.launches for k, f in counters.items() if f.launches}
    if grad_launches != {"attention_mix_tnh": tcfg.n_layers,
                         "attention_mix_tnh_bwd": tcfg.n_layers - 1}:
        raise AssertionError(f"text gradient launches {grad_launches}")
    t0 = time.perf_counter()
    for _ in range(GRAD_TIMED):
        bf16.run_with_cache(toks, names_filter=RESID_POST, incl_bwd=True, loss_fn=_metric,
                            return_cache_object=False)
    torch.cuda.synchronize()
    grad_s = (time.perf_counter() - t0) / GRAD_TIMED
    _, cache_e = einsum.run_with_cache(toks, names_filter=RESID_POST, incl_bwd=True,
                                       loss_fn=_metric, return_cache_object=False)
    bf16_grad_errs = _cache_grad_errs(cache, cache_e, GRAD_BF16_REL)
    if not all(cache[k].abs().max() > 0 for k in cache if k.endswith("_grad")):
        raise AssertionError("a text resid_post gradient is all zeros")
    peak = torch.cuda.max_memory_allocated() / 1e9
    del einsum, fused_ln, cache, cache_e

    # the zero-shot classifier, f32 and bf16, the tokenizer timed apart
    tally = {}

    def timed_tok(texts):
        t0 = time.perf_counter()
        ids = tok(texts)
        tally["s"] += time.perf_counter() - t0
        # rows that reach the context's end: truncated, or exactly 77 long
        tally["full"] += int((ids[:, -1] != 0).sum())
        return ids

    classifiers, builds = {}, {}
    for name, model in (("f32", raw), ("bf16", bf16)):
        tally.update(s=0.0, full=0)
        _zero_counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c = Z.zero_shot_classifier(model, timed_tok, names, templates)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        forwards = len(names) * -(-len(templates) // 64)
        b = {k: f.launches for k, f in counters.items() if f.launches}
        if b != {"attention_mix_tnh": tcfg.n_layers * forwards}:
            raise AssertionError(f"classifier {name} launches {b}, {forwards} forwards")
        if tuple(c.shape) != (tcfg.n_classes, len(names)) or c.dtype != model.cfg.torch_dtype:
            raise AssertionError(f"classifier {name}: {tuple(c.shape)} {c.dtype}")
        norm_err = (torch.linalg.norm(c.float(), dim=0) - 1).abs().max().item()
        if not norm_err <= ZS_NORM_TOL[c.dtype]:
            raise AssertionError(f"classifier {name} column norms off by {norm_err}")
        classifiers[name] = c
        builds[name] = {"s": total, "tokenizer_s": tally["s"],
                        "encoder_and_rest_s": total - tally["s"], "forwards": forwards,
                        "launches": b, "column_norm_err": norm_err}
    full = tally["full"]
    truncated = sum(len(tok.encode(t.format(c=c))) + 2 > tcfg.context_length
                    for c in names for t in templates) if full else 0
    t0 = time.perf_counter()
    cpu_c = Z.zero_shot_classifier(cpu, tok, names[:ZS_CPU_CLASSES], templates)
    cpu_s = time.perf_counter() - t0
    cpu_err = check_close("classifier card vs cpu", classifiers["f32"][:, :ZS_CPU_CLASSES],
                          cpu_c, text_atol(TEXT_F32_REL, cpu_c))
    bf16_vs_f32 = check_close("classifier bf16 vs f32", classifiers["bf16"], classifiers["f32"],
                              text_atol(TEXT_BF16_REL, classifiers["f32"]))
    del cpu, cpu_c, raw, bf16
    release()

    # zero-shot evaluation of the vision tower from the same state dict
    vision = load_hooked_model(TEXT_MODEL, state_dict=sd, device="cuda", dtype="bfloat16")
    classifier = classifiers["f32"]
    g = torch.Generator(device="cuda").manual_seed(61)
    images = torch.randn(ZS_IMAGES, 3, vcfg.image_size, vcfg.image_size, generator=g,
                         device="cuda").bfloat16()
    labels = torch.randint(0, len(names), (ZS_IMAGES,), generator=g, device="cuda")
    batches = [(images[i:i + ZS_BATCH], labels[i:i + ZS_BATCH])
               for i in range(0, ZS_IMAGES, ZS_BATCH)]
    hooks = [("blocks.6.hook_resid_post", lambda v, hook: v * 0.5)]
    evals = {}
    for name, fwd_hooks in (("plain", None), ("hooked", hooks)):
        _zero_counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = Z.zero_shot_eval(vision, {"imagenet-val": batches},
                               pretrained_classifier=classifier, fwd_hooks=fwd_hooks)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        b = {k: f.launches for k, f in counters.items() if f.launches}
        if b != {"attention_mix_tnh": vcfg.n_layers * len(batches)}:
            raise AssertionError(f"zero_shot_eval {name} launches {b}")
        hits = [0.0, 0.0]
        for x, y in batches:
            feats = vision(x) if fwd_hooks is None else vision.run_with_hooks(x, fwd_hooks)
            for i, h in enumerate(_zs_plain_counts((100.0 * feats).float() @ classifier, y)):
                hits[i] += h
        want = [h / ZS_IMAGES for h in hits]
        got = [res["imagenet-zeroshot-val-top1"], res["imagenet-zeroshot-val-top5"]]
        if got != want:
            raise AssertionError(f"zero_shot_eval {name}: {got}, plain top-k counts {want}")
        evals[name] = {"top1": got[0], "top5": got[1], "s": seconds,
                       "img_per_s": ZS_IMAGES / seconds, "launches": b}
    del vision, images, batches

    emit({"phase": "text", **info, "model": TEXT_MODEL, "n_layers": tcfg.n_layers,
          "d_model": tcfg.d_model, "n_heads": tcfg.n_heads, "vocab_size": tcfg.vocab_size,
          "context_length": tcfg.context_length, "text_params": n_params,
          "source": "HF CLIPModel layout, seed 0 (hf_clip_state_dict with the text tower)",
          "load_s": load_s, "output_absmax": out_raw.abs().max().item(),
          "processed_vs_raw_max_abs_err": processed_err,
          "processed_rel_tol": TEXT_PROCESSED_REL,
          "f32_card_vs_cpu": {"batch": TEXT_CPU_BATCH, "output_max_abs_err": f32_cpu_err,
                              "rel_tol": TEXT_F32_REL, "atol": f32_limit,
                              "tf32_control_max_abs_err": tf32_err,
                              "grad_max_abs_err": f32_grad_errs,
                              "grad_rel_tol": GRAD_F32_REL},
          "tokenizer": {"merges": len(tok.ranks), "vocab": tok.vocab_size,
                        "train_merges_s": merges_s, "prompts": len(names) * len(templates),
                        "rows_filling_context": full, "truncated": truncated},
          "batch": TEXT_BATCH, "dtype": "bfloat16", "launches": launches,
          "fused_ln_launches": ln_launches, "bf16_max_abs_err": bf16_errs,
          "bf16_rel_tol": TEXT_BF16_REL, "bf16_atol": bf16_limit,
          "unmasked_control_max_abs_err": unmasked_err, "turns": turns,
          "forward_tflop": _text_forward_tflop(tcfg, TEXT_BATCH),
          "grad": {"s": grad_s, "prompts_per_s": TEXT_BATCH / grad_s,
                   "launches": grad_launches, "bf16_vs_einsum_max_abs_err": bf16_grad_errs,
                   "rel_tol": GRAD_BF16_REL},
          "peak_memory_GB": peak,
          "classifier": {**builds, "classes": len(names), "templates": len(templates),
                         "tflop": _text_forward_tflop(tcfg, len(names) * len(templates)),
                         "cpu_classes": ZS_CPU_CLASSES, "cpu_s": cpu_s,
                         "card_vs_cpu_max_abs_err": cpu_err, "rel_tol": TEXT_F32_REL,
                         "bf16_vs_f32_max_abs_err": bf16_vs_f32,
                         "bf16_rel_tol": TEXT_BF16_REL},
          "zero_shot_eval": {"images": ZS_IMAGES, "batch": ZS_BATCH, "vision_dtype": "bfloat16",
                             "classifier_dtype": "float32", "hook": hooks[0][0] + " * 0.5",
                             **evals},
          "phase_s": time.perf_counter() - phase_t0})
    # B1 over the phase's counted parts, B2 and B14 on theirs
    parts = [launches, ln_launches, grad_launches] + [r["launches"] for r in builds.values()]
    parts += [r["launches"] for r in evals.values()]
    text_launches = {"attention_mix_tnh": sum(p["attention_mix_tnh"] for p in parts),
                     "attention_mix_tnh_bwd": grad_launches["attention_mix_tnh_bwd"],
                     "ln_matmul": ln_launches["ln_matmul"]}
    return classifier.T.contiguous(), text_launches


def _text_forward_tflop(cfg, n_prompts) -> float:
    """The text forward's products over n_prompts of context_length tokens:
    QKV, O and the MLP per token, the causal scores and PV per kept pair,
    and the head on the pooled rows."""
    T, D, M, L = cfg.context_length, cfg.d_model, cfg.d_mlp, cfg.n_layers
    per_prompt = L * (T * 2 * (4 * D * D + 2 * D * M) + 2 * 2 * (T * (T + 1) // 2) * D)
    return n_prompts * (per_prompt + 2 * D * cfg.n_classes) / 1e12


# -- phase `data`: the image pipeline into the activation store ------------

# The card's host has neither the libjpeg headers nor the library (no
# jpeglib.h, no libjpeg.so in ldconfig), so the native loader cannot be
# built there: the JPEG steps are left out by this fixed decision,
# and the store's steps read seeded uint8 arrays.  Set it where g++ finds
# jpeglib.h and libjpeg.
DATA_JPEG = False
DATA_FIXTURES = "tests/fixtures/jpeg"
DATA_PATHS = 4096             # the fixtures repeated
DATA_BATCH = 32               # images a loader batch and a store batch
DATA_WORKERS = (4, min(os.cpu_count() or 1, 16))
DATA_LOADER_BATCHES = 64      # timed loader batches, after 4 warm-up ones
DATA_POOL_TOL = 0.05          # a fixture's 8 x 8 pool against the manifest
DATA_IMAGES = 2048            # seeded uint8 images of the host-fed stream
DATA_BUFFER_BATCHES = 1       # the default SAE's buffer: fill 4,096 images
DATA_STEPS = 30               # across the one refill, at step 26
DATA_CHECK_BUFFER = 16_384    # rows of the stores of the bitwise checks
# uint8 rows against float32 rows of the same images: the seeded arrays'
# float32 images are the uint8 pixels normalized on the host (rounding
# alone), the loader's are not quantized (half a pixel step at most)
DATA_ROW_REL = 5e-2 if DATA_JPEG else 1e-4
DATA_CYCLE_IMAGES = 1024      # a uint8 device-resident dataset (154 MB)
DATA_CYCLE_BUFFER = 32_768    # half: 4 steps a cycle
DATA_CYCLES = 2
DATA_CACHE_BUFFER = 65_536
DATA_CACHE_SHARDS = 6
DATA_CACHE_SHARD_ROWS = 20_000  # a refill's 32,768 fresh rows span shards


def _data_host() -> dict:
    """What the host offers the native loader (facts, read, not tried)."""
    def first_line(cmd):
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
        return (out.stdout or out.stderr).strip().splitlines()[:1]
    ldconfig = subprocess.run(["ldconfig", "-p"], capture_output=True, text=True,
                              timeout=60).stdout
    try:
        import PIL
        pil = PIL.__version__
    except ImportError:
        pil = None
    return {"cpu_count": os.cpu_count(), "cpu_affinity": len(os.sched_getaffinity(0)),
            "gxx": first_line(["g++", "--version"]),
            "jpeglib_h": os.path.exists("/usr/include/jpeglib.h"),
            "libjpeg": [l.strip() for l in ldconfig.splitlines()
                        if "libjpeg" in l or "libturbojpeg" in l],
            "PIL": pil}


def _data_jpeg_checks() -> dict:
    """The native library's build, each fixture's decode against the
    manifest, and the loader's images per second by wire and workers."""
    import hashlib
    from vit_prisma_tpu_torch.dataloaders import native
    t0 = time.perf_counter()
    _, built = native.build_library()
    out = {"library_built": built, "library_s": time.perf_counter() - t0}
    manifest = _data_manifest()
    equal, worst = 0, 0.0
    for f in manifest["files"]:
        with open(os.path.join(DATA_FIXTURES, f["name"]), "rb") as fh:
            data = fh.read()
        if hashlib.sha256(data).hexdigest() != f["sha256"]:
            raise AssertionError(f"fixture {f['name']} differs from its manifest")
        img = native.decode_and_preprocess(data, manifest["out_size"])
        equal += hashlib.sha256(img.tobytes()).hexdigest() == f["out_sha256"]
        p, s = manifest["pool"], manifest["out_size"]
        pool = img.reshape(3, p, s // p, p, s // p).mean(axis=(2, 4))
        worst = max(worst, float(np.abs(pool - np.asarray(f["out_pool8"])).max()))
    if not worst <= DATA_POOL_TOL:
        raise AssertionError(f"fixture decodes {worst} from the manifest's pools")
    out.update(fixtures=len(manifest["files"]), decodes_equal_to_manifest=equal,
               pool8_max_diff=worst, pool8_tol=DATA_POOL_TOL)
    paths = _data_paths()
    for wire in ("float32", "uint8"):
        for workers in DATA_WORKERS:
            ld = native.NativeBatchLoader(paths, DATA_BATCH, 224, n_workers=workers,
                                          uint8_wire=wire == "uint8")
            for _ in range(4):
                next(ld)
            t0 = time.perf_counter()
            for _ in range(DATA_LOADER_BATCHES):
                next(ld)
            out[f"loader_img_per_s_{wire}_{workers}_workers"] = \
                DATA_LOADER_BATCHES * DATA_BATCH / (time.perf_counter() - t0)
            if ld.decode_failures():
                raise AssertionError(f"{ld.decode_failures()} decode failures")
            ld.close()
    return out


def _data_manifest() -> dict:
    with open(os.path.join(DATA_FIXTURES, "MANIFEST.json")) as fh:
        return json.load(fh)


def _data_paths():
    names = [f["name"] for f in _data_manifest()["files"]]
    return [os.path.join(DATA_FIXTURES, names[i % len(names)]) for i in range(DATA_PATHS)]


def _data_arrays():
    """The seeded uint8 images and their float32 normalization (CLIP's
    statistics, the default model's), on the host."""
    from vit_prisma_tpu_torch.dataloaders.transforms import CLIP_MEAN, CLIP_STD
    raw = np.random.default_rng(5).integers(0, 256, (DATA_IMAGES, 3, 224, 224), dtype=np.uint8)
    mean = np.asarray(CLIP_MEAN, np.float32).reshape(1, 3, 1, 1)
    std = np.asarray(CLIP_STD, np.float32).reshape(1, 3, 1, 1)
    return raw, (raw.astype(np.float32) / 255.0 - mean) / std


def _data_source(wire, arrays, workers):
    """The host-fed stream on ``wire``: a native loader over the fixtures or
    the seeded arrays (kept on the host), and the store's extra arguments."""
    if DATA_JPEG:
        from vit_prisma_tpu_torch.dataloaders.native import NativeBatchLoader
        return NativeBatchLoader(_data_paths(), DATA_BATCH, 224, n_workers=workers,
                                 uint8_wire=wire == "uint8"), {}
    return arrays[0] if wire == "uint8" else arrays[1], {"device_dataset": False}


def _data_run(model, cfg, arrays, prefetch, counters):
    """One feed of the default SAE: fill, ``run(DATA_STEPS)`` across a
    refill, with every count set to 0 just before and read just after."""
    from vit_prisma_tpu_torch.sae import VisionActivationsStore, VisionSAETrainer
    source, kw = _data_source(cfg.store_wire_dtype, arrays, DATA_WORKERS[-1])
    torch.cuda.synchronize()
    _zero_counts(counters)
    t0 = time.perf_counter()
    store = VisionActivationsStore(cfg, model, source, prefetch=prefetch, **kw)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    trainer = VisionSAETrainer(cfg, model, store)
    refills = _time_refills(store)
    log = _record_logs(trainer)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    trainer.run(max_steps=DATA_STEPS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t1
    launches = {k: f.launches for k, f in counters.items()}
    store.close()
    if DATA_JPEG:
        source.close()
    per_batch = store.tokens_per_store_batch
    n_fill = -(-cfg.tokens_per_buffer // per_batch)
    n_fresh = -(-(cfg.tokens_per_buffer // 2) // per_batch)
    expected = dict.fromkeys(counters, 0)
    expected.update({"attention_mix_tnh": (cfg.hook_point_layer + 1)
                     * (n_fill + len(refills) * n_fresh),
                     "take_rows": 1 + len(refills),
                     "adam_update": len(trainer.state.params) * DATA_STEPS})
    if len(refills) != 1 or launches != expected:
        raise AssertionError(f"data launches {launches}, expected {expected}, "
                             f"{len(refills)} refills")
    item = 3 * 224 * 224 * (1 if cfg.store_wire_dtype == "uint8" else 4)
    block = n_fresh * cfg.store_batch_size * item
    want_bytes = n_fill * cfg.store_batch_size * item + (len(refills) + prefetch) * block
    if store.bytes_to_device != want_bytes:
        raise AssertionError(f"{store.bytes_to_device} bytes sent, expected {want_bytes}")
    if not log or not all(math.isfinite(v) for vals in log for v in vals.values()) \
            or not log[-1]["l0"] > 0:
        raise AssertionError(f"metrics {log[-1:]}")
    tokens = DATA_STEPS * cfg.train_batch_size
    return launches, {"wire": cfg.store_wire_dtype, "prefetch": prefetch,
                      "fill_s": fill_s, "refill_s": refills[0], "run_s": run_s,
                      "bytes_per_refill": block, "fill_bytes": n_fill * cfg.store_batch_size
                      * item, "sae_tokens_per_s": tokens / run_s,
                      "sae_tokens_per_s_without_refill": tokens / (run_s - refills[0]),
                      "launches": launches}


def _data_rows_check(model, cfg, arrays):
    """Bitwise: prefetch on and off serve the same rows (one loader worker:
    batches in order); uint8 rows against float32 rows of the same images."""
    from vit_prisma_tpu_torch.sae import VisionActivationsStore
    cfg = cfg.replace(buffer_tokens_override=DATA_CHECK_BUFFER)
    rows, sources = {}, []
    for name, wire, prefetch in (("on", "uint8", True), ("off", "uint8", False),
                                 ("f32", "float32", True)):
        source, kw = _data_source(wire, arrays, 1)
        sources.append(source)
        store = VisionActivationsStore(cfg.replace(store_wire_dtype=wire), model, source,
                                       prefetch=prefetch, **kw)
        rows[name] = torch.cat([store.buffer.clone()] + [store.next_batch() for _ in range(6)])
        store.close()
    if DATA_JPEG:
        for source in sources:
            source.close()
    if not torch.equal(rows["on"], rows["off"]):
        raise AssertionError("prefetch changed the rows")
    scale = rows["f32"].abs().max().item()
    err = (rows["on"] - rows["f32"]).abs().max().item()
    if not err <= DATA_ROW_REL * scale:
        raise AssertionError(f"uint8 rows {err} from float32 rows (absmax {scale})")
    return {"prefetch_rows_bitwise": True, "rows": rows["on"].shape[0],
            "uint8_vs_f32_max_abs_err": err, "f32_rows_absmax": scale,
            "uint8_vs_f32_rel_limit": DATA_ROW_REL}


def _smoke_augment(generator, images):
    """A seeded augment: a random horizontal flip per image and noise."""
    flip = torch.rand((images.shape[0], 1, 1, 1), generator=generator,
                      device=images.device) < 0.5
    images = torch.where(flip, images.flip(-1), images)
    return images + 0.05 * torch.randn(images.shape, generator=generator,
                                       device=images.device, dtype=images.dtype)


def _data_cycles(model, cfg, counters):
    """A uint8 device-resident dataset with a seeded augment through
    ``train_cycles``, against the stepwise path from the same state: the
    same buffer and parameters, to the bit; the cycles' launches exact."""
    from vit_prisma_tpu_torch.sae import VisionActivationsStore, VisionSAETrainer
    cfg = cfg.replace(buffer_tokens_override=DATA_CYCLE_BUFFER, store_wire_dtype="auto")
    raw = torch.from_numpy(np.random.default_rng(6).integers(
        0, 256, (DATA_CYCLE_IMAGES, 3, 224, 224), dtype=np.uint8).copy()).cuda()
    pairs = []
    for _ in range(2):
        store = VisionActivationsStore(cfg, model, raw, augment=_smoke_augment)
        pairs.append((VisionSAETrainer(cfg, model, store), store))
    half = pairs[0][1].buffer.shape[0] // 2
    K = half // cfg.train_batch_size
    for trainer, store in pairs:
        if store._dev_images.dtype != torch.uint8 or store._wire_dtype != torch.uint8:
            raise AssertionError("the cycles' dataset is not uint8 on the card")
        trainer.train_steps(store.next_batches(K))
    torch.cuda.synchronize()
    _zero_counts(counters)
    t0 = time.perf_counter()
    pairs[0][0].train_cycles(DATA_CYCLES)
    torch.cuda.synchronize()
    cycles_s = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counters.items()}
    for _ in range(DATA_CYCLES):
        pairs[1][0].train_steps(pairs[1][1].next_batches(K))
    n_fresh = -(-half // pairs[0][1].tokens_per_store_batch)
    expected = dict.fromkeys(counters, 0)
    expected.update({"attention_mix_tnh": (cfg.hook_point_layer + 1) * n_fresh * DATA_CYCLES,
                     "take_rows": DATA_CYCLES, "adam_update": 4 * K * DATA_CYCLES})
    if launches != expected:
        raise AssertionError(f"cycle launches {launches}, expected {expected}")
    (ta, sa), (tb, sb) = pairs
    if not torch.equal(sa.buffer, sb.buffer) or not all(
            torch.equal(ta.state.params[k], tb.state.params[k]) for k in ta.state.params):
        raise AssertionError("train_cycles differs from the stepwise path")
    return launches, {"images": DATA_CYCLE_IMAGES, "cycles": DATA_CYCLES, "steps_a_cycle": K,
                      "cycles_s": cycles_s, "bitwise_equal_to_stepwise": True,
                      "augment": "seeded flip + noise", "launches": launches}


def _data_cached(model, cfg, counters):
    """Float16 shards of a uint8 device-resident dataset's harvest in a
    temporary directory (deleted after); ``CachedActivationsStore`` across a
    refill whose fresh rows span two shards, against the float16 harvest."""
    import shutil
    import tempfile
    from vit_prisma_tpu_torch.sae import CachedActivationsStore, VisionActivationsStore
    raw = np.random.default_rng(7).integers(0, 256, (DATA_CYCLE_IMAGES, 3, 224, 224),
                                            dtype=np.uint8)
    cfg = cfg.replace(buffer_tokens_override=DATA_CACHE_BUFFER, store_wire_dtype="auto")
    live = VisionActivationsStore(cfg, model, raw)
    chunks, fill = [], live._fill

    def kept_fill(n, *args, **kwargs):
        out = fill(n, *args, **kwargs)
        chunks.append(out.to(torch.float16))
        return out
    live._fill = kept_fill
    tmp = tempfile.mkdtemp(prefix="smoke_shards_")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = live.generate_cached_activations(tmp, DATA_CACHE_SHARDS * DATA_CACHE_SHARD_ROWS,
                                             DATA_CACHE_SHARD_ROWS)
        write_s = time.perf_counter() - t0
        written = sum(os.path.getsize(os.path.join(tmp, f)) for f in os.listdir(tmp))
        perms = []

        def recorded(m):
            perms.append(torch.randperm(m, device="cuda", generator=gen))
            return perms[-1]
        gen = torch.Generator(device="cuda").manual_seed(cfg.seed)
        torch.cuda.synchronize()
        _zero_counts(counters)
        t0 = time.perf_counter()
        cached = CachedActivationsStore(cfg, tmp, device="cuda", permutation=recorded)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        rows = cfg.tokens_per_buffer
        want = torch.cat(chunks)[:rows].float()[perms[0]]
        if n != DATA_CACHE_SHARDS or not torch.equal(cached.buffer, want):
            raise AssertionError("the cached store's buffer is not the float16 harvest")
        before = cached.buffer.clone()
        half = rows // 2
        cached.next_batches(half // cfg.train_batch_size)
        t0 = time.perf_counter()
        cached.next_batch()  # refills
        torch.cuda.synchronize()
        refill_s = time.perf_counter() - t0
        n_init = -(-rows // DATA_CACHE_SHARD_ROWS)
        fresh = torch.cat(chunks[n_init:])[:rows - half].float()
        if n_init + 2 > n or fresh.shape[0] <= DATA_CACHE_SHARD_ROWS:
            raise AssertionError("the refill does not span two shards")
        want = torch.cat([before[half:], fresh])[perms[1]]
        if not torch.equal(cached.buffer, want):
            raise AssertionError("the cached store's refill is not the float16 harvest")
        launches = {k: f.launches for k, f in counters.items()}
        if launches != {**dict.fromkeys(counters, 0), "take_rows": 2}:
            raise AssertionError(f"cached store launches {launches}")
    finally:
        shutil.rmtree(tmp)
    return {"shards": n, "shard_rows": DATA_CACHE_SHARD_ROWS, "MB_written": written / 1e6,
            "write_s_with_harvest": write_s, "MB_per_s_with_harvest": written / 1e6 / write_s,
            "load_s": load_s, "refill_s": refill_s, "buffer_rows": rows,
            "refill_spans_shards": [n_init, n_init + 1], "launches": launches}


def phase_data(info):
    """The image pipeline into the store: the host's facts; with DATA_JPEG
    the native library's build, the fixtures against their manifest and the
    loader's images per second; the default SAE fed three ways (float32
    wire, uint8 wire with and without prefetch) with exact launches; the
    rows of prefetch on and off to the bit, uint8 against float32 rows;
    ``train_cycles`` on a uint8 device dataset with a seeded augment against
    the stepwise path; float16 shards and ``CachedActivationsStore``."""
    from vit_prisma_tpu_torch import HookedViT, get_model_config
    from vit_prisma_tpu_torch.sae import SAERunnerConfig
    t_phase = time.perf_counter()
    rec = {"phase": "data", **info, "host": _data_host(), "jpeg_steps": DATA_JPEG}
    if DATA_JPEG:
        rec.update(_data_jpeg_checks())
    else:
        rec["source"] = (f"{DATA_IMAGES} seeded uint8 224 px images (numpy seed 5) and their "
                         "float32 normalization, on the host: the card's host has no libjpeg")
    counters = _sae_counters()
    cfg = SAERunnerConfig(n_batches_in_buffer=DATA_BUFFER_BATCHES)
    model = HookedViT(get_model_config(cfg.model_name), device="cuda",
                      generator=torch.Generator().manual_seed(0))
    arrays = None if DATA_JPEG else _data_arrays()
    release()
    torch.cuda.reset_peak_memory_stats()
    launches, runs = {}, {}
    for name, wire, prefetch in (("f32_wire", "float32", True),
                                 ("uint8_prefetch", "uint8", True),
                                 ("uint8_no_prefetch", "uint8", False)):
        launches[name], runs[name] = _data_run(model, cfg.replace(store_wire_dtype=wire),
                                               arrays, prefetch, counters)
        release()
    rec["runs"] = runs
    rec["rows_check"] = _data_rows_check(model, cfg, arrays)
    launches["cycles"], rec["cycles"] = _data_cycles(model, cfg, counters)
    release()
    rec["cached"] = _data_cached(model, cfg, counters)
    rec.update(peak_memory_GB=torch.cuda.max_memory_allocated() / 1e9,
               phase_s=time.perf_counter() - t_phase)
    emit(rec)
    return {k: sum(l[k] for l in launches.values()) for k in counters}


# sae_variants: the SAE variants at B/32 width (12 x 768, random weights from
# seed 0, float32).  A transcoder from blocks.9.hook_resid_mid to
# blocks.9.hook_mlp_out (768 -> 12,288 -> 768, W_skip, train batch 4096) on
# the train phase's 2-batch buffer (409,600 rows of [2, 768] float32, 6,144 B:
# fill 8,192 images, 4,096 a refill), VARIANT_STEPS steps across one refill
# (at step 51): B1 10 a store batch (stop at layer 10), B3 one a mix, B7 6 a
# step.  Then, on the store's input rows, default ReLU SAEs (768 -> 12,288)
# with ghost grads, each normalization and the TopK row with
# topk_use_approx, drawn from seed 0 with the geometric-median b_dec, each
# trained VARIANT_WARM_STEPS steps on the card first (Adam's first step is
# lr * sign(g), which a near-zero gradient's rounding can flip), then one
# step held to the CPU's as phase 6 holds three (step_check's bounds).
# Ghost grads: a seeded quarter of the features marked dead through
# n_forward_passes_since_fired.  Last, a reference-format checkpoint of the
# trained transcoder and a legacy SAELens-v2 dump of the ghost SAE, written
# at full width in a temporary directory, loaded onto the card and stepped.
VARIANT_BUFFER_BATCHES = 2
VARIANT_STEPS = 60
VARIANT_WARM_STEPS = 5
VARIANT_DEAD_SEED = 7
# The ghost loss is ill-conditioned in float32 (in JAX as here): it rescales
# each element by mse / (mse_ghost + 1e-6), so an element whose ghost fit is
# near exact turns its rounding into a large change of its gradient term,
# and such elements dominate the ghost gradient.  The entries the ghost
# loss reaches are held to the CPU within the larger of step_check's bound
# and twice the spread of either device's own gradients when x moves by one
# or two ulps (SPREAD_PERTURBATIONS), as the CPU tests hold the port to JAX
# (``_step_against_cpu``).
SPREAD_PERTURBATIONS = tuple(1 + s * 2.0 ** -e for e in (23, 22) for s in (1, -1))
# float32 exp overflows past log(FLT_MAX) = 88.72: the ghost loss's
# exp(hidden_pre) * mask is then inf * 0 = NaN for an alive feature, in JAX
# as here; the phase counts such pre-activations.
EXP_OVERFLOW = 88.72


def _variant_state(cfg, sample, seed=0):
    """A fresh train state on the card: parameters drawn from ``seed``,
    b_dec by ``cfg``'s method from ``sample``."""
    from vit_prisma_tpu_torch.sae import init_train_state, initialize_b_dec
    from vit_prisma_tpu_torch.sae.sae import init_sae_params
    params = init_sae_params(cfg, torch.Generator().manual_seed(seed), "cuda")
    return init_train_state(cfg, params=initialize_b_dec(cfg, params, sample))


def _grad_spread(state, cfg, x, y, grads):
    """How far one device's own gradients ``grads`` move, relative to their
    absmax, when x moves by one or two ulps (SPREAD_PERTURBATIONS)."""
    from vit_prisma_tpu_torch.sae.sae import set_decoder_norm_to_unit_norm
    from vit_prisma_tpu_torch.sae.train import loss_and_grads
    dead = state.n_forward_passes_since_fired > cfg.dead_feature_window
    params = set_decoder_norm_to_unit_norm(state.params)
    spread = dict.fromkeys(grads, 0.0)
    for f in SPREAD_PERTURBATIONS:
        moved, _ = loss_and_grads(params, x * f, cfg, dead, y)
        for k in grads:
            d = (moved[k] - grads[k]).abs().max().item() / grads[k].abs().max().item()
            spread[k] = max(spread[k], d)
    return spread


def _feature_parts(key, ghost, hit):
    """Boolean masks (alive, ghost, switched) over the entries of the
    tensor ``key`` names (``W_enc``, ``mu/W_dec``, ...): by feature, its last
    axis for W_enc and b_enc and its first for W_dec; b_dec, which every
    dead feature's ghost term reaches, is wholly ghost where any is dead.
    ReLU switches (``hit``) only split W_enc and b_enc, as phase 6 does."""
    name = key.rsplit("/", 1)[-1]
    any_ghost = bool(ghost.any())
    if name in ("W_enc", "b_enc"):
        return ~ghost & ~hit, ghost & ~hit, hit
    if name == "W_dec":
        none = torch.zeros_like(ghost)
        return ~ghost[:, None], ghost[:, None], none[:, None]
    whole = torch.ones((), dtype=torch.bool)
    return (~whole if name == "b_dec" and any_ghost else whole,
            whole if name == "b_dec" and any_ghost else ~whole, ~whole)


def _part_max(d, mask):
    mask = mask.expand(d.shape)
    return float(d[mask].max()) if mask.any() else 0.0


def _step_against_cpu(name, state, cfg, x, y=None):
    """One step from ``state`` on the card and on the CPU in float32 (with
    ``y``, a transcoder's target): step-1 gradients, then params, moments and
    counters, held as phase 6 holds them (``check_steps``).  With ghost
    grads, the entries the ghost loss reaches (the dead features' W_enc
    columns, b_enc entries and W_dec rows, and b_dec) may differ by up to
    twice either device's own spread (``_grad_spread``) where that exceeds
    phase 6's gradient bound, and their params and moments by phase 6's
    bounds times the same ratio (twice it for nu, Adam's second moment of
    the gradient); alive features keep phase 6's bounds.  The ghost parts'
    errors are divided by their widening before ``check_steps`` reads
    them."""
    from vit_prisma_tpu_torch.sae.convert import train_state_to_numpy
    from vit_prisma_tpu_torch.sae.sae import encode, set_decoder_norm_to_unit_norm
    from vit_prisma_tpu_torch.sae.train import loss_and_grads, sae_train_step
    cpu = _state_to(state, "cpu")
    xc, yc = x.cpu(), None if y is None else y.cpu()
    dead = state.n_forward_passes_since_fired > cfg.dead_feature_window
    pg = set_decoder_norm_to_unit_norm(state.params)
    pc = set_decoder_norm_to_unit_norm(cpu.params)
    gg, og = loss_and_grads(pg, x, cfg, dead, y)
    gc, oc = loss_and_grads(pc, xc, cfg, dead.cpu(), yc)
    flip = (encode(pg, cfg, x)[2] > 0).cpu() != (encode(pc, cfg, xc)[2] > 0)
    hit = flip.any(0)
    ghost = dead.cpu() if cfg.use_ghost_grads else torch.zeros_like(hit)
    spread = ratio = None
    if cfg.use_ghost_grads:
        on_cpu, on_card = _grad_spread(cpu, cfg, xc, yc, gc), _grad_spread(state, cfg, x, y, gg)
        spread = {k: max(on_cpu[k], on_card[k]) for k in gc}
        ratio = {k: max(1.0, 2 * spread[k] / STEP_GRAD_REL) for k in gc}
    widen = lambda k, nu=False: 1.0 if ratio is None else ratio[k] * (2 if nu else 1)
    grad_errs, raw = {}, {}
    for k in gc:
        d = (gg[k].cpu() - gc[k]).abs() / gc[k].abs().max().item()
        alive, gh, sw = _feature_parts(k, ghost, hit)
        raw[k] = {"alive": _part_max(d, alive), "ghost": _part_max(d, gh),
                  "switched": _part_max(d, sw)}
        grad_errs[k] = {"rel": d.max().item(),
                        "rel_unswitched": max(raw[k]["alive"], raw[k]["ghost"] / widen(k))}
    card, mg = sae_train_step(state, x, cfg, y)
    cpu, mc = sae_train_step(cpu, xc, cfg, yc)
    got, want = train_state_to_numpy(card), train_state_to_numpy(cpu)
    errs, scales = {}, {}
    for k in want:
        d = torch.from_numpy(np.asarray(np.abs(got[k].astype(np.float64) - want[k])))
        scales[k] = float(np.abs(want[k]).max())
        if "/" not in k:
            errs[k] = {"unswitched": float(d.max()), "switched": 0.0}
            continue
        alive, gh, sw = _feature_parts(k, ghost, hit)
        w = widen(k.split("/", 1)[1], nu=k.startswith("nu/"))
        errs[k] = {"unswitched": max(_part_max(d, alive), _part_max(d, gh) / w),
                   "switched": _part_max(d, sw), "ghost_raw": _part_max(d, gh)}
    rec = {"grad_rel_err": grad_errs, "grad_rel_err_by_part": raw, "state_max_abs_err": errs,
           "relu_switches": int(flip.sum()), "spread_of_either_device": spread,
           "losses_card_cpu": {f: (getattr(mg, f).item(), getattr(mc, f).item()) for f in (
               "loss", "mse_loss", "l1_loss", "ghost_grad_loss", "explained_variance")},
           "ghost_loss_card": og.ghost_grad_loss.item(),
           "ghost_loss_cpu": oc.ghost_grad_loss.item()}
    emit({"phase": "sae_variants", "what": f"{name} step against the CPU", **rec})
    check_steps([grad_errs], errs, scales, int(flip.sum()), int(hit.sum()), got, want)
    for f, (a, b) in rec["losses_card_cpu"].items():
        if not abs(a - b) <= STEP_GRAD_REL * max(1.0, abs(b)):
            raise AssertionError(f"{name} {f}: {a} on the card, {b} on the CPU")
    return rec


def _warm(state, cfg, xs):
    from vit_prisma_tpu_torch.sae.train import sae_train_step
    for x in xs:
        state, m = sae_train_step(state, x, cfg)
    if not all(math.isfinite(v) for v in (m.loss.item(), m.explained_variance.item())):
        raise AssertionError(f"warm-up metrics {m}")
    return state


def _variant_ghost(cfg, store, counters):
    """Ghost grads on the default ReLU SAE: after the warm-up, a seeded
    quarter marked dead; the ghost loss, the W_dec gradients with and
    without ghost grads (alive rows equal, to the bit; dead rows moved), the
    pre-activations past exp's overflow, then the step against the CPU."""
    from vit_prisma_tpu_torch.sae.sae import encode, set_decoder_norm_to_unit_norm
    from vit_prisma_tpu_torch.sae.train import loss_and_grads
    gcfg = cfg.replace(architecture="standard", is_transcoder=False, use_ghost_grads=True)
    xs = [store.next_batch()[:, 0] for _ in range(VARIANT_WARM_STEPS + 1)]
    state = _warm(_variant_state(gcfg, store.peek_tokens(4096 * 8)), gcfg, xs[:-1])
    dead = torch.from_numpy(np.random.default_rng(VARIANT_DEAD_SEED).permutation(gcfg.d_sae)
                            < gcfg.d_sae // 4).cuda()
    state = state._replace(n_forward_passes_since_fired=torch.where(
        dead, float(gcfg.dead_feature_window + 1), 0.0))
    x = xs[-1]
    params = set_decoder_norm_to_unit_norm(state.params)
    _zero_counts(counters)
    g_ghost, out = loss_and_grads(params, x, gcfg, dead)
    g_plain, _ = loss_and_grads(params, x, gcfg.replace(use_ghost_grads=False), dead)
    launches = {k: f.launches for k, f in counters.items() if f.launches}
    hidden_pre = encode(params, gcfg, x)[2]
    moved = (g_ghost["W_dec"] - g_plain["W_dec"]).abs().amax(-1)
    rec = {"dead_features": int(dead.sum()), "ghost_loss": out.ghost_grad_loss.item(),
           "loss": out.loss.item(), "mse_loss": out.mse_loss.item(),
           "alive_rows_equal_bitwise": bool(torch.equal(g_ghost["W_dec"][~dead],
                                                        g_plain["W_dec"][~dead])),
           "dead_rows_moved": int((moved[dead] > 0).sum()),
           "dead_rows_min_change": moved[dead].min().item(),
           "hidden_pre_max": hidden_pre.max().item(),
           "exp_overflow_entries": int((hidden_pre > EXP_OVERFLOW).sum()),
           "exp_overflow_alive_entries": int((hidden_pre[:, ~dead] > EXP_OVERFLOW).sum()),
           "launches_two_grads": launches}
    if not (rec["ghost_loss"] > 0 and math.isfinite(rec["loss"])
            and rec["alive_rows_equal_bitwise"] and rec["dead_rows_moved"] == rec["dead_features"]):
        raise AssertionError(f"ghost grads: {rec}")
    rec["against_cpu"] = _step_against_cpu("ghost_grads", state, gcfg, x)
    rec["float64_anchor"] = _ghost_anchor(state, gcfg, x, rec["against_cpu"])
    return rec, state


def _ghost_anchor(state, cfg, x, against_cpu):
    """The ghost-grads step's gradients in float64 on the CPU from the same
    state and rows: the card's and the CPU's float32 gradients must each lie
    within the bound ``_step_against_cpu`` allows them (the larger of
    STEP_GRAD_REL and twice either device's own spread, relative to the
    anchor's absmax), so that bound hides no error of the port."""
    from vit_prisma_tpu_torch.sae.sae import set_decoder_norm_to_unit_norm
    from vit_prisma_tpu_torch.sae.train import loss_and_grads
    cpu = _state_to(state, "cpu")
    dead = state.n_forward_passes_since_fired > cfg.dead_feature_window
    p64 = {k: v.double() for k, v in set_decoder_norm_to_unit_norm(cpu.params).items()}
    g64, _ = loss_and_grads(p64, x.cpu().double(), cfg, dead.cpu())
    g_card, _ = loss_and_grads(set_decoder_norm_to_unit_norm(state.params), x, cfg, dead)
    g_cpu, _ = loss_and_grads(set_decoder_norm_to_unit_norm(cpu.params), x.cpu(), cfg,
                              dead.cpu())
    spread = against_cpu["spread_of_either_device"]
    rec = {}
    for k, a in g64.items():
        scale = a.abs().max().item()
        tol = max(STEP_GRAD_REL, 2 * spread[k])
        rec[k] = {"card_rel": (g_card[k].cpu().double() - a).abs().max().item() / scale,
                  "cpu_rel": (g_cpu[k].double() - a).abs().max().item() / scale,
                  "rel_tol": tol}
        if not (rec[k]["card_rel"] <= tol and rec[k]["cpu_rel"] <= tol):
            raise AssertionError(f"ghost grads {k} against the float64 anchor: {rec[k]}")
    emit({"phase": "sae_variants", "what": "ghost grads against a float64 CPU anchor", **rec})
    return rec


def _variant_norms(cfg, store):
    """One step under each normalization, after the warm-up, against the
    CPU."""
    out = {}
    for norm in ("layer_norm", "constant_norm_rescale"):
        ncfg = cfg.replace(architecture="standard", is_transcoder=False,
                           normalize_activations=norm)
        xs = [store.next_batch()[:, 0] for _ in range(VARIANT_WARM_STEPS + 1)]
        state = _warm(_variant_state(ncfg, store.peek_tokens(4096 * 8)), ncfg, xs[:-1])
        out[norm] = _step_against_cpu(norm, state, ncfg, xs[-1])
    return out


def _variant_topk_approx(cfg, store, counters):
    """The TopK row with topk_use_approx: the generic step (the fused gate
    refuses it) and ``encode`` take the exact top k, JAX's route off the
    TPU: no B8, B9 or B10 launch, and exactly k active a row (min(k, the
    positive pre-activations))."""
    from vit_prisma_tpu_torch.sae.sae import encode
    from vit_prisma_tpu_torch.sae.train import _fused_single_ok, sae_train_step
    tcfg = topk_config().replace(topk_use_approx=True, layer_subtype=cfg.layer_subtype,
                                 n_batches_in_buffer=cfg.n_batches_in_buffer)
    state = _variant_state(tcfg, store.peek_tokens(4096 * 8))
    x = store.next_batch()[:, 0]
    _zero_counts(counters)
    state, m = sae_train_step(state, x, tcfg)
    _, feats, hidden_pre, _ = encode(state.params, tcfg, x)
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters.items() if f.launches}
    want_k = torch.clamp((hidden_pre > 0).sum(-1), max=tcfg.topk_k)
    rec = {"fused_gate": _fused_single_ok(tcfg, x.shape[0]), "launches": launches,
           "l0": m.l0.item(), "rows_with_k_active": int(((feats > 0).sum(-1) == want_k).sum()),
           "rows": x.shape[0], "k": tcfg.topk_k}
    if rec["fused_gate"] or launches != {"adam_update": 4} \
            or rec["rows_with_k_active"] != rec["rows"]:
        raise AssertionError(f"topk_use_approx: {rec}")
    return rec


def _variant_import(tc_trainer, tc_cfg, ghost_state, store, counters):
    """A reference-format checkpoint of the trained transcoder (its config an
    object of a class that does not import, as the reference's) and a legacy
    SAELens-v2 dump of the ghost SAE, written at full width in a temporary
    directory (deleted after), loaded onto the card by default, equal to
    what was written, and stepped (B7 6 and 4)."""
    import shutil
    import tempfile
    import types
    from vit_prisma_tpu_torch.sae import (init_train_state, load_legacy_saelens_v2,
                                          load_reference_sae_checkpoint)
    from vit_prisma_tpu_torch.sae.train import sae_train_step
    tmp = tempfile.mkdtemp(prefix="smoke_import_")
    try:
        ref_params = {k: v.detach().cpu() for k, v in tc_trainer.state.params.items()}
        ref_cfg = types.SimpleNamespace(
            d_in=tc_cfg.d_in, expansion_factor=tc_cfg.expansion_factor, _dtype=torch.float32,
            _device="cuda", hook_point=tc_cfg.hook_point, architecture="transcoder",
            is_transcoder=True, d_out=tc_cfg.d_out, out_hook_point_layer=9,
            layer_out_subtype="hook_mlp_out", use_ghost_grads=True, log_to_wandb=False)
        legacy_params = {k: v.detach().cpu() for k, v in ghost_state.params.items()}
        legacy_cfg = {"d_in": tc_cfg.d_in, "expansion_factor": 16, "l1_coefficient": 2e-4,
                      "hook_point": tc_cfg.hook_point, "dtype": torch.float32}
        paths = {"reference": os.path.join(tmp, "n_images_2600058.pt"),
                 "legacy": os.path.join(tmp, "legacy_saelens_v2.pt")}
        torch.save({"cfg": ref_cfg, "state_dict": ref_params}, paths["reference"])
        torch.save({"config": legacy_cfg, "autoencoder": {"state_dict": legacy_params}},
                   paths["legacy"])
        rec = {"file_MB": {k: os.path.getsize(p) / 1e6 for k, p in paths.items()}}
        t0 = time.perf_counter()
        saes = {"reference": load_reference_sae_checkpoint(paths["reference"]),
                "legacy": load_legacy_saelens_v2(paths["legacy"])}
        torch.cuda.synchronize()
        rec["load_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp)
    batch = store.next_batch()
    for name, sae, written in (("reference", saes["reference"], ref_params),
                               ("legacy", saes["legacy"], legacy_params)):
        cfg = sae.cfg
        if not (all(v.is_cuda for v in sae.params.values()) and set(sae.params) == set(written)
                and all(torch.equal(sae.params[k].cpu(), v) for k, v in written.items())
                and cfg.use_ghost_grads):
            placed = {k: (v.device, tuple(v.shape)) for k, v in sae.params.items()}
            raise AssertionError(f"{name} checkpoint loaded as {cfg}, {placed}")
        state = init_train_state(cfg, params=sae.params)
        state = state._replace(n_forward_passes_since_fired=torch.where(
            torch.arange(cfg.d_sae, device="cuda") % 4 == 0,
            float(cfg.dead_feature_window + 1), 0.0))
        _zero_counts(counters)
        new, m = sae_train_step(state, batch[:, 0], cfg,
                                batch[:, 1] if cfg.is_transcoder else None)
        torch.cuda.synchronize()
        launches = {k: f.launches for k, f in counters.items() if f.launches}
        r = {"is_transcoder": cfg.is_transcoder, "use_ghost_grads": cfg.use_ghost_grads,
             "hook_point": cfg.hook_point, "params": sorted(sae.params), "launches": launches,
             "loss": m.loss.item(), "ghost_grad_loss": m.ghost_grad_loss.item(),
             "params_moved": bool(not torch.equal(new.params["W_enc"], state.params["W_enc"]))}
        if not (math.isfinite(r["loss"]) and r["ghost_grad_loss"] > 0 and r["params_moved"]
                and launches == {"adam_update": len(sae.params)}):
            raise AssertionError(f"{name} checkpoint step: {r}")
        rec[name] = r
    return rec


def phase_sae_variants(info):
    """The SAE variants on the card: the transcoder's main path (two-hook
    store, B3 on 6,144-byte rows, the target step) across a refill with
    exact launches, fill and refill seconds, SAE tokens per second and a step
    against the CPU; ghost grads; both normalizations; ``topk_use_approx``;
    the import tools.  Returns the transcoder path's launches."""
    from vit_prisma_tpu_torch import HookedViT, get_model_config
    from vit_prisma_tpu_torch.sae import (SAERunnerConfig, VisionActivationsStore,
                                          VisionSAETrainer)
    t_phase = time.perf_counter()
    cfg = SAERunnerConfig(architecture="transcoder", is_transcoder=True,
                          layer_subtype="hook_resid_mid", layer_out_subtype="hook_mlp_out",
                          n_batches_in_buffer=VARIANT_BUFFER_BATCHES)
    counters = _sae_counters()
    model = HookedViT(get_model_config(cfg.model_name), device="cuda",
                      generator=torch.Generator().manual_seed(0))
    images = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (TRAIN_IMAGES, 3, cfg.image_size, cfg.image_size), dtype=np.float32)).cuda()
    torch.cuda.synchronize()
    release()
    torch.cuda.reset_peak_memory_stats()

    # The transcoder's main path, with every count set to 0 just before it.
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
    sae = trainer.run(max_steps=VARIANT_STEPS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t1
    launches = {k: f.launches for k, f in counters.items()}

    harvests = -(-cfg.tokens_per_buffer // store.tokens_per_store_batch) + \
        len(refills) * -(-(cfg.tokens_per_buffer // 2) // store.tokens_per_store_batch)
    expected = dict.fromkeys(counters, 0)
    expected.update({"attention_mix_tnh": (cfg.out_hook_point_layer + 1) * harvests,
                     "take_rows": 1 + len(refills),
                     "adam_update": len(trainer.state.params) * VARIANT_STEPS})
    row_bytes = store.buffer[0].numel() * store.buffer.element_size()
    if len(refills) != 1 or launches != expected or row_bytes != 2 * cfg.d_in * 4 \
            or tuple(store.buffer.shape) != (cfg.tokens_per_buffer, 2, cfg.d_in):
        raise AssertionError(f"transcoder launches {launches}, expected {expected}, "
                             f"{len(refills)} refills, rows {tuple(store.buffer.shape)}")
    shapes = {k: tuple(v.shape) for k, v in sae.params.items()}
    d, s = cfg.d_in, cfg.d_sae
    if shapes != {"W_enc": (d, s), "W_dec": (s, d), "b_enc": (s,), "b_dec": (d,),
                  "b_dec_out": (d,), "W_skip": (d, d)}:
        raise AssertionError(f"transcoder params {shapes}")
    if len(log) != VARIANT_STEPS // cfg.wandb_log_frequency or not all(
            math.isfinite(v) for vals in log for v in vals.values()) or not log[-1]["l0"] > 0:
        raise AssertionError(f"transcoder metrics {log}")
    if not all(torch.isfinite(v).all() for v in sae.params.values()):
        raise AssertionError("non-finite transcoder parameters")
    tokens = VARIANT_STEPS * cfg.train_batch_size
    rec = {"phase": "sae_variants", **info, "model": cfg.model_name,
           "weights": "random, seed 0", "dataset": f"{TRAIN_IMAGES} random float32 images, "
           "numpy seed 3, on the card",
           "transcoder": {
               "hook_point": cfg.hook_point, "out_hook_point": cfg.out_hook_point,
               "d_in": cfg.d_in, "d_sae": cfg.d_sae, "d_out": cfg.d_out,
               "train_batch_size": cfg.train_batch_size, "buffer_rows": cfg.tokens_per_buffer,
               "row_bytes": row_bytes, "steps": VARIANT_STEPS, "harvest_batches": harvests,
               "launches": launches, "expected_launches": expected,
               "store_fill_s": fill_s, "trainer_init_s": init_s, "run_s": run_s,
               "refill_s": refills, "tokens_per_s_run": tokens / run_s,
               "tokens_per_s_without_refill": tokens / (run_s - sum(refills)),
               "metrics_first": log[0], "metrics_last": log[-1]}}
    emit({**rec, "what": "transcoder path"})
    batch = store.next_batch()
    rec["transcoder"]["against_cpu"] = _step_against_cpu(
        "transcoder", trainer.state, cfg, batch[:, 0], batch[:, 1])
    rec["ghost_grads"], ghost_state = _variant_ghost(cfg, store, counters)
    rec["normalize_activations"] = _variant_norms(cfg, store)
    rec["topk_use_approx"] = _variant_topk_approx(cfg, store, counters)
    rec["import"] = _variant_import(trainer, cfg, ghost_state, store, counters)
    rec.update(peak_memory_GB=torch.cuda.max_memory_allocated() / 1e9,
               phase_s=time.perf_counter() - t_phase)
    emit(rec)
    return launches


# ---------------------------------------------------------------------------
# tools: get_activations, profiling, the Kandinsky adapter
# ---------------------------------------------------------------------------

# get_activations at B/32 width in bf16 over TOOLS_BATCHES batches of
# TOOLS_BATCH images, at two hooks: its B1 launches are exact (one a block
# the forward runs, the forward stopped past the hook's block).
TOOLS_MODEL = "openai/clip-vit-base-patch32"
TOOLS_BATCH = 256
TOOLS_BATCHES = 4
TOOLS_HOOKS = (("blocks.11.hook_resid_post", 12), ("blocks.5.hook_resid_post", 6))
# profiling.device_time against this script's CUDA-event timer on one call
# (both are events around a loop): within 25% of each other.
TOOLS_TIME_RATIO = 1.25
# The adapter at its default widths (512 -> 2048 -> 1280), ADAPTER_STEPS Adam
# steps (lr 1e-4) at batch ADAPTER_BATCH with the same dropout masks on the
# card and on the CPU (float32, TF32 off).  Adam moves a weight by about lr
# a step whatever its gradient's size, so a near-zero gradient whose sign
# differs between two summation orders moves that weight up to 2 lr apart,
# and a hidden unit whose ReLU switches on one device only moves its whole
# row: single entries are no measure (the card against the CPU on an H100:
# up to 6 lr, 0.2-0.8% of W2's entries more than lr apart, which failed
# first bounds set on entries).  Held instead, for each tensor, the
# norm of the two runs' difference over the norm of the card's whole update
# (p - p0) within ADAPTER_UPDATE_REL (two CPU runs at 4 and 8 threads:
# 0.0008-0.0055), and the last loss within ADAPTER_LOSS_REL of the CPU's.
ADAPTER_STEPS = 200
ADAPTER_BATCH = 64
ADAPTER_LR = 1e-4
ADAPTER_LOSS_REL = 1e-4
ADAPTER_UPDATE_REL = 0.05


def phase_tools(info):
    """``get_activations`` on the B/32 width in bf16 (exact B1 launches, the
    harvest against the einsum route), ``profiling.device_time`` and
    ``memory_stats`` against CUDA events and ``max_memory_allocated``, and
    the Kandinsky adapter trained on the card against the CPU."""
    from vit_prisma_tpu_torch import HookedViT, get_model_config
    from vit_prisma_tpu_torch.sae import kandinsky_adapter as ad
    from vit_prisma_tpu_torch.utils import get_activations as ga
    from vit_prisma_tpu_torch.utils import profiling
    counters = _sae_counters()
    cfg = get_model_config(TOOLS_MODEL, dtype="bfloat16")
    model = HookedViT(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    batches = [torch.from_numpy(rng.standard_normal((TOOLS_BATCH, 3, 224, 224),
                                                    dtype=np.float32)).to("cuda", torch.bfloat16)
               for _ in range(TOOLS_BATCHES)]
    labels = [torch.arange(TOOLS_BATCH) % 7 for _ in range(TOOLS_BATCHES)]
    release()
    torch.cuda.reset_peak_memory_stats()
    plain = model.with_cfg(use_fused_attention=False)
    model(batches[0])  # the first forward's one-time costs, before the timed paths
    harvest = {}
    for name, per_batch in TOOLS_HOOKS:
        # the main path, with every count set to 0 just before it
        _zero_counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acts, got_labels = ga.get_activations(model, name, zip(batches, labels),
                                              return_labels=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k: f.launches for k, f in counters.items() if f.launches}
        if launches != {"attention_mix_tnh": per_batch * TOOLS_BATCHES}:
            raise AssertionError(f"get_activations {name} launches {launches}")
        if acts.dtype != torch.bfloat16 or tuple(acts.shape) != (
                TOOLS_BATCH * TOOLS_BATCHES, cfg.n_tokens, cfg.d_model) \
                or not torch.equal(got_labels, torch.cat(labels)):
            raise AssertionError(f"get_activations {name}: {acts.dtype} {tuple(acts.shape)}")
        stop = int(name.split(".")[1]) + 1
        _, ref = plain.run_with_cache(batches[-1], names_filter=[name], stop_at_layer=stop,
                                      return_cache_object=False)
        err = check_close(f"get_activations {name}", acts[-TOOLS_BATCH:], ref[name],
                          rel_atol(SLICE_BF16_REL, ref[name]))
        harvest[name] = {"launches": launches, "seconds": secs,
                         "images_per_s": TOOLS_BATCH * TOOLS_BATCHES / secs,
                         "max_abs_err_vs_einsum": err, "rel_tol": SLICE_BF16_REL}

    # profiling against this script's timers
    fwd = lambda: model(batches[0])
    t_dev = profiling.device_time(fwd, iters=10, warmup=2) * 1e6
    t_ev = cuda_us(fwd, iters=10, warmup=2)
    ratio = max(t_dev, t_ev) / min(t_dev, t_ev)
    stats = profiling.memory_stats()
    peak = torch.cuda.max_memory_allocated()
    if not ratio <= TOOLS_TIME_RATIO or stats["allocated_bytes.all.peak"] != peak \
            or profiling.memory_stats("cpu") is not None:
        raise AssertionError(f"profiling: device_time {t_dev} us, events {t_ev} us, "
                             f"peak {stats['allocated_bytes.all.peak']} vs {peak}")
    del acts, plain, model, batches
    release()

    # the adapter on the card and on the CPU, the same masks
    src = np.random.default_rng(6).standard_normal((ADAPTER_BATCH * 8, 512), dtype=np.float32)
    tgt = np.random.default_rng(7).standard_normal((ADAPTER_BATCH * 8, 1280), dtype=np.float32)
    init = ad.init_adapter_params(torch.Generator().manual_seed(8), device="cpu")
    mask_gen = torch.Generator().manual_seed(9)
    masks = [ad.dropout_masks(mask_gen, ADAPTER_BATCH, 2048, device="cpu")
             for _ in range(ADAPTER_STEPS)]
    epochs = ADAPTER_STEPS // 8
    run = lambda dev: ad.train_adapter(
        src, tgt, num_epochs=epochs, batch_size=ADAPTER_BATCH, lr=ADAPTER_LR, device=dev,
        params=init, masks_fn=lambda step: tuple(m.to(dev) for m in masks[step]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card_p, card_loss = run("cuda")
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_p, cpu_loss = run("cpu")
    cpu_s = time.perf_counter() - t0
    adapter_errs = {}
    for k in cpu_p:
        d = (card_p[k] - cpu_p[k]).abs()
        adapter_errs[k] = {"update_rel": (d.norm() / (card_p[k] - init[k]).norm()).item(),
                           "max_lr": d.max().item() / ADAPTER_LR,
                           "far_share": (d > ADAPTER_LR).float().mean().item()}
    if not (all(e["update_rel"] <= ADAPTER_UPDATE_REL for e in adapter_errs.values())
            and abs(card_loss - cpu_loss) <= ADAPTER_LOSS_REL * abs(cpu_loss)):
        raise AssertionError(f"adapter card vs CPU: {adapter_errs}, loss {card_loss} vs "
                             f"{cpu_loss}")
    emit({"phase": "tools", **info, "model": TOOLS_MODEL, "dtype": "bfloat16",
          "weights": "random, seed 0", "batch": TOOLS_BATCH, "batches": TOOLS_BATCHES,
          "get_activations": harvest,
          "profiling": {"device_time_us": t_dev, "cuda_events_us": t_ev, "ratio": ratio,
                        "ratio_tol": TOOLS_TIME_RATIO, "memory_stats_peak": stats[
                            "allocated_bytes.all.peak"], "max_memory_allocated": peak},
          "adapter": {"widths": [512, 2048, 1280], "steps": ADAPTER_STEPS,
                      "batch": ADAPTER_BATCH, "card_s": card_s, "cpu_s": cpu_s,
                      "card_steps_per_s": ADAPTER_STEPS / card_s,
                      "diff_vs_cpu": adapter_errs, "loss_card_cpu": [card_loss, cpu_loss],
                      "loss_rel_tol": ADAPTER_LOSS_REL, "update_rel_tol": ADAPTER_UPDATE_REL},
          "peak_memory_GB": peak / 1e9})
    return {"attention_mix_tnh": sum(h["launches"]["attention_mix_tnh"]
                                     for h in harvest.values())}


# ---------------------------------------------------------------------------
# parallel: a world of one on NCCL, a world of two on gloo on one card
# ---------------------------------------------------------------------------

# The default SAE (SAERunnerConfig(): B/32 layer 9 resid_post, 768 -> 12,288,
# batch 4096, float32) with a 6-batch buffer: PAR_STEPS steps take one
# refill at step 4.
PAR_BUFFER_TOKENS = 6 * 4096
PAR_STEPS = 5
PAR_SWEEP_STEPS = 12         # the L/14 sweep: one refill (6 steps a half)
PAR_CHECK_STEPS = 3          # the step checks on fixed batches
PAR_WORLD_TIMEOUT_S = 400
PAR_OUT = "smoke_out/parallel"  # gitignored: references and the init file
# The default SAE's run at (data=2, model=1) against one process over a run
# with a refill: rows are the same (each rank harvests its half of every
# store batch) but the gradients are means of two halves' means, so a
# near-zero gradient may take the other sign: every parameter within 2 lr a
# step of the single run's, and 99.9% within STEP_SWITCHED_PARAM_ATOL.  Step
# and token counts exact.  The step checks on fixed batches hold phase 6's
# bounds: 99.9% of each parameter within STEP_PARAM_ATOL, all within
# STEP_SWITCHED_PARAM_ATOL, counts exact.
PAR_P999 = 0.999
# A tensor-parallel bf16 forward sums each block's two partial products over
# the ranks in bf16: its cache and gradients are held as phase 15 holds the
# kernels against the einsum route (GRAD_BF16_REL of each entry's absmax).


def _par_config(**kw):
    from vit_prisma_tpu_torch.sae import SAERunnerConfig
    return SAERunnerConfig(buffer_tokens_override=PAR_BUFFER_TOKENS, **kw)


def _par_topk_config():
    return _par_config(activation_fn_str="topk", activation_fn_kwargs=(("k", TOPK_K),),
                       expansion_factor=16, compute_dtype="bfloat16", fused_sae_step=False,
                       b_dec_init_method="zeros")


def _par_images(n, size, seed=3):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n, 3, size, size), dtype=np.float32)).cuda()


def _par_batches(n, rows, d, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(rows, d, generator=g).cuda() for _ in range(n)]


def _par_main_run(cfg, model, images, steps, mesh=None, sweep=False):
    """Store -> trainer.run(steps) through the public ``mesh=``: the launches
    of the path, the store's first rows after its fill, and seconds."""
    from vit_prisma_tpu_torch.sae import (SAESweepTrainer, VisionActivationsStore,
                                          VisionSAETrainer)
    counters = _sae_counters()
    _zero_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    store = VisionActivationsStore(cfg, model, images, mesh=mesh)
    first = store.buffer[:4096].clone()
    trainer = (SAESweepTrainer if sweep else VisionSAETrainer)(cfg, model, store)
    refills = _time_refills(store)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    trainer.run(max_steps=steps)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {k: f.launches for k, f in counters.items() if f.launches}
    return trainer, store, first, launches, {"fill_and_init_s": t1 - t0, "run_s": t2 - t1,
                                             "refill_s": list(refills)}


def _state_diff(got, want, lr_steps=None):
    """Per leaf of two numpy state dicts: max abs difference, the share of
    entries past STEP_PARAM_ATOL and past STEP_SWITCHED_PARAM_ATOL."""
    out = {}
    for k, w in want.items():
        d = np.abs(got[k].astype(np.float64) - w)
        out[k] = {"max": float(d.max()), "over_atol": float((d > STEP_PARAM_ATOL).mean()),
                  "over_switched": float((d > STEP_SWITCHED_PARAM_ATOL).mean())}
    return out


def _check_state(name, got, want, max_abs=None):
    """Counts exact; parameters held as the step checks hold them
    (``max_abs`` bounds every entry when given, else 99.9% within
    STEP_PARAM_ATOL and all within STEP_SWITCHED_PARAM_ATOL)."""
    diff = _state_diff(got, want)
    for k, d in diff.items():
        if k in STEP_EXACT:
            ok = d["max"] == 0
        elif not k.startswith("params/"):
            continue
        elif max_abs is not None:
            ok = d["max"] <= max_abs and d["over_switched"] <= 1 - PAR_P999
        else:
            ok = d["over_atol"] <= 1 - PAR_P999 and d["max"] <= STEP_SWITCHED_PARAM_ATOL
        if not ok:
            raise AssertionError(f"{name} {k}: {d}")
    return {k: d for k, d in diff.items() if k.startswith("params/") or k in STEP_EXACT}


def _comm_timing():
    """Wrap ``torch.distributed``'s collectives so that their synchronized
    wall seconds add up in the returned dict (the time a step waits on them)."""
    import torch.distributed as dist
    spent = {"s": 0.0, "calls": 0}
    for name in ("all_reduce", "all_gather", "all_to_all_single"):
        inner = getattr(dist, name)

        def timed_op(*a, _inner=inner, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _inner(*a, **kw)
            torch.cuda.synchronize()
            spent["s"] += time.perf_counter() - t0
            spent["calls"] += 1
            return out
        setattr(dist, name, timed_op)
    return spent


def _profiled_steps(trainer, batches):
    """Seconds a step over ``batches`` (one warm-up step, then two timed by
    the host clock, synchronized) and the collectives' share of a step: by
    the synchronized wrapper's seconds over those two steps, and by
    torch.profiler (gloo's work events over the ``ProfilerStep`` span of one
    step kept after one unkept warm-up cycle)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    trainer.train_step(batches[0])
    torch.cuda.synchronize()
    spent = _COMM[0] or {"s": 0.0}
    s0, t0 = spent["s"], time.perf_counter()
    for b in batches[1:3]:
        trainer.train_step(b)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    comm_s = spent["s"] - s0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for b in batches[3:5]:
            trainer.train_step(b)
            torch.cuda.synchronize()
            prof.step()
    events = prof.key_averages()
    step_us = sum(e.cpu_time_total for e in events if e.key.startswith("ProfilerStep"))
    comm = [e for e in events if e.key.startswith(("gloo:", "nccl:"))]
    return {"s_per_step": wall / 2, "collective_share_wrapped": comm_s / wall,
            "collective_share_profiler": sum(e.cpu_time_total for e in comm) / step_us
            if step_us else None, "profiler_collective_events": sorted(e.key for e in comm)}


_COMM = [None]


def _par_child(rank, world, init, ref_path, q):
    """One rank of the world of two on the card (gloo): the cases of
    ``phase_parallel`` (b); puts ``(rank, ok, record)`` on ``q``."""
    import traceback
    from datetime import timedelta
    try:
        import torch.distributed as dist
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                                world_size=world, timeout=timedelta(seconds=PAR_WORLD_TIMEOUT_S))
        _COMM[0] = _comm_timing()
        try:
            q.put((rank, True, _par_cases(rank, torch.load(ref_path, weights_only=False))))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the parent
        q.put((rank, False, traceback.format_exc()))


def _par_cases(rank, ref):
    from vit_prisma_tpu_torch import HookedViT, get_model_config
    from vit_prisma_tpu_torch.parallel import mesh as M
    from vit_prisma_tpu_torch.sae import init_sweep_state, init_train_state
    from vit_prisma_tpu_torch.sae.convert import train_state_to_numpy
    from vit_prisma_tpu_torch.sae.train import sae_sweep_train_step, sae_train_step
    counters = _sae_counters()
    out = {"rank": rank}

    # the default SAE at (data=2, model=1): its main path, then a step check
    cfg = _par_config()
    mesh = M.make_mesh(2, 1)
    model = HookedViT(get_model_config(cfg.model_name), device="cuda",
                      generator=torch.Generator().manual_seed(0))
    torch.cuda.reset_peak_memory_stats()
    trainer, store, _, launches, secs = _par_main_run(cfg, model, _par_images(
        TRAIN_IMAGES, cfg.image_size), PAR_STEPS, mesh)
    whole = train_state_to_numpy(trainer.whole_state())
    rec = {"launches": launches, **secs, "peak_memory_GB": torch.cuda.max_memory_allocated() / 1e9}
    if rank == 0:
        rec["state_vs_single"] = _check_state(
            "default (2, 1) run", whole, ref["default_state"], max_abs=2 * cfg.lr * PAR_STEPS)
    rec["profile"] = _profiled_steps(trainer, [store.next_batch() for _ in range(5)])
    del trainer, store, model
    release()
    state0 = init_train_state(cfg, generator=torch.Generator().manual_seed(11), device="cuda")
    batches = _par_batches(PAR_CHECK_STEPS, cfg.train_batch_size, cfg.d_in, 12)
    place, step = M.shard_sae_train_step(cfg, mesh, state0)
    local = place(state0)
    for b in batches:
        local, _ = step(local, M.data_rows(b, mesh))
    got = train_state_to_numpy(M.gather_tree(local, M.sae_state_shardings(mesh, state0)))
    if rank == 0:
        want = state0
        for b in batches:
            want, _ = sae_train_step(want, b, cfg)
        rec["step_check"] = _check_state("default (2, 1) steps", got, train_state_to_numpy(want))
    out["default_2x1"] = rec
    del local, state0
    release()

    # the TopK row at (data=1, model=2): the generic step, B10 on the
    # gathered candidates
    cfg = _par_topk_config()
    mesh = M.make_mesh(1, 2)
    state0 = init_train_state(cfg, generator=torch.Generator().manual_seed(13), device="cuda")
    batches = _par_batches(PAR_CHECK_STEPS, cfg.train_batch_size, cfg.d_in, 14)
    place, step = M.shard_sae_train_step(cfg, mesh, state0)
    local = place(state0)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(counters)
    torch.cuda.synchronize()
    s0, t0 = _COMM[0]["s"], time.perf_counter()
    for b in batches:
        local, metrics = step(local, b)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rec = {"launches": {k: f.launches for k, f in counters.items() if f.launches},
           "s_per_step": wall / PAR_CHECK_STEPS,
           "collective_share_wrapped": (_COMM[0]["s"] - s0) / wall,
           "local_W_enc": list(local.params["W_enc"].shape), "l0": metrics.l0.item(),
           "peak_memory_GB": torch.cuda.max_memory_allocated() / 1e9}
    got = train_state_to_numpy(M.gather_tree(local, M.sae_state_shardings(mesh, state0)))
    if rank == 0:
        want = state0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            want, wm = sae_train_step(want, b, cfg)
        torch.cuda.synchronize()
        rec["single_s_per_step"] = (time.perf_counter() - t0) / PAR_CHECK_STEPS
        rec["l0_single"] = wm.l0.item()
        rec["step_check"] = _check_state("TopK (1, 2) steps", got, train_state_to_numpy(want),
                                         max_abs=2 * cfg.lr * PAR_CHECK_STEPS)
    out["topk_1x2"] = rec
    del local, state0
    release()

    # the L/14 sweep at full width at (data=1, model=2): the TP harvest (B1
    # on 8 of 16 heads), B3, B4/B6, B7; then a step check on fixed rows
    cfg = sweep_config()
    mesh = M.make_mesh(1, 2)
    model = HookedViT(get_model_config(SWEEP_MODEL, dtype="bfloat16"), device="cuda",
                      generator=torch.Generator().manual_seed(0))
    torch.cuda.reset_peak_memory_stats()
    trainer, store, first, launches, secs = _par_main_run(
        cfg, model, _par_images(SWEEP_IMAGES, 224, seed=4), PAR_SWEEP_STEPS, mesh, sweep=True)
    L_loc = len(cfg.sweep_layers) // 2
    want_rows = ref["sweep_first_rows"][:, rank * L_loc:(rank + 1) * L_loc].cuda()
    rec = {"launches": launches, **secs, "heads_local": model.blocks[0].attn.W_Q.shape[0],
           "harvest_max_abs_err": check_close("sweep (1, 2) harvest", first, want_rows,
                                              rel_atol(GRAD_BF16_REL, want_rows)),
           "harvest_rel_tol": GRAD_BF16_REL,
           "peak_memory_GB": torch.cuda.max_memory_allocated() / 1e9}
    rec["profile"] = _profiled_steps(trainer, [store.next_batch() for _ in range(5)])
    del trainer, store, model, first
    release()
    state0 = init_sweep_state(cfg, len(cfg.sweep_layers),
                              generator=torch.Generator().manual_seed(15), device="cuda")
    x = torch.randn(cfg.train_batch_size, len(cfg.sweep_layers), cfg.d_in,
                    generator=torch.Generator().manual_seed(16)).cuda()
    place, step = M.shard_sae_sweep_step(cfg, mesh, state0)
    local = place(state0)
    for _ in range(PAR_CHECK_STEPS):
        local, _ = step(local, M.shard_tensor(x, M.sweep_batch_sharding(mesh)))
    got_params = {k: M.axis(mesh, "model").all_gather(v, 0) for k, v in local.params.items()}
    if rank == 0:
        want = state0
        for _ in range(PAR_CHECK_STEPS):
            want, _ = sae_sweep_train_step(want, x, cfg)
        tol = SWEEP_CHECK_TOL[torch.bfloat16]
        diffs = {}
        for k, w in want.params.items():
            d = (got_params[k].float() - w.float()).abs()
            diffs[k] = {"max": d.max().item(),
                        "over_p999": (d > tol["param_p999"]).float().mean().item()}
            if not (diffs[k]["max"] <= tol["param_max"] and diffs[k]["over_p999"] <= 1e-3):
                raise AssertionError(f"sweep (1, 2) steps {k}: {diffs[k]}")
        rec["step_check"] = diffs
    out["sweep_1x2"] = rec
    del local, state0, got_params
    release()

    # a B/32 incl_bwd cache at (data=1, model=2): B2 on the local heads
    bcfg = get_model_config(TOOLS_MODEL, dtype="bfloat16")
    model = HookedViT(bcfg, device="cuda", generator=torch.Generator().manual_seed(0))
    model.shard(mesh)
    images = _par_images(GRAD_BATCH, 224, seed=17).bfloat16()
    _zero_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, cache = model.run_with_cache(images, names_filter=RESID_POST, incl_bwd=True,
                                    return_cache_object=False)
    torch.cuda.synchronize()
    rec = {"launches": {k: f.launches for k, f in counters.items() if f.launches},
           "seconds": time.perf_counter() - t0, "heads_local": model.blocks[0].attn.W_Q.shape[0]}
    if rank == 0:
        want = {k: v.cuda() for k, v in ref["bwd_cache"].items()}
        rec["grad_max_abs_err"] = _cache_grad_errs(cache, want, GRAD_BF16_REL)
        rec["act_max_abs_err"] = {k: check_close(k, cache[k], want[k],
                                                 rel_atol(GRAD_BF16_REL, want[k]))
                                  for k in want if not k.endswith("_grad")}
    out["incl_bwd_1x2"] = rec
    return out


def _par_world(ref_path):
    """Spawn the world of two on the card and collect each rank's record;
    a rank that fails or a world that does not come up fails the phase."""
    import queue

    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    init = os.path.abspath(os.path.join(PAR_OUT, f"init_{os.getpid()}"))
    if os.path.exists(init):
        os.remove(init)
    procs = [ctx.Process(target=_par_child, args=(r, 2, init, ref_path, q)) for r in range(2)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        for _ in procs:
            rank, ok, value = q.get(timeout=PAR_WORLD_TIMEOUT_S)
            if not ok:
                errors.append(f"rank {rank}: {value}")
                break
            results[rank] = value
    except queue.Empty:
        errors.append(f"the world of two did not finish within {PAR_WORLD_TIMEOUT_S} s")
    finally:
        for p in procs:
            p.join(timeout=30 if not errors else 5)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    if errors:
        raise AssertionError("parallel world of two failed: " + "\n".join(errors))
    return [results[0], results[1]]


def phase_parallel(info):
    """(a) A world of one on NCCL: the default SAE through
    ``mesh=make_mesh(1, 1)`` with a refill equals the unsharded trainer to
    the bit, with the same launches.  (b) A world of two processes on the one
    card over gloo (NCCL refuses two ranks on one device): the default SAE at
    (data=2, model=1), the TopK row at (1, 2), the L/14 sweep at full width
    at (1, 2) and a B/32 ``incl_bwd`` cache at (1, 2), each against one
    process, with exact launches per rank, seconds a step, the collectives'
    share of a step and peak memory.  A world of two on one card measures
    the sharded code's overhead, not scaling.  Returns the launches per
    rank of (b)."""
    import torch.distributed as dist
    from vit_prisma_tpu_torch import HookedViT, get_model_config
    from vit_prisma_tpu_torch.parallel import make_mesh
    from vit_prisma_tpu_torch.sae import SAESweepTrainer, VisionActivationsStore
    from vit_prisma_tpu_torch.sae.convert import train_state_to_numpy
    os.makedirs(PAR_OUT, exist_ok=True)
    cfg = _par_config()
    images = _par_images(TRAIN_IMAGES, cfg.image_size)
    runs = {}
    for name, mesh in (("unsharded", None), ("mesh_1x1", "mesh")):
        model = HookedViT(get_model_config(cfg.model_name), device="cuda",
                          generator=torch.Generator().manual_seed(0))
        if mesh is not None:
            mesh = make_mesh(1, 1)
        trainer, store, _, launches, secs = _par_main_run(cfg, model, images, PAR_STEPS, mesh)
        runs[name] = (train_state_to_numpy(trainer.whole_state()), launches, secs)
        if mesh is None:
            secs["profile"] = _profiled_steps(trainer, [store.next_batch() for _ in range(5)])
        del trainer, store, model
        release()
    (want, l_want, s_want), (got, l_got, s_got) = runs["unsharded"], runs["mesh_1x1"]
    bitwise = all(np.array_equal(got[k], want[k]) for k in want)
    backend = dist.get_backend()
    dist.destroy_process_group()
    if not bitwise or l_got != l_want or backend != "nccl":
        raise AssertionError(f"mesh (1, 1) against unsharded: bitwise {bitwise}, launches "
                             f"{l_got} vs {l_want}, backend {backend}")
    world1 = {"backend": backend, "bitwise_equal": bitwise, "launches": l_got,
              "unsharded_s": s_want, "mesh_s": s_got}

    # references for (b), made by one process
    ref = {"default_state": want}
    scfg = sweep_config()
    model = HookedViT(get_model_config(SWEEP_MODEL, dtype="bfloat16"), device="cuda",
                      generator=torch.Generator().manual_seed(0))
    store = VisionActivationsStore(scfg, model, _par_images(SWEEP_IMAGES, 224, seed=4))
    ref["sweep_first_rows"] = store.buffer[:4096].cpu()
    sweep_single = _profiled_steps(SAESweepTrainer(scfg, model, store),
                                   [store.next_batch() for _ in range(5)])
    del store, model
    release()
    bmodel = HookedViT(get_model_config(TOOLS_MODEL, dtype="bfloat16"), device="cuda",
                       generator=torch.Generator().manual_seed(0))
    _, cache = bmodel.run_with_cache(_par_images(GRAD_BATCH, 224, seed=17).bfloat16(),
                                     names_filter=RESID_POST, incl_bwd=True,
                                     return_cache_object=False)
    ref["bwd_cache"] = {k: v.cpu() for k, v in cache.items()}
    del bmodel, cache
    release()
    ref_path = os.path.join(PAR_OUT, "references.pt")
    torch.save(ref, ref_path)
    del ref
    t0 = time.perf_counter()
    ranks = _par_world(ref_path)
    world_s = time.perf_counter() - t0
    os.remove(ref_path)

    # exact launches per rank
    n_params = 4
    harvest_batches = lambda c, refills: -(-c.tokens_per_buffer // (
        c.store_batch_size * c.tokens_per_image)) + refills * -(-(c.tokens_per_buffer // 2) // (
            c.store_batch_size * c.tokens_per_image))
    d = ranks[0]["default_2x1"]
    n_ref = len(d["refill_s"])
    expect = {
        "default_2x1": {"attention_mix_tnh": (cfg.hook_point_layer + 1) * harvest_batches(
            cfg, n_ref), "take_rows": 2 * (2 + n_ref), "adam_update": n_params * PAR_STEPS},
        "topk_1x2": {"kth_value": PAR_CHECK_STEPS, "adam_update": n_params * PAR_CHECK_STEPS},
        "incl_bwd_1x2": {"attention_mix_tnh": 12, "attention_mix_tnh_bwd": 11},
    }
    s = ranks[0]["sweep_1x2"]
    k_steps = PAR_SWEEP_STEPS
    expect["sweep_1x2"] = {
        "attention_mix_tnh": len(scfg.sweep_layers) * harvest_batches(scfg, len(s["refill_s"])),
        "take_rows": 1 + len(s["refill_s"]), "sae_fused_forward": k_steps,
        "sae_fused_backward_stored": k_steps, "adam_update": n_params * k_steps}
    emit({"phase": "parallel", **info, "world_of_one_nccl": world1,
          "sweep_single_process_steps": sweep_single,
          "world_of_two_gloo_s": world_s, "ranks": ranks, "expected_launches": expect,
          "note": "two processes on one card over gloo: the sharded code's overhead, "
                  "not scaling"})
    for r in ranks:
        for case, want_l in expect.items():
            if r[case]["launches"] != want_l:
                raise AssertionError(f"rank {r['rank']} {case} launches {r[case]['launches']}, "
                                     f"expected {want_l}")
    if not all(r["sweep_1x2"]["heads_local"] == 8 and r["incl_bwd_1x2"]["heads_local"] == 6
               for r in ranks):
        raise AssertionError("tensor-parallel ranks do not hold half the heads")
    return {case: [r[case]["launches"] for r in ranks] for case in expect}

T_START = time.perf_counter()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card; none is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name_power = card()
    info = {"card": name_power}

    timed(phase_build, info)
    kernels = timed(phase_kernels, info)
    mix_kernels, mix_launches = timed(phase_mix_kernels, info)
    release()
    sae_kernels = timed(phase_sae_kernels, info)
    kth = timed(phase_kth_value, info)
    fused, plain = timed(phase_slice, info)
    launches = timed(phase_serve, info, fused, plain)
    del fused, plain
    release()
    class_emb, text_launches = timed(phase_text, info)
    release()
    trainer, store, cfg, train_launches = timed(phase_train, info)
    check_steps(*timed(phase_step_check, info, trainer, store, cfg))
    del store
    release()
    timed(phase_sae_eval, info, trainer, cfg, class_emb)
    del trainer
    release()
    data_launches = timed(phase_data, info)
    release()
    variant_launches = timed(phase_sae_variants, info)
    release()
    sae_step_kernels = timed(phase_sae_step_kernels, info)
    timed(phase_remat_marks, info)
    release()
    topk_kernels = timed(phase_topk_kernels, info)
    trainer, store, cfg, topk_launches = timed(phase_train, info, topk_config(), "topk_train",
                                              SLICE_STEPS, name="topk_train")
    topk_remat_launches = timed(phase_topk_remat, info, trainer, store, cfg)
    topk_f32_launches = timed(phase_topk_train_f32, info, trainer, store, cfg)
    kth_launches = timed(phase_topk_step_check, info, trainer, store, cfg)
    timed(phase_step_profile, info, trainer, store, cfg, "topk_profile", name="topk_profile")
    timed(phase_checkpoint, info, store)
    del trainer, store
    release()
    sweep, sweep_store, sweep_cfg, sweep_launches, remat_launches = timed(phase_sweep, info)
    check_sweep_steps(timed(phase_sweep_step_check, info, sweep, sweep_store, sweep_cfg))
    del sweep_store
    release()
    timed(phase_sweep_eval, info, sweep, sweep_cfg)
    del sweep
    release()
    # the same sweep at the config's default compute dtype (float32)
    _, _, _, f32_sweep_launches, f32_remat_launches = timed(
        phase_sweep, info, sweep_f32_config(), "sweep_f32", name="sweep_f32")
    release()
    gated_kernels = timed(phase_gated_kernels, info)
    trainer, store, cfg, gated_launches = timed(phase_train, info, gated_config(), "gated_train",
                                              SLICE_STEPS, name="gated_train")
    gated_f32_launches = timed(phase_gated_train_f32, info, trainer, store, cfg)
    timed(phase_step_profile, info, trainer, store, cfg, "gated_profile", name="gated_profile")
    timed(phase_gated_step_check, info, trainer, store, cfg)
    del trainer, store
    release()
    grad_kernels = timed(phase_grad_kernels, info)
    timed(phase_attribution, info)
    release()
    vit_train_launches = timed(phase_vit_train, info)
    release()
    timed(phase_vit_train_check, info)
    timed(phase_sae_attribution, info)
    release()
    ln_kernels = timed(phase_ln_gemm_kernels, info)
    flash_kernels = timed(phase_flash_kernels, info)
    release()
    ln_launches = timed(phase_serve_ln_fused, info)
    release()
    l336_launches = timed(phase_serve_l14_336, info)
    release()
    l336_attrib_launches = timed(phase_attribution_l14_336, info)
    release()
    l336_f32_launches = timed(phase_l14_336_f32, info)
    release()
    timed(phase_video, info)
    release()
    timed(phase_serve_graph, info)
    release()
    analysis_launches = timed(phase_analysis, info)
    release()
    tools_launches = timed(phase_tools, info)
    release()
    parallel_launches = timed(phase_parallel, info)
    release()

    def entry(name, source, replaces, launches, rec, ms_key="ms", scale=1.0):
        """One kernel's line: launches from its main path, the rest measured
        at the shape that path gives it."""
        lib = rec.get("library_" + ms_key)
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": rec["max_abs_err"],
                "ms": rec[ms_key] * scale, "plain_ms": rec["plain_" + ms_key] * scale,
                "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                "library_ms": None if lib is None else lib * scale}

    tc_keys = ("route", "TFLOP_per_s", "cublas_products_ms", "ms", "bound_ms",
               "max_abs_err", "bitwise_repeat")
    other_sources = {"sae_fused_forward": SAE_FWD_SOURCE, "sae_fused_backward": SAE_BWD_SOURCE,
                     "sae_fused_backward_stored": SAE_BWD_SOURCE,
                     "sae_fused_forward_topk": TOPK_FWD_SOURCE,
                     "sae_fused_backward_topk": SAE_BWD_SOURCE}

    def tc_extra(rec, beside):
        """A routed SAE kernel's GEMM route (`gemm_route`: the line's `route`
        is the kernel's language, cuda), rate, cuBLAS-products time and
        repeatability at the line's shape, and the same figures at the
        shapes of ``beside`` (name -> record: another Hopper shape and the
        ViT-S width that keeps the mma.sync tiles)."""
        return {"gemm_route": rec["route"], "TFLOP_per_s": rec["TFLOP_per_s"],
                "cublas_products_ms": rec["cublas_products_ms"],
                "cublas_products_note": rec["cublas_products_note"],
                "bitwise_repeat": rec["bitwise_repeat"],
                "other_routes_source": other_sources[rec["kernel"]],
                **{f"{shape}_{k}": r[k] for shape, r in beside.items() for k in tc_keys}}

    def sae_tc_extra(rec, slice_rec):
        """B4, B5 or B6 at the sweep's shape, with the TopK slice's and the
        ViT-S width's figures beside."""
        return tc_extra(rec, {"topk_slice": slice_rec, SAE_MMA_SYNC_SHAPES[0]:
                              sae_step_kernels[(rec["kernel"], SAE_MMA_SYNC_SHAPES[0])]})

    def topk_tc_extra(rec):
        """B8 or B9 at the TopK slice, with the sweep's and the ViT-S width's
        figures beside."""
        return tc_extra(rec, {shape: topk_kernels[(rec["kernel"], shape)]
                              for shape in ("sweep_bf16", SAE_MMA_SYNC_SHAPES[0])})

    take_rows_line = {
        shape: {"max_abs_err": r["max_abs_err"], "us": r["kernel_us"], "call_us": r["us"],
                "plain_us": r["plain_us"], "library_us": r["library_device_us"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"]}
        for (kernel, shape, *_), r in sae_kernels.items() if kernel == "take_rows"}
    adam = [sae_kernels[("adam_update", name, torch.float32)] for name, _, _ in ADAM_SHAPES]
    adam_bytes = sum(r["MB_moved"] for r in adam) * 1e6
    adam_ops = sum(15 * math.prod(r["dims"]) for r in adam)
    adam_rec = {"max_abs_err": max(max(r["max_abs_err"].values()) for r in adam),
                "us": sum(r["us"] for r in adam), "plain_us": sum(r["plain_us"] for r in adam),
                **bound(adam_bytes, [("fp32", adam_ops)])}
    # the sweep's step: its four stacked tensors, float32 moments
    adam_sweep = [sae_kernels[("adam_update", name, torch.float32)]
                  for name, _, _ in ADAM_SWEEP_SHAPES]
    adam_sweep_bytes = sum(r["MB_moved"] for r in adam_sweep) * 1e6
    adam_sweep_line = {
        "sweep_ms": sum(r["us"] for r in adam_sweep) * 1e-3,
        "sweep_plain_ms": sum(r["plain_us"] for r in adam_sweep) * 1e-3,
        "sweep_MB_moved": adam_sweep_bytes / 1e6,
        "sweep_max_abs_err": max(max(r["max_abs_err"].values()) for r in adam_sweep),
        **{f"sweep_{k}": v for k, v in bound(
            adam_sweep_bytes,
            [("fp32", sum(15 * math.prod(r["dims"]) for r in adam_sweep))]).items()}}
    sweep_rec = lambda k: sae_step_kernels[(k, "sweep_bf16")]
    topk_rec = lambda k: topk_kernels[(k, "slice_bf16")]
    # a routed SAE kernel's float32 figures at each of ``shapes`` (3xTF32)
    f32_sae_keys = ("route", "ms", "plain_ms", "bound_ms", "bound_by", "cublas_products_ms",
                    "TFLOP_per_s", "max_abs_err")
    f32_sae = lambda kernel, recs, shapes: {
        f"f32_{shape}_{key}": recs[(kernel, shape)][key] for shape in shapes
        for key in f32_sae_keys}
    f32_step = lambda kernel: {**f32_sae(kernel, sae_step_kernels, ("sweep_f32", "topk_slice_f32")),
                               "f32_source": SAE_TF32_SOURCE}
    # B8's and B9's: at the TopK slice and the sweep's widths, their tf32 C
    # entry, and their launches on the float32 TopK train path
    f32_topk = lambda kernel: {**f32_sae(kernel, topk_kernels, ("slice_f32", "sweep_f32")),
                               "f32_source": SAE_TF32_SOURCE,
                               "f32_entry": SAE_TF32_TOPK_ENTRIES[kernel],
                               "f32_path_launches": topk_f32_launches[kernel]}
    l14 = kernels[("l14", torch.bfloat16)]
    text = kernels[("text_causal", torch.bfloat16)]
    # the float32 route's figures at each shape of a kernel phase
    f32_keys = ("us", "library_us", "bound_ms", "max_abs_err", "route")
    f32_figures = lambda recs, shapes: {
        f"f32_{shape}_{key.replace('us', 'ms')}":
            recs[(shape, torch.float32)][key] * (1e-3 if key.endswith("us") else 1)
        for shape in shapes for key in f32_keys}
    line = [
        # at B/32 serving's bf16 shape, with its CLIP L/14 and causal text
        # tower figures beside
        {**entry("attention_mix_tnh", KERNEL_SOURCE, KERNEL_REPLACES, launches,
                 kernels[("b32", torch.bfloat16)], "us", 1e-3),
         "analysis_launches": analysis_launches,
         "data_phase_launches": data_launches["attention_mix_tnh"],
         "variants_phase_launches": variant_launches["attention_mix_tnh"],
         "text_phase_launches": text_launches["attention_mix_tnh"],
         "l14_ms": l14["us"] * 1e-3, "l14_library_ms": l14["library_us"] * 1e-3,
         "l14_bound_ms": l14["bound_ms"], "l14_max_abs_err": l14["max_abs_err"],
         "text_ms": text["us"] * 1e-3, "text_library_ms": text["library_us"] * 1e-3,
         "text_bound_ms": text["bound_ms"], "text_plain_ms": text["plain_us"] * 1e-3,
         "text_max_abs_err": text["max_abs_err"],
         **f32_figures(kernels, [s[0] for s in KERNEL_SHAPES])},
        # at the store's f32 shape: the kernel's and index_select's device
        # times (the call's event time, with the wrapper's index check, beside
        # them), with the bf16 store's and the sweep store's figures; launches
        # from the train path and the sweep's
        {**entry("take_rows", TAKE_ROWS_SOURCE, TAKE_ROWS_REPLACES,
                 train_launches["take_rows"] + sweep_launches["take_rows"],
                 take_rows_line["store_f32"], "us", 1e-3),
         "call_ms": take_rows_line["store_f32"]["call_us"] * 1e-3,
         **{f"{shape}_{key.replace('us', 'ms')}":
                take_rows_line[shape][key] * (1 if key == "bound_ms" else 1e-3)
            for shape in ("store_bf16", "sweep_bf16", "transcoder_f32")
            for key in ("us", "library_us", "bound_ms")},
         "transcoder_f32_max_abs_err": take_rows_line["transcoder_f32"]["max_abs_err"],
         "transcoder_f32_plain_ms": take_rows_line["transcoder_f32"]["plain_us"] * 1e-3,
         "data_phase_launches": data_launches["take_rows"],
         "variants_phase_launches": variant_launches["take_rows"]},
        # one train step's four tensors, float32 moments, with the sweep
        # step's four stacked tensors beside
        {**entry("adam_update", ADAM_SOURCE, ADAM_REPLACES, train_launches["adam_update"],
                 adam_rec, "us", 1e-3), **adam_sweep_line,
         "data_phase_launches": data_launches["adam_update"],
         "variants_phase_launches": variant_launches["adam_update"]},
        # at the sweep's bf16 shape; launches from the sweep's main path (B5:
        # from its remat cycle; B6: the sweep's and the TopK slice's).  B4-B6
        # run their Hopper route there (source: its file), with the TopK
        # slice's bf16 figures and the cuBLAS time of their products beside
        {**entry("sae_fused_forward", SAE_TC_SOURCE, SAE_REPLACES["sae_fused_forward"],
                 sweep_launches["sae_fused_forward"], sweep_rec("sae_fused_forward")),
         **sae_tc_extra(sweep_rec("sae_fused_forward"),
                        sae_step_kernels[("sae_fused_forward", "topk_slice_bf16")]),
         **f32_step("sae_fused_forward"),
         "f32_sweep_path_launches": f32_sweep_launches["sae_fused_forward"]},
        {**entry("sae_fused_backward", SAE_TC_SOURCE, SAE_REPLACES["sae_fused_backward"],
                 remat_launches["sae_fused_backward"], sweep_rec("sae_fused_backward")),
         **sae_tc_extra(sweep_rec("sae_fused_backward"),
                        sae_step_kernels[("sae_fused_backward", "topk_slice_bf16")]),
         "b5_against_b6_on_b4_hc": sweep_rec("sae_fused_backward")["b5_against_b6_on_b4_hc"],
         **f32_step("sae_fused_backward"),
         "f32_sweep_path_launches": f32_remat_launches["sae_fused_backward"],
         "f32_b5_against_b6_on_b4_hc":
             sae_step_kernels[("sae_fused_backward", "sweep_f32")]["b5_against_b6_on_b4_hc"]},
        {**entry("sae_fused_backward_stored", SAE_TC_SOURCE,
                 SAE_REPLACES["sae_fused_backward_stored"],
                 sweep_launches["sae_fused_backward_stored"]
                 + topk_launches["sae_fused_backward_stored"],
                 sweep_rec("sae_fused_backward_stored")),
         **sae_tc_extra(sweep_rec("sae_fused_backward_stored"),
                        topk_rec("sae_fused_backward_stored")),
         **f32_step("sae_fused_backward_stored"),
         **{f"f32_on_topk_h_{k}": v for k, v in f32_sae(
             "sae_fused_backward_stored", topk_kernels, ("slice_f32", "sweep_f32")).items()},
         "f32_topk_path_launches": topk_f32_launches["sae_fused_backward_stored"],
         "f32_sweep_path_launches": f32_sweep_launches["sae_fused_backward_stored"]},
        # at the TopK slice's bf16 shape; launches from its train path (B9:
        # from its remat steps).  Both run their Hopper route there (source:
        # its file), with the sweep's and the ViT-S width's figures beside
        {**entry("sae_fused_forward_topk", SAE_TC_SOURCE, TOPK_REPLACES["sae_fused_forward_topk"],
                 topk_launches["sae_fused_forward_topk"], topk_rec("sae_fused_forward_topk")),
         **topk_tc_extra(topk_rec("sae_fused_forward_topk")),
         **f32_topk("sae_fused_forward_topk")},
        {**entry("sae_fused_backward_topk", SAE_TC_SOURCE,
                 TOPK_REPLACES["sae_fused_backward_topk"],
                 topk_remat_launches["sae_fused_backward_topk"],
                 topk_rec("sae_fused_backward_topk")),
         **topk_tc_extra(topk_rec("sae_fused_backward_topk")),
         "b9_equals_b6_on_h": topk_rec("sae_fused_backward_topk")["B9_equals_B6_on_h"],
         **f32_topk("sae_fused_backward_topk"),
         "f32_b9_equals_b6_on_h":
             topk_kernels[("sae_fused_backward_topk", "slice_f32")]["B9_equals_B6_on_h"]},
        # the generic TopK step's float32 [4096, 12288], with the other
        # shapes of KTH_SHAPES beside it; launches from the generic steps and
        # encode of the TopK step check
        {**entry("kth_value", KTH_SOURCE, KTH_REPLACES, kth_launches, kth["slice_f32"]),
         **{f"{shape}_{key}": kth[shape][key] for shape in ("slice_bf16", "wide_f32", "wide_bf16")
            for key in ("ms", "library_ms", "bound_ms")}}]
    # at the gated slice's bf16 shape; launches from its train path.  B11
    # and B12 run their Hopper route there (source: its file), with the
    # cuBLAS time of their products, and the sweep widths' and the ViT-S
    # width's (mma.sync route) figures beside; their float32 route (3xTF32,
    # f32_source) at the slice and the sweep's widths, with its launches on
    # the float32 gated train path
    gated_keys = ("route", "TFLOP_per_s", "cublas_products_ms", "ms", "bound_ms",
                  "max_abs_err", "bitwise_repeat")
    for k in GATED_SOURCES:
        rec = gated_kernels[(k, "slice_bf16")]
        line.append({**entry(k, SAE_TC_SOURCE, GATED_REPLACES[k], gated_launches[k], rec),
                     "gemm_route": rec["route"], "TFLOP_per_s": rec["TFLOP_per_s"],
                     "cublas_products_ms": rec["cublas_products_ms"],
                     "cublas_products_note": rec["cublas_products_note"],
                     "bitwise_repeat": rec["bitwise_repeat"],
                     "b12_recomputes_b11_acts_bitwise": rec["b12_recomputes_b11_acts_bitwise"],
                     "other_routes_source": GATED_SOURCES[k],
                     **{f"{shape}_{key}": gated_kernels[(k, shape)][key]
                        for shape in ("sweep_bf16", "vit_s_bf16") for key in gated_keys},
                     **f32_sae(k, gated_kernels, ("slice_f32", "sweep_f32")),
                     "f32_source": SAE_TF32_SOURCE, "f32_entry": SAE_TF32_GATED_ENTRIES[k],
                     "f32_path_launches": gated_f32_launches[k],
                     "f32_b12_recomputes_b11_acts_bitwise":
                         gated_kernels[(k, "slice_f32")]["b12_recomputes_b11_acts_bitwise"]})
    # at the B/32 grad paths' bf16 shape, with its CLIP L/14 figures beside;
    # launches from the vit_train path
    l14_bwd = grad_kernels[("l14", torch.bfloat16)]
    text_bwd = grad_kernels[("text_causal", torch.bfloat16)]
    line.append({**entry("attention_mix_tnh_bwd", GRAD_SOURCE, GRAD_REPLACES,
                         vit_train_launches["attention_mix_tnh_bwd"],
                         grad_kernels[("b32", torch.bfloat16)], "us", 1e-3),
                 "text_phase_launches": text_launches["attention_mix_tnh_bwd"],
                 "l14_ms": l14_bwd["us"] * 1e-3, "l14_library_ms": l14_bwd["library_us"] * 1e-3,
                 "l14_bound_ms": l14_bwd["bound_ms"], "l14_max_abs_err": l14_bwd["max_abs_err"],
                 "text_ms": text_bwd["us"] * 1e-3,
                 "text_library_ms": text_bwd["library_us"] * 1e-3,
                 "text_bound_ms": text_bwd["bound_ms"],
                 "text_max_abs_err": text_bwd["max_abs_err"],
                 **f32_figures(grad_kernels, [s[0] for s in GRAD_KERNEL_SHAPES
                                              if torch.float32 in s[-1]])})
    # B14 at B/32's bf16 QKV shape, launches from the fused-LN serve path;
    # B13 at CLIP L/14-336's bf16 serving shape (forward, launches from its
    # serve path) and attribution shape (backward passes, launches from the
    # attribution path), with its float32 figures beside.  No single library
    # call computes one backward pass, so library_ms is null there; SDPA's
    # whole backward at the same shape stands beside both passes as
    # library_bwd_ms (beside the f32 figures: f32_*_library_ms).
    # B14's figures at the text phase's two shapes beside it.
    # B14's float32 route (3xTF32) at each float32 shape, and its launches
    # on the float32 paths of l14_336_f32, beside.
    line.append({**entry("ln_matmul", LN_SOURCE, LN_REPLACES, ln_launches["ln_matmul"],
                         ln_kernels[("b32_qkv", torch.bfloat16)], "us", 1e-3),
                 "text_phase_launches": text_launches["ln_matmul"],
                 "f32_path_launches": {p_: l.get("ln_matmul", 0)
                                       for p_, l in l336_f32_launches.items()},
                 **f32_figures(ln_kernels, [s_[0] for s_ in LN_SHAPES
                                            if torch.float32 in s_[-1]]),
                 **{f"{shape}_{k}": v for shape in ("text_qkv", "text_mlp_in")
                    for k, v in (("ms", ln_kernels[(shape, torch.bfloat16)]["us"] * 1e-3),
                                 ("library_ms",
                                  ln_kernels[(shape, torch.bfloat16)]["library_us"] * 1e-3),
                                 ("bound_ms", ln_kernels[(shape, torch.bfloat16)]["bound_ms"]),
                                 ("max_abs_err",
                                  ln_kernels[(shape, torch.bfloat16)]["max_abs_err"]))}})
    serve_rec = flash_kernels[("l14_336_serve", torch.bfloat16)]
    attrib_rec = flash_kernels[("l14_336_attrib", torch.bfloat16)]
    passes = [("flash_attention_padded", serve_rec, "fwd", ("z",), l336_launches),
              ("flash_attention_padded_bwd_dkv", attrib_rec, "bwd_dkv", ("dk", "dv"),
               l336_attrib_launches),
              ("flash_attention_padded_bwd_dq", attrib_rec, "bwd_dq", ("dq",),
               l336_attrib_launches)]
    for name, rec, key, grads, launches in passes:
        flat = {"max_abs_err": max(rec["max_abs_err"][k] for k in grads),
                "us": rec["us"][key], "plain_us": rec["plain_us"][key],
                "library_us": rec["library_us"]["fwd"] if key == "fwd" else None,
                **rec["bound"][key]}
        e = entry(name, FLASH_SOURCES[name], FLASH_REPLACES[name], launches[name], flat, "us",
                  1e-3)
        # the float32 route (3xTF32) at each float32 shape, and its launches
        # on the float32 paths of l14_336_f32
        e["f32_path_launches"] = {p_: l.get(name, 0) for p_, l in l336_f32_launches.items()}
        for (shape, dt), r in flash_kernels.items():
            if dt == torch.float32:
                e.update({f"f32_{shape}_ms": r["us"][key] * 1e-3,
                          f"f32_{shape}_library_ms":
                              r["library_us"]["fwd" if key == "fwd" else "bwd"] * 1e-3,
                          f"f32_{shape}_bound_ms": r["bound"][key]["bound_ms"],
                          f"f32_{shape}_max_abs_err": max(r["max_abs_err"][k] for k in grads),
                          f"f32_{shape}_route": r["route"]})
        if key != "fwd":
            e["library_bwd_ms"] = rec["library_us"]["bwd"] * 1e-3
        else:  # the video towers' forwards beside
            for shape in ("vivit_b", "vjepa_h"):
                v = flash_kernels[(shape, torch.bfloat16)]
                e.update({f"{shape}_ms": v["us"]["fwd"] * 1e-3,
                          f"{shape}_library_ms": v["library_us"]["fwd"] * 1e-3,
                          f"{shape}_bound_ms": v["bound"]["fwd"]["bound_ms"],
                          f"{shape}_TFLOP_per_s": v["TFLOP_s"]["fwd"],
                          f"{shape}_route": v["route"],
                          f"{shape}_max_abs_err": v["max_abs_err"]["z"]})
        line.append(e)
    # B15 and B16 at B/32 bf16; launches from their op-level path (they have
    # no caller on any path of either package)
    line += [entry(k, src, rep_, mix_launches[k], mix_kernels[(k, "b32", torch.bfloat16)],
                   "us", 1e-3)
             for k, src, rep_ in (("attention_mix", MIX_SOURCE, MIX_REPLACES),
                                  ("fused_attention_block", BLOCK_SOURCE, BLOCK_REPLACES))]
    # each one's float32 route at the same shape beside
    for e in line[-2:]:
        r = mix_kernels[(e["name"], "b32", torch.float32)]
        e.update({f"f32_b32_{k.replace('us', 'ms')}": r[k] * (1e-3 if k.endswith("us") else 1)
                  for k in ("us", "library_us", "bound_ms", "max_abs_err", "route")
                  if k in r})
    # the sharded paths' launches, per rank of the world of two on gloo
    for e in line:
        per_case = {case: [r.get(e["name"], 0) for r in ranks]
                    for case, ranks in parallel_launches.items()
                    if any(r.get(e["name"], 0) for r in ranks)}
        if per_case:
            e["parallel_phase_launches_per_rank"] = per_case
        if e["name"] in tools_launches:
            e["tools_phase_launches"] = tools_launches[e["name"]]
    missing = [e["name"] for e in line if not e["launches"] > 0]
    if missing:
        raise AssertionError(f"kernels not launched on their main paths: {missing}")
    emit({"phase_seconds": PHASE_SECONDS, "total_s": time.perf_counter() - T_START,
          "card": name_power, "profile_padded": PROFILE_PADDED,
          "cuda_event_fallbacks": CUDA_EVENT_FALLBACKS, "names_retaken": NAMES_RETAKEN})
    print(name_power)
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    sys.exit(main())
