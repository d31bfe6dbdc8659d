"""Train steps of the fused SAE kernels alone, without the ViT: the sweep's
step (24 SAEs, 1024 -> 8192, batch 4096, bf16; ``chip_smoke.sweep_config``),
the same at the config's default float32 compute dtype (``compute_dtype``
unset, float32 batches), the TopK slice's (bench.py's bf16 TopK row;
``chip_smoke.topk_config``) and the same at its float32 compute dtype
(bench.py's TopK recipe as it stands: no ``compute_dtype``); ``--f32`` runs
only the two float32 steps.  Each with its activations kept
(``fused_store_acts`` True: B4+B6, B8+B6) and recomputed (False: B4+B5,
B8+B9), from one random state on random batches of
the store's row dtype: ms a step by CUDA events over STEPS steps after two
warm-up steps, and ``torch.profiler``'s device time by kernel over three.
Prints JSON lines.  Run from the repository root on a CUDA card:
``python3 probes/sae_steps.py``.  A copy of this file in another checkout's
``probes/`` measures that checkout (how a parent and a change are compared
in turns)."""

import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

STEPS = 10


def measure(name, step, state, batches, cfg):
    def run(n):
        s = state
        for j in range(n):
            s, _ = step(s, batches[j % len(batches)], cfg)

    run(2)
    ms = chip_smoke.cuda_us(lambda: run(STEPS), iters=1, warmup=0) / 1000.0 / STEPS
    prof = chip_smoke._profile(lambda: run(3), warm=True, top=12)
    return {"step": name, "fused_store_acts": cfg.fused_store_acts, "ms_per_step": ms,
            "device_busy_ms_per_step": prof["device_busy_ms"] / 3,
            "kernels_of_3_steps": prof["kernels"]}


def main():
    from vit_prisma_tpu_torch.sae.train import (init_sweep_state, init_train_state,
                                                sae_sweep_train_step, sae_train_step)
    torch.backends.cuda.matmul.allow_tf32 = False
    info = {"card": chip_smoke.card()}
    print(json.dumps(info), flush=True)
    g = torch.Generator(device="cuda").manual_seed(11)
    f32_only = "--f32" in sys.argv[1:]
    sweeps = [("sweep_f32", chip_smoke.sweep_config().replace(compute_dtype=None),
               torch.float32)]
    if not f32_only:
        sweeps.insert(0, ("sweep", chip_smoke.sweep_config(), torch.bfloat16))
    for name, cfg, row_dtype in sweeps:
        L = len(cfg.sweep_layers)
        state = init_sweep_state(cfg, L, device="cuda")
        batches = [torch.randn(cfg.train_batch_size, L, cfg.d_in, generator=g,
                               device="cuda").to(row_dtype) for _ in range(3)]
        for keep in (True, False):
            print(json.dumps({**info, **measure(name, sae_sweep_train_step, state, batches,
                                                cfg.replace(fused_store_acts=keep))}),
                  flush=True)
        del state, batches
        torch.cuda.empty_cache()
    topks = [("topk_f32", chip_smoke.topk_config().replace(compute_dtype=None))]
    if not f32_only:
        topks.insert(0, ("topk", chip_smoke.topk_config()))
    for name, cfg in topks:
        state = init_train_state(cfg, device="cuda")
        batches = [torch.randn(cfg.train_batch_size, cfg.d_in, generator=g, device="cuda")
                   for _ in range(3)]
        for keep in (True, False):
            print(json.dumps({**info, **measure(name, sae_train_step, state, batches,
                                                cfg.replace(fused_store_acts=keep))}),
                  flush=True)


if __name__ == "__main__":
    main()
