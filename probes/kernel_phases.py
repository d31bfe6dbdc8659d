"""chip_smoke.py's kernel phases alone, after the build: each named phase
(``take_rows``, ``kth_value``, ``grad_kernels``, ``flash_kernels``,
``text``, ``tools``, ``parallel``, ...: the ``phase_<name>`` functions that
take only the card's record) in the order given; ``gated_train`` runs phase 14 alone (the
gated train path, its float32 steps, its step profile and the
fused-vs-generic float32 step check), ``topk_train`` phase 9 alone (the TopK train path, its
remat steps, its float32 steps, the fused-vs-generic step check and its
step profile), ``sweep_check`` the bf16 sweep and the
fused-vs-generic sweep step checks (bf16 and float32), and ``sweep_f32``
the sweep at the config's default float32 compute dtype.  Prints chip_smoke.py's JSON records.  Run from the
repository root on a CUDA card: ``python3 probes/kernel_phases.py take_rows
kth_value``.  A copy of this file in another checkout's ``probes/`` runs
that checkout's phases (how a parent and a change are compared in turns)."""

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = {"card": chip_smoke.card()}
    print(info["card"])
    chip_smoke.phase_build(info)
    for name in sys.argv[1:]:
        if name == "gated_train":
            trainer, store, cfg, _ = chip_smoke.phase_train(info, chip_smoke.gated_config(),
                                                            "gated_train", chip_smoke.SLICE_STEPS)
            chip_smoke.phase_gated_train_f32(info, trainer, store, cfg)
            chip_smoke.phase_step_profile(info, trainer, store, cfg, "gated_profile")
            chip_smoke.phase_gated_step_check(info, trainer, store, cfg)
            del trainer, store
        elif name == "sweep_check":  # the bf16 sweep, then the fused-vs-generic step checks
            trainer, store, cfg, _, _ = chip_smoke.phase_sweep(info)
            chip_smoke.check_sweep_steps(
                chip_smoke.phase_sweep_step_check(info, trainer, store, cfg))
            del trainer, store
        elif name == "sweep_f32":
            chip_smoke.phase_sweep(info, chip_smoke.sweep_f32_config(), "sweep_f32")
        elif name == "topk_train":
            trainer, store, cfg, _ = chip_smoke.phase_train(info, chip_smoke.topk_config(),
                                                            "topk_train", chip_smoke.SLICE_STEPS)
            chip_smoke.phase_topk_remat(info, trainer, store, cfg)
            chip_smoke.phase_topk_train_f32(info, trainer, store, cfg)
            chip_smoke.phase_topk_step_check(info, trainer, store, cfg)
            chip_smoke.phase_step_profile(info, trainer, store, cfg, "topk_profile")
            del trainer, store
        else:
            getattr(chip_smoke, f"phase_{name}")(info)
        chip_smoke.release()


if __name__ == "__main__":
    main()
