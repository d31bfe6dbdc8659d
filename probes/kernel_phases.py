"""chip_smoke.py's kernel phases alone, after the build: each named phase
(``take_rows``, ``kth_value``, ``grad_kernels``, ``flash_kernels``,
``text``, ``tools``, ``parallel``, ...: the ``phase_<name>`` functions that
take only the card's record) in the order given; ``gated_train`` runs phase 14 alone, the gated train path and its
step profile, and ``topk_train`` phase 9 alone (the TopK train path, its
remat steps and its step profile).  Prints chip_smoke.py's JSON records.  Run from the
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
            chip_smoke.phase_step_profile(info, trainer, store, cfg, "gated_profile")
            del trainer, store
        elif name == "topk_train":
            trainer, store, cfg, _ = chip_smoke.phase_train(info, chip_smoke.topk_config(),
                                                            "topk_train", chip_smoke.SLICE_STEPS)
            chip_smoke.phase_topk_remat(info, trainer, store, cfg)
            chip_smoke.phase_step_profile(info, trainer, store, cfg, "topk_profile")
            del trainer, store
        else:
            getattr(chip_smoke, f"phase_{name}")(info)
        chip_smoke.release()


if __name__ == "__main__":
    main()
