"""chip_smoke.py's kernel phases alone, after the build: each named phase
(``take_rows``, ``kth_value``, ``grad_kernels``, ``flash_kernels``, ...: the
``phase_<name>`` functions that take only the card's record) in the order
given.  Prints chip_smoke.py's JSON records.  Run from the repository root
on a CUDA card: ``python3 probes/kernel_phases.py take_rows kth_value``."""

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
        getattr(chip_smoke, f"phase_{name}")(info)
        chip_smoke.release()


if __name__ == "__main__":
    main()
