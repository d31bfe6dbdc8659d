"""chip_smoke.py's kernel phases for B2 (``grad``) and B13 (``flash``)
alone, after the build: each kernel against its plain version, its times
beside the library call's, and ptxas's record.  Prints chip_smoke.py's JSON
records.  Run from the repository root on a CUDA card:
``python3 probes/attn_bwd_kernels.py [grad] [flash]``."""

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    info = {"card": chip_smoke.card()}
    print(info["card"])
    chip_smoke.phase_build(info)
    if "grad" in sys.argv[1:]:
        chip_smoke.phase_grad_kernels(info)
    if "flash" in sys.argv[1:]:
        chip_smoke.phase_flash_kernels(info)


if __name__ == "__main__":
    main()
