"""Project directory constants (a copy of ``vit_prisma_tpu/utils/constants.py``
for the PyTorch port).

``BASE_DIR``, ``DATA_DIR`` and ``MODEL_DIR`` are the JAX package's, read
from the same environment variables.  :func:`device` gives the torch device
the port runs on: the CUDA card unless the caller asks for another.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

from vit_prisma_tpu_torch.utils.device import resolve_device

BASE_DIR = Path(os.environ.get("VIT_PRISMA_BASE_DIR",
                               Path(__file__).resolve().parents[2]))
DATA_DIR = Path(os.environ.get("VIT_PRISMA_DATA_DIR", BASE_DIR / "data"))
MODEL_DIR = Path(os.environ.get("VIT_PRISMA_MODEL_DIR", BASE_DIR / "models"))


def device(device=None) -> torch.device:
    """The device the port's entry points build on: ``device`` when given
    (``"cpu"`` on a host without a card), else the current CUDA card
    (``RuntimeError`` when there is none)."""
    return resolve_device(device)
