"""Model-type enum (a copy of ``vit_prisma_tpu/utils/enums.py``)."""

from enum import Enum


class ModelType(Enum):
    VISION = "vision"
    TEXT = "text"
