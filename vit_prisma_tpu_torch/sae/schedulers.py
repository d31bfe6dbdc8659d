"""LR schedules as step -> multiplier functions (PyTorch port of
``vit_prisma_tpu/sae/schedulers.py``): constant / constantwithwarmup /
linearwarmupdecay / cosineannealing / cosineannealingwarmup /
cosineannealingwarmrestarts.

The step may be a Python int or an integer tensor on any device; the result
is a float32 tensor on the step's device, so the train step can feed the
scheduled learning rate to the optimizer kernel without a host sync.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch


def get_schedule(scheduler_name: Optional[str], *, warm_up_steps: int = 0,
                 training_steps: Optional[int] = None, lr_end: float = 0.0,
                 num_cycles: int = 1) -> Callable:
    """Step -> LR multiplier in [0, 1] (float32 tensor)."""
    name = (scheduler_name or "constant").lower()

    if name == "constant":
        return lambda step: torch.ones_like(torch.as_tensor(step), dtype=torch.float32)

    if name == "constantwithwarmup":
        w = max(warm_up_steps, 1)
        return lambda step: torch.clamp((torch.as_tensor(step) + 1) / w, max=1.0)

    if name == "linearwarmupdecay":
        assert training_steps is not None, "training_steps must be provided"
        w, T = max(warm_up_steps, 1), training_steps

        def linear(step):
            s = torch.as_tensor(step)
            return torch.where(s < w, (s + 1) / w, (T - s) / max(T - w, 1))
        return linear

    if name == "cosineannealing":
        assert training_steps is not None, "training_steps must be provided"
        T = training_steps
        return lambda step: lr_end + 0.5 * (1 - lr_end) * (
            1 + torch.cos(math.pi * torch.as_tensor(step) / T))

    if name == "cosineannealingwarmup":
        assert training_steps is not None, "training_steps must be provided"
        w, T = max(warm_up_steps, 1), training_steps

        def sched(step):
            s = torch.as_tensor(step)
            progress = (s - w) / max(T - w, 1)
            cos_val = lr_end + 0.5 * (1 - lr_end) * (1 + torch.cos(math.pi * progress))
            return torch.where(s < w, (s + 1) / w, cos_val)
        return sched

    if name == "cosineannealingwarmrestarts":
        assert training_steps is not None, "training_steps must be provided"
        T0 = max(training_steps // max(num_cycles, 1), 1)
        return lambda step: lr_end + 0.5 * (1 - lr_end) * (
            1 + torch.cos(math.pi * (torch.as_tensor(step) % T0) / T0))

    raise ValueError(f"Unsupported scheduler: {scheduler_name}")
