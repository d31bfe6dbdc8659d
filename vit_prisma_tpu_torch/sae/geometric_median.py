"""Geometric median by Weiszfeld iterations (PyTorch port of
``vit_prisma_tpu/sae/geometric_median.py``): a fixed ``maxiter`` with no
early exit, as in the JAX package, so the loop never syncs with the host."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class GeometricMedianResult(NamedTuple):
    median: torch.Tensor
    new_weights: torch.Tensor


def compute_geometric_median(points: torch.Tensor,
                             weights: Optional[torch.Tensor] = None,
                             eps: float = 1e-6, maxiter: int = 100
                             ) -> GeometricMedianResult:
    """points [n, d] -> median [d], in float32 on the points' device."""
    points = points.float()
    if weights is None:
        weights = torch.ones(points.shape[0], device=points.device)

    def weighted_average(w):
        return (points * w[:, None]).sum(0) / w.sum()

    median, new_w = weighted_average(weights), weights
    for _ in range(maxiter):
        norms = torch.linalg.norm(points - median[None, :], dim=1)
        new_w = weights / torch.clamp(norms, min=eps)
        median = weighted_average(new_w)
    return GeometricMedianResult(median=median, new_weights=new_w)
