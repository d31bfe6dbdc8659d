"""Patch-level logit lens (PyTorch port of
``vit_prisma_tpu/prisma/logit_lens.py``).

``get_patch_logit_directions`` projects the LayerNorm-scaled accumulated
residual stream onto class directions; ``get_patch_logit_dictionary`` reads
each patch's argmax class (and optionally a label's rank) layer by layer.
Class names are passed in (dict/list index -> name);
``vit_prisma_tpu_torch.dataloaders.imagenet_names.load_imagenet_dict``
gives the ImageNet table.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from vit_prisma_tpu_torch.utils.prisma_utils import to_numpy


@torch.no_grad()
def get_patch_logit_directions(cache, all_answers, incl_mid: bool = False,
                               return_labels: bool = True):
    """Project the accumulated residual stream onto class directions.

    ``all_answers``: [n_answers, d_model] class directions (e.g. rows of the
    unembedding / zero-shot classifier).  Returns
    ([batch, patches, layers, n_answers], labels)."""
    accumulated, labels = cache.accumulated_resid(
        layer=-1, incl_mid=incl_mid, return_labels=True)
    scaled = cache.apply_ln_to_stack(accumulated, layer=-1)
    answers = all_answers if isinstance(all_answers, torch.Tensor) \
        else torch.as_tensor(to_numpy(all_answers))
    result = torch.einsum("lbpd,od->lbpo", scaled, answers.to(scaled.device, scaled.dtype))
    result = result.permute(1, 2, 0, 3)
    if return_labels:
        return result, labels
    return result


def get_patch_logit_dictionary(patch_logit_directions, batch_idx: int = 0,
                               rank_label: Optional[str] = None,
                               class_names: Optional[Union[Dict[int, str], Sequence[str]]] = None,
                               name_to_index=None):
    """Per-patch, per-layer argmax readout.

    Returns {patch_idx: [(logit, predicted_name, predicted_idx[, rank]), …]}
    with one tuple per layer."""
    if isinstance(patch_logit_directions, tuple):
        patch_logit_directions = patch_logit_directions[0]
    directions = to_numpy(patch_logit_directions)

    def name_of(i: int) -> str:
        if class_names is None:
            return str(i)
        if isinstance(class_names, dict):
            return class_names.get(i, str(i))
        return class_names[i]

    patch_dictionary = defaultdict(list)
    for patch_idx, patches in enumerate(directions[batch_idx]):
        for logits in patches:  # one row per layer
            probs = _softmax(logits)
            predicted_idx = int(np.argmax(probs))
            logit = float(logits[predicted_idx])
            predicted_name = name_of(predicted_idx)
            if rank_label is not None:
                assert name_to_index is not None, \
                    "rank_label requires a name_to_index mapping"
                rank_index = name_to_index(rank_label)
                sorted_idx = np.argsort(-probs)
                rank = int(np.where(sorted_idx == rank_index)[0][0])
                patch_dictionary[patch_idx].append(
                    (logit, predicted_name, predicted_idx, rank))
            else:
                patch_dictionary[patch_idx].append(
                    (logit, predicted_name, predicted_idx))
    return patch_dictionary


def _softmax(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max())
    return e / e.sum()
