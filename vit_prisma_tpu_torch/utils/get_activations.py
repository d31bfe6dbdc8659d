"""Batch activation harvester (PyTorch port of
``vit_prisma_tpu/utils/get_activations.py``).

One cached forward a batch, ``run_with_cache(names_filter=[name],
stop_at_layer=...)``, stopped just past the hook's block (kernel B1 in every
block it runs, where the attention gate admits it).

Four deliberate differences from the JAX function, each tested:

* a dotted name that the model does not have raises ``ValueError`` naming
  it; only a name without a ``.`` (``"resid_post"``) takes the last-layer
  shorthand (the JAX function mangles a dotted name through that fallback);
* exactly ``max_count`` batches are taken from the loader
  (``itertools.islice``), where the JAX loop pulls one more and drops it;
* the activations keep the hook's dtype (the JAX function casts to
  float32);
* ``return_labels=True`` with no labelled batch raises ``ValueError``
  (the JAX function returns zero labels).
"""

from __future__ import annotations

import itertools
import re
from typing import Iterable, Optional, Tuple, Union

import numpy as np
import torch

__all__ = ["get_activations", "hook_stop_layer"]

_BLOCK_RE = re.compile(r"^blocks\.(\d+)\.")


def hook_stop_layer(hook_name: str, n_layers: int) -> Optional[int]:
    """Earliest ``stop_at_layer`` that still computes ``hook_name``:
    ``blocks.L.*`` needs ``L + 1``, pre-block names (the embeddings) ``0``,
    post-block names (``ln_final``, the head) the whole stack (None)."""
    m = _BLOCK_RE.match(hook_name)
    if m:
        layer = int(m.group(1))
        if layer >= n_layers:
            raise ValueError(f"{hook_name!r} names layer {layer} but the "
                             f"model has {n_layers} layers")
        return layer + 1
    if "embed" in hook_name:
        return 0
    return None


def _resolve_name(model, hook_name: str) -> str:
    from vit_prisma_tpu_torch.models.vit import hook_names
    from vit_prisma_tpu_torch.utils.prisma_utils import get_act_name

    names = set(hook_names(model.cfg))
    if "." in hook_name:
        if hook_name not in names:
            raise ValueError(f"hook {hook_name!r} is not available on this model")
        return hook_name
    name = get_act_name(hook_name)
    if name in names:
        return name
    # a layer-less block shorthand ("resid_post", "pattern", ...): the last layer
    name = get_act_name(hook_name, model.cfg.n_layers - 1)
    if name not in names:
        raise ValueError(f"hook {hook_name!r} is not available on this model")
    return name


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x)).to(device)


def get_activations(model, hook_name: str, data_loader: Iterable,
                    max_count: int = 0, test_run: bool = False,
                    return_labels: bool = False,
                    ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Harvest ``hook_name`` activations for the batches of ``data_loader``
    (``images`` or ``(images, labels)`` items): ``max_count`` batches (0:
    the whole loader; ``test_run``: one).  Returns ``[num_examples, ...]``
    on the model's device in the hook's dtype, and the stacked labels
    (int64, on the CPU) with ``return_labels=True``."""
    name = _resolve_name(model, hook_name)
    stop = hook_stop_layer(name, model.cfg.n_layers)
    device = next(model.parameters()).device
    n_batches = 1 if test_run else (max_count if max_count > 0 else None)

    chunks, label_chunks = [], []
    for batch in itertools.islice(data_loader, n_batches):
        if isinstance(batch, (tuple, list)):
            images, labels = batch[0], batch[1] if len(batch) > 1 else None
        else:
            images, labels = batch, None
        _, cache = model.run_with_cache(_as_tensor(images, device), names_filter=[name],
                                        stop_at_layer=stop, return_cache_object=False)
        chunks.append(cache[name])
        if labels is not None:
            label_chunks.append(torch.as_tensor(np.asarray(labels)).to(torch.int64))
    if not chunks:
        raise ValueError("data_loader yielded no batches")
    acts = torch.cat(chunks, dim=0)
    if return_labels:
        if not label_chunks:
            raise ValueError("return_labels=True but no batch carried labels")
        return acts, torch.cat(label_chunks, dim=0)
    return acts
