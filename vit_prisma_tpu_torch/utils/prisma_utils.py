"""Utility helpers (PyTorch port of ``vit_prisma_tpu/utils/prisma_utils.py``):
the hook-name resolver :func:`get_act_name`, :func:`to_numpy`, :class:`Slice`
and the top-k readout :func:`test_prompt`.
"""

from __future__ import annotations

import re
from typing import Any, Optional, Sequence, Union

import numpy as np
import torch

_LAYER_TYPE_ALIAS = {
    "a": "attn",
    "m": "mlp",
    "b": "",
    "block": "",
    "blocks": "",
    "attention": "attn",
}

_ACT_NAME_ALIAS = {
    "attn": "pattern",
    "attn_logits": "attn_scores",
    "key": "k",
    "query": "q",
    "value": "v",
    "mlp_pre": "pre",
    "mlp_mid": "mid",
    "mlp_post": "post",
}

_ATTN_ACTS = {"k", "v", "q", "z", "rot_k", "rot_q", "result", "pattern", "attn_scores"}
_MLP_ACTS = {"pre", "post", "mid", "pre_linear"}
_LN_NAMES = {"scale", "normalized"}


def get_act_name(name: str, layer: Optional[Union[int, str]] = None,
                 layer_type: Optional[str] = None) -> str:
    """Shorthand -> hook-name resolver: ``get_act_name('k', 6) ==
    'blocks.6.attn.hook_k'``, ``'embed' -> 'hook_embed'``,
    ``'scale4ln1' -> 'blocks.4.ln1.hook_scale'``."""
    if ("." in name or name.startswith("hook_")) and layer is None and layer_type is None:
        return name
    match = re.match(r"([a-z]+)(\d+)([a-z]?.*)", name)
    if match is not None:
        name, layer, layer_type = match.groups(0)

    if name in _ACT_NAME_ALIAS:
        name = _ACT_NAME_ALIAS[name]

    full = ""
    if layer is not None:
        full += f"blocks.{layer}."
    if name in _ATTN_ACTS:
        layer_type = "attn"
    elif name in _MLP_ACTS:
        layer_type = "mlp"
    elif layer_type in _LAYER_TYPE_ALIAS:
        layer_type = _LAYER_TYPE_ALIAS[layer_type]
    if layer_type:
        full += f"{layer_type}."
    full += f"hook_{name}"
    if name in _LN_NAMES and layer is None:
        full = f"ln_final.{full}"
    return full


def to_numpy(x) -> np.ndarray:
    """Tensors (bfloat16 as float32), numpy arrays, lists, tuples and
    scalars as a numpy array."""
    if isinstance(x, np.ndarray):
        return x
    if isinstance(x, (list, tuple)):
        return np.array(x)
    if isinstance(x, (int, float, bool, np.number)):
        return np.array(x)
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


SliceInput = Optional[Union[int, slice, tuple, Sequence[int], np.ndarray, torch.Tensor]]


class Slice:
    """An int, a slice, a ``(start, stop[, step])`` tuple, a list or array
    of indices, or None (everything), applied along one axis of a tensor or
    numpy array."""

    def __init__(self, input_slice: SliceInput = None):
        if isinstance(input_slice, tuple):
            input_slice = slice(*input_slice)
        if input_slice is None:
            self.slice: Any = slice(None)
            self.mode = "identity"
        elif isinstance(input_slice, int):
            self.slice = input_slice
            self.mode = "int"
        elif isinstance(input_slice, slice):
            self.slice = input_slice
            self.mode = "slice"
        elif isinstance(input_slice, (list, np.ndarray)) or hasattr(input_slice, "shape"):
            self.slice = to_numpy(input_slice)
            self.mode = "array"
        elif isinstance(input_slice, Slice):
            self.slice = input_slice.slice
            self.mode = input_slice.mode
        else:
            raise ValueError(f"Invalid slice input {input_slice!r}")

    def apply(self, tensor, dim: int = 0):
        idx = [slice(None)] * tensor.ndim
        sl = self.slice
        if self.mode == "array" and isinstance(tensor, torch.Tensor):
            sl = torch.as_tensor(sl, dtype=torch.long, device=tensor.device)
        idx[dim] = sl
        return tensor[tuple(idx)]

    def indices(self, max_ctx: Optional[int] = None):
        if self.mode == "identity" and max_ctx is None:
            raise ValueError("Cannot get indices of an identity slice without max_ctx")
        return np.arange(max_ctx)[self.slice] if self.mode != "array" else self.slice

    def __repr__(self):
        return f"Slice: [{self.slice}], mode: {self.mode}"


def test_prompt(example_data_point, model, example_answer: Optional[str] = None,
                top_k: int = 10, class_names=None) -> None:
    """Top-k class readout for one image ``[C, H, W]`` (a batch dim is
    added): prints each of the top-k predictions with its logit and
    probability, then the rank of ``example_answer`` if given.
    ``class_names`` defaults to the ImageNet table.  The image goes to the
    device of ``model``'s parameters."""
    from vit_prisma_tpu_torch.dataloaders.imagenet_names import (
        imagenet_index_from_word, load_imagenet_dict)

    if class_names is None:
        class_names = load_imagenet_dict()

    x = torch.as_tensor(example_data_point)
    if x.ndim == 3:
        x = x[None]
    param = next(iter(model.parameters()), None) if hasattr(model, "parameters") else None
    if param is not None:
        x = x.to(param.device)
    logits = to_numpy(model(x))[0]
    probs = np.exp(logits - logits.max())
    probs = probs / probs.sum()
    order = np.argsort(probs)[::-1]

    for i in range(top_k):
        index = int(order[i])
        label = class_names.get(index, str(index)) \
            if isinstance(class_names, dict) else class_names[index]
        print(f"Top {i}th token. Logit: {logits[index]:.2f} "
              f"Prob: {probs[index] * 100:.2f}% Label: |{label}|")

    if example_answer is not None:
        answer_index = imagenet_index_from_word(example_answer,
                                                mapping=class_names)
        rank = int(np.where(order == answer_index)[0][0])
        print("Rank of the correct answer:")
        print(f"Class Name: {example_answer} | Rank: {rank} | "
              f"ImageNet Index: {answer_index}")
