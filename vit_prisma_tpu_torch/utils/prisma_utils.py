"""Utility helpers (PyTorch port of ``vit_prisma_tpu/utils/prisma_utils.py``).

Only the hook-name resolver :func:`get_act_name` is ported; ``to_numpy``,
``Slice`` and ``test_prompt`` wait for the analysis surface (ROADMAP queue A,
item 11).
"""

from __future__ import annotations

import re
from typing import Optional, Union

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

_NOT_PORTED = ("is not ported yet (ROADMAP queue A, item 11: analysis "
               "surface)")


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


def to_numpy(x):
    raise NotImplementedError(f"to_numpy {_NOT_PORTED}")


class Slice:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"Slice {_NOT_PORTED}")


def test_prompt(*args, **kwargs):
    raise NotImplementedError(f"test_prompt {_NOT_PORTED}")
