"""Flat reference-named state dicts into the port (PyTorch port of
``vit_prisma_tpu/models/loading/state_dict.py``).

The port's modules already carry the reference's flat names
(``blocks.{l}.attn.W_Q``), so what is left here is the patch-embedding
layout and the JAX package's stacked-by-layer parameter tree.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from vit_prisma_tpu_torch.configs.vit_config import ViTConfig

Flat = Dict[str, Any]


def _tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v
    a = np.asarray(v)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: exact via float32
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def port_state_dict(flat: Flat, cfg: ViTConfig) -> Dict[str, torch.Tensor]:
    """Flat reference-named dict (numpy arrays or tensors) -> the port's
    ``state_dict`` keys and shapes.

    Accepts the matmul layout ``embed.W [C*P*P, d_model]`` or the
    convolution's ``embed.proj.weight [d_model, C, P, P]`` (flattened in
    (C, Ph, Pw) order), or for a video config the Conv3d's ``[d_model, C,
    D, P, P]`` (flattened in (C, D, Ph, Pw) order, that of
    ``tubelet_patchify``).  ``cls_token`` of any shape is reshaped to
    ``[1, 1, d_model]``; a missing head is zero-filled, as in the JAX
    package.  Dtype and device are left to ``load_state_dict``."""
    out = {k: _tensor(v) for k, v in flat.items()}
    if "embed.proj.weight" in out:
        out["embed.W"] = out.pop("embed.proj.weight").reshape(cfg.d_model, -1).T
        out["embed.b"] = out.pop("embed.proj.bias")
    if "cls_token" in out:
        out["cls_token"] = out["cls_token"].reshape(1, 1, cfg.d_model)
    if "head.W_H" not in out:
        out["head.W_H"] = torch.zeros(cfg.d_model, cfg.n_classes)
        out["head.b_H"] = torch.zeros(cfg.n_classes)
    return out


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """The JAX package's nested parameter tree, with numpy leaves
    (``jax.tree.map(np.asarray, model.params)``) -> the port's flat dict.
    Leaves under ``blocks`` are stacked over layers and are split here."""
    flat: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif path[0] == "blocks":
            a = _tensor(node)
            for l in range(a.shape[0]):
                flat[".".join(("blocks", str(l)) + path[1:])] = a[l]
        else:
            flat[".".join(path)] = _tensor(node)

    walk(tree, ())
    return flat
