"""Flat reference-named state dicts into the port (PyTorch port of
``vit_prisma_tpu/models/loading/state_dict.py``).

The port's modules already carry the reference's flat names
(``blocks.{l}.attn.W_Q``), so what is left here is the patch-embedding
layout and the JAX package's stacked-by-layer parameter tree:
:func:`stack_params` and :func:`unstack_params` go between the flat dict
and that tree, as the JAX functions of the same names do (the text tower's
are ``models/text.py``'s ``stack_text_params`` and
``unstack_text_params``), and :func:`params_from_jax` reads the JAX
package's tree of either tower into the port.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from vit_prisma_tpu_torch.configs.vit_config import TextTransformerConfig, ViTConfig

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
    """The JAX package's nested parameter tree of a ``HookedViT`` or a
    ``HookedTextTransformer``, with numpy leaves (``jax.tree.map(np.asarray,
    model.params)``) -> the port's flat dict.  Leaves under ``blocks`` are
    stacked over layers and are split here."""
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


def stack_params(flat: Flat, cfg: ViTConfig) -> Dict[str, Any]:
    """Flat reference-named state dict (numpy arrays or tensors) -> the JAX
    package's parameter tree stacked by layer, as tensors in ``cfg``'s
    dtype.  Takes the matmul layout ``embed.W`` or the convolution's
    ``embed.proj.weight``; a missing head is zero-filled."""
    dt = cfg.torch_dtype

    def g(k):
        return _tensor(flat[k]).to(dt)

    params: Dict[str, Any] = {}
    if cfg.use_cls_token and "cls_token" in flat:
        params["cls_token"] = g("cls_token").reshape(1, 1, cfg.d_model)
    if "embed.proj.weight" in flat:
        w = g("embed.proj.weight")  # [d_model, C, (D,) P, P]
        params["embed"] = {"W": w.reshape(cfg.d_model, -1).T.contiguous(),
                           "b": g("embed.proj.bias")}
    else:
        params["embed"] = {"W": g("embed.W"), "b": g("embed.b")}
    params["pos_embed"] = {"W_pos": g("pos_embed.W_pos")}

    def stack(fmt: str):
        return torch.stack([g(fmt.format(l=l)) for l in range(cfg.n_layers)])

    ln = cfg.normalization_type == "LN"
    blocks: Dict[str, Any] = {
        "attn": {k: stack(f"blocks.{{l}}.attn.{k}")
                 for k in ["W_Q", "W_K", "W_V", "W_O", "b_Q", "b_K", "b_V", "b_O"]}}
    if ln:
        blocks["ln1"] = {"w": stack("blocks.{l}.ln1.w"), "b": stack("blocks.{l}.ln1.b")}
    if not cfg.attn_only:
        blocks["mlp"] = {k: stack(f"blocks.{{l}}.mlp.{k}")
                         for k in ["W_in", "b_in", "W_out", "b_out"]}
        if ln:
            blocks["ln2"] = {"w": stack("blocks.{l}.ln2.w"), "b": stack("blocks.{l}.ln2.b")}
        if cfg.activation_name == "solu_ln" and ln:
            blocks["mlp"]["ln"] = {"w": stack("blocks.{l}.mlp.ln.w"),
                                   "b": stack("blocks.{l}.mlp.ln.b")}
    params["blocks"] = blocks

    if cfg.layer_norm_pre and ln:
        params["ln_pre"] = {"w": g("ln_pre.w"), "b": g("ln_pre.b")}
    if ln:
        params["ln_final"] = {"w": g("ln_final.w"), "b": g("ln_final.b")}
    if "head.W_H" in flat:
        params["head"] = {"W_H": g("head.W_H"), "b_H": g("head.b_H")}
    else:
        params["head"] = {"W_H": torch.zeros(cfg.d_model, cfg.n_classes, dtype=dt),
                          "b_H": torch.zeros(cfg.n_classes, dtype=dt)}
    return params


def unstack_params(params: Dict[str, Any], cfg: ViTConfig) -> Flat:
    """The stacked tree (tensor or numpy leaves) -> the flat reference-named
    dict, with the patch embedding in the convolution's layout
    (``embed.proj.weight``), as the JAX function writes it."""
    flat: Flat = {}
    if "cls_token" in params:
        flat["cls_token"] = params["cls_token"]
    P, C = cfg.patch_size, cfg.n_channels
    conv = ((cfg.d_model, C, cfg.video_tubelet_depth, P, P) if cfg.is_video_transformer
            else (cfg.d_model, C, P, P))
    flat["embed.proj.weight"] = params["embed"]["W"].T.reshape(conv)
    flat["embed.proj.bias"] = params["embed"]["b"]
    flat["pos_embed.W_pos"] = params["pos_embed"]["W_pos"]

    blocks = params["blocks"]
    for l in range(cfg.n_layers):
        for k, v in blocks["attn"].items():
            flat[f"blocks.{l}.attn.{k}"] = v[l]
        if "ln1" in blocks:
            flat[f"blocks.{l}.ln1.w"] = blocks["ln1"]["w"][l]
            flat[f"blocks.{l}.ln1.b"] = blocks["ln1"]["b"][l]
        if "mlp" in blocks:
            for k in ["W_in", "b_in", "W_out", "b_out"]:
                flat[f"blocks.{l}.mlp.{k}"] = blocks["mlp"][k][l]
            if "ln" in blocks["mlp"]:
                flat[f"blocks.{l}.mlp.ln.w"] = blocks["mlp"]["ln"]["w"][l]
                flat[f"blocks.{l}.mlp.ln.b"] = blocks["mlp"]["ln"]["b"][l]
        if "ln2" in blocks:
            flat[f"blocks.{l}.ln2.w"] = blocks["ln2"]["w"][l]
            flat[f"blocks.{l}.ln2.b"] = blocks["ln2"]["b"][l]

    for ln in ("ln_pre", "ln_final"):
        if ln in params:
            flat[f"{ln}.w"] = params[ln]["w"]
            flat[f"{ln}.b"] = params[ln]["b"]
    flat["head.W_H"] = params["head"]["W_H"]
    flat["head.b_H"] = params["head"]["b_H"]
    return flat


def reference_state_dict(model) -> Dict[str, torch.Tensor]:
    """A port ``HookedViT``'s weights as the JAX package's flat state dict
    (``HookedViT.state_dict()`` there): the convolution's patch-embedding
    layout, the rest by the same names.  A ``HookedTextTransformer``'s
    as the JAX package's ``unstack_text_params`` gives them."""
    flat = {k: v.detach() for k, v in model.state_dict().items()}
    if isinstance(model.cfg, TextTransformerConfig):
        from vit_prisma_tpu_torch.models.text import stack_text_params, unstack_text_params
        return unstack_text_params(stack_text_params(flat, model.cfg), model.cfg)
    return unstack_params(stack_params(flat, model.cfg), model.cfg)
