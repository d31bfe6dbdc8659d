"""Weight-processing transforms: LayerNorm folding, weight centring, value
bias folding and the QK/OV refactoring (PyTorch port of
``vit_prisma_tpu/models/loading/processing.py``).

Functions over the *flat* reference-named state dict.  Values may be numpy
arrays or tensors; each transform works on tensors on their own device and
returns tensors, in the values' dtype (the converters give float32, so the
folding runs in float32, as in the JAX package).

As in the JAX package, folded LayerNorms are set to identity weights (ones
and zeros) rather than removed, so the processed model keeps ``LN`` and
takes the same routes (the LayerNorm-prologue GEMM B14 included); the
computation is the same.
"""

from __future__ import annotations

import logging
from typing import Any, Dict

import torch

from vit_prisma_tpu_torch.configs.vit_config import ViTConfig
from vit_prisma_tpu_torch.models.loading.state_dict import _tensor
from vit_prisma_tpu_torch.prisma.factored_matrix import FactoredMatrix

Flat = Dict[str, Any]


def _tensors(flat: Flat) -> Dict[str, torch.Tensor]:
    return {k: _tensor(v) for k, v in flat.items()}


def fold_layer_norm(flat: Flat, cfg: ViTConfig, fold_biases: bool = True,
                    center_weights: bool = True) -> Flat:
    """Fold each LayerNorm's weight and bias into the linear layer that
    reads it, and centre the reading weights:
    ``LN(x) @ W = LNPre(x) @ (diag(w) @ W) + b @ W``."""
    sd = _tensors(flat)

    def identity_ln(prefix: str, length: int):
        like = sd["head.W_H"]
        sd[f"{prefix}.w"] = torch.ones(length, dtype=like.dtype, device=like.device)
        sd[f"{prefix}.b"] = torch.zeros(length, dtype=like.dtype, device=like.device)

    for l in range(cfg.n_layers):
        ln1_w = sd[f"blocks.{l}.ln1.w"]
        ln1_b = sd[f"blocks.{l}.ln1.b"]
        # Fold the biases first: they read the unfolded weights.
        if fold_biases:
            for m in ("Q", "K", "V"):
                sd[f"blocks.{l}.attn.b_{m}"] = sd[f"blocks.{l}.attn.b_{m}"] + (
                    sd[f"blocks.{l}.attn.W_{m}"] * ln1_b[None, :, None]).sum(-2)
        for m in ("Q", "K", "V"):
            W = sd[f"blocks.{l}.attn.W_{m}"] * ln1_w[None, :, None]
            if center_weights:
                # LNPre's output has zero mean, so the mean over d_model of
                # a reading weight is in its null space.
                W = W - W.mean(-2, keepdim=True)
            sd[f"blocks.{l}.attn.W_{m}"] = W
        identity_ln(f"blocks.{l}.ln1", cfg.d_model)

        if not cfg.attn_only:
            ln2_w = sd[f"blocks.{l}.ln2.w"]
            ln2_b = sd[f"blocks.{l}.ln2.b"]
            if fold_biases:
                sd[f"blocks.{l}.mlp.b_in"] = sd[f"blocks.{l}.mlp.b_in"] + (
                    sd[f"blocks.{l}.mlp.W_in"] * ln2_b[:, None]).sum(-2)
            W_in = sd[f"blocks.{l}.mlp.W_in"] * ln2_w[:, None]
            if center_weights:
                W_in = W_in - W_in.mean(-2, keepdim=True)
            sd[f"blocks.{l}.mlp.W_in"] = W_in
            identity_ln(f"blocks.{l}.ln2", cfg.d_model)

            if cfg.activation_name.startswith("solu"):
                # the MLP's inner LayerNorm folds into W_out
                mln_w = sd[f"blocks.{l}.mlp.ln.w"]
                mln_b = sd[f"blocks.{l}.mlp.ln.b"]
                if fold_biases:
                    sd[f"blocks.{l}.mlp.b_out"] = sd[f"blocks.{l}.mlp.b_out"] + (
                        sd[f"blocks.{l}.mlp.W_out"] * mln_b[:, None]).sum(-2)
                W_out = sd[f"blocks.{l}.mlp.W_out"] * mln_w[:, None]
                if center_weights:
                    W_out = W_out - W_out.mean(-2, keepdim=True)
                sd[f"blocks.{l}.mlp.W_out"] = W_out
                identity_ln(f"blocks.{l}.mlp.ln", cfg.d_mlp)

    # ln_final folds into the head.
    if fold_biases:
        sd["head.b_H"] = sd["head.b_H"] + (
            sd["head.W_H"] * sd["ln_final.b"][:, None]).sum(-2)
    W_H = sd["head.W_H"] * sd["ln_final.w"][:, None]
    if center_weights:
        W_H = W_H - W_H.mean(-2, keepdim=True)
    sd["head.W_H"] = W_H
    identity_ln("ln_final", cfg.d_model)
    return sd


def center_writing_weights(flat: Flat, cfg: ViTConfig) -> Flat:
    """Zero the d_model-mean of everything that writes to the residual
    stream; the computation is unchanged because every reader applies a
    LayerNorm first."""
    sd = _tensors(flat)
    sd["pos_embed.W_pos"] = sd["pos_embed.W_pos"] - \
        sd["pos_embed.W_pos"].mean(-1, keepdim=True)
    for l in range(cfg.n_layers):
        sd[f"blocks.{l}.attn.W_O"] = sd[f"blocks.{l}.attn.W_O"] - \
            sd[f"blocks.{l}.attn.W_O"].mean(-1, keepdim=True)
        sd[f"blocks.{l}.attn.b_O"] = sd[f"blocks.{l}.attn.b_O"] - \
            sd[f"blocks.{l}.attn.b_O"].mean()
        if not cfg.attn_only:
            sd[f"blocks.{l}.mlp.W_out"] = sd[f"blocks.{l}.mlp.W_out"] - \
                sd[f"blocks.{l}.mlp.W_out"].mean(-1, keepdim=True)
            sd[f"blocks.{l}.mlp.b_out"] = sd[f"blocks.{l}.mlp.b_out"] - \
                sd[f"blocks.{l}.mlp.b_out"].mean()
    return sd


def fold_value_biases(flat: Flat, cfg: ViTConfig) -> Flat:
    """b_O += sum over heads of b_V @ W_O; b_V = 0.  Exact because each
    attention pattern row sums to 1."""
    sd = _tensors(flat)
    for l in range(cfg.n_layers):
        b_V = sd[f"blocks.{l}.attn.b_V"]       # [head, d_head]
        W_O = sd[f"blocks.{l}.attn.W_O"]       # [head, d_head, d_model]
        sd[f"blocks.{l}.attn.b_O"] = sd[f"blocks.{l}.attn.b_O"] + \
            (b_V[:, :, None] * W_O).sum((0, 1))
        sd[f"blocks.{l}.attn.b_V"] = torch.zeros_like(b_V)
    return sd


def refactor_factored_attn_matrices(flat: Flat, cfg: ViTConfig) -> Flat:
    """The QK and OV circuits refactored through their SVDs: W_Q and W_K
    share the singular values evenly (the biases folded in as a d_model+1-th
    row), W_V = U·S and W_O = Vhᵀ.  The singular vectors' signs are the
    solver's, so the weights may differ in sign from the JAX package's;
    the products they form do not."""
    sd = _tensors(flat)
    for l in range(cfg.n_layers):
        W_Q_eff = torch.cat(
            [sd[f"blocks.{l}.attn.W_Q"], sd[f"blocks.{l}.attn.b_Q"][:, None, :]], dim=1)
        W_K_eff = torch.cat(
            [sd[f"blocks.{l}.attn.W_K"], sd[f"blocks.{l}.attn.b_K"][:, None, :]], dim=1)
        W_Q_eff_even, W_K_eff_even_T = FactoredMatrix(
            W_Q_eff, W_K_eff.transpose(-1, -2)).make_even().pair
        W_K_eff_even = W_K_eff_even_T.transpose(-1, -2)
        sd[f"blocks.{l}.attn.W_Q"] = W_Q_eff_even[:, :-1, :]
        sd[f"blocks.{l}.attn.b_Q"] = W_Q_eff_even[:, -1, :]
        sd[f"blocks.{l}.attn.W_K"] = W_K_eff_even[:, :-1, :]
        sd[f"blocks.{l}.attn.b_K"] = W_K_eff_even[:, -1, :]

        W_V = sd[f"blocks.{l}.attn.W_V"]
        W_O = sd[f"blocks.{l}.attn.W_O"]
        b_V = sd[f"blocks.{l}.attn.b_V"]
        b_O = sd[f"blocks.{l}.attn.b_O"]
        sd[f"blocks.{l}.attn.b_O"] = b_O + torch.einsum("nh,nhd->d", b_V, W_O)
        sd[f"blocks.{l}.attn.b_V"] = torch.zeros_like(b_V)

        U, S, Vh = FactoredMatrix(W_V, W_O).svd()
        sd[f"blocks.{l}.attn.W_V"] = U * S[..., None, :]
        sd[f"blocks.{l}.attn.W_O"] = Vh.transpose(-1, -2)
    return sd


def process_state_dict(flat: Flat, cfg: ViTConfig, fold_ln: bool = True,
                       center_writing: bool = True,
                       fold_value_biases_flag: bool = True,
                       refactor_factored: bool = False) -> Flat:
    """The transforms in the reference's order: fold the LayerNorms, centre
    the writing weights, fold the value biases, refactor QK/OV."""
    sd = _tensors(flat)
    if fold_ln:
        if cfg.normalization_type in ("LN", "LNPre"):
            sd = fold_layer_norm(sd, cfg)
        else:
            logging.warning("No LayerNorm to fold; skipping")
    if center_writing:
        if cfg.normalization_type not in ("LN", "LNPre"):
            logging.warning("Not using LayerNorm; skipping weight centering")
        else:
            sd = center_writing_weights(sd, cfg)
    if fold_value_biases_flag:
        sd = fold_value_biases(sd, cfg)
    if refactor_factored:
        sd = refactor_factored_attn_matrices(sd, cfg)
    return sd
