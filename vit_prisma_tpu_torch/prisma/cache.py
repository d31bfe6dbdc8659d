"""ActivationCache: a dict-like view over cached activations with the
analyses of the residual stream (PyTorch port of
``vit_prisma_tpu/prisma/cache.py``).

Shorthand keys (``("resid_pre", 5)``, negative layers) resolve through
:func:`get_act_name`.  ``accumulated_resid``, ``decompose_resid``, the head
and neuron results, ``stack_activation``, ``apply_ln_to_stack`` (with the
*cached* LayerNorm scales) and ``get_full_resid_decomposition`` compute in
torch on the cache's own device, without gradients.
"""

from __future__ import annotations

import logging
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from vit_prisma_tpu_torch.utils import prisma_utils as utils
from vit_prisma_tpu_torch.utils.prisma_utils import Slice, SliceInput


def _cat(tensors: List[torch.Tensor], dim: int = 0) -> torch.Tensor:
    """``torch.cat`` in the promoted dtype of the inputs (bfloat16 heads
    beside a float32 bias give float32, as ``jnp.concatenate`` does)."""
    dtype = tensors[0].dtype
    for t in tensors[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return torch.cat([t.to(dtype) for t in tensors], dim=dim)


class ActivationCache:
    def __init__(self, cache_dict: Dict[str, torch.Tensor], model,
                 has_batch_dim: bool = True):
        self.cache_dict = dict(cache_dict)
        self.model = model
        self.has_batch_dim = has_batch_dim
        self.has_embed = "hook_embed" in self.cache_dict
        self.has_pos_embed = "hook_pos_embed" in self.cache_dict

    # -- dict protocol ---------------------------------------------------
    def __getitem__(self, key) -> torch.Tensor:
        if key in self.cache_dict:
            return self.cache_dict[key]
        if isinstance(key, str):
            return self.cache_dict[utils.get_act_name(key)]
        if len(key) > 1 and key[1] is not None and key[1] < 0:
            key = (key[0], self.model.cfg.n_layers + key[1], *key[2:])
        return self.cache_dict[utils.get_act_name(*key)]

    def __contains__(self, key) -> bool:
        try:
            self[key]
            return True
        except KeyError:
            return False

    def __len__(self) -> int:
        return len(self.cache_dict)

    def __iter__(self) -> Iterator[str]:
        return iter(self.cache_dict)

    def keys(self):
        return self.cache_dict.keys()

    def values(self):
        return self.cache_dict.values()

    def items(self):
        return self.cache_dict.items()

    def __repr__(self) -> str:
        return f"ActivationCache with keys {list(self.cache_dict.keys())}"

    def remove_batch_dim(self) -> "ActivationCache":
        if self.has_batch_dim:
            for key in self.cache_dict:
                assert self.cache_dict[key].shape[0] == 1, (
                    f"Cannot remove batch dimension from cache with batch "
                    f"size > 1, for key {key} with shape "
                    f"{tuple(self.cache_dict[key].shape)}")
                self.cache_dict[key] = self.cache_dict[key][0]
            self.has_batch_dim = False
        else:
            logging.warning(
                "Tried removing batch dimension after already having removed it.")
        return self

    # -- residual-stream analyses ---------------------------------------
    @torch.no_grad()
    def accumulated_resid(self, layer: Optional[int] = None,
                          incl_mid: bool = False, apply_ln: bool = False,
                          pos_slice: SliceInput = None, mlp_input: bool = False,
                          return_labels: bool = False):
        """The accumulated residual stream entering each layer up to
        ``layer`` (the logit lens's input): ``[components, ..., d_model]``."""
        if not isinstance(pos_slice, Slice):
            pos_slice = Slice(pos_slice)
        if layer is None or layer == -1:
            layer = self.model.cfg.n_layers
        labels, components = [], []
        for l in range(layer + 1):
            if l == self.model.cfg.n_layers:
                components.append(self[("resid_post", l - 1)])
                labels.append("final_post")
                continue
            components.append(self[("resid_pre", l)])
            labels.append(f"{l}_pre")
            if (incl_mid and l < layer) or (mlp_input and l == layer):
                components.append(self[("resid_mid", l)])
                labels.append(f"{l}_mid")
        components = torch.stack([pos_slice.apply(c, dim=-2) for c in components], dim=0)
        if apply_ln:
            components = self.apply_ln_to_stack(components, layer,
                                                pos_slice=pos_slice,
                                                mlp_input=mlp_input)
        return (components, labels) if return_labels else components

    @torch.no_grad()
    def decompose_resid(self, layer: Optional[int] = None,
                        mlp_input: bool = False, mode: str = "all",
                        apply_ln: bool = False, pos_slice: SliceInput = None,
                        incl_embeds: bool = True, return_labels: bool = False):
        """The residual input to ``layer`` as per-component contributions:
        embeddings, then each layer's attention and MLP outputs."""
        if not isinstance(pos_slice, Slice):
            pos_slice = Slice(pos_slice)
        if layer is None or layer == -1:
            layer = self.model.cfg.n_layers
        incl_attn = mode != "mlp"
        incl_mlp = mode != "attn" and not self.model.cfg.attn_only
        components, labels = [], []
        if incl_embeds:
            if self.has_embed:
                components.append(self["hook_embed"])
                labels.append("embed")
            if self.has_pos_embed:
                components.append(self["hook_pos_embed"])
                labels.append("pos_embed")
        for l in range(layer):
            if incl_attn:
                components.append(self[("attn_out", l)])
                labels.append(f"{l}_attn_out")
            if incl_mlp:
                components.append(self[("mlp_out", l)])
                labels.append(f"{l}_mlp_out")
        if mlp_input and incl_attn:
            components.append(self[("attn_out", layer)])
            labels.append(f"{layer}_attn_out")
        components = torch.stack([pos_slice.apply(c, dim=-2) for c in components], dim=0)
        if apply_ln:
            components = self.apply_ln_to_stack(components, layer,
                                                pos_slice=pos_slice,
                                                mlp_input=mlp_input)
        return (components, labels) if return_labels else components

    # -- head / neuron attribution --------------------------------------
    @torch.no_grad()
    def compute_head_results(self):
        """Per-head results ``z @ W_O`` for every layer, cached as
        ``blocks.{l}.attn.hook_result``."""
        if "blocks.0.attn.hook_result" in self.cache_dict:
            logging.warning("Tried to compute head results when they were already cached")
            return
        W_O = self.model.W_O  # [n_layers, n_heads, d_head, d_model]
        for l in range(self.model.cfg.n_layers):
            self.cache_dict[f"blocks.{l}.attn.hook_result"] = torch.einsum(
                "...nh,nhd->...nd", self[("z", l, "attn")], W_O[l])

    @torch.no_grad()
    def stack_head_results(self, layer: int = -1, return_labels: bool = False,
                           incl_remainder: bool = False,
                           pos_slice: SliceInput = None,
                           apply_ln: bool = False):
        """Per-head residual contributions up to ``layer``:
        ``[(layer head), ..., d_model]``, and the remainder of the last
        resid_post with ``incl_remainder``."""
        if not isinstance(pos_slice, Slice):
            pos_slice = Slice(pos_slice)
        if layer is None or layer == -1:
            layer = self.model.cfg.n_layers
        if "blocks.0.attn.hook_result" not in self.cache_dict:
            self.compute_head_results()

        components, labels = [], []
        for l in range(layer):
            components.append(pos_slice.apply(self[("result", l, "attn")], dim=-3))
            labels.extend([f"L{l}H{h}" for h in range(self.model.cfg.n_heads)])
        if components:
            stacked = torch.cat(components, dim=-2)
            stacked = stacked.movedim(-2, 0)  # [(layer head), ..., d_model]
            if incl_remainder:
                remainder = pos_slice.apply(self[("resid_post", layer - 1)], dim=-2) \
                    - stacked.sum(dim=0)
                stacked = torch.cat([stacked, remainder[None]], dim=0)
                labels.append("remainder")
            components = stacked
        elif incl_remainder:
            components = torch.stack(
                [pos_slice.apply(self[("resid_post", layer - 1)], dim=-2)], dim=0)
            labels.append("remainder")
        else:
            embed = self["hook_embed"]
            components = torch.zeros(
                (0, *pos_slice.apply(embed, dim=-2).shape), device=embed.device)
        if apply_ln:
            components = self.apply_ln_to_stack(components, layer, pos_slice=pos_slice)
        return (components, labels) if return_labels else components

    @torch.no_grad()
    def stack_activation(self, activation_name: str, layer: int = -1,
                         sublayer_type: Optional[str] = None) -> torch.Tensor:
        """One activation stacked over the layers up to ``layer``."""
        if layer is None or layer == -1:
            layer = self.model.cfg.n_layers
        return torch.stack(
            [self[(activation_name, l, sublayer_type)] for l in range(layer)], dim=0)

    @torch.no_grad()
    def get_neuron_results(self, layer: int, neuron_slice: SliceInput = None,
                           pos_slice: SliceInput = None) -> torch.Tensor:
        """Per-neuron residual contributions of one layer:
        ``[..., neurons, d_model]``."""
        if not isinstance(neuron_slice, Slice):
            neuron_slice = Slice(neuron_slice)
        if not isinstance(pos_slice, Slice):
            pos_slice = Slice(pos_slice)
        neuron_acts = self[("post", layer, "mlp")]
        W_out = self.model.blocks[layer].mlp.W_out
        neuron_acts = pos_slice.apply(neuron_acts, dim=-2)
        neuron_acts = neuron_slice.apply(neuron_acts, dim=-1)
        W_out = neuron_slice.apply(W_out, dim=0)
        return neuron_acts[..., None] * W_out

    @torch.no_grad()
    def stack_neuron_results(self, layer: int, pos_slice: SliceInput = None,
                             neuron_slice: SliceInput = None,
                             return_labels: bool = False,
                             incl_remainder: bool = False,
                             apply_ln: bool = False):
        """Per-neuron residual contributions up to ``layer``:
        ``[(layer neuron), ..., d_model]``."""
        if layer is None or layer == -1:
            layer = self.model.cfg.n_layers
        if not isinstance(neuron_slice, Slice):
            neuron_slice = Slice(neuron_slice)
        if not isinstance(pos_slice, Slice):
            pos_slice = Slice(pos_slice)

        components, labels = [], []
        neuron_labels = neuron_slice.apply(np.arange(self.model.cfg.d_mlp), dim=0)
        if isinstance(neuron_labels, (int, np.integer)):
            neuron_labels = np.array([neuron_labels])
        for l in range(layer):
            components.append(self.get_neuron_results(
                l, pos_slice=pos_slice, neuron_slice=neuron_slice))
            labels.extend([f"L{l}N{h}" for h in neuron_labels])
        if components:
            stacked = torch.cat(components, dim=-2)
            stacked = stacked.movedim(-2, 0)
            if incl_remainder:
                remainder = pos_slice.apply(self[("resid_post", layer - 1)], dim=-2) \
                    - stacked.sum(dim=0)
                stacked = torch.cat([stacked, remainder[None]], dim=0)
                labels.append("remainder")
            components = stacked
        elif incl_remainder:
            components = torch.stack(
                [pos_slice.apply(self[("resid_post", layer - 1)], dim=-2)], dim=0)
            labels.append("remainder")
        else:
            embed = self["hook_embed"]
            components = torch.zeros(
                (0, *pos_slice.apply(embed, dim=-2).shape), device=embed.device)
        if apply_ln:
            components = self.apply_ln_to_stack(components, layer, pos_slice=pos_slice)
        return (components, labels) if return_labels else components

    # -- LN scaling ------------------------------------------------------
    @torch.no_grad()
    def apply_ln_to_stack(self, residual_stack: torch.Tensor,
                          layer: Optional[int] = None, mlp_input: bool = False,
                          pos_slice: SliceInput = None,
                          batch_slice: SliceInput = None,
                          has_batch_dim: bool = True) -> torch.Tensor:
        """Centre a residual stack and divide it by the *cached* LayerNorm
        scale of ``layer``'s input (ln_final's past the last layer)."""
        if self.model.cfg.normalization_type not in ["LN", "LNPre"]:
            return residual_stack
        if not isinstance(pos_slice, Slice):
            pos_slice = Slice(pos_slice)
        if not isinstance(batch_slice, Slice):
            batch_slice = Slice(batch_slice)
        if layer is None or layer == -1:
            layer = self.model.cfg.n_layers

        if has_batch_dim:
            residual_stack = batch_slice.apply(residual_stack, dim=1)
        residual_stack = residual_stack - residual_stack.mean(dim=-1, keepdim=True)

        if layer == self.model.cfg.n_layers:
            scale = self["ln_final.hook_scale"]
        else:
            scale = self[f"blocks.{layer}.ln{2 if mlp_input else 1}.hook_scale"]
        scale = pos_slice.apply(scale, dim=-2)
        if self.has_batch_dim:
            scale = batch_slice.apply(scale)
        return residual_stack / scale

    @torch.no_grad()
    def get_full_resid_decomposition(self, layer: Optional[int] = None,
                                     mlp_input: bool = False,
                                     expand_neurons: bool = True,
                                     apply_ln: bool = False,
                                     pos_slice: SliceInput = None,
                                     return_labels: bool = False):
        """The residual input to ``layer`` as heads, neurons (or MLP
        outputs), the embeddings where cached, and the accumulated bias.
        Every component is materialized, as in the JAX package."""
        if layer is None or layer == -1:
            layer = self.model.cfg.n_layers
        if not isinstance(pos_slice, Slice):
            pos_slice = Slice(pos_slice)
        head_stack, head_labels = self.stack_head_results(
            layer + (1 if mlp_input else 0), pos_slice=pos_slice,
            return_labels=True)
        labels = list(head_labels)
        components = [head_stack]
        if not self.model.cfg.attn_only and layer > 0:
            if expand_neurons:
                neuron_stack, neuron_labels = self.stack_neuron_results(
                    layer, pos_slice=pos_slice, return_labels=True)
                labels.extend(neuron_labels)
                components.append(neuron_stack)
            else:
                mlp_stack, mlp_labels = self.decompose_resid(
                    layer, mlp_input=mlp_input, pos_slice=pos_slice,
                    incl_embeds=False, mode="mlp", return_labels=True)
                labels.extend(mlp_labels)
                components.append(mlp_stack)
        if self.has_embed:
            labels.append("embed")
            components.append(pos_slice.apply(self["embed"], -2)[None])
        if self.has_pos_embed:
            labels.append("pos_embed")
            components.append(pos_slice.apply(self["pos_embed"], -2)[None])
        bias = self.model.accumulated_bias(layer, mlp_input,
                                           include_mlp_biases=expand_neurons)
        bias = bias.to(head_stack.device).broadcast_to((1,) + tuple(head_stack.shape[1:]))
        labels.append("bias")
        components.append(bias)
        residual_stack = _cat(components, dim=0)
        if apply_ln:
            residual_stack = self.apply_ln_to_stack(
                residual_stack, layer, pos_slice=pos_slice, mlp_input=mlp_input)
        return (residual_stack, labels) if return_labels else residual_stack
