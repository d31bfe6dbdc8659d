"""HookedViT (PyTorch port of ``vit_prisma_tpu/models/vit.py``).

The model is an ``nn.Module`` with one module per block
(``blocks[l].attn.W_Q``), so ``state_dict()`` keys are the reference's flat
names (``blocks.{l}.attn.W_Q``).  The forward is :func:`vit_forward`, a
function over the module that threads a :class:`HookRuntime` through the
layers; ``run_with_cache`` and ``run_with_hooks`` build that runtime.
Forwards that need no gradient run under ``torch.inference_mode()``, so they
record no autograd graph; ``run_with_cache(incl_bwd=True)`` and
``bwd_hooks`` record one and take the gradients at the cached hook points
(:func:`grad_cached_traced`), through the attention backward kernel (B2) on
the fused path.
"""

from __future__ import annotations

import copy
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from vit_prisma_tpu_torch.configs.vit_config import ViTConfig
from vit_prisma_tpu_torch.models import layers as L
from vit_prisma_tpu_torch.models.loading.state_dict import _tensor, port_state_dict
from vit_prisma_tpu_torch.prisma.cache import ActivationCache
from vit_prisma_tpu_torch.prisma.factored_matrix import FactoredMatrix
from vit_prisma_tpu_torch.prisma.hooks import (
    NULL_HOOKS,
    HookRuntime,
    NamesFilter,
    grad_cached_traced,
    resolve_names_filter,
)
from vit_prisma_tpu_torch.utils.device import resolve_device


# ---------------------------------------------------------------------------
# Hook-name inventory (the API contract)
# ---------------------------------------------------------------------------

def block_hook_names(cfg: ViTConfig, l: int) -> List[str]:
    p = f"blocks.{l}"
    names = [f"{p}.hook_resid_pre"]
    if cfg.use_attn_in:
        names.append(f"{p}.hook_attn_in")
    if cfg.use_split_qkv_input:
        names += [f"{p}.hook_q_input", f"{p}.hook_k_input", f"{p}.hook_v_input"]

    ln1 = [f"{p}.ln1.hook_scale", f"{p}.ln1.hook_normalized"] if cfg.normalization_type else []
    attn = [f"{p}.attn.hook_q", f"{p}.attn.hook_k", f"{p}.attn.hook_v",
            f"{p}.attn.hook_attn_scores", f"{p}.attn.hook_pattern",
            f"{p}.attn.hook_z"]
    if cfg.use_attn_result:
        attn.append(f"{p}.attn.hook_result")

    if cfg.use_bert_block:
        names += attn + [f"{p}.hook_attn_out"] + ln1
    else:
        names += ln1 + attn + [f"{p}.hook_attn_out"]

    if not cfg.attn_only:
        names.append(f"{p}.hook_resid_mid")
        if cfg.use_hook_mlp_in:
            names.append(f"{p}.hook_mlp_in")
        ln2 = [f"{p}.ln2.hook_scale", f"{p}.ln2.hook_normalized"] if cfg.normalization_type else []
        mlp = [f"{p}.mlp.hook_pre"]
        if cfg.activation_name == "solu_ln":
            mlp.append(f"{p}.mlp.hook_mid")
            if cfg.normalization_type:
                mlp += [f"{p}.mlp.ln.hook_scale", f"{p}.mlp.ln.hook_normalized"]
        mlp.append(f"{p}.mlp.hook_post")
        if cfg.use_bert_block:
            names += mlp + [f"{p}.hook_mlp_out"] + ln2
        else:
            names += ln2 + mlp + [f"{p}.hook_mlp_out"]
    names.append(f"{p}.hook_resid_post")
    return names


def hook_names(cfg: ViTConfig) -> List[str]:
    """All hook names of a HookedViT, in firing order."""
    names = ["hook_embed", "hook_pos_embed", "hook_full_embed"]
    if cfg.layer_norm_pre:
        if cfg.normalization_type:
            names += ["ln_pre.hook_scale", "ln_pre.hook_normalized"]
        names.append("hook_ln_pre")
    for l in range(cfg.n_layers):
        names += block_hook_names(cfg, l)
    if cfg.normalization_type:
        names += ["ln_final.hook_scale", "ln_final.hook_normalized"]
    names += ["hook_ln_final", "hook_post_head_pre_normalize"]
    return names


# ---------------------------------------------------------------------------
# Parameter initialization
# ---------------------------------------------------------------------------

def init_vit_params(cfg: ViTConfig,
                    generator: Optional[torch.Generator] = None
                    ) -> Dict[str, torch.Tensor]:
    """Random init in the JAX package's scheme (xavier-uniform attention,
    kaiming-normal MLP/head/embed, zero biases, unit LN weights), drawn from
    ``generator`` on the CPU.  Returns the flat reference-named state dict
    in ``cfg``'s dtype.  The numbers differ from the JAX init's."""
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    Lyr, N, D, Dh, M = cfg.n_layers, cfg.n_heads, cfg.d_model, cfg.d_head, cfg.d_mlp
    patch_dim = L.patch_dim(cfg)

    def normal(shape, std):
        return torch.randn(shape, generator=g) * std

    def xavier(shape):
        limit = math.sqrt(6.0 / (shape[-2] + shape[-1]))
        return torch.rand(shape, generator=g) * (2 * limit) - limit

    zeros, ones = torch.zeros, torch.ones
    flat = {
        "embed.W": normal((patch_dim, D), math.sqrt(2.0 / patch_dim)),
        "embed.b": zeros(D),
        "pos_embed.W_pos": normal((cfg.n_tokens, D), cfg.pos_std),
        "head.W_H": normal((D, cfg.n_classes), math.sqrt(2.0 / D)),
        "head.b_H": zeros(cfg.n_classes),
    }
    if cfg.use_cls_token:
        flat["cls_token"] = normal((1, 1, D), cfg.cls_std)
    stacked = {
        "attn.W_Q": xavier((Lyr, N, D, Dh)),
        "attn.W_K": xavier((Lyr, N, D, Dh)),
        "attn.W_V": xavier((Lyr, N, D, Dh)),
        "attn.W_O": xavier((Lyr, N, Dh, D)),
        "attn.b_Q": zeros(Lyr, N, Dh),
        "attn.b_K": zeros(Lyr, N, Dh),
        "attn.b_V": zeros(Lyr, N, Dh),
        "attn.b_O": zeros(Lyr, D),
    }
    ln = cfg.normalization_type == "LN"
    if ln:
        stacked.update({"ln1.w": ones(Lyr, D), "ln1.b": zeros(Lyr, D)})
    if not cfg.attn_only:
        stacked.update({
            "mlp.W_in": normal((Lyr, D, M), math.sqrt(2.0 / M)),
            "mlp.b_in": zeros(Lyr, M),
            "mlp.W_out": normal((Lyr, M, D), math.sqrt(2.0 / D)),
            "mlp.b_out": zeros(Lyr, D),
        })
        if ln:
            stacked.update({"ln2.w": ones(Lyr, D), "ln2.b": zeros(Lyr, D)})
        if cfg.activation_name == "solu_ln" and ln:
            stacked.update({"mlp.ln.w": ones(Lyr, M), "mlp.ln.b": zeros(Lyr, M)})
    for name, a in stacked.items():
        for l in range(Lyr):
            flat[f"blocks.{l}.{name}"] = a[l]
    if cfg.layer_norm_pre and ln:
        flat.update({"ln_pre.w": ones(D), "ln_pre.b": zeros(D)})
    if ln:
        flat.update({"ln_final.w": ones(D), "ln_final.b": zeros(D)})
    return {k: v.to(cfg.torch_dtype) for k, v in flat.items()}


# ---------------------------------------------------------------------------
# Forward pass
# ---------------------------------------------------------------------------

def embed_tokens(params, cfg: ViTConfig, x, hooks: HookRuntime):
    """Patch-embed + cls token + positional embedding + optional pre-LN."""
    embed_fn = L.tubelet_embedding if cfg.is_video_transformer else L.patch_embedding
    embed = hooks("hook_embed", embed_fn(params.embed, cfg, x))
    B = x.shape[0]
    if cfg.use_cls_token:
        cls = params.cls_token.to(embed.dtype).expand(B, 1, cfg.d_model)
        embed = torch.cat([cls, embed], dim=1)
    W_pos = params.pos_embed.W_pos
    if not torch.is_grad_enabled():
        # the expanded view is cached: without gradients, no view of a
        # parameter may carry requires_grad out of the forward
        W_pos = W_pos.detach()
    pos = hooks("hook_pos_embed", W_pos[None].expand(B, *W_pos.shape))
    residual = embed + pos
    # The reference discards this hook's return value: cached, not editable.
    residual = hooks("hook_full_embed", residual, editable=False)
    if cfg.layer_norm_pre:
        residual = L.apply_norm(params.ln_pre, cfg, residual, hooks, "ln_pre")
        residual = hooks("hook_ln_pre", residual)
    return residual


def vit_forward(params, cfg: ViTConfig, x, hooks: HookRuntime = NULL_HOOKS,
                stop_at_layer: Optional[int] = None, dropout_key=None,
                start_at_layer: int = 0):
    """Full HookedViT forward over the module ``params``.

    ``stop_at_layer`` (exclusive, negative indices allowed) returns the
    residual stream entering that block.  ``start_at_layer`` treats ``x`` as
    the residual stream ``[B, T, d_model]`` entering that block and runs
    only the rest.  ``dropout_key``, a ``torch.Generator`` on x's device,
    enables train-mode dropout in every block (the JAX package's name for
    its PRNG key); None runs the eval-mode forward."""
    residual = x if start_at_layer else embed_tokens(params, cfg, x, hooks)
    for l in range(cfg.n_layers)[start_at_layer:stop_at_layer]:
        residual = params.blocks[l](residual, hooks, f"blocks.{l}",
                                    dropout_key=dropout_key)
    if stop_at_layer is not None:
        return residual

    x_out = L.apply_norm(params.ln_final, cfg, residual, hooks, "ln_final")
    x_out = hooks("hook_ln_final", x_out, editable=False)

    if cfg.classification_type == "gaap":
        x_out = x_out.mean(dim=1)
    elif cfg.classification_type == "cls":
        cls_tok = x_out[:, 0]
        if "dino-vitb" in cfg.model_name:
            # DINO concat output
            patches_pooled = x_out[:, 1:].mean(dim=1)
            x_out = torch.cat([cls_tok[..., None], patches_pooled[..., None]],
                              dim=-1)
        else:
            x_out = cls_tok

    if cfg.return_type != "pre_logits":
        x_out = L.head(params.head, cfg, x_out)

    x_out = hooks("hook_post_head_pre_normalize", x_out, editable=False)

    if cfg.normalize_output:
        x_out = x_out / torch.linalg.norm(x_out, dim=-1, keepdim=True)
    return x_out


# ---------------------------------------------------------------------------
# HookedViT
# ---------------------------------------------------------------------------

class HookedModule(nn.Module):
    """The surface that ``HookedViT`` and ``HookedTextTransformer`` share:
    ``with_cfg``, ``run_with_hooks``, the cached forward behind each
    ``run_with_cache``, loading a flat reference-named state dict, and the
    stacked block weights.  A subclass sets ``_forward_fn(module, cfg, x,
    hooks, stop_at_layer)`` and overrides ``_inputs`` or
    ``_port_state_dict`` where its inputs or its state dict need
    converting."""

    _forward_fn = None

    def _inputs(self, x):
        return x

    def _port_state_dict(self, state_dict) -> Dict[str, torch.Tensor]:
        return {k: _tensor(v) for k, v in state_dict.items()}

    def with_cfg(self, **overrides):
        """This model with config fields overridden (its routes, as
        ``use_fused_attention``), sharing its parameters: no second draw
        or copy of the weights."""
        cfg = self.cfg.replace(**overrides)
        other = copy.copy(self)
        other.__dict__["_modules"] = dict(self._modules)
        other.cfg = cfg
        blocks = []
        for b in self.blocks:
            b = copy.copy(b)
            b.cfg = cfg
            blocks.append(b)
        other.blocks = nn.ModuleList(blocks)
        return other

    def _cached_forward(self, x, names: Tuple[str, ...], stop_at_layer: Optional[int],
                        fwd_hooks: Sequence[Tuple], incl_bwd: bool,
                        bwd_hooks: Sequence[Tuple], loss_fn):
        """``(output, {name: value})`` of a forward caching ``names``, with
        the gradients of ``incl_bwd`` (see ``HookedViT.run_with_cache``)."""
        cfg, forward = self.cfg, self._forward_fn
        traced = grad_cached_traced(
            lambda p, x, rt: forward(p, cfg, x, rt, stop_at_layer), names,
            fwd_hooks=fwd_hooks, bwd_hooks=bwd_hooks, loss_fn=loss_fn,
            incl_bwd=incl_bwd)
        return traced(self, self._inputs(x))

    # -- intervened forward ----------------------------------------------
    @torch.inference_mode()
    def run_with_hooks(self, x, fwd_hooks: Sequence[Tuple] = (),
                       stop_at_layer: Optional[int] = None):
        """Forward with intervention hooks ``(name_or_pred, fn)`` where
        ``fn(value, hook) -> value``."""
        hooks = (HookRuntime(fwd_hooks=fwd_hooks, record=False)
                 if fwd_hooks else NULL_HOOKS)
        return self._forward_fn(self, self.cfg, self._inputs(x), hooks, stop_at_layer)

    # -- state-dict round trip -------------------------------------------
    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        """Load a flat reference-named state dict of numpy arrays or
        tensors."""
        return super().load_state_dict(self._port_state_dict(state_dict),
                                       strict=strict, assign=assign)

    # -- stacked weight properties ---------------------------------------
    def _stack(self, module: str, name: str) -> torch.Tensor:
        return torch.stack([getattr(getattr(b, module), name) for b in self.blocks])

    @property
    def W_Q(self): return self._stack("attn", "W_Q")
    @property
    def W_K(self): return self._stack("attn", "W_K")
    @property
    def W_V(self): return self._stack("attn", "W_V")
    @property
    def W_O(self): return self._stack("attn", "W_O")
    @property
    def W_in(self): return self._stack("mlp", "W_in")
    @property
    def W_out(self): return self._stack("mlp", "W_out")


class HookedViT(HookedModule):
    """Counterpart of the JAX package's ``HookedViT``: ``forward``,
    ``run_with_cache`` and ``run_with_hooks``, the stacked weight
    properties and circuits, and loading (``from_pretrained``,
    ``from_local``, ``save_local``), with parameters on ``device`` (the
    CUDA card when None) in ``cfg.dtype``, initialized from ``generator``
    (seed 0 when None)."""

    _forward_fn = staticmethod(vit_forward)

    def __init__(self, cfg: ViTConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        dt = cfg.torch_dtype
        ln = cfg.normalization_type == "LN"
        self.embed = L.PatchEmbedding(cfg, device)
        self.pos_embed = L.PosEmbedding(cfg, device)
        if cfg.use_cls_token:
            self.cls_token = L.new_param((1, 1, cfg.d_model), device, dt)
        self.ln_pre = (L.LayerNorm(cfg.d_model, device, dt)
                       if cfg.layer_norm_pre and ln else None)
        self.blocks = nn.ModuleList(
            L.TransformerBlock(cfg, device) for _ in range(cfg.n_layers))
        self.ln_final = L.LayerNorm(cfg.d_model, device, dt) if ln else None
        self.head = L.Head(cfg, device)
        self.load_state_dict(init_vit_params(cfg, generator))

    def _port_state_dict(self, state_dict) -> Dict[str, torch.Tensor]:
        """The patch embedding as ``embed.W`` or as the convolution's
        ``embed.proj.weight`` (:func:`port_state_dict`)."""
        return port_state_dict(state_dict, self.cfg)

    # -- plain forward ---------------------------------------------------
    @torch.inference_mode()
    def forward(self, x, stop_at_layer: Optional[int] = None, dropout_key=None):
        return vit_forward(self, self.cfg, x, NULL_HOOKS, stop_at_layer,
                           dropout_key=dropout_key)

    # -- cached forward --------------------------------------------------
    def run_with_cache(self, x, names_filter: NamesFilter = None,
                       return_cache_object: bool = True,
                       stop_at_layer: Optional[int] = None,
                       fwd_hooks: Sequence[Tuple] = (),
                       remove_batch_dim: bool = False,
                       incl_bwd: bool = False,
                       bwd_hooks: Sequence[Tuple] = (),
                       loss_fn=None):
        """Forward that also returns ``{hook name: activation}`` for the hook
        points ``names_filter`` selects, in firing order.

        ``incl_bwd=True`` also caches, for every cached hook point that
        fired, the gradient of the loss there under ``{name}_grad``, after
        the activations and in reverse firing order; ``loss_fn(out) ->
        scalar`` is the loss (default ``out.sum()``), and a point the loss
        does not reach gets zeros.  ``bwd_hooks`` are gradient editors
        ``(name_or_pred, f(grad, hook) -> grad)`` applied to the gradient
        flowing upstream; a point's cached gradient is the unedited one.
        Only these calls record an autograd graph; the rest run in inference
        mode.  Parameter gradients are not computed.

        Returns ``(output, ActivationCache)``, or ``(output, dict)`` with
        ``return_cache_object=False``."""
        out, cache = self._cached_forward(
            x, self._resolve_names(names_filter, stop_at_layer), stop_at_layer,
            fwd_hooks, incl_bwd, bwd_hooks, loss_fn)
        if remove_batch_dim:
            batch = next(iter(cache.values())).shape[0] if cache else 1
            if batch != 1:
                raise ValueError(
                    f"remove_batch_dim requires batch size 1, got {batch}")
            cache = {k: v[0] for k, v in cache.items()}
        if return_cache_object:
            cache = ActivationCache(cache, self, has_batch_dim=not remove_batch_dim)
        return out, cache

    def run_with_hooks(self, x, fwd_hooks: Sequence[Tuple] = (),
                       stop_at_layer: Optional[int] = None,
                       return_type: str = "output"):
        """:meth:`HookedModule.run_with_hooks`; ``return_type`` is accepted
        and ignored, as in the JAX package."""
        return super().run_with_hooks(x, fwd_hooks, stop_at_layer)

    def _resolve_names(self, names_filter: NamesFilter,
                       stop_at_layer: Optional[int]) -> Tuple[str, ...]:
        """The hook names a filter selects among those that can fire, in
        firing order."""
        pred = resolve_names_filter(names_filter)
        all_names = hook_names(self.cfg)
        if stop_at_layer is not None:
            keep_layers = set(range(self.cfg.n_layers)[:stop_at_layer])
            pre = {"hook_embed", "hook_pos_embed", "hook_full_embed",
                   "ln_pre.hook_scale", "ln_pre.hook_normalized", "hook_ln_pre"}

            def alive(n):
                if n in pre:
                    return True
                if n.startswith("blocks."):
                    return int(n.split(".")[1]) in keep_layers
                return False
            all_names = [n for n in all_names if alive(n)]
        return tuple(n for n in all_names if pred(n))

    def shard(self, mesh) -> "HookedViT":
        """Make the model tensor-parallel over the ``model`` axis of a
        ``(data, model)`` mesh (``parallel/mesh.py``), in place: each rank
        keeps its heads of ``W_Q``/``W_K``/``W_V``/``b_Q``/``b_K``/``b_V``/
        ``W_O`` and its ``d_mlp`` columns of ``W_in``/``b_in`` and rows of
        ``W_out`` (heads that do not divide the axis keep attention whole).
        The forward sums over the axis after ``W_O`` and after ``W_out``
        (differentiable, so ``incl_bwd`` runs B2 on the local heads), the
        kernels run on the local heads and columns, and hooks and the cache
        see whole tensors.  Pass each rank its rows of the batch
        (``parallel.data_rows``).  The stacked weight properties then give
        this rank's shard.  Returns self."""
        from vit_prisma_tpu_torch.parallel.mesh import shard_vit_
        return shard_vit_(self, mesh)

    # -- stacked weight properties ---------------------------------------
    @property
    def b_Q(self): return self._stack("attn", "b_Q")
    @property
    def b_K(self): return self._stack("attn", "b_K")
    @property
    def b_V(self): return self._stack("attn", "b_V")
    @property
    def b_O(self): return self._stack("attn", "b_O")
    @property
    def b_in(self): return self._stack("mlp", "b_in")
    @property
    def b_out(self): return self._stack("mlp", "b_out")
    @property
    def W_E(self): return self.embed.W
    @property
    def W_pos(self): return self.pos_embed.W_pos
    @property
    def W_H(self): return self.head.W_H
    @property
    def b_H(self): return self.head.b_H

    @property
    def OV(self) -> FactoredMatrix:
        """Each head's OV circuit W_V·W_O: [n_layers, n_heads, d_model,
        d_model], factored."""
        return FactoredMatrix(self.W_V.detach(), self.W_O.detach())

    @property
    def QK(self) -> FactoredMatrix:
        """Each head's QK circuit W_Q·W_Kᵀ: [n_layers, n_heads, d_model,
        d_model], factored."""
        return FactoredMatrix(self.W_Q.detach(), self.W_K.detach().transpose(-2, -1))

    @torch.no_grad()
    def tokens_to_residual_directions(self, labels) -> torch.Tensor:
        """Residual directions of class labels, the columns of W_H:
        labels [batch] -> [batch, d_model]."""
        idx = torch.as_tensor(labels, dtype=torch.long, device=self.W_H.device)
        return self.W_H[:, idx].transpose(-2, -1)

    @torch.no_grad()
    def accumulated_bias(self, layer: int, mlp_input: bool = False,
                         include_mlp_biases: bool = True) -> torch.Tensor:
        """The output biases (b_O, and b_out with ``include_mlp_biases``)
        summed up to the input of ``layer``, in float32; with ``mlp_input``
        also that layer's b_O."""
        bias = torch.zeros(self.cfg.d_model, dtype=torch.float32, device=self.W_E.device)
        if layer > 0:
            bias = bias + self.b_O[:layer].sum(0)
            if include_mlp_biases and not self.cfg.attn_only:
                bias = bias + self.b_out[:layer].sum(0)
        if mlp_input:
            assert layer < self.cfg.n_layers, \
                "Cannot include attn_bias from beyond the final layer"
            bias = bias + self.b_O[layer]
        return bias

    # -- loading ----------------------------------------------------------
    @classmethod
    def from_pretrained(cls, model_name: str, **kwargs) -> "HookedViT":
        """``load_hooked_model(model_name, **kwargs)``."""
        from vit_prisma_tpu_torch.models.loading.loader import load_hooked_model
        return load_hooked_model(model_name, **kwargs)

    @classmethod
    def from_local(cls, cfg: ViTConfig, checkpoint_path: str, device=None) -> "HookedViT":
        """A model from a local checkpoint: the port's supervised-trainer
        ``.ckpt``, an ``.npz`` of the flat reference-named state dict (as
        :meth:`save_local` and the JAX package write it), or a torch file of
        that dict."""
        if checkpoint_path.endswith(".ckpt"):
            from vit_prisma_tpu_torch.training.trainer import load_checkpoint
            flat = load_checkpoint(checkpoint_path)["params"]
        elif checkpoint_path.endswith(".npz"):
            from vit_prisma_tpu_torch.sae.sae import numpy_to_tensor
            with np.load(checkpoint_path) as z:
                flat = {k: numpy_to_tensor(z[k]) for k in z.files}
        else:
            from vit_prisma_tpu_torch.models.loading.loader import _load_checkpoint
            flat = _load_checkpoint(checkpoint_path)
        model = cls(cfg, device=device)
        model.load_state_dict(flat)
        return model

    def save_local(self, path: str):
        """Save the flat reference-named state dict (the JAX package's
        names and patch-embedding layout) as ``.npz``; bfloat16 weights as
        their two-byte words."""
        from vit_prisma_tpu_torch.models.loading.state_dict import reference_state_dict
        from vit_prisma_tpu_torch.sae.sae import tensor_to_numpy
        flat = {k: tensor_to_numpy(v.cpu()) for k, v in reference_state_dict(self).items()}
        np.savez(path if path.endswith(".npz") else path + ".npz", **flat)
