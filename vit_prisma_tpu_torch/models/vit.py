"""HookedViT (PyTorch port of ``vit_prisma_tpu/models/vit.py``).

The model is an ``nn.Module`` with one module per block
(``blocks[l].attn.W_Q``), so ``state_dict()`` keys are the reference's flat
names (``blocks.{l}.attn.W_Q``).  The forward is :func:`vit_forward`, a
function over the module that threads a :class:`HookRuntime` through the
layers; ``run_with_cache`` and ``run_with_hooks`` build that runtime.
Forwards run under ``torch.inference_mode()``: gradients wait for the
attention backward kernel (ROADMAP queue B, B2).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from vit_prisma_tpu_torch.configs.vit_config import ViTConfig
from vit_prisma_tpu_torch.models import layers as L
from vit_prisma_tpu_torch.models.loading.state_dict import port_state_dict
from vit_prisma_tpu_torch.prisma.hooks import (
    NULL_HOOKS,
    HookRuntime,
    NamesFilter,
    resolve_names_filter,
)
from vit_prisma_tpu_torch.utils.device import resolve_device

_NO_GRADIENTS = ("is not ported yet (ROADMAP queue A, item 11; gradients "
                 "need kernel B2, the attention backward)")


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
    patch_dim = cfg.n_channels * cfg.patch_size ** 2

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
    embed = hooks("hook_embed", L.patch_embedding(params.embed, cfg, x))
    B = x.shape[0]
    if cfg.use_cls_token:
        cls = params.cls_token.to(embed.dtype).expand(B, 1, cfg.d_model)
        embed = torch.cat([cls, embed], dim=1)
    W_pos = params.pos_embed.W_pos
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
    only the rest."""
    if dropout_key is not None:
        raise NotImplementedError(
            "train-mode dropout is not ported yet (ROADMAP queue A, item 13: "
            "supervised trainer)")
    residual = x if start_at_layer else embed_tokens(params, cfg, x, hooks)
    for l in range(cfg.n_layers)[start_at_layer:stop_at_layer]:
        residual = params.blocks[l](residual, hooks, f"blocks.{l}")
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

class HookedViT(nn.Module):
    """Counterpart of the JAX package's ``HookedViT``: ``forward``,
    ``run_with_cache`` and ``run_with_hooks``, with parameters on
    ``device`` (the CUDA card when None) in ``cfg.dtype``, initialized from
    ``generator`` (seed 0 when None)."""

    def __init__(self, cfg: ViTConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.is_video_transformer:
            raise NotImplementedError(
                "video transformers are not ported yet (ROADMAP queue A, "
                "item 14)")
        if cfg.use_fused_ln_gemm:
            raise NotImplementedError(
                "use_fused_ln_gemm needs the ln->GEMM kernel, which is not "
                "ported yet (ROADMAP queue B, B14)")
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

    # -- plain forward ---------------------------------------------------
    @torch.inference_mode()
    def forward(self, x, stop_at_layer: Optional[int] = None, dropout_key=None):
        return vit_forward(self, self.cfg, x, NULL_HOOKS, stop_at_layer,
                           dropout_key=dropout_key)

    # -- cached forward --------------------------------------------------
    @torch.inference_mode()
    def run_with_cache(self, x, names_filter: NamesFilter = None,
                       return_cache_object: bool = False,
                       stop_at_layer: Optional[int] = None,
                       fwd_hooks: Sequence[Tuple] = (),
                       remove_batch_dim: bool = False,
                       incl_bwd: bool = False,
                       bwd_hooks: Sequence[Tuple] = (),
                       loss_fn=None):
        """Forward that also returns ``{hook name: activation}`` for the hook
        points ``names_filter`` selects, in firing order.

        Unlike the JAX package, the default is a plain dict:
        ``return_cache_object=True`` (ActivationCache) waits for ROADMAP
        queue A, item 11, as do ``incl_bwd``, ``bwd_hooks`` and
        ``loss_fn``."""
        if incl_bwd or bwd_hooks or loss_fn is not None:
            raise NotImplementedError(f"incl_bwd/bwd_hooks/loss_fn {_NO_GRADIENTS}")
        if return_cache_object:
            raise NotImplementedError(
                "ActivationCache is not ported yet (ROADMAP queue A, item 11); "
                "pass return_cache_object=False for a dict")
        names = self._resolve_names(names_filter, stop_at_layer)
        hooks = HookRuntime(names_filter=names, fwd_hooks=fwd_hooks)
        out = vit_forward(self, self.cfg, x, hooks, stop_at_layer)
        cache = dict(hooks.cache)
        if remove_batch_dim:
            batch = next(iter(cache.values())).shape[0] if cache else 1
            if batch != 1:
                raise ValueError(
                    f"remove_batch_dim requires batch size 1, got {batch}")
            cache = {k: v[0] for k, v in cache.items()}
        return out, cache

    # -- intervened forward ----------------------------------------------
    @torch.inference_mode()
    def run_with_hooks(self, x, fwd_hooks: Sequence[Tuple] = (),
                       stop_at_layer: Optional[int] = None,
                       return_type: str = "output"):
        """Forward with intervention hooks ``(name_or_pred, fn)`` where
        ``fn(value, hook) -> value``."""
        hooks = (HookRuntime(fwd_hooks=fwd_hooks, record=False)
                 if fwd_hooks else NULL_HOOKS)
        return vit_forward(self, self.cfg, x, hooks, stop_at_layer)

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

    def shard(self, mesh):
        raise NotImplementedError(
            "sharding is not ported yet (ROADMAP queue A, item 15)")

    # -- state-dict round trip -------------------------------------------
    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        """Load a flat reference-named state dict: numpy arrays or tensors,
        with the patch embedding as ``embed.W`` or as the convolution's
        ``embed.proj.weight``."""
        return super().load_state_dict(port_state_dict(state_dict, self.cfg),
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
    def b_Q(self): return self._stack("attn", "b_Q")
    @property
    def b_K(self): return self._stack("attn", "b_K")
    @property
    def b_V(self): return self._stack("attn", "b_V")
    @property
    def b_O(self): return self._stack("attn", "b_O")
    @property
    def W_in(self): return self._stack("mlp", "W_in")
    @property
    def W_out(self): return self._stack("mlp", "W_out")
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
