"""HookedTextTransformer, the CLIP text tower (PyTorch port of
``vit_prisma_tpu/models/text.py``).

Token embedding lookup, the learned positional embedding's first rows, an
optional cls embedding appended at the *end* of the sequence, the causal
mask (with the cls embedding, an additive one merged with a pad-aware
mask), the pre-LN blocks of ``models/layers.py``, ``ln_final``, pooling at
the end-of-text token (``argmax(tokens)``: EOT has the largest id), the
projection head and an optional L2 normalization.

The pure causal tower passes the ``"causal"`` marker to the blocks, so its
attention takes the causal route of kernel B1 (and of B2 in its gradient
path) wherever no attention-internal hook is requested; the additive mask
of ``use_cls_emb`` takes the einsum attention.  As in the JAX package (and
OpenCLIP's text towers), no ``ln_pre`` is applied.

Parameters live in ``nn.Module``s named as the reference's flat state dict
(``token_embed.W_E``, ``pos_embed.W_pos``, ``blocks.{l}.attn.W_Q``, ...);
:func:`stack_text_params` and :func:`unstack_text_params` go between that
flat dict and the JAX package's stacked-by-layer tree.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from vit_prisma_tpu_torch.configs.vit_config import TextTransformerConfig
from vit_prisma_tpu_torch.models import layers as L
from vit_prisma_tpu_torch.models.loading.state_dict import _tensor
from vit_prisma_tpu_torch.models.vit import HookedModule, block_hook_names, init_vit_params
from vit_prisma_tpu_torch.prisma.cache import ActivationCache
from vit_prisma_tpu_torch.prisma.hooks import (
    NULL_HOOKS,
    HookRuntime,
    NamesFilter,
    resolve_names_filter,
)
from vit_prisma_tpu_torch.utils.device import resolve_device


def text_hook_names(cfg: TextTransformerConfig) -> List[str]:
    """All hook names of a HookedTextTransformer, in firing order."""
    names = ["hook_embed", "hook_pos_embed", "hook_full_embed"]
    for l in range(cfg.n_layers):
        names += block_hook_names(cfg, l)
    if cfg.normalization_type:
        names += ["ln_final.hook_scale", "ln_final.hook_normalized"]
    names += ["hook_ln_final", "hook_post_head_pre_normalize"]
    return names


def build_causal_mask(num_pos: int, device=None) -> torch.Tensor:
    """Additive float32 causal mask: -inf above the diagonal."""
    return torch.full((num_pos, num_pos), float("-inf"), device=device).triu(1)


def _build_cls_mask(tokens: torch.Tensor, pad_id: int = 0) -> torch.Tensor:
    """Pad-aware additive mask [B, 1, 1, S+1] over the keys, as the JAX
    package builds it: the first key is always allowed, key j > 0 where
    token j-1 is not padding."""
    B = tokens.shape[0]
    keys = torch.cat([torch.ones(B, 1, dtype=torch.bool, device=tokens.device),
                      tokens != pad_id], dim=-1)
    zero = torch.zeros((), device=tokens.device)
    return torch.where(keys[:, None, None, :], zero, float("-inf"))


def init_text_params(cfg: TextTransformerConfig,
                     generator: Optional[torch.Generator] = None
                     ) -> Dict[str, torch.Tensor]:
    """Random init in the JAX package's scheme (the blocks and head as
    :func:`init_vit_params` draws them, token embeddings N(0, 0.02²),
    positions N(0, 0.01²), the cls embedding N(0, cls_std²)), drawn from
    ``generator`` on the CPU.  Returns the flat reference-named state dict
    in ``cfg``'s dtype.  The numbers differ from the JAX init's."""
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    base = init_vit_params(cfg.replace(layer_norm_pre=False), g)
    D = cfg.d_model
    flat = {k: v for k, v in base.items() if k.startswith(("blocks.", "head."))}
    flat["token_embed.W_E"] = torch.randn(cfg.vocab_size, D, generator=g) * 0.02
    flat["pos_embed.W_pos"] = torch.randn(cfg.context_length, D, generator=g) * 0.01
    if cfg.normalization_type == "LN":
        flat["ln_final.w"] = torch.ones(D)
        flat["ln_final.b"] = torch.zeros(D)
    if cfg.use_cls_emb:
        flat["cls_emb"] = torch.randn(D, generator=g) * cfg.cls_std
    return {k: v.to(cfg.torch_dtype) for k, v in flat.items()}


def text_forward(params, cfg: TextTransformerConfig, tokens: torch.Tensor,
                 hooks: HookRuntime = NULL_HOOKS,
                 stop_at_layer: Optional[int] = None):
    """Forward over integer token ids [B, S] (on the model's device).
    ``stop_at_layer`` returns the residual stream entering that block."""
    B, S = tokens.shape
    embed = hooks("hook_embed", params.token_embed.W_E[tokens.long()])

    seq_len = S
    if cfg.causal_attention and not cfg.use_cls_emb:
        # the marker lets the attention kernels apply the mask themselves
        attn_mask = "causal"
    else:
        attn_mask = (build_causal_mask(cfg.n_tokens, tokens.device)
                     if cfg.causal_attention else None)

    if cfg.use_cls_emb:
        seq_len += 1
        cls = params.cls_emb.to(embed.dtype).expand(B, 1, cfg.d_model)
        embed = torch.cat([embed, cls], dim=1)
        # the pad-aware mask merges only into an existing causal mask:
        # without causal_attention the tower runs unmasked, as in JAX
        if attn_mask is not None:
            attn_mask = (attn_mask[None, None, :seq_len, :seq_len]
                         + _build_cls_mask(tokens)[:, :, :seq_len, :seq_len])

    W_pos = params.pos_embed.W_pos
    if not torch.is_grad_enabled():
        W_pos = W_pos.detach()  # no view of a parameter leaves an inference forward
    pos = hooks("hook_pos_embed", W_pos[:seq_len])
    x = hooks("hook_full_embed", embed + pos, editable=False)

    for l in range(cfg.n_layers)[:stop_at_layer]:
        x = L.transformer_block(params.blocks[l], cfg, x, hooks, f"blocks.{l}",
                                attn_mask=attn_mask)
    if stop_at_layer is not None:
        return x

    x = L.apply_norm(params.ln_final, cfg, x, hooks, "ln_final")
    x = hooks("hook_ln_final", x, editable=False)

    # pooling at the end-of-text token, the first maximum of each row
    pooled = x[torch.arange(B, device=x.device), tokens.argmax(dim=-1)]
    if cfg.return_type != "pre_logits":
        pooled = L.head(params.head, cfg, pooled)
    pooled = hooks("hook_post_head_pre_normalize", pooled, editable=False)
    if cfg.normalize_output:
        pooled = pooled / torch.linalg.norm(pooled, dim=-1, keepdim=True)
    return pooled


# ---------------------------------------------------------------------------
# State-dict round trip
# ---------------------------------------------------------------------------

def stack_text_params(flat: Dict[str, Any], cfg: TextTransformerConfig) -> Dict[str, Any]:
    """Flat reference-named state dict (numpy arrays or tensors) -> the JAX
    package's text parameter tree stacked by layer, as tensors in ``cfg``'s
    dtype.  Takes ``token_embed.W_E`` or ``token_embed.weight`` and
    ``pos_embed.W_pos`` or ``pos_embed``."""
    dt = cfg.torch_dtype

    def g(k):
        return _tensor(flat[k]).to(dt)

    def stack(fmt):
        return torch.stack([g(fmt.format(l=l)) for l in range(cfg.n_layers)])

    params: Dict[str, Any] = {
        "token_embed": {"W_E": g("token_embed.W_E") if "token_embed.W_E" in flat
                        else g("token_embed.weight")},
        "pos_embed": {"W_pos": g("pos_embed.W_pos") if "pos_embed.W_pos" in flat
                      else g("pos_embed")},
        "blocks": {
            "attn": {k: stack(f"blocks.{{l}}.attn.{k}")
                     for k in ["W_Q", "W_K", "W_V", "W_O", "b_Q", "b_K", "b_V", "b_O"]},
            "mlp": {k: stack(f"blocks.{{l}}.mlp.{k}")
                    for k in ["W_in", "b_in", "W_out", "b_out"]},
        },
        "head": {"W_H": g("head.W_H"), "b_H": g("head.b_H")},
    }
    if cfg.normalization_type == "LN":
        params["blocks"]["ln1"] = {"w": stack("blocks.{l}.ln1.w"),
                                   "b": stack("blocks.{l}.ln1.b")}
        params["blocks"]["ln2"] = {"w": stack("blocks.{l}.ln2.w"),
                                   "b": stack("blocks.{l}.ln2.b")}
        params["ln_final"] = {"w": g("ln_final.w"), "b": g("ln_final.b")}
    if cfg.use_cls_emb and "cls_emb" in flat:
        params["cls_emb"] = g("cls_emb")
    return params


def unstack_text_params(params: Dict[str, Any], cfg: TextTransformerConfig) -> Dict[str, Any]:
    """The stacked text tree (tensor or numpy leaves) -> the flat
    reference-named dict."""
    flat: Dict[str, Any] = {
        "token_embed.W_E": params["token_embed"]["W_E"],
        "pos_embed.W_pos": params["pos_embed"]["W_pos"],
        "head.W_H": params["head"]["W_H"],
        "head.b_H": params["head"]["b_H"],
    }
    blocks = params["blocks"]
    for l in range(cfg.n_layers):
        for k, v in blocks["attn"].items():
            flat[f"blocks.{l}.attn.{k}"] = v[l]
        for k in ["W_in", "b_in", "W_out", "b_out"]:
            flat[f"blocks.{l}.mlp.{k}"] = blocks["mlp"][k][l]
        if "ln1" in blocks:
            flat[f"blocks.{l}.ln1.w"] = blocks["ln1"]["w"][l]
            flat[f"blocks.{l}.ln1.b"] = blocks["ln1"]["b"][l]
            flat[f"blocks.{l}.ln2.w"] = blocks["ln2"]["w"][l]
            flat[f"blocks.{l}.ln2.b"] = blocks["ln2"]["b"][l]
    if "ln_final" in params:
        flat["ln_final.w"] = params["ln_final"]["w"]
        flat["ln_final.b"] = params["ln_final"]["b"]
    if "cls_emb" in params:
        flat["cls_emb"] = params["cls_emb"]
    return flat


# ---------------------------------------------------------------------------
# HookedTextTransformer
# ---------------------------------------------------------------------------

class _TokenEmbedding(nn.Module):
    def __init__(self, cfg: TextTransformerConfig, device=None):
        super().__init__()
        self.W_E = L.new_param((cfg.vocab_size, cfg.d_model), device, cfg.torch_dtype)


class _TextPosEmbedding(nn.Module):
    def __init__(self, cfg: TextTransformerConfig, device=None):
        super().__init__()
        self.W_pos = L.new_param((cfg.context_length, cfg.d_model), device, cfg.torch_dtype)


class HookedTextTransformer(HookedModule):
    """Counterpart of the JAX package's ``HookedTextTransformer``:
    ``forward``, ``run_with_cache``, ``run_with_hooks``, the stacked weight
    properties and ``from_pretrained``, with parameters on ``device`` (the
    CUDA card when None) in ``cfg.dtype``, initialized from ``generator``
    (seed 0 when None).  Token ids may be any integer dtype; they are
    moved to the model's device."""

    _forward_fn = staticmethod(text_forward)

    def __init__(self, cfg: TextTransformerConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        dt = cfg.torch_dtype
        self.token_embed = _TokenEmbedding(cfg, device)
        self.pos_embed = _TextPosEmbedding(cfg, device)
        if cfg.use_cls_emb:
            self.cls_emb = L.new_param((cfg.d_model,), device, dt)
        self.blocks = nn.ModuleList(
            L.TransformerBlock(cfg, device) for _ in range(cfg.n_layers))
        self.ln_final = (L.LayerNorm(cfg.d_model, device, dt)
                         if cfg.normalization_type == "LN" else None)
        self.head = L.Head(cfg, device)
        self.load_state_dict(init_text_params(cfg, generator))

    def _inputs(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens).to(self.W_E.device, non_blocking=True)

    @torch.inference_mode()
    def forward(self, tokens, stop_at_layer: Optional[int] = None):
        return text_forward(self, self.cfg, self._inputs(tokens), NULL_HOOKS, stop_at_layer)

    def run_with_cache(self, tokens, names_filter: NamesFilter = None,
                       return_cache_object: bool = True,
                       stop_at_layer: Optional[int] = None,
                       fwd_hooks: Sequence[Tuple] = (),
                       incl_bwd: bool = False,
                       bwd_hooks: Sequence[Tuple] = (),
                       loss_fn=None):
        """Forward that also returns ``{hook name: activation}`` for the
        hook points ``names_filter`` selects, in firing order;
        ``incl_bwd``, ``bwd_hooks`` and ``loss_fn`` behave as on
        ``HookedViT.run_with_cache`` (gradients under ``{name}_grad``, in
        reverse firing order).  Returns ``(output, ActivationCache)``, or
        ``(output, dict)`` with ``return_cache_object=False``."""
        pred = resolve_names_filter(names_filter)
        names = tuple(n for n in text_hook_names(self.cfg) if pred(n))
        out, cache = self._cached_forward(tokens, names, stop_at_layer, fwd_hooks,
                                          incl_bwd, bwd_hooks, loss_fn)
        if return_cache_object:
            cache = ActivationCache(cache, self)
        return out, cache

    @property
    def W_E(self): return self.token_embed.W_E
    @property
    def W_pos(self): return self.pos_embed.W_pos

    @classmethod
    def from_pretrained(cls, model_name: str, **kwargs) -> "HookedTextTransformer":
        """``load_hooked_model(model_name, model_type="text", **kwargs)``."""
        from vit_prisma_tpu_torch.models.loading.loader import load_hooked_model
        return load_hooked_model(model_name, model_type="text", **kwargs)
