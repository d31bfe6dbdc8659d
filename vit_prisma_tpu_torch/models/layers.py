"""ViT layers (PyTorch port of ``vit_prisma_tpu/models/layers.py``).

Parameters live in small ``nn.Module``s (:class:`LayerNorm`,
:class:`Attention`, :class:`MLP`, :class:`TransformerBlock`, ...) with the
JAX package's names and logical layouts (``W_Q [n_heads, d_model, d_head]``,
``embed.W [C·P·P, d_model]``).  The computation is in plain functions that
take such a module as ``params``, the config, the input and a
:class:`HookRuntime`, and fire the same hook points in the same order as the
JAX functions of the same names.

Numerics notes:
 * LayerNorm computes in float32 when the model dtype is lower
   (``cfg.compute_in_fp32``) and fires ``hook_scale``.
 * The softmax NaN->0 guard and the cast of ``pattern`` to the model dtype
   before ``z`` are kept.
 * Attention takes the hand-written kernel (:func:`_fused_attention`) under
   the JAX package's gate: no attention-internal hook requested, no mask or
   the causal marker, no split inputs, no ``use_attn_result``, and
   ``matmul_precision == 'default'``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from vit_prisma_tpu_torch.configs.vit_config import ViTConfig
from vit_prisma_tpu_torch.ops.attention import attention_mix_tnh
from vit_prisma_tpu_torch.prisma.hooks import NULL_HOOKS, HookRuntime
from vit_prisma_tpu_torch.utils.device import resolve_device


# ---------------------------------------------------------------------------
# Activation functions
# ---------------------------------------------------------------------------

def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def gelu_new(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def gelu_fast(x):
    return 0.5 * x * (1.0 + torch.tanh(x * 0.7978845608 * (1.0 + 0.044715 * x * x)))


def solu(x):
    return x * torch.softmax(x, dim=-1)


ACT_FNS = {
    "relu": F.relu,
    "gelu": F.gelu,  # exact erf form
    "silu": F.silu,
    "gelu_new": gelu_new,
    "gelu_fast": gelu_fast,
    "quick_gelu": quick_gelu,
    "solu_ln": solu,
}


# ---------------------------------------------------------------------------
# Parameter modules
# ---------------------------------------------------------------------------

def new_param(shape, device, dtype):
    # On the card unless ``device`` names another; no gradients until the
    # attention backward kernel (B2) is ported.
    return nn.Parameter(torch.empty(shape, device=resolve_device(device), dtype=dtype),
                        requires_grad=False)


class LayerNorm(nn.Module):
    def __init__(self, d: int, device=None, dtype=None):
        super().__init__()
        self.w = new_param((d,), device, dtype)
        self.b = new_param((d,), device, dtype)


class PatchEmbedding(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        patch_dim = cfg.n_channels * cfg.patch_size ** 2
        self.W = new_param((patch_dim, cfg.d_model), device, cfg.torch_dtype)
        self.b = new_param((cfg.d_model,), device, cfg.torch_dtype)


class PosEmbedding(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        self.W_pos = new_param((cfg.n_tokens, cfg.d_model), device, cfg.torch_dtype)


class Head(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        self.W_H = new_param((cfg.d_model, cfg.n_classes), device, cfg.torch_dtype)
        self.b_H = new_param((cfg.n_classes,), device, cfg.torch_dtype)


class Attention(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        N, D, H, dt = cfg.n_heads, cfg.d_model, cfg.d_head, cfg.torch_dtype
        self.W_Q = new_param((N, D, H), device, dt)
        self.W_K = new_param((N, D, H), device, dt)
        self.W_V = new_param((N, D, H), device, dt)
        self.W_O = new_param((N, H, D), device, dt)
        self.b_Q = new_param((N, H), device, dt)
        self.b_K = new_param((N, H), device, dt)
        self.b_V = new_param((N, H), device, dt)
        self.b_O = new_param((D,), device, dt)


class MLP(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        D, M, dt = cfg.d_model, cfg.d_mlp, cfg.torch_dtype
        self.W_in = new_param((D, M), device, dt)
        self.b_in = new_param((M,), device, dt)
        self.W_out = new_param((M, D), device, dt)
        self.b_out = new_param((D,), device, dt)
        if cfg.activation_name == "solu_ln" and cfg.normalization_type == "LN":
            self.ln = LayerNorm(M, device, dt)


class TransformerBlock(nn.Module):
    """One block's parameters; ``forward`` runs the pre-LN block or, with
    ``cfg.use_bert_block``, the post-LN BertBlock."""

    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        ln = cfg.normalization_type == "LN"
        self.ln1 = LayerNorm(cfg.d_model, device, cfg.torch_dtype) if ln else None
        self.attn = Attention(cfg, device)
        if not cfg.attn_only:
            self.ln2 = LayerNorm(cfg.d_model, device, cfg.torch_dtype) if ln else None
            self.mlp = MLP(cfg, device)

    def forward(self, resid_pre, hooks: HookRuntime = NULL_HOOKS,
                prefix: str = "blocks.0", attn_mask=None):
        block_fn = bert_block if self.cfg.use_bert_block else transformer_block
        return block_fn(self, self.cfg, resid_pre, hooks, prefix, attn_mask)


# ---------------------------------------------------------------------------
# LayerNorm
# ---------------------------------------------------------------------------

def layer_norm(params, cfg: ViTConfig, x, hooks: HookRuntime = NULL_HOOKS,
               prefix: str = "ln"):
    """LayerNorm with learned weight/bias; fires ``{prefix}.hook_scale`` and
    ``{prefix}.hook_normalized`` (the latter on the affine output)."""
    out_dtype = cfg.torch_dtype if cfg.compute_in_fp32 else x.dtype
    if cfg.compute_in_fp32:
        x = x.float()
    x = x - x.mean(dim=-1, keepdim=True)
    scale = torch.sqrt((x * x).mean(dim=-1, keepdim=True) + cfg.eps)
    scale = hooks(f"{prefix}.hook_scale", scale)
    x = x / scale
    out = hooks(f"{prefix}.hook_normalized", x * params.w + params.b)
    return out.to(out_dtype)


def layer_norm_pre(cfg: ViTConfig, x, hooks: HookRuntime = NULL_HOOKS,
                   prefix: str = "ln"):
    """Weightless center+normalize; ``hook_normalized`` fires on the
    pre-affine value."""
    out_dtype = cfg.torch_dtype if cfg.compute_in_fp32 else x.dtype
    if cfg.compute_in_fp32:
        x = x.float()
    x = x - x.mean(dim=-1, keepdim=True)
    scale = torch.sqrt((x * x).mean(dim=-1, keepdim=True) + cfg.eps)
    scale = hooks(f"{prefix}.hook_scale", scale)
    out = hooks(f"{prefix}.hook_normalized", x / scale)
    return out.to(out_dtype)


def apply_norm(params, cfg: ViTConfig, x, hooks, prefix):
    """Dispatch on ``cfg.normalization_type``."""
    if cfg.normalization_type == "LN":
        return layer_norm(params, cfg, x, hooks, prefix)
    if cfg.normalization_type == "LNPre":
        return layer_norm_pre(cfg, x, hooks, prefix)
    if cfg.normalization_type is None:
        return x
    raise ValueError(f"Invalid normalization type: {cfg.normalization_type}")


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------

def patchify(cfg: ViTConfig, x):
    """[B, C, H, W] -> [B, T, C*P*P] in the (C, Ph, Pw) element order of
    ``Conv2d.weight.reshape(d_model, -1)``."""
    B, C, H, W = x.shape
    P = cfg.patch_size
    x = x.reshape(B, C, H // P, P, W // P, P).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(B, (H // P) * (W // P), C * P * P)


def patch_embedding(params, cfg: ViTConfig, x):
    """Patch embedding as patch extraction plus one matmul, numerically the
    stride=kernel convolution (and not a cuDNN conv, whose float32 default
    is TF32).  ``params.W: [C*P*P, d_model]``."""
    patches = patchify(cfg, x).to(params.W.dtype)
    return patches @ params.W + params.b


def tubelet_embedding(params, cfg: ViTConfig, x):
    raise NotImplementedError(
        "video tubelet embedding is not ported yet (ROADMAP queue A, item 14)")


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _wants_attn_internals(hooks: HookRuntime, prefix: str) -> bool:
    """True if any hook inside the attention mix is cached or edited."""
    return any(hooks.wants(f"{prefix}.{n}") for n in
               ("hook_q", "hook_k", "hook_v", "hook_attn_scores",
                "hook_pattern", "hook_z", "hook_result"))


def _fused_attention(params, cfg: ViTConfig, x, prefix: str,
                     causal: bool = False):
    """The speed path: the QKV projections run as flat [B*T, d_model] GEMMs
    whose row-major [B, T, N*H] output feeds the attention-mix kernel with
    no layout copy, and the scores, softmax and PV product stay inside the
    kernel (float32 softmax)."""
    scale = math.sqrt(cfg.d_head) if cfg.use_attn_scale else 1.0
    B, T, D = x.shape
    N, H = cfg.n_heads, cfg.d_head
    xf = x.reshape(B * T, D)
    Wq = params.W_Q.permute(1, 0, 2).reshape(D, N * H)
    Wk = params.W_K.permute(1, 0, 2).reshape(D, N * H)
    Wv = params.W_V.permute(1, 0, 2).reshape(D, N * H)
    Wo = params.W_O.reshape(N * H, D)
    q = ((xf @ Wq) / scale + params.b_Q.reshape(-1) / scale).reshape(B, T, N * H)
    k = (xf @ Wk + params.b_K.reshape(-1)).reshape(B, T, N * H)
    v = (xf @ Wv + params.b_V.reshape(-1)).reshape(B, T, N * H)
    z = attention_mix_tnh(q, k, v, N, causal)
    return (z.reshape(B * T, N * H) @ Wo).reshape(B, T, D) + params.b_O


def attention(params, cfg: ViTConfig, query_input, key_input, value_input,
              hooks: HookRuntime = NULL_HOOKS, prefix: str = "attn",
              attention_mask=None):
    """Multi-head attention with per-head parameter layout.

    Inputs are [B, pos, d_model], or [B, pos, n_heads, d_model] when
    ``use_split_qkv_input``/``use_attn_in``.  Hook points: hook_q/k/v
    [B,pos,head,d_head], hook_attn_scores & hook_pattern
    [B,head,q_pos,k_pos], hook_z [B,pos,head,d_head], hook_result
    [B,pos,head,d_model] (gated by use_attn_result).

    ``attention_mask`` is None, the marker ``"causal"`` (fusable in the
    kernel) or an additive tensor.  When the gate of the module docstring
    holds, the mix runs as the kernel (:func:`_fused_attention`); a T too
    long for it raises rather than falling back to this einsum path.
    """
    split = cfg.use_split_qkv_input or cfg.use_attn_in
    causal_marker = isinstance(attention_mask, str) and attention_mask == "causal"
    fusable = (cfg.use_fused_attention and not split
               and (attention_mask is None or causal_marker)
               and not cfg.use_attn_result and cfg.matmul_precision == "default"
               and query_input is key_input is value_input
               and not _wants_attn_internals(hooks, prefix))
    if fusable:
        return _fused_attention(params, cfg, query_input, prefix,
                                causal=causal_marker)

    if not split and cfg.fused_qkv and query_input is key_input is value_input:
        Wqkv = torch.stack([params.W_Q, params.W_K, params.W_V])
        qkv = torch.einsum("bpd,sndh->sbpnh", query_input, Wqkv)
        q = hooks(f"{prefix}.hook_q", qkv[0] + params.b_Q)
        k = hooks(f"{prefix}.hook_k", qkv[1] + params.b_K)
        v = hooks(f"{prefix}.hook_v", qkv[2] + params.b_V)
    else:
        eq = "bpnd,ndh->bpnh" if split else "bpd,ndh->bpnh"
        q = hooks(f"{prefix}.hook_q",
                  torch.einsum(eq, query_input, params.W_Q) + params.b_Q)
        k = hooks(f"{prefix}.hook_k",
                  torch.einsum(eq, key_input, params.W_K) + params.b_K)
        v = hooks(f"{prefix}.hook_v",
                  torch.einsum(eq, value_input, params.W_V) + params.b_V)

    attn_scale = math.sqrt(cfg.d_head) if cfg.use_attn_scale else 1.0
    scores = torch.einsum("bqnh,bknh->bnqk", q, k) / attn_scale
    if causal_marker:
        T = scores.shape[-1]
        keep = torch.ones(T, T, dtype=torch.bool, device=scores.device).tril()
        attention_mask = torch.zeros(T, T, dtype=scores.dtype,
                                     device=scores.device).masked_fill(
                                         ~keep, float("-inf"))
    if attention_mask is not None:
        scores = scores + attention_mask
    scores = hooks(f"{prefix}.hook_attn_scores", scores)

    pattern = torch.softmax(scores, dim=-1)
    pattern = torch.where(torch.isnan(pattern), torch.zeros_like(pattern), pattern)
    pattern = hooks(f"{prefix}.hook_pattern", pattern)
    pattern = pattern.to(cfg.torch_dtype)

    z = hooks(f"{prefix}.hook_z", torch.einsum("bknh,bnqk->bqnh", v, pattern))

    if not cfg.use_attn_result:
        return torch.einsum("bqnh,nhd->bqd", z, params.W_O) + params.b_O
    result = hooks(f"{prefix}.hook_result",
                   torch.einsum("bqnh,nhd->bqnd", z, params.W_O))
    return result.sum(dim=2) + params.b_O


# ---------------------------------------------------------------------------
# MLP and head
# ---------------------------------------------------------------------------

def mlp(params, cfg: ViTConfig, x, hooks: HookRuntime = NULL_HOOKS,
        prefix: str = "mlp"):
    return _mlp_from_pre(params, cfg, x @ params.W_in + params.b_in, hooks,
                         prefix)


def _mlp_from_pre(params, cfg: ViTConfig, pre, hooks: HookRuntime,
                  prefix: str):
    pre = hooks(f"{prefix}.hook_pre", pre)
    act_fn = ACT_FNS[cfg.activation_name]
    if not cfg.activation_name.endswith("_ln"):
        post = hooks(f"{prefix}.hook_post", act_fn(pre))
    else:
        mid = hooks(f"{prefix}.hook_mid", act_fn(pre))
        if cfg.normalization_type == "LN":
            normed = layer_norm(params.ln, cfg, mid, hooks, f"{prefix}.ln")
        else:
            normed = layer_norm_pre(cfg, mid, hooks, f"{prefix}.ln")
        post = hooks(f"{prefix}.hook_post", normed)
    return post @ params.W_out + params.b_out


def head(params, cfg: ViTConfig, x):
    return x @ params.W_H + params.b_H


# ---------------------------------------------------------------------------
# Transformer blocks
# ---------------------------------------------------------------------------

def _split_inputs(cfg, resid_pre, hooks, prefix):
    """Head-dim broadcast and the q/k/v-input hooks."""
    if cfg.use_attn_in or cfg.use_split_qkv_input:
        B, P, D = resid_pre.shape
        attn_in = resid_pre[:, :, None, :].expand(B, P, cfg.n_heads, D)
    else:
        attn_in = resid_pre
    if cfg.use_attn_in:
        attn_in = hooks(f"{prefix}.hook_attn_in", attn_in)
    if cfg.use_split_qkv_input:
        query_input = hooks(f"{prefix}.hook_q_input", attn_in)
        key_input = hooks(f"{prefix}.hook_k_input", attn_in)
        value_input = hooks(f"{prefix}.hook_v_input", attn_in)
    else:
        query_input = key_input = value_input = attn_in
    return query_input, key_input, value_input


def transformer_block(params, cfg: ViTConfig, resid_pre,
                      hooks: HookRuntime = NULL_HOOKS, prefix: str = "blocks.0",
                      attn_mask=None):
    """Pre-LN block."""
    resid_pre = hooks(f"{prefix}.hook_resid_pre", resid_pre)
    q_in, k_in, v_in = _split_inputs(cfg, resid_pre, hooks, prefix)
    if cfg.use_split_qkv_input:
        ln_q = apply_norm(params.ln1, cfg, q_in, hooks, f"{prefix}.ln1")
        ln_k = apply_norm(params.ln1, cfg, k_in, hooks, f"{prefix}.ln1")
        ln_v = apply_norm(params.ln1, cfg, v_in, hooks, f"{prefix}.ln1")
    else:
        ln_q = ln_k = ln_v = apply_norm(params.ln1, cfg, q_in, hooks, f"{prefix}.ln1")
    attn_out = attention(params.attn, cfg, ln_q, ln_k, ln_v, hooks,
                         f"{prefix}.attn", attn_mask)
    attn_out = hooks(f"{prefix}.hook_attn_out", attn_out)

    if cfg.attn_only:
        return hooks(f"{prefix}.hook_resid_post", resid_pre + attn_out)
    resid_mid = hooks(f"{prefix}.hook_resid_mid", resid_pre + attn_out)
    mlp_in = hooks(f"{prefix}.hook_mlp_in", resid_mid) if cfg.use_hook_mlp_in else resid_mid
    normalized = apply_norm(params.ln2, cfg, mlp_in, hooks, f"{prefix}.ln2")
    mlp_out = hooks(f"{prefix}.hook_mlp_out",
                    mlp(params.mlp, cfg, normalized, hooks, f"{prefix}.mlp"))
    return hooks(f"{prefix}.hook_resid_post", resid_mid + mlp_out)


def bert_block(params, cfg: ViTConfig, resid_pre,
               hooks: HookRuntime = NULL_HOOKS, prefix: str = "blocks.0",
               attn_mask=None):
    """Post-LN variant: LN after attention and after the MLP.  As in the
    reference, ``hook_mlp_out`` fires before ln2."""
    resid_pre = hooks(f"{prefix}.hook_resid_pre", resid_pre)
    q_in, k_in, v_in = _split_inputs(cfg, resid_pre, hooks, prefix)

    attn_out = attention(params.attn, cfg, q_in, k_in, v_in, hooks,
                         f"{prefix}.attn", attn_mask)
    attn_out = hooks(f"{prefix}.hook_attn_out", attn_out)
    attn_out = apply_norm(params.ln1, cfg, attn_out, hooks, f"{prefix}.ln1")

    if cfg.attn_only:
        return hooks(f"{prefix}.hook_resid_post", resid_pre + attn_out)
    resid_mid = hooks(f"{prefix}.hook_resid_mid", resid_pre + attn_out)
    mlp_in = hooks(f"{prefix}.hook_mlp_in", resid_mid) if cfg.use_hook_mlp_in else resid_mid
    mlp_out = hooks(f"{prefix}.hook_mlp_out",
                    mlp(params.mlp, cfg, mlp_in, hooks, f"{prefix}.mlp"))
    mlp_out = apply_norm(params.ln2, cfg, mlp_out, hooks, f"{prefix}.ln2")
    return hooks(f"{prefix}.hook_resid_post", resid_mid + mlp_out)
