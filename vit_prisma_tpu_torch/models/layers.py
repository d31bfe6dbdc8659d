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
 * Attention takes the hand-written kernels under the JAX package's gate:
   no attention-internal hook requested, no mask or the causal marker, no
   split inputs, no ``use_attn_result``, and ``matmul_precision ==
   'default'``.  A T that fits B1's shared memory runs the whole-T mix
   (:func:`_fused_attention`), a longer one the tiled flash kernel B13
   (:func:`_flash_attention_long`).
 * With ``cfg.use_fused_ln_gemm`` the pre-LN block runs ln1 -> QKV
   (:func:`_fused_ln_attention`, where the whole-T mix would run) and ln2 ->
   W_in (:func:`_fused_ln_mlp`) as the LayerNorm-prologue GEMM B14, unless a
   hook inside that LayerNorm is requested.
 * Tensor parallelism (``HookedViT.shard``, ``parallel/mesh.py``): a
   sharded block's ``attn`` and ``mlp`` hold this rank's heads and
   ``d_mlp`` columns and carry the mesh's ``model`` axis as ``.tp``.  Their
   input passes ``copy_to`` (whose backward sums the partial gradients),
   their output is summed over the axis (``reduce_from``) before the bias,
   and a head- or ``d_mlp``-indexed hook point that a hook wants fires on
   the whole tensor (``hook_whole``): two all-reduces a block and no other
   collective on the plain path.  The kernels run on the local heads and
   columns.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vit_prisma_tpu_torch.configs.vit_config import ViTConfig
from vit_prisma_tpu_torch.ops.attention import (attention_mix_tnh, flash_attention_padded,
                                                mix_tnh_fits_smem)
from vit_prisma_tpu_torch.ops.ln_matmul import fold_ln_affine, ln_matmul, ln_matmul_fits
from vit_prisma_tpu_torch.parallel.collectives import SINGLE, hook_whole
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
    # On the card unless ``device`` names another.
    return nn.Parameter(torch.empty(shape, device=resolve_device(device), dtype=dtype))


class LayerNorm(nn.Module):
    def __init__(self, d: int, device=None, dtype=None):
        super().__init__()
        self.w = new_param((d,), device, dtype)
        self.b = new_param((d,), device, dtype)


def patch_dim(cfg: ViTConfig) -> int:
    """Rows of ``embed.W``: C·P² for images, C·D·P² for a video config's
    tubelets of depth D."""
    n = cfg.n_channels * cfg.patch_size ** 2
    return n * cfg.video_tubelet_depth if cfg.is_video_transformer else n


class PatchEmbedding(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        self.W = new_param((patch_dim(cfg), cfg.d_model), device, cfg.torch_dtype)
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
                prefix: str = "blocks.0", attn_mask=None, dropout_key=None):
        block_fn = bert_block if self.cfg.use_bert_block else transformer_block
        return block_fn(self, self.cfg, resid_pre, hooks, prefix, attn_mask,
                        dropout_key=dropout_key)


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


def tubelet_patchify(cfg: ViTConfig, x):
    """[B, C, T, H, W] -> [B, (T/D)·(H/P)·(W/P), C*D*P*P] in the (C, D, Ph,
    Pw) element order of ``Conv3d.weight.reshape(d_model, -1)``."""
    B, C, T, H, W = x.shape
    P, D = cfg.patch_size, cfg.video_tubelet_depth
    x = x.reshape(B, C, T // D, D, H // P, P, W // P, P)
    x = x.permute(0, 2, 4, 6, 1, 3, 5, 7)
    return x.reshape(B, (T // D) * (H // P) * (W // P), C * D * P * P)


def tubelet_embedding(params, cfg: ViTConfig, x):
    """Video tubelet embedding: tubelet extraction plus one matmul, the
    stride=kernel Conv3d.  ``params.W: [C*D*P*P, d_model]``."""
    patches = tubelet_patchify(cfg, x).to(params.W.dtype)
    return patches @ params.W + params.b


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _tp(params):
    """The tensor-parallel axis of a sharded ``attn`` or ``mlp`` (SINGLE
    when whole)."""
    return params.__dict__.get("tp") or SINGLE


def _wants_attn_internals(hooks: HookRuntime, prefix: str) -> bool:
    """True if any hook inside the attention mix is cached or edited."""
    return any(hooks.wants(f"{prefix}.{n}") for n in
               ("hook_q", "hook_k", "hook_v", "hook_attn_scores",
                "hook_pattern", "hook_z", "hook_result"))


def _wants_ln(hooks: HookRuntime, prefix: str) -> bool:
    """True if the LayerNorm's internal hooks are cached or edited."""
    return (hooks.wants(f"{prefix}.hook_scale")
            or hooks.wants(f"{prefix}.hook_normalized"))


def _qkv_weights(params, D: int, NH: int):
    """Per-head W_Q, W_K, W_V as [D, N*H] and W_O as [N*H, D]."""
    flat = lambda w: w.permute(1, 0, 2).reshape(D, NH)
    return flat(params.W_Q), flat(params.W_K), flat(params.W_V), params.W_O.reshape(NH, D)


def _fused_ln_attention(params, ln_params, cfg: ViTConfig, x, prefix: str,
                        causal: bool = False):
    """:func:`_fused_attention` with ln1's normalize fused into the QKV GEMM
    (kernel B14, ops/ln_matmul.py): the LayerNorm's output never reaches
    device memory, and q, k, v leave the kernel as contiguous [B*T, N*H]
    slices for the mix.  An affine ln1 folds into W_Q, W_K, W_V on every
    call, after W_Q and b_Q are divided by the scale (fold_ln_affine)."""
    scale = math.sqrt(cfg.d_head) if cfg.use_attn_scale else 1.0
    tp = _tp(params)
    x = tp.copy_to(x)
    B, T, D = x.shape
    N = params.W_Q.shape[0]
    NH = N * cfg.d_head
    Wq, Wk, Wv, Wo = _qkv_weights(params, D, NH)
    W = torch.stack([Wq / scale, Wk, Wv])
    b = torch.stack([params.b_Q.reshape(-1) / scale, params.b_K.reshape(-1),
                     params.b_V.reshape(-1)])
    if ln_params is not None:  # normalization_type == "LN"
        W, b = fold_ln_affine(W, b, tp.copy_to(ln_params.w), tp.copy_to(ln_params.b))
    qkv = ln_matmul(x.reshape(B * T, D), W, b, cfg.eps)  # [3, B*T, N*H]
    z = attention_mix_tnh(qkv[0].reshape(B, T, NH), qkv[1].reshape(B, T, NH),
                          qkv[2].reshape(B, T, NH), N, causal)
    return tp.reduce_from((z.reshape(B * T, NH) @ Wo).reshape(B, T, D)) + params.b_O


def _ln_gemm_fusable(cfg: ViTConfig, hooks: HookRuntime, prefix: str,
                     attn_mask, x, n_heads: Optional[int] = None) -> bool:
    """Gate for the ln1 -> QKV fusion: the conditions under which
    :func:`attention` would take the whole-T mix (B1), plus no ln1 hook and
    a shape the LayerNorm-prologue GEMM takes (``n_heads``: the block's
    local heads under tensor parallelism, ``cfg.n_heads`` when None)."""
    if not (cfg.use_fused_ln_gemm and cfg.use_fused_attention
            and cfg.normalization_type in ("LN", "LNPre")
            and not (cfg.use_split_qkv_input or cfg.use_attn_in)
            and not cfg.use_attn_result and cfg.matmul_precision == "default"):
        return False
    causal_marker = isinstance(attn_mask, str) and attn_mask == "causal"
    if not (attn_mask is None or causal_marker):
        return False
    if (_wants_attn_internals(hooks, f"{prefix}.attn")
            or _wants_ln(hooks, f"{prefix}.ln1")):
        return False
    B, T, D = x.shape
    return (mix_tnh_fits_smem(T, cfg.d_head)
            and ln_matmul_fits(B * T, 3, D, (n_heads or cfg.n_heads) * cfg.d_head))


def _project_qkv(params, cfg: ViTConfig, x):
    """The kernel routes' projections: flat [B*T, d_model] GEMMs giving q
    (divided by the attention scale), k and v as [B*T, N*H], and W_O as
    [N*H, d_model]."""
    scale = math.sqrt(cfg.d_head) if cfg.use_attn_scale else 1.0
    B, T, D = x.shape
    xf = _tp(params).copy_to(x).reshape(B * T, D)
    Wq, Wk, Wv, Wo = _qkv_weights(params, D, params.W_Q.shape[0] * cfg.d_head)
    q = (xf @ Wq) / scale + params.b_Q.reshape(-1) / scale
    k = xf @ Wk + params.b_K.reshape(-1)
    v = xf @ Wv + params.b_V.reshape(-1)
    return q, k, v, Wo


def _fused_attention(params, cfg: ViTConfig, x, prefix: str,
                     causal: bool = False):
    """The speed path: the QKV projections run as flat [B*T, d_model] GEMMs
    whose row-major [B, T, N*H] output feeds the attention-mix kernel with
    no layout copy, and the scores, softmax and PV product stay inside the
    kernel (float32 softmax)."""
    B, T, D = x.shape
    N = params.W_Q.shape[0]
    NH = N * cfg.d_head
    q, k, v, Wo = _project_qkv(params, cfg, x)
    z = attention_mix_tnh(q.reshape(B, T, NH), k.reshape(B, T, NH), v.reshape(B, T, NH),
                          N, causal)
    return _tp(params).reduce_from((z.reshape(B * T, NH) @ Wo).reshape(B, T, D)) + params.b_O


def _flash_attention_long(params, cfg: ViTConfig, x, prefix: str,
                          causal: bool = False):
    """Long token axes (T past B1's shared memory, e.g. CLIP L/14 at 336
    pixels): the projections and epilogue of :func:`_fused_attention`, the
    mix as the tiled flash kernel B13 (ops/attention.py
    flash_attention_padded) over head-major [B, N, Tp, H].  The relayout,
    the pad of T to a multiple of 128 and the segment ids (1 for real
    tokens, 2 for padding, so neither sees the other) are plain torch ops,
    and the padding rows are sliced away."""
    B, T, D = x.shape
    N, H = params.W_Q.shape[0], cfg.d_head
    q, k, v, Wo = _project_qkv(params, cfg, x)
    Tp = -(-T // 128) * 128

    def heads(t):  # [B*T, N*H] -> [B, N, Tp, H], padded with zeros
        return F.pad(t.reshape(B, T, N, H).transpose(1, 2), (0, 0, 0, Tp - T)).contiguous()

    seg = torch.where(torch.arange(Tp, device=x.device) < T, 1, 2).to(torch.int32)
    z = flash_attention_padded(heads(q), heads(k), heads(v),
                               seg.expand(B, Tp).contiguous(), causal)
    z = z[:, :, :T].transpose(1, 2).reshape(B * T, N * H)
    return _tp(params).reduce_from((z @ Wo).reshape(B, T, D)) + params.b_O


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
    kernels) or an additive tensor.  When the gate of the module docstring
    holds, the mix runs as B1 (:func:`_fused_attention`) where T fits its
    shared memory, else as the flash kernel B13
    (:func:`_flash_attention_long`), as the JAX package routes it.
    """
    split = cfg.use_split_qkv_input or cfg.use_attn_in
    causal_marker = isinstance(attention_mask, str) and attention_mask == "causal"
    fusable = (cfg.use_fused_attention and not split
               and (attention_mask is None or causal_marker)
               and not cfg.use_attn_result and cfg.matmul_precision == "default"
               and query_input is key_input is value_input
               and not _wants_attn_internals(hooks, prefix))
    if fusable:
        if mix_tnh_fits_smem(query_input.shape[1], cfg.d_head):
            return _fused_attention(params, cfg, query_input, prefix,
                                    causal=causal_marker)
        return _flash_attention_long(params, cfg, query_input, prefix,
                                     causal=causal_marker)

    tp = _tp(params)
    if tp.size > 1:
        # this rank's heads of a split input; the whole input otherwise
        if split:
            query_input, key_input, value_input = (tp.own(t, 2) for t in
                                                   (query_input, key_input, value_input))
        elif query_input is key_input is value_input:
            query_input = key_input = value_input = tp.copy_to(query_input)
        else:
            query_input, key_input, value_input = (tp.copy_to(t) for t in
                                                   (query_input, key_input, value_input))
    hk = lambda name, value, dim: hook_whole(hooks, f"{prefix}.{name}", value, tp, dim)
    if not split and cfg.fused_qkv and query_input is key_input is value_input:
        Wqkv = torch.stack([params.W_Q, params.W_K, params.W_V])
        qkv = torch.einsum("bpd,sndh->sbpnh", query_input, Wqkv)
        q = hk("hook_q", qkv[0] + params.b_Q, 2)
        k = hk("hook_k", qkv[1] + params.b_K, 2)
        v = hk("hook_v", qkv[2] + params.b_V, 2)
    else:
        eq = "bpnd,ndh->bpnh" if split else "bpd,ndh->bpnh"
        q = hk("hook_q", torch.einsum(eq, query_input, params.W_Q) + params.b_Q, 2)
        k = hk("hook_k", torch.einsum(eq, key_input, params.W_K) + params.b_K, 2)
        v = hk("hook_v", torch.einsum(eq, value_input, params.W_V) + params.b_V, 2)

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
    scores = hk("hook_attn_scores", scores, 1)

    pattern = torch.softmax(scores, dim=-1)
    pattern = torch.where(torch.isnan(pattern), torch.zeros_like(pattern), pattern)
    pattern = hk("hook_pattern", pattern, 1)
    pattern = pattern.to(cfg.torch_dtype)

    z = hk("hook_z", torch.einsum("bknh,bnqk->bqnh", v, pattern), 2)

    if not cfg.use_attn_result:
        return tp.reduce_from(torch.einsum("bqnh,nhd->bqd", z, params.W_O)) + params.b_O
    result = hk("hook_result", torch.einsum("bqnh,nhd->bqnd", z, params.W_O), 2)
    return tp.reduce_from(result.sum(dim=2)) + params.b_O


# ---------------------------------------------------------------------------
# MLP and head
# ---------------------------------------------------------------------------

def mlp(params, cfg: ViTConfig, x, hooks: HookRuntime = NULL_HOOKS,
        prefix: str = "mlp"):
    x = _tp(params).copy_to(x)
    return _mlp_from_pre(params, cfg, x @ params.W_in + params.b_in, hooks,
                         prefix)


def _fused_ln_mlp(params, ln_params, cfg: ViTConfig, x,
                  hooks: HookRuntime = NULL_HOOKS, prefix: str = "mlp"):
    """The MLP with ln2's normalize fused into the W_in GEMM (kernel B14);
    ``hook_pre`` and everything after it are those of :func:`mlp`."""
    tp = _tp(params)
    x = tp.copy_to(x)
    B, T, D = x.shape
    W, b = params.W_in[None], params.b_in[None]
    if ln_params is not None:  # normalization_type == "LN"
        W, b = fold_ln_affine(W, b, tp.copy_to(ln_params.w), tp.copy_to(ln_params.b))
    pre = ln_matmul(x.reshape(B * T, D), W, b, cfg.eps)
    return _mlp_from_pre(params, cfg, pre[0].reshape(B, T, -1), hooks, prefix)


def _ln_mlp_fusable(cfg: ViTConfig, hooks: HookRuntime, prefix: str, x,
                    d_mlp: Optional[int] = None) -> bool:
    """Gate for the ln2 -> W_in fusion: the flag, an LN or LNPre norm, the
    default matmul precision, no ln2 hook, and a shape the kernel takes
    (``d_mlp``: the block's local columns, ``cfg.d_mlp`` when None)."""
    if not (cfg.use_fused_ln_gemm and cfg.normalization_type in ("LN", "LNPre")
            and cfg.matmul_precision == "default"):
        return False
    if _wants_ln(hooks, f"{prefix}.ln2"):
        return False
    B, T, D = x.shape
    return ln_matmul_fits(B * T, 1, D, d_mlp or cfg.d_mlp)


def _mlp_from_pre(params, cfg: ViTConfig, pre, hooks: HookRuntime,
                  prefix: str):
    tp = _tp(params)
    pre = hook_whole(hooks, f"{prefix}.hook_pre", pre, tp, -1)
    act_fn = ACT_FNS[cfg.activation_name]
    if not cfg.activation_name.endswith("_ln"):
        post = hook_whole(hooks, f"{prefix}.hook_post", act_fn(pre), tp, -1)
    else:
        mid = hooks(f"{prefix}.hook_mid", act_fn(pre))
        if cfg.normalization_type == "LN":
            normed = layer_norm(params.ln, cfg, mid, hooks, f"{prefix}.ln")
        else:
            normed = layer_norm_pre(cfg, mid, hooks, f"{prefix}.ln")
        post = hooks(f"{prefix}.hook_post", normed)
    return tp.reduce_from(post @ params.W_out) + params.b_out


def head(params, cfg: ViTConfig, x):
    return x @ params.W_H + params.b_H


# ---------------------------------------------------------------------------
# Dropout (the reference's nn.Dropout on attn_out and mlp_out in the pre-LN
# block; the BertBlock has none)
# ---------------------------------------------------------------------------

def dropout(x, rate: float, generator=None):
    """Inverted dropout, drawing its mask from the ``torch.Generator``
    ``generator`` (on x's device).  A no-op when ``generator`` is None (eval
    mode) or ``rate == 0``.  The masks are not ``jax.random``'s."""
    if generator is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


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
                      attn_mask=None, dropout_key=None):
    """Pre-LN block.  ``dropout_key`` (a ``torch.Generator``) enables
    train-mode dropout on attn_out and mlp_out, in that order."""
    resid_pre = hooks(f"{prefix}.hook_resid_pre", resid_pre)
    q_in, k_in, v_in = _split_inputs(cfg, resid_pre, hooks, prefix)
    affine = cfg.normalization_type == "LN"
    if _ln_gemm_fusable(cfg, hooks, prefix, attn_mask, q_in, params.attn.W_Q.shape[0]):
        attn_out = _fused_ln_attention(
            params.attn, params.ln1 if affine else None, cfg, q_in, f"{prefix}.attn",
            causal=isinstance(attn_mask, str) and attn_mask == "causal")
    else:
        if cfg.use_split_qkv_input:
            ln_q = apply_norm(params.ln1, cfg, q_in, hooks, f"{prefix}.ln1")
            ln_k = apply_norm(params.ln1, cfg, k_in, hooks, f"{prefix}.ln1")
            ln_v = apply_norm(params.ln1, cfg, v_in, hooks, f"{prefix}.ln1")
        else:
            ln_q = ln_k = ln_v = apply_norm(params.ln1, cfg, q_in, hooks, f"{prefix}.ln1")
        attn_out = attention(params.attn, cfg, ln_q, ln_k, ln_v, hooks,
                             f"{prefix}.attn", attn_mask)
    attn_out = dropout(attn_out, cfg.attn_dropout_rate, dropout_key)
    attn_out = hooks(f"{prefix}.hook_attn_out", attn_out)

    if cfg.attn_only:
        return hooks(f"{prefix}.hook_resid_post", resid_pre + attn_out)
    resid_mid = hooks(f"{prefix}.hook_resid_mid", resid_pre + attn_out)
    mlp_in = hooks(f"{prefix}.hook_mlp_in", resid_mid) if cfg.use_hook_mlp_in else resid_mid
    if _ln_mlp_fusable(cfg, hooks, prefix, mlp_in, params.mlp.W_in.shape[1]):
        mlp_out = _fused_ln_mlp(params.mlp, params.ln2 if affine else None, cfg, mlp_in,
                                hooks, f"{prefix}.mlp")
    else:
        normalized = apply_norm(params.ln2, cfg, mlp_in, hooks, f"{prefix}.ln2")
        mlp_out = mlp(params.mlp, cfg, normalized, hooks, f"{prefix}.mlp")
    mlp_out = hooks(f"{prefix}.hook_mlp_out",
                    dropout(mlp_out, cfg.mlp_dropout_rate, dropout_key))
    return hooks(f"{prefix}.hook_resid_post", resid_mid + mlp_out)


def bert_block(params, cfg: ViTConfig, resid_pre,
               hooks: HookRuntime = NULL_HOOKS, prefix: str = "blocks.0",
               attn_mask=None, dropout_key=None):
    """Post-LN variant: LN after attention and after the MLP.  As in the
    reference, ``hook_mlp_out`` fires before ln2, and there is no dropout
    (``dropout_key`` is accepted and unused)."""
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
