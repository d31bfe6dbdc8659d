"""Weight converters: foreign checkpoint formats -> the flat reference-named
state dict (``blocks.{l}.attn.W_Q`` ..., per-head layouts).

A copy of ``vit_prisma_tpu/models/loading/convert.py``, which the port may
not import; ``tests/test_torch_loading.py`` holds every converter equal to
the original, to the bit.  HF CLIP (vision and text), open_clip (vision and
text), Kandinsky's CLIP image encoder, timm, DINO / HF ``ViTModel``, HF
``ViTForImageClassification``, ViViT and V-JEPA, and ``fill_missing_keys``.

All converters are pure numpy (tensors are accepted and detached), so they
run the same on any host; the model then moves the result to its device
once.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from vit_prisma_tpu_torch.configs.vit_config import TextTransformerConfig, ViTConfig

Flat = Dict[str, Any]


def _np(v) -> np.ndarray:
    if hasattr(v, "detach"):
        v = v.detach().cpu().float().numpy()
    return np.asarray(v)


def _split_heads_qkv(W: np.ndarray, cfg) -> np.ndarray:
    """[(h dh), d] -> [h, d, dh]"""
    H, Dh = cfg.n_heads, cfg.d_head
    return W.reshape(H, Dh, cfg.d_model).transpose(0, 2, 1)


def _split_heads_bias(b: np.ndarray, cfg) -> np.ndarray:
    """[(h dh)] -> [h, dh]"""
    return b.reshape(cfg.n_heads, cfg.d_head)


def _split_heads_out(W_O: np.ndarray, cfg) -> np.ndarray:
    """[d, (h dh)] -> [h, dh, d]"""
    H, Dh = cfg.n_heads, cfg.d_head
    return W_O.reshape(cfg.d_model, H, Dh).transpose(1, 2, 0)


def _block_attn(flat: Flat, l: int, W_Q, W_K, W_V, W_O, b_Q, b_K, b_V, b_O,
                cfg) -> None:
    p = f"blocks.{l}.attn"
    flat[f"{p}.W_Q"] = _split_heads_qkv(_np(W_Q), cfg)
    flat[f"{p}.W_K"] = _split_heads_qkv(_np(W_K), cfg)
    flat[f"{p}.W_V"] = _split_heads_qkv(_np(W_V), cfg)
    flat[f"{p}.W_O"] = _split_heads_out(_np(W_O), cfg)
    flat[f"{p}.b_Q"] = _split_heads_bias(_np(b_Q), cfg)
    flat[f"{p}.b_K"] = _split_heads_bias(_np(b_K), cfg)
    flat[f"{p}.b_V"] = _split_heads_bias(_np(b_V), cfg)
    flat[f"{p}.b_O"] = _np(b_O)


def _block_mlp(flat: Flat, l: int, W_in, b_in, W_out, b_out) -> None:
    # torch Linear weights are [out, in]; ours are [in, out].
    flat[f"blocks.{l}.mlp.W_in"] = _np(W_in).T
    flat[f"blocks.{l}.mlp.W_out"] = _np(W_out).T
    flat[f"blocks.{l}.mlp.b_in"] = _np(b_in)
    flat[f"blocks.{l}.mlp.b_out"] = _np(b_out)


def _block_ln(flat: Flat, l: int, which: str, w, b) -> None:
    flat[f"blocks.{l}.{which}.w"] = _np(w)
    flat[f"blocks.{l}.{which}.b"] = _np(b)


# ---------------------------------------------------------------------------
# timm ViT (weight_conversion.py:625-706)
# ---------------------------------------------------------------------------

def convert_timm_weights(old: Dict[str, Any], cfg: ViTConfig) -> Flat:
    g = lambda k: _np(old[k])
    flat: Flat = {
        "cls_token": g("cls_token"),
        "pos_embed.W_pos": g("pos_embed").squeeze(0),
        "embed.proj.weight": g("patch_embed.proj.weight"),
        "embed.proj.bias": g("patch_embed.proj.bias"),
        "ln_final.w": g("norm.weight"),
        "ln_final.b": g("norm.bias"),
        "head.W_H": g("head.weight").T,
        "head.b_H": g("head.bias"),
    }
    for l in range(cfg.n_layers):
        k = f"blocks.{l}"
        _block_ln(flat, l, "ln1", old[f"{k}.norm1.weight"], old[f"{k}.norm1.bias"])
        _block_ln(flat, l, "ln2", old[f"{k}.norm2.weight"], old[f"{k}.norm2.bias"])
        qkv_w = g(f"{k}.attn.qkv.weight")  # [(3 h dh), d]
        qkv_b = g(f"{k}.attn.qkv.bias")
        W_Q, W_K, W_V = np.split(qkv_w, 3, axis=0)
        b_Q, b_K, b_V = np.split(qkv_b, 3, axis=0)
        _block_attn(flat, l, W_Q, W_K, W_V, old[f"{k}.attn.proj.weight"],
                    b_Q, b_K, b_V, old[f"{k}.attn.proj.bias"], cfg)
        _block_mlp(flat, l, old[f"{k}.mlp.fc1.weight"], old[f"{k}.mlp.fc1.bias"],
                   old[f"{k}.mlp.fc2.weight"], old[f"{k}.mlp.fc2.bias"])
    return flat


# ---------------------------------------------------------------------------
# HF CLIP vision tower (weight_conversion.py:521-622).  ``old`` is the
# ``CLIPVisionModel`` (vision_model.*-stripped) state dict; ``head`` is the
# visual_projection Linear state dict.
# ---------------------------------------------------------------------------

def convert_clip_weights(old: Dict[str, Any], head: Dict[str, Any],
                         cfg: ViTConfig) -> Flat:
    g = lambda k: _np(old[k])
    flat: Flat = {
        "cls_token": g("embeddings.class_embedding").reshape(1, 1, -1),
        "pos_embed.W_pos": g("embeddings.position_embedding.weight"),
        "embed.proj.weight": g("embeddings.patch_embedding.weight"),
        "embed.proj.bias": np.zeros((cfg.d_model,), np.float32),
        "ln_final.w": g("post_layernorm.weight"),
        "ln_final.b": g("post_layernorm.bias"),
        "ln_pre.w": g("pre_layrnorm.weight"),  # (sic) HF CLIPModel typo
        "ln_pre.b": g("pre_layrnorm.bias"),
        "head.W_H": _np(head["weight"]).T,
        "head.b_H": np.zeros((cfg.n_classes,), np.float32),
    }
    for l in range(cfg.n_layers):
        k = f"encoder.layers.{l}"
        _block_ln(flat, l, "ln1", old[f"{k}.layer_norm1.weight"],
                  old[f"{k}.layer_norm1.bias"])
        _block_ln(flat, l, "ln2", old[f"{k}.layer_norm2.weight"],
                  old[f"{k}.layer_norm2.bias"])
        _block_attn(flat, l,
                    old[f"{k}.self_attn.q_proj.weight"],
                    old[f"{k}.self_attn.k_proj.weight"],
                    old[f"{k}.self_attn.v_proj.weight"],
                    old[f"{k}.self_attn.out_proj.weight"],
                    old[f"{k}.self_attn.q_proj.bias"],
                    old[f"{k}.self_attn.k_proj.bias"],
                    old[f"{k}.self_attn.v_proj.bias"],
                    old[f"{k}.self_attn.out_proj.bias"], cfg)
        _block_mlp(flat, l, old[f"{k}.mlp.fc1.weight"], old[f"{k}.mlp.fc1.bias"],
                   old[f"{k}.mlp.fc2.weight"], old[f"{k}.mlp.fc2.bias"])
    return flat


# ---------------------------------------------------------------------------
# Kandinsky image encoder (weight_conversion.py:148-273): the Kandinsky 2.2
# prior's CLIPVisionModelWithProjection.  Keys carry a ``vision_model.``
# prefix; the head is the visual projection (:268-271).
# ---------------------------------------------------------------------------

def convert_kandinsky_clip_weights(old: Dict[str, Any], cfg: ViTConfig) -> Flat:
    stripped = {k[len("vision_model."):]: v for k, v in old.items()
                if k.startswith("vision_model.")}
    head = {"weight": old["visual_projection.weight"]}
    return convert_clip_weights(stripped, head, cfg)


# ---------------------------------------------------------------------------
# OpenCLIP vision / text (weight_conversion.py:276-431)
# ---------------------------------------------------------------------------

def _open_clip_blocks(old: Dict[str, Any], cfg, layer_key: str) -> Flat:
    flat: Flat = {}
    for l in range(cfg.n_layers):
        k = f"{layer_key}.{l}"
        _block_ln(flat, l, "ln1", old[f"{k}.ln_1.weight"], old[f"{k}.ln_1.bias"])
        _block_ln(flat, l, "ln2", old[f"{k}.ln_2.weight"], old[f"{k}.ln_2.bias"])
        in_w = _np(old[f"{k}.attn.in_proj_weight"])
        in_b = _np(old[f"{k}.attn.in_proj_bias"])
        W_Q, W_K, W_V = np.split(in_w, 3, axis=0)
        b_Q, b_K, b_V = np.split(in_b, 3, axis=0)
        _block_attn(flat, l, W_Q, W_K, W_V, old[f"{k}.attn.out_proj.weight"],
                    b_Q, b_K, b_V, old[f"{k}.attn.out_proj.bias"], cfg)
        _block_mlp(flat, l, old[f"{k}.mlp.c_fc.weight"], old[f"{k}.mlp.c_fc.bias"],
                   old[f"{k}.mlp.c_proj.weight"], old[f"{k}.mlp.c_proj.bias"])
    return flat


def convert_open_clip_weights(old: Dict[str, Any], cfg: ViTConfig) -> Flat:
    flat: Flat = {
        "cls_token": _np(old["visual.class_embedding"]).reshape(1, 1, -1),
        "pos_embed.W_pos": _np(old["visual.positional_embedding"]),
        "embed.proj.weight": _np(old["visual.conv1.weight"]),
        "embed.proj.bias": np.zeros((cfg.d_model,), np.float32),
        "ln_final.w": _np(old["visual.ln_post.weight"]),
        "ln_final.b": _np(old["visual.ln_post.bias"]),
        "ln_pre.w": _np(old["visual.ln_pre.weight"]),
        "ln_pre.b": _np(old["visual.ln_pre.bias"]),
        "head.W_H": _np(old["visual.proj"]),
        "head.b_H": np.zeros((cfg.n_classes,), np.float32),
    }
    flat.update(_open_clip_blocks(old, cfg, "visual.transformer.resblocks"))
    return flat


def convert_open_clip_text_weights(old: Dict[str, Any],
                                   cfg: TextTransformerConfig) -> Flat:
    flat: Flat = {
        "token_embed.W_E": _np(old["token_embedding.weight"]),
        "pos_embed.W_pos": _np(old["positional_embedding"]),
        "ln_final.w": _np(old["ln_final.weight"]),
        "ln_final.b": _np(old["ln_final.bias"]),
        "head.W_H": _np(old["text_projection"]),
        "head.b_H": np.zeros((cfg.n_classes,), np.float32),
    }
    flat.update(_open_clip_blocks(old, cfg, "transformer.resblocks"))
    return flat


# ---------------------------------------------------------------------------
# HF CLIP text tower (the reference loads text via open_clip only; we also
# support transformers' CLIPTextModel naming for offline-local checkpoints).
# ---------------------------------------------------------------------------

def convert_hf_clip_text_weights(old: Dict[str, Any], head: Dict[str, Any],
                                 cfg: TextTransformerConfig) -> Flat:
    g = lambda k: _np(old[k])
    flat: Flat = {
        "token_embed.W_E": g("embeddings.token_embedding.weight"),
        "pos_embed.W_pos": g("embeddings.position_embedding.weight"),
        "ln_final.w": g("final_layer_norm.weight"),
        "ln_final.b": g("final_layer_norm.bias"),
        "head.W_H": _np(head["weight"]).T,
        "head.b_H": np.zeros((cfg.n_classes,), np.float32),
    }
    for l in range(cfg.n_layers):
        k = f"encoder.layers.{l}"
        _block_ln(flat, l, "ln1", old[f"{k}.layer_norm1.weight"],
                  old[f"{k}.layer_norm1.bias"])
        _block_ln(flat, l, "ln2", old[f"{k}.layer_norm2.weight"],
                  old[f"{k}.layer_norm2.bias"])
        _block_attn(flat, l,
                    old[f"{k}.self_attn.q_proj.weight"],
                    old[f"{k}.self_attn.k_proj.weight"],
                    old[f"{k}.self_attn.v_proj.weight"],
                    old[f"{k}.self_attn.out_proj.weight"],
                    old[f"{k}.self_attn.q_proj.bias"],
                    old[f"{k}.self_attn.k_proj.bias"],
                    old[f"{k}.self_attn.v_proj.bias"],
                    old[f"{k}.self_attn.out_proj.bias"], cfg)
        _block_mlp(flat, l, old[f"{k}.mlp.fc1.weight"], old[f"{k}.mlp.fc1.bias"],
                   old[f"{k}.mlp.fc2.weight"], old[f"{k}.mlp.fc2.bias"])
    return flat


# ---------------------------------------------------------------------------
# DINO / HF ViTModel (weight_conversion.py:432-519) and
# ViTForImageClassification (:805-904) — same encoder naming.
# ---------------------------------------------------------------------------

def _hf_vit_encoder_blocks(old: Dict[str, Any], cfg, layer_fmt: str) -> Flat:
    flat: Flat = {}
    for l in range(cfg.n_layers):
        k = layer_fmt.format(l=l)
        _block_ln(flat, l, "ln1", old[f"{k}.layernorm_before.weight"],
                  old[f"{k}.layernorm_before.bias"])
        _block_ln(flat, l, "ln2", old[f"{k}.layernorm_after.weight"],
                  old[f"{k}.layernorm_after.bias"])
        _block_attn(flat, l,
                    old[f"{k}.attention.attention.query.weight"],
                    old[f"{k}.attention.attention.key.weight"],
                    old[f"{k}.attention.attention.value.weight"],
                    old[f"{k}.attention.output.dense.weight"],
                    old[f"{k}.attention.attention.query.bias"],
                    old[f"{k}.attention.attention.key.bias"],
                    old[f"{k}.attention.attention.value.bias"],
                    old[f"{k}.attention.output.dense.bias"], cfg)
        _block_mlp(flat, l, old[f"{k}.intermediate.dense.weight"],
                   old[f"{k}.intermediate.dense.bias"],
                   old[f"{k}.output.dense.weight"],
                   old[f"{k}.output.dense.bias"])
    return flat


def convert_dino_weights(old: Dict[str, Any], cfg: ViTConfig) -> Flat:
    g = lambda k: _np(old[k])
    flat: Flat = {
        "cls_token": g("embeddings.cls_token"),
        "pos_embed.W_pos": g("embeddings.position_embeddings").squeeze(0),
        "embed.proj.weight": g("embeddings.patch_embeddings.projection.weight"),
        "embed.proj.bias": g("embeddings.patch_embeddings.projection.bias"),
        "ln_final.w": g("layernorm.weight"),
        "ln_final.b": g("layernorm.bias"),
        "head.W_H": np.zeros((cfg.d_model, cfg.n_classes), np.float32),
        "head.b_H": np.zeros((cfg.n_classes,), np.float32),
    }
    flat.update(_hf_vit_encoder_blocks(old, cfg, "encoder.layer.{l}"))
    return flat


def convert_hf_vit_for_image_classification_weights(old: Dict[str, Any],
                                                    cfg: ViTConfig) -> Flat:
    g = lambda k: _np(old[k])
    flat: Flat = {
        "cls_token": g("vit.embeddings.cls_token"),
        "pos_embed.W_pos": g("vit.embeddings.position_embeddings").squeeze(0),
        "embed.proj.weight": g("vit.embeddings.patch_embeddings.projection.weight"),
        "embed.proj.bias": g("vit.embeddings.patch_embeddings.projection.bias"),
        "ln_final.w": g("vit.layernorm.weight"),
        "ln_final.b": g("vit.layernorm.bias"),
        "head.W_H": g("classifier.weight").T,
        "head.b_H": g("classifier.bias"),
    }
    flat.update(_hf_vit_encoder_blocks(old, cfg, "vit.encoder.layer.{l}"))
    return flat


# ---------------------------------------------------------------------------
# ViViT (weight_conversion.py:707-804) — HF VivitModel naming (tubelet conv).
# ---------------------------------------------------------------------------

def convert_vivit_weights(old: Dict[str, Any], cfg: ViTConfig) -> Flat:
    g = lambda k: _np(old[k])
    flat: Flat = {
        "cls_token": g("vivit.embeddings.cls_token"),
        "pos_embed.W_pos": g("vivit.embeddings.position_embeddings").squeeze(0),
        "embed.proj.weight": g("vivit.embeddings.patch_embeddings.projection.weight"),
        "embed.proj.bias": g("vivit.embeddings.patch_embeddings.projection.bias"),
        "ln_final.w": g("vivit.layernorm.weight"),
        "ln_final.b": g("vivit.layernorm.bias"),
    }
    if "classifier.weight" in old:
        flat["head.W_H"] = g("classifier.weight").T
        flat["head.b_H"] = g("classifier.bias")
    flat.update(_hf_vit_encoder_blocks(old, cfg, "vivit.encoder.layer.{l}"))
    return flat


# ---------------------------------------------------------------------------
# V-JEPA (weight_conversion.py:48-145) — HF-style VJEPAModel naming; no cls
# token, tubelet embedding, weights use fused qkv per layer.
# ---------------------------------------------------------------------------

def _identity_head(cfg: ViTConfig) -> Dict[str, np.ndarray]:
    """The reference's V-JEPA converter installs an identity head
    (weight_conversion.py:141-142: ``torch.eye(d_model)``) — a pass-through
    under ``return_type='pre_logits'``.  Fall back to zeros for non-square
    head shapes (no identity exists)."""
    if cfg.n_classes == cfg.d_model:
        return {"head.W_H": np.eye(cfg.d_model, dtype=np.float32),
                "head.b_H": np.zeros((cfg.d_model,), np.float32)}
    return {"head.W_H": np.zeros((cfg.d_model, cfg.n_classes), np.float32),
            "head.b_H": np.zeros((cfg.n_classes,), np.float32)}


def convert_vjepa_weights(old: Dict[str, Any], cfg: ViTConfig) -> Flat:
    """Accepts BOTH V-JEPA export formats:

    - the reference's vendored HF-style ``VJEPAModel`` naming
      (``embeddings.patch_embeddings.proj.*``, separate per-layer
      q/k/v — weight_conversion.py:48-145), and
    - the original facebookresearch backbone naming
      (``encoder.backbone.blocks.{l}.attn.qkv.*`` with fused qkv).
    """
    g = lambda k: _np(old[k])
    if "embeddings.patch_embeddings.proj.weight" in old:
        # HF-style (the format the reference's converter consumes).
        flat: Flat = {
            "pos_embed.W_pos": g("embeddings.position_embeddings").squeeze(),
            "embed.proj.weight": g("embeddings.patch_embeddings.proj.weight"),
            "embed.proj.bias": g("embeddings.patch_embeddings.proj.bias"),
            "ln_final.w": g("layernorm.weight"),
            "ln_final.b": g("layernorm.bias"),
            **_identity_head(cfg),
        }
        for l in range(cfg.n_layers):
            k = f"encoder.layer.{l}"
            _block_ln(flat, l, "ln1", old[f"{k}.norm1.weight"],
                      old[f"{k}.norm1.bias"])
            _block_ln(flat, l, "ln2", old[f"{k}.norm2.weight"],
                      old[f"{k}.norm2.bias"])
            _block_attn(flat, l,
                        old[f"{k}.attention.query.weight"],
                        old[f"{k}.attention.key.weight"],
                        old[f"{k}.attention.value.weight"],
                        old[f"{k}.attention.proj.weight"],
                        old[f"{k}.attention.query.bias"],
                        old[f"{k}.attention.key.bias"],
                        old[f"{k}.attention.value.bias"],
                        old[f"{k}.attention.proj.bias"], cfg)
            _block_mlp(flat, l,
                       old[f"{k}.mlp.fc1.weight"], old[f"{k}.mlp.fc1.bias"],
                       old[f"{k}.mlp.fc2.weight"], old[f"{k}.mlp.fc2.bias"])
        return flat
    flat = {
        "pos_embed.W_pos": g("encoder.backbone.pos_embed").squeeze(0)
        if "encoder.backbone.pos_embed" in old else
        np.zeros((cfg.n_tokens, cfg.d_model), np.float32),
        "embed.proj.weight": g("encoder.backbone.patch_embed.proj.weight"),
        "embed.proj.bias": g("encoder.backbone.patch_embed.proj.bias"),
        "ln_final.w": g("encoder.backbone.norm.weight"),
        "ln_final.b": g("encoder.backbone.norm.bias"),
        **_identity_head(cfg),
    }
    for l in range(cfg.n_layers):
        k = f"encoder.backbone.blocks.{l}"
        _block_ln(flat, l, "ln1", old[f"{k}.norm1.weight"], old[f"{k}.norm1.bias"])
        _block_ln(flat, l, "ln2", old[f"{k}.norm2.weight"], old[f"{k}.norm2.bias"])
        qkv_w = g(f"{k}.attn.qkv.weight")
        qkv_b = g(f"{k}.attn.qkv.bias")
        W_Q, W_K, W_V = np.split(qkv_w, 3, axis=0)
        b_Q, b_K, b_V = np.split(qkv_b, 3, axis=0)
        _block_attn(flat, l, W_Q, W_K, W_V, old[f"{k}.attn.proj.weight"],
                    b_Q, b_K, b_V, old[f"{k}.attn.proj.bias"], cfg)
        _block_mlp(flat, l, old[f"{k}.mlp.fc1.weight"], old[f"{k}.mlp.fc1.bias"],
                   old[f"{k}.mlp.fc2.weight"], old[f"{k}.mlp.fc2.bias"])
    return flat


# ---------------------------------------------------------------------------
# Missing-key fill (weight_conversion.py:907-936)
# ---------------------------------------------------------------------------

def fill_missing_keys(flat: Flat, cfg: ViTConfig, reference_flat: Flat) -> Flat:
    """Fill any key present in ``reference_flat`` (a freshly-initialized
    model's flat state dict) but missing from ``flat``."""
    out = dict(flat)
    for key, val in reference_flat.items():
        if key not in out:
            out[key] = _np(val)
    return out
