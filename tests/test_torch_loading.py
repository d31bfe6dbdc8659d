"""The port's model loading against the JAX package's: every converter to the
bit on numpy state dicts drawn from a seed in each family's key layout;
the processing transforms within float32 tolerance, and the forward they
preserve; every vision name of the registry; ``stack_params`` /
``unstack_params``; ``load_hooked_model`` for each family; ``from_local`` /
``save_local``; the golden gate of ``test_full_cache_golden.py`` through
the port's own loader; and every new module imported without JAX.

Tolerances: converters and loaded weights bit for bit (both are numpy
copies and reshapes); processed weights within 1e-5 of max(1, their
absmax) (float32, summation order); forwards within 1e-4 (as
``test_torch_vit.py``); the golden digests within 2e-5 x scale, as
``test_full_cache_golden.py``."""

import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_prisma_tpu
import vit_prisma_tpu_torch
from tests import test_full_cache_golden as golden
from tests._torch_parity import assert_close, seeded, seeded_flat, seeded_models
from vit_prisma_tpu.models.loading import convert as jax_convert
from vit_prisma_tpu.models.loading import loader as jax_loader
from vit_prisma_tpu.models.loading import processing as jax_processing
from vit_prisma_tpu.models.loading import registry as jax_registry
from vit_prisma_tpu.models.loading import state_dict as jax_sd
from vit_prisma_tpu_torch.models.loading import convert as port_convert
from vit_prisma_tpu_torch.models.loading import loader as port_loader
from vit_prisma_tpu_torch.models.loading import processing as port_processing
from vit_prisma_tpu_torch.models.loading import registry as port_registry
from vit_prisma_tpu_torch.models.loading import state_dict as port_sd

ATOL = 1e-4
PROC_REL = 1e-5

# A small geometry shared by every family: 2 layers, 16 wide, 4 heads of 4,
# MLP 32, patch 4 on 8x8 images (T = 5 with the class token), 6 classes.
D, N, H, M, L, P, IMG, C = 16, 4, 4, 32, 2, 4, 8, 6
SMALL = dict(n_layers=L, d_model=D, d_head=H, n_heads=N, d_mlp=M, patch_size=P,
             image_size=IMG, n_classes=C)
VIDEO = dict(SMALL, is_video_transformer=True, video_tubelet_depth=2, video_num_frames=4)


def _draw(keys_shapes, seed):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * 0.3).astype(np.float32)
            for k, s in keys_shapes.items()}


def _layers(fmt, per_layer):
    return {fmt.format(l=l) + "." + k: s for l in range(L) for k, s in per_layer.items()}


def _hf_clip_layer():
    out = {f"layer_norm{i}.{p}": (D,) for i in (1, 2) for p in ("weight", "bias")}
    for m in ("q", "k", "v", "out"):
        out[f"self_attn.{m}_proj.weight"] = (D, D)
        out[f"self_attn.{m}_proj.bias"] = (D,)
    out.update({"mlp.fc1.weight": (M, D), "mlp.fc1.bias": (M,),
                "mlp.fc2.weight": (D, M), "mlp.fc2.bias": (D,)})
    return out


def _open_clip_layer():
    return {"ln_1.weight": (D,), "ln_1.bias": (D,), "ln_2.weight": (D,), "ln_2.bias": (D,),
            "attn.in_proj_weight": (3 * D, D), "attn.in_proj_bias": (3 * D,),
            "attn.out_proj.weight": (D, D), "attn.out_proj.bias": (D,),
            "mlp.c_fc.weight": (M, D), "mlp.c_fc.bias": (M,),
            "mlp.c_proj.weight": (D, M), "mlp.c_proj.bias": (D,)}


def _hf_vit_layer():
    out = {f"layernorm_{w}.{p}": (D,) for w in ("before", "after") for p in ("weight", "bias")}
    for m in ("query", "key", "value"):
        out[f"attention.attention.{m}.weight"] = (D, D)
        out[f"attention.attention.{m}.bias"] = (D,)
    out.update({"attention.output.dense.weight": (D, D), "attention.output.dense.bias": (D,),
                "intermediate.dense.weight": (M, D), "intermediate.dense.bias": (M,),
                "output.dense.weight": (D, M), "output.dense.bias": (D,)})
    return out


def _timm_layer():
    return {"norm1.weight": (D,), "norm1.bias": (D,), "norm2.weight": (D,), "norm2.bias": (D,),
            "attn.qkv.weight": (3 * D, D), "attn.qkv.bias": (3 * D,),
            "attn.proj.weight": (D, D), "attn.proj.bias": (D,),
            "mlp.fc1.weight": (M, D), "mlp.fc1.bias": (M,),
            "mlp.fc2.weight": (D, M), "mlp.fc2.bias": (D,)}


def _vjepa_hf_layer():
    out = {"norm1.weight": (D,), "norm1.bias": (D,), "norm2.weight": (D,), "norm2.bias": (D,),
           "attention.proj.weight": (D, D), "attention.proj.bias": (D,),
           "mlp.fc1.weight": (M, D), "mlp.fc1.bias": (M,),
           "mlp.fc2.weight": (D, M), "mlp.fc2.bias": (D,)}
    for m in ("query", "key", "value"):
        out[f"attention.{m}.weight"] = (D, D)
        out[f"attention.{m}.bias"] = (D,)
    return out


T = (IMG // P) ** 2 + 1
T_VIDEO = (IMG // P) ** 2 * 2 + 1
VOCAB, CTX = 20, 7


def _clip_vision(prefix=""):
    sd = {"embeddings.class_embedding": (D,), "embeddings.position_embedding.weight": (T, D),
          "embeddings.patch_embedding.weight": (D, 3, P, P),
          "pre_layrnorm.weight": (D,), "pre_layrnorm.bias": (D,),
          "post_layernorm.weight": (D,), "post_layernorm.bias": (D,),
          **_layers("encoder.layers.{l}", _hf_clip_layer())}
    return {prefix + k: s for k, s in sd.items()}


def _clip_text(prefix=""):
    sd = {"embeddings.token_embedding.weight": (VOCAB, D),
          "embeddings.position_embedding.weight": (CTX, D),
          "final_layer_norm.weight": (D,), "final_layer_norm.bias": (D,),
          **_layers("encoder.layers.{l}", _hf_clip_layer())}
    return {prefix + k: s for k, s in sd.items()}


# family -> (layout: key -> shape, converter call on a module, config fields)
FAMILIES = {
    "clip": ({**_clip_vision(), "head.weight": (C, D)},
             lambda m, sd, cfg: m.convert_clip_weights(
                 {k: v for k, v in sd.items() if k != "head.weight"},
                 {"weight": sd["head.weight"]}, cfg), SMALL),
    "kandinsky": ({**_clip_vision("vision_model."), "visual_projection.weight": (C, D)},
                  lambda m, sd, cfg: m.convert_kandinsky_clip_weights(sd, cfg), SMALL),
    "open_clip": ({"visual.class_embedding": (D,), "visual.positional_embedding": (T, D),
                   "visual.conv1.weight": (D, 3, P, P), "visual.ln_pre.weight": (D,),
                   "visual.ln_pre.bias": (D,), "visual.ln_post.weight": (D,),
                   "visual.ln_post.bias": (D,), "visual.proj": (D, C),
                   **_layers("visual.transformer.resblocks.{l}", _open_clip_layer())},
                  lambda m, sd, cfg: m.convert_open_clip_weights(sd, cfg), SMALL),
    "open_clip_text": ({"token_embedding.weight": (VOCAB, D), "positional_embedding": (CTX, D),
                        "ln_final.weight": (D,), "ln_final.bias": (D,),
                        "text_projection": (D, C),
                        **_layers("transformer.resblocks.{l}", _open_clip_layer())},
                       lambda m, sd, cfg: m.convert_open_clip_text_weights(sd, cfg), SMALL),
    "hf_clip_text": ({**_clip_text(), "head.weight": (C, D)},
                     lambda m, sd, cfg: m.convert_hf_clip_text_weights(
                         {k: v for k, v in sd.items() if k != "head.weight"},
                         {"weight": sd["head.weight"]}, cfg), SMALL),
    "timm": ({"cls_token": (1, 1, D), "pos_embed": (1, T, D),
              "patch_embed.proj.weight": (D, 3, P, P), "patch_embed.proj.bias": (D,),
              "norm.weight": (D,), "norm.bias": (D,), "head.weight": (C, D), "head.bias": (C,),
              **_layers("blocks.{l}", _timm_layer())},
             lambda m, sd, cfg: m.convert_timm_weights(sd, cfg), SMALL),
    "dino": ({"embeddings.cls_token": (1, 1, D), "embeddings.position_embeddings": (1, T, D),
              "embeddings.patch_embeddings.projection.weight": (D, 3, P, P),
              "embeddings.patch_embeddings.projection.bias": (D,),
              "layernorm.weight": (D,), "layernorm.bias": (D,),
              **_layers("encoder.layer.{l}", _hf_vit_layer())},
             lambda m, sd, cfg: m.convert_dino_weights(sd, cfg), SMALL),
    "hf_vit": ({"vit.embeddings.cls_token": (1, 1, D),
                "vit.embeddings.position_embeddings": (1, T, D),
                "vit.embeddings.patch_embeddings.projection.weight": (D, 3, P, P),
                "vit.embeddings.patch_embeddings.projection.bias": (D,),
                "vit.layernorm.weight": (D,), "vit.layernorm.bias": (D,),
                "classifier.weight": (C, D), "classifier.bias": (C,),
                **_layers("vit.encoder.layer.{l}", _hf_vit_layer())},
               lambda m, sd, cfg: m.convert_hf_vit_for_image_classification_weights(sd, cfg),
               SMALL),
    "vivit": ({"vivit.embeddings.cls_token": (1, 1, D),
               "vivit.embeddings.position_embeddings": (1, T_VIDEO, D),
               "vivit.embeddings.patch_embeddings.projection.weight": (D, 3, 2, P, P),
               "vivit.embeddings.patch_embeddings.projection.bias": (D,),
               "vivit.layernorm.weight": (D,), "vivit.layernorm.bias": (D,),
               "classifier.weight": (C, D), "classifier.bias": (C,),
               **_layers("vivit.encoder.layer.{l}", _hf_vit_layer())},
              lambda m, sd, cfg: m.convert_vivit_weights(sd, cfg), VIDEO),
    "vivit_headless": ({"vivit.embeddings.cls_token": (1, 1, D),
                        "vivit.embeddings.position_embeddings": (1, T_VIDEO, D),
                        "vivit.embeddings.patch_embeddings.projection.weight": (D, 3, 2, P, P),
                        "vivit.embeddings.patch_embeddings.projection.bias": (D,),
                        "vivit.layernorm.weight": (D,), "vivit.layernorm.bias": (D,),
                        **_layers("vivit.encoder.layer.{l}", _hf_vit_layer())},
                       lambda m, sd, cfg: m.convert_vivit_weights(sd, cfg), VIDEO),
    "vjepa_hf": ({"embeddings.position_embeddings": (1, T_VIDEO - 1, D),
                  "embeddings.patch_embeddings.proj.weight": (D, 3, 2, P, P),
                  "embeddings.patch_embeddings.proj.bias": (D,),
                  "layernorm.weight": (D,), "layernorm.bias": (D,),
                  **_layers("encoder.layer.{l}", _vjepa_hf_layer())},
                 lambda m, sd, cfg: m.convert_vjepa_weights(sd, cfg),
                 dict(VIDEO, use_cls_token=False, n_classes=D)),
    "vjepa_backbone": ({"encoder.backbone.pos_embed": (1, T_VIDEO - 1, D),
                        "encoder.backbone.patch_embed.proj.weight": (D, 3, 2, P, P),
                        "encoder.backbone.patch_embed.proj.bias": (D,),
                        "encoder.backbone.norm.weight": (D,), "encoder.backbone.norm.bias": (D,),
                        **_layers("encoder.backbone.blocks.{l}", _timm_layer())},
                       lambda m, sd, cfg: m.convert_vjepa_weights(sd, cfg),
                       dict(VIDEO, use_cls_token=False)),
    "vjepa_no_pos": ({"encoder.backbone.patch_embed.proj.weight": (D, 3, 2, P, P),
                      "encoder.backbone.patch_embed.proj.bias": (D,),
                      "encoder.backbone.norm.weight": (D,), "encoder.backbone.norm.bias": (D,),
                      **_layers("encoder.backbone.blocks.{l}", _timm_layer())},
                     lambda m, sd, cfg: m.convert_vjepa_weights(sd, cfg),
                     dict(VIDEO, use_cls_token=False, n_classes=D)),
}


def _configs(fields):
    return vit_prisma_tpu.ViTConfig(**fields), vit_prisma_tpu_torch.ViTConfig(**fields)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_converter_matches_jax_bitwise(family):
    layout, call, fields = FAMILIES[family]
    sd = _draw(layout, seed=sorted(FAMILIES).index(family))
    jax_cfg, port_cfg = _configs(fields)
    want = call(jax_convert, sd, jax_cfg)
    got = call(port_convert, sd, port_cfg)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k
    # tensors are taken as they come (detached, float32)
    from_tensors = call(port_convert, {k: torch.from_numpy(v) for k, v in sd.items()}, port_cfg)
    assert all(from_tensors[k].tobytes() == want[k].tobytes() for k in want)


def test_fill_missing_keys_matches_jax():
    jax_cfg, port_cfg = _configs(SMALL)
    ref = seeded_flat(SMALL, seed=3)
    partial = {k: v for i, (k, v) in enumerate(ref.items()) if i % 3}
    defaults = {k: torch.from_numpy(v + 1) for k, v in ref.items()}
    want = jax_convert.fill_missing_keys(partial, jax_cfg, defaults)
    got = port_convert.fill_missing_keys(partial, port_cfg, defaults)
    assert list(got) == list(want)
    assert all(np.asarray(got[k]).tobytes() == np.asarray(want[k]).tobytes() for k in want)


# ---------------------------------------------------------------------------
# Processing
# ---------------------------------------------------------------------------

PROC_CONFIGS = {
    "clip": dict(SMALL, activation_name="quick_gelu", layer_norm_pre=True, eps=1e-5,
                 return_type="class_logits"),
    "solu_ln": dict(SMALL, activation_name="solu_ln", return_type="class_logits"),
    "attn_only": dict(SMALL, attn_only=True, return_type="class_logits"),
}
# transform -> (call on a module, whether it keeps the forward)
TRANSFORMS = {
    "fold_layer_norm": (lambda m, sd, cfg: m.fold_layer_norm(sd, cfg), True),
    "fold_layer_norm_uncentred": (
        lambda m, sd, cfg: m.fold_layer_norm(sd, cfg, center_weights=False), True),
    # without its biases folded, the LayerNorms' biases are dropped
    "fold_layer_norm_no_biases": (
        lambda m, sd, cfg: m.fold_layer_norm(sd, cfg, fold_biases=False), False),
    "center_writing_weights": (lambda m, sd, cfg: m.center_writing_weights(sd, cfg), True),
    "fold_value_biases": (lambda m, sd, cfg: m.fold_value_biases(sd, cfg), True),
    "process_default": (lambda m, sd, cfg: m.process_state_dict(sd, cfg), True),
    "process_all": (
        lambda m, sd, cfg: m.process_state_dict(sd, cfg, refactor_factored=True), True),
}


def _proc_close(want, got, name):
    want = np.asarray(want)
    atol = PROC_REL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=atol, err_msg=name)


def _qk_ov_products(sd, l):
    """The refactoring's invariants: each head's QK form on [x, 1] and OV
    product, and the output bias."""
    W_Q = np.concatenate([np.asarray(sd[f"blocks.{l}.attn.W_Q"]),
                          np.asarray(sd[f"blocks.{l}.attn.b_Q"])[:, None]], axis=1)
    W_K = np.concatenate([np.asarray(sd[f"blocks.{l}.attn.W_K"]),
                          np.asarray(sd[f"blocks.{l}.attn.b_K"])[:, None]], axis=1)
    return {"QK": W_Q @ W_K.transpose(0, 2, 1),
            "OV": np.asarray(sd[f"blocks.{l}.attn.W_V"]) @ np.asarray(sd[f"blocks.{l}.attn.W_O"]),
            "b_O": np.asarray(sd[f"blocks.{l}.attn.b_O"]),
            "b_V": np.asarray(sd[f"blocks.{l}.attn.b_V"])}


def _forward(fields, flat, x):
    port = vit_prisma_tpu_torch.HookedViT(vit_prisma_tpu_torch.ViTConfig(**fields),
                                          device="cpu")
    port.load_state_dict(flat)
    return port(torch.from_numpy(x))


@pytest.mark.parametrize("transform", list(TRANSFORMS))
@pytest.mark.parametrize("config", list(PROC_CONFIGS))
def test_processing_matches_jax_and_keeps_the_forward(config, transform):
    fields = PROC_CONFIGS[config]
    call, keeps_forward = TRANSFORMS[transform]
    jax_cfg, port_cfg = _configs(fields)
    flat = seeded_flat(fields, seed=5)
    want = call(jax_processing, flat, jax_cfg)
    got = call(port_processing, flat, port_cfg)
    assert sorted(got) == sorted(want)
    assert all(isinstance(v, torch.Tensor) and v.dtype == torch.float32 for v in got.values())
    refactored = transform == "process_all"
    for k in want:
        if refactored and k.split(".")[-1] in ("W_Q", "W_K", "W_V", "W_O", "b_Q", "b_K"):
            continue  # the SVD's signs are the solver's: compared by products below
        _proc_close(want[k], got[k], k)
    if refactored:
        for l in range(fields["n_layers"]):
            w, g = _qk_ov_products(want, l), _qk_ov_products(got, l)
            for name in w:
                _proc_close(w[name], g[name], f"layer {l} {name}")
    x = seeded(6, (2, 3, IMG, IMG))
    if keeps_forward:
        torch.testing.assert_close(_forward(fields, got, x), _forward(fields, flat, x),
                                   rtol=0, atol=ATOL)


def test_folded_layer_norms_are_identity():
    fields = PROC_CONFIGS["clip"]
    got = port_processing.process_state_dict(seeded_flat(fields, seed=5),
                                              vit_prisma_tpu_torch.ViTConfig(**fields))
    for k in ("blocks.0.ln1", "blocks.1.ln2", "ln_final"):
        assert torch.equal(got[k + ".w"], torch.ones(D)) and torch.equal(got[k + ".b"],
                                                                         torch.zeros(D))
    assert not torch.equal(got["ln_pre.w"], torch.ones(D))  # ln_pre is not folded
    assert torch.equal(got["blocks.0.attn.b_V"], torch.zeros(N, H))


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

STRUCTURAL_NAMES = [
    "open-clip:laion/CLIP-ViT-H-14-frozen-xlm-roberta-large-laion5B-s13B-b90k",
    "open-clip:laion/CLIP-ViT-g-14-laion2B-s12B-b42K-test",
    "hf-hub:timm/vit_large_patch14_clip_336.openai",
    "open-clip:laion/CLIP-ViT-bigG-14-laion2B-39B-b160k-test",
    "open-clip:laion/CLIP-ViT-B-32-256x256-DataComp-test",
    "open-clip:timm/vit_huge_patch14_clip_224.metaclip_test",
]
ALL_VISION_NAMES = sorted(jax_registry.MODEL_CONFIGS) + STRUCTURAL_NAMES


@pytest.mark.parametrize("name", ALL_VISION_NAMES)
def test_registry_name_matches_jax(name):
    assert port_registry.get_model_config(name).to_dict() == \
        jax_registry.get_model_config(name).to_dict()
    assert port_registry.get_model_config(name, dtype="bfloat16", n_layers=1).to_dict() == \
        jax_registry.get_model_config(name, dtype="bfloat16", n_layers=1).to_dict()
    assert port_registry.categorize(name) == port_registry.ModelCategory(
        jax_registry.categorize(name).value)
    assert _outcome(port_registry.parse_open_clip_name, name) == \
        _outcome(jax_registry.parse_open_clip_name, name)


def _outcome(fn, *args):
    """``fn(*args)``, or the type and message of what it raised."""
    try:
        return fn(*args)
    except Exception as e:  # noqa: BLE001
        return type(e).__name__, str(e)


def test_registry_tables_match_jax():
    assert list(port_registry.MODEL_CONFIGS) == list(jax_registry.MODEL_CONFIGS)
    assert port_registry.MODEL_CONFIGS == jax_registry.MODEL_CONFIGS
    assert port_registry.TEXT_MODEL_CONFIGS == jax_registry.TEXT_MODEL_CONFIGS
    assert port_registry.TEXT_SUPPORTED_MODELS == jax_registry.TEXT_SUPPORTED_MODELS
    assert port_registry.PASSING_MODELS == jax_registry.PASSING_MODELS
    assert port_registry.FAILING_MODELS == jax_registry.FAILING_MODELS
    assert [c.value for c in port_registry.ModelCategory] == \
        [c.value for c in jax_registry.ModelCategory]
    assert port_registry.VIT_SIZES == jax_registry.VIT_SIZES


@pytest.mark.parametrize("name", ["open-clip:timm/vit_base_patch16_plus_clip_240.other",
                                  "open-clip:laion/CLIP-ViT-X-99", "something/else",
                                  "open-clip:timm/vit_wide_patch16_clip_224.x"])
def test_registry_errors_match_jax(name):
    with pytest.raises(Exception) as want:
        jax_registry.get_model_config(name)
    with pytest.raises(Exception) as got:
        port_registry.get_model_config(name)
    assert type(got.value) is type(want.value) and str(got.value) == str(want.value)


def test_registry_text_and_check_model_name(caplog):
    for name in ("openai/clip-vit-base-patch32", "open-clip:laion/CLIP-ViT-B-32-x"):
        got = port_registry.get_model_config(name, model_type="text")
        assert isinstance(got, vit_prisma_tpu_torch.TextTransformerConfig)
        assert got.to_dict() == jax_registry.get_model_config(name, model_type="text").to_dict()
    got = port_registry.open_clip_text_config("open-clip:laion/CLIP-ViT-B-32-x")
    assert got.to_dict() == jax_registry.open_clip_text_config(
        "open-clip:laion/CLIP-ViT-B-32-x").to_dict()
    failing = sorted(jax_registry.FAILING_MODELS)[0]
    with pytest.raises(ValueError, match="known-failing"):
        port_registry.check_model_name(failing)
    port_registry.check_model_name(failing, allow_failing=True)
    port_registry.check_model_name("open-clip:laion/CLIP-ViT-B-32-unlisted")
    assert "not on the verified-checkpoint list" in caplog.text


# ---------------------------------------------------------------------------
# stack_params / unstack_params
# ---------------------------------------------------------------------------

STACK_CONFIGS = {
    "ln": SMALL,
    "clip": PROC_CONFIGS["clip"],
    "solu_ln": PROC_CONFIGS["solu_ln"],
    "attn_only": PROC_CONFIGS["attn_only"],
    "no_norm": dict(SMALL, normalization_type=None),
    "no_cls": dict(SMALL, use_cls_token=False, classification_type="gaap"),
    "video": VIDEO,
}


@pytest.mark.parametrize("config", list(STACK_CONFIGS))
def test_stack_unstack_match_jax(config):
    fields = STACK_CONFIGS[config]
    jax_cfg, port_cfg = _configs(fields)
    flat = seeded_flat(fields, seed=4)
    want = jax_sd.stack_params(flat, jax_cfg)
    got = port_sd.stack_params(flat, port_cfg)
    want_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    got_leaves = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(got_leaves) == len(want_leaves)
    for path, w in want_leaves:
        g = got_leaves[path]
        assert isinstance(g, torch.Tensor) and g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=str(path))
    back = port_sd.unstack_params(got, port_cfg)
    want_back = jax_sd.unstack_params(want, jax_cfg)
    assert list(back) == list(want_back)
    for k in want_back:
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(want_back[k]), err_msg=k)
        np.testing.assert_array_equal(back[k].numpy(), flat[k], err_msg=k)
    # the matmul layout goes in too, numpy leaves come out as numpy
    matmul = dict(port_sd.port_state_dict(flat, port_cfg))
    again = port_sd.stack_params(matmul, port_cfg)
    assert torch.equal(again["embed"]["W"], got["embed"]["W"])
    as_numpy = port_sd.unstack_params(jax.tree.map(np.asarray, want), port_cfg)
    assert all(isinstance(v, np.ndarray) for v in as_numpy.values())
    # a headless dict gets a zero head, in the config's dtype
    headless = port_sd.stack_params({k: v for k, v in flat.items() if not k.startswith("head")},
                                    port_cfg.replace(dtype="bfloat16"))
    assert headless["head"]["W_H"].dtype == torch.bfloat16
    assert not headless["head"]["W_H"].any()


def test_reference_state_dict_is_the_jax_models():
    jax_model, port = seeded_models(PROC_CONFIGS["clip"], seed=2)
    want = jax_model.state_dict()
    got = port_sd.reference_state_dict(port)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


# ---------------------------------------------------------------------------
# load_hooked_model
# ---------------------------------------------------------------------------

CLIP_FIELDS = dict(SMALL, activation_name="quick_gelu", layer_norm_pre=True, eps=1e-5,
                   return_type="class_logits")
# case -> (model name, source layout, how the source is passed, config fields)
LOADS = {
    "clip_full": ("openai/clip-test", "clip_model", "state_dict", CLIP_FIELDS),
    "open_clip": ("open-clip:laion/CLIP-ViT-B-32-test", "open_clip", "state_dict", CLIP_FIELDS),
    "timm": ("vit_test_patch4", "timm", "state_dict", SMALL),
    "dino": ("facebook/dino-test", "dino", "state_dict", SMALL),
    "hf_vit": ("google/vit-test", "hf_vit", "state_dict", SMALL),
    "vivit": ("google/vivit-test", "vivit", "state_dict", VIDEO),
    "vivit_headless": ("google/vivit-test", "vivit_headless", "state_dict", VIDEO),
    "vjepa": ("vjepa_test", "vjepa_backbone", "state_dict", dict(VIDEO, use_cls_token=False)),
    "clip_dropped_keys": ("openai/clip-test", "clip_model", "state_dict", SMALL),
    "clip_pt": ("openai/clip-test", "clip_model", "checkpoint_pt", CLIP_FIELDS),
    "timm_bin": ("vit_test_patch4", "timm", "checkpoint_bin", SMALL),
}


def _clip_model_sd(seed):
    layout = {**_clip_vision("vision_model."), "visual_projection.weight": (C, D),
              **_clip_text("text_model."), "text_projection.weight": (C, D)}
    return _draw(layout, seed)


@pytest.mark.parametrize("case", list(LOADS))
def test_load_hooked_model_matches_jax(case, tmp_path):
    name, layout, how, fields = LOADS[case]
    sd = _clip_model_sd(11) if layout == "clip_model" else _draw(FAMILIES[layout][0], 11)
    kw = {}
    if how == "state_dict":
        kw["state_dict"] = sd
    else:
        path = str(tmp_path / ("src.pt" if how == "checkpoint_pt" else "pytorch_model.bin"))
        blob = {k: torch.from_numpy(v) for k, v in sd.items()}
        torch.save({"state_dict": blob} if how == "checkpoint_pt" else blob, path)
        kw["checkpoint_path"] = path
    jax_cfg, port_cfg = _configs(fields)
    want = jax_loader.load_hooked_model(name, cfg=jax_cfg, **kw)
    got = port_loader.load_hooked_model(name, cfg=port_cfg, device="cpu", **kw)
    assert isinstance(got, vit_prisma_tpu_torch.HookedViT) and got.cfg == port_cfg
    converted = jax_loader.convert_weights(
        jax_registry.categorize(name),
        {"clip_model_sd": sd} if layout == "clip_model" else {"sd": sd}, jax_cfg)
    want_flat, got_flat = want.state_dict(), port_sd.reference_state_dict(got)
    assert sorted(got_flat) == sorted(want_flat)
    filled = set(want_flat) - set(converted)  # each package's own initial values
    for k in want_flat:
        assert tuple(got_flat[k].shape) == tuple(np.shape(want_flat[k])), k
        if k not in filled:
            np.testing.assert_array_equal(got_flat[k].numpy(), np.asarray(want_flat[k]),
                                          err_msg=k)
    if not filled:
        x = seeded(12, (2, 3, 4, IMG, IMG) if fields.get("is_video_transformer")
                   else (2, 3, IMG, IMG))
        assert_close(want(jnp.asarray(x)), got(torch.from_numpy(x)), ATOL, "output")


@pytest.mark.parametrize("flags", [
    dict(fold_ln=True),
    dict(fold_ln=True, center_writing_weights=True, fold_value_biases=True),
    dict(fold_ln=True, center_writing_weights=True, fold_value_biases=True,
         refactor_factored_attn_matrices=True)])
def test_load_hooked_model_processing_matches_jax(flags):
    jax_cfg, port_cfg = _configs(CLIP_FIELDS)
    sd = _clip_model_sd(seed=13)
    raw = port_loader.load_hooked_model("openai/clip-test", cfg=port_cfg, state_dict=sd,
                                        device="cpu")
    want = jax_loader.load_hooked_model("openai/clip-test", cfg=jax_cfg, state_dict=sd, **flags)
    got = port_loader.load_hooked_model("openai/clip-test", cfg=port_cfg, state_dict=sd,
                                        device="cpu", **flags)
    x = seeded(14, (2, 3, IMG, IMG))
    out = got(torch.from_numpy(x))
    assert_close(want(jnp.asarray(x)), out, ATOL, "output vs JAX")
    torch.testing.assert_close(out, raw(torch.from_numpy(x)), rtol=0, atol=ATOL)
    assert torch.equal(got.blocks[0].ln1.w, torch.ones(D))


def test_load_hooked_model_bfloat16_and_errors(tmp_path, monkeypatch):
    sd = _clip_model_sd(seed=15)
    fields = dict(SMALL, activation_name="quick_gelu", layer_norm_pre=True,
                  return_type="class_logits")
    bf16 = port_loader.load_hooked_model("openai/clip-test", state_dict=sd, device="cpu",
                                         cfg=vit_prisma_tpu_torch.ViTConfig(**fields,
                                                                            dtype="bfloat16"))
    assert bf16.W_Q.dtype == torch.bfloat16
    # a registry name resolves the config, with overrides and dtype
    reg = port_loader.load_hooked_model(
        "openai/clip-vit-base-patch32", state_dict=sd, device="cpu", dtype="bfloat16",
        n_layers=L, d_model=D, n_heads=N, d_head=H, d_mlp=M, patch_size=P, image_size=IMG,
        n_classes=C)
    assert reg.cfg == port_registry.get_model_config(
        "openai/clip-vit-base-patch32", dtype="bfloat16", n_layers=L, d_model=D, n_heads=N,
        d_head=H, d_mlp=M, patch_size=P, image_size=IMG, n_classes=C)
    assert reg.cfg.eps == 1e-6 and reg.W_in.dtype == torch.bfloat16
    # the text tower from the same CLIPModel state dict, in bfloat16
    text_fields = dict(n_layers=L, d_model=D, d_head=H, n_heads=N, d_mlp=M, n_classes=C,
                       vocab_size=VOCAB, context_length=CTX, activation_name="quick_gelu",
                       eps=1e-5, return_type="class_logits", dtype="bfloat16")
    text = port_loader.load_hooked_model(
        "openai/clip-test", model_type="text", state_dict=sd, device="cpu",
        cfg=vit_prisma_tpu_torch.TextTransformerConfig(**text_fields))
    want_text = jax_loader.load_hooked_model(
        "openai/clip-test", model_type="text", state_dict=sd,
        cfg=vit_prisma_tpu.TextTransformerConfig(**text_fields))
    assert isinstance(text, vit_prisma_tpu_torch.HookedTextTransformer)
    assert text.W_Q.dtype == torch.bfloat16
    from vit_prisma_tpu.models.text import unstack_text_params
    want_flat = unstack_text_params(want_text.params, want_text.cfg)
    got_flat = port_sd.reference_state_dict(text)
    assert sorted(got_flat) == sorted(want_flat)
    for k, v in got_flat.items():  # bf16 copies of the same float32 weights
        want_v = np.asarray(want_flat[k]).astype(np.float32)
        assert torch.equal(v.float(), torch.from_numpy(want_v)), k
    # safetensors: read through the package, or a clear error without it
    safetensors = pytest.importorskip("safetensors.numpy")
    path = str(tmp_path / "src.safetensors")
    safetensors.save_file(sd, path)
    got = port_loader.load_hooked_model("openai/clip-test", checkpoint_path=path, device="cpu",
                                        cfg=vit_prisma_tpu_torch.ViTConfig(**fields))
    want = port_loader.load_hooked_model("openai/clip-test", state_dict=sd, device="cpu",
                                         cfg=vit_prisma_tpu_torch.ViTConfig(**fields))
    assert all(torch.equal(a, b) for a, b in zip(got.state_dict().values(),
                                                 want.state_dict().values()))
    monkeypatch.setitem(sys.modules, "safetensors.numpy", None)
    with pytest.raises(ImportError, match="safetensors package"):
        port_loader._load_checkpoint(path)


def test_fetch_from_hub_names_the_offline_arguments(monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(RuntimeError, match="state_dict="):
        port_loader._fetch_from_hub("openai/clip-test", port_registry.ModelCategory.CLIP)


def test_from_pretrained_is_load_hooked_model():
    sd = _clip_model_sd(seed=16)
    cfg = vit_prisma_tpu_torch.ViTConfig(**dict(SMALL, layer_norm_pre=True,
                                                return_type="class_logits"))
    a = vit_prisma_tpu_torch.HookedViT.from_pretrained("openai/clip-test", cfg=cfg,
                                                       state_dict=sd, device="cpu")
    b = vit_prisma_tpu_torch.load_hooked_model("openai/clip-test", cfg=cfg, state_dict=sd,
                                               device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))


# ---------------------------------------------------------------------------
# from_local / save_local
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_save_local_from_local_round_trip(tmp_path, dtype):
    fields = dict(PROC_CONFIGS["clip"], dtype=dtype)
    _, port = seeded_models(PROC_CONFIGS["clip"], seed=17)
    if dtype == "bfloat16":
        port = port.to(torch.bfloat16)
        port.cfg = vit_prisma_tpu_torch.ViTConfig(**fields)
    port.save_local(str(tmp_path / "m"))
    back = vit_prisma_tpu_torch.HookedViT.from_local(port.cfg, str(tmp_path / "m.npz"),
                                                     device="cpu")
    for (k, a), (k2, b) in zip(port.state_dict().items(), back.state_dict().items()):
        assert k == k2 and a.dtype == b.dtype and torch.equal(a, b), k


def test_local_files_cross_load_with_jax(tmp_path):
    fields = PROC_CONFIGS["clip"]
    jax_model, port = seeded_models(fields, seed=18)
    jax_cfg, port_cfg = _configs(fields)
    port.save_local(str(tmp_path / "port.npz"))
    jax_back = vit_prisma_tpu.HookedViT.from_local(jax_cfg, str(tmp_path / "port.npz"))
    jax_model.save_local(str(tmp_path / "jax"))
    port_back = vit_prisma_tpu_torch.HookedViT.from_local(port_cfg, str(tmp_path / "jax.npz"),
                                                          device="cpu")
    want = jax_model.state_dict()
    for k, v in jax_back.state_dict().items():
        np.testing.assert_array_equal(np.asarray(v), np.asarray(want[k]), err_msg=k)
    for k, v in port_back.state_dict().items():
        assert torch.equal(v, port.state_dict()[k]), k
    # a torch file of the flat dict
    torch.save(port_sd.reference_state_dict(port), str(tmp_path / "flat.pt"))
    pt = vit_prisma_tpu_torch.HookedViT.from_local(port_cfg, str(tmp_path / "flat.pt"),
                                                   device="cpu")
    assert all(torch.equal(v, port.state_dict()[k]) for k, v in pt.state_dict().items())


def test_from_local_reads_the_trainers_checkpoint(tmp_path):
    from vit_prisma_tpu_torch.training.trainer import TrainState, save_checkpoint
    fields = PROC_CONFIGS["clip"]
    _, port = seeded_models(fields, seed=19)
    opt = torch.optim.SGD(port.parameters(), lr=0.1)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 1.0)
    path = str(tmp_path / "run" / "model.ckpt")
    save_checkpoint(path, TrainState(port, opt, sched, 3), epoch=1)
    back = vit_prisma_tpu_torch.HookedViT.from_local(port.cfg, path, device="cpu")
    assert all(torch.equal(v, port.state_dict()[k]) for k, v in back.state_dict().items())
    with open(path, "rb") as f:
        assert pickle.load(f)["step"] == 3


# ---------------------------------------------------------------------------
# The golden gate, through the port's own loader
# ---------------------------------------------------------------------------

def test_full_cache_golden_through_the_ports_loader():
    src = np.load(golden.SRC_NPZ)
    cfg = vit_prisma_tpu_torch.ViTConfig(**golden.CFG)
    model = vit_prisma_tpu_torch.load_hooked_model(
        "openai/clip-test", cfg=cfg, state_dict={k: src[k] for k in src.files}, device="cpu")
    with open(golden.GOLDEN) as f:
        want = json.load(f)
    flat = {k: v.numpy() for k, v in port_sd.reference_state_dict(model).items()}
    assert golden._flat_sha(flat) == want["converted_sha256"]
    out, cache = model.run_with_cache(torch.from_numpy(golden._input_image()))
    assert isinstance(cache, vit_prisma_tpu_torch.ActivationCache)
    np.testing.assert_allclose(np.asarray(out, np.float64)[0, :8], want["out_head"], atol=2e-5)
    assert set(cache) == set(want["cache"])
    for name, g in want["cache"].items():
        r = golden._entry_stats(cache[name].numpy())
        assert r["shape"] == g["shape"], name
        scale = max(abs(g["absmax"]), 1.0)
        for field in ("mean", "std", "absmax"):
            assert abs(r[field] - g[field]) <= 2e-5 * scale, f"{name}.{field}"
        np.testing.assert_allclose(r["picks"], g["picks"], atol=2e-5 * scale, err_msg=name)


# ---------------------------------------------------------------------------
# No JAX in the new modules
# ---------------------------------------------------------------------------

def test_analysis_and_loading_modules_import_without_jax():
    """Every module of the analysis surface and of loading imports with jax
    made unimportable, and pulls in nothing of JAX or the JAX package."""
    code = ("import sys; sys.modules['jax'] = None; "
            "import vit_prisma_tpu_torch.prisma.cache, "
            "vit_prisma_tpu_torch.prisma.factored_matrix, "
            "vit_prisma_tpu_torch.prisma.logit_lens, vit_prisma_tpu_torch.utils.prisma_utils, "
            "vit_prisma_tpu_torch.dataloaders.imagenet_names, "
            "vit_prisma_tpu_torch.models.loading.state_dict, "
            "vit_prisma_tpu_torch.models.loading.convert, "
            "vit_prisma_tpu_torch.models.loading.processing, "
            "vit_prisma_tpu_torch.models.loading.registry, "
            "vit_prisma_tpu_torch.models.loading.loader; "
            "from vit_prisma_tpu_torch import (ActivationCache, FactoredMatrix, "
            "load_hooked_model, test_prompt); "
            "from vit_prisma_tpu_torch.dataloaders.imagenet_names import load_imagenet_dict; "
            "assert len(load_imagenet_dict()) == 1000; "
            "bad = sorted(m for m, mod in sys.modules.items() if mod is not None and "
            "(m.startswith(('jax', 'vit_prisma_tpu.')) or m == 'vit_prisma_tpu')); "
            "assert not bad, bad")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=root)
