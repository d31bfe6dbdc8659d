"""The port's HookedViT against the JAX package's, hook by hook, in float32
with the same numpy inputs and weights (per-hook atol 1e-4)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_prisma_tpu
import vit_prisma_tpu_torch
from tests import test_full_cache_golden as golden
from tests._torch_parity import (assert_caches_close, assert_close,
                                 jax_and_port, port_from_jax, seeded)
from vit_prisma_tpu.models.loading.loader import load_hooked_model
from vit_prisma_tpu.models.loading.registry import get_model_config as jax_get_config
from vit_prisma_tpu_torch.ops.attention import attention_mix_tnh

ATOL = 1e-4
BASE = dict(n_layers=2, d_model=32, d_head=8, n_heads=4, d_mlp=64,
            patch_size=8, image_size=16, n_classes=7, return_type="logits")
VARIANTS = {
    "LN": {},
    "LNPre": dict(normalization_type="LNPre"),
    "no_norm": dict(normalization_type=None),
    "bert_block": dict(use_bert_block=True),
    "solu_ln": dict(activation_name="solu_ln"),
    "attn_only": dict(attn_only=True),
    "gaap": dict(classification_type="gaap"),
    "no_cls": dict(use_cls_token=False),
    "attn_result": dict(use_attn_result=True),
    "split_qkv": dict(use_split_qkv_input=True),
    "hook_mlp_in": dict(use_hook_mlp_in=True),
    "fused_qkv": dict(fused_qkv=True),
}


def _images(n=2, size=16, seed=1):
    return seeded(seed, (n, 3, size, size))


def _resid_post(name):
    return "resid_post" in name


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_hook_names_match_jax(variant):
    fields = {**BASE, **VARIANTS[variant]}
    assert (vit_prisma_tpu_torch.hook_names(vit_prisma_tpu_torch.ViTConfig(**fields))
            == vit_prisma_tpu.hook_names(vit_prisma_tpu.ViTConfig(**fields)))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_full_cache_matches_jax(variant):
    jax_model, port = jax_and_port(**BASE, **VARIANTS[variant])
    x = _images()
    want_out, want = jax_model.run_with_cache(jnp.asarray(x), return_cache_object=False)
    got_out, got = port.run_with_cache(torch.from_numpy(x))
    assert list(got) == vit_prisma_tpu_torch.hook_names(port.cfg)
    assert_caches_close(want, got, ATOL)
    assert_close(want_out, got_out, ATOL, "output")


@pytest.mark.parametrize("variant", ["LN", "LNPre"])
def test_resid_post_cache_takes_kernel_path_and_matches_jax(variant):
    # No attention-internal hook is requested, so both sides take the fused
    # mix: JAX's Pallas kernel in interpret mode, the port's plain version.
    jax_model, port = jax_and_port(**BASE, **VARIANTS[variant], layer_norm_pre=True)
    x = _images()
    want_out, want = jax_model.run_with_cache(
        jnp.asarray(x), names_filter=_resid_post, return_cache_object=False)
    before = attention_mix_tnh.launches
    got_out, got = port.run_with_cache(torch.from_numpy(x), names_filter=_resid_post)
    assert attention_mix_tnh.launches == before  # CPU: no kernel launch
    assert list(got) == [f"blocks.{l}.hook_resid_post" for l in range(2)]
    assert_caches_close(want, got, ATOL)
    assert_close(want_out, got_out, ATOL, "output")
    assert_close(jax_model(jnp.asarray(x)), port(torch.from_numpy(x)), ATOL, "forward")


@pytest.mark.parametrize("stop_at_layer", [1, -1])
def test_stop_at_layer_matches_jax(stop_at_layer):
    jax_model, port = jax_and_port(**{**BASE, "n_layers": 3})
    x = _images()
    want_out, want = jax_model.run_with_cache(
        jnp.asarray(x), stop_at_layer=stop_at_layer, return_cache_object=False)
    got_out, got = port.run_with_cache(torch.from_numpy(x), stop_at_layer=stop_at_layer)
    assert_caches_close(want, got, ATOL)
    assert_close(want_out, got_out, ATOL, "residual")
    assert not any(k.startswith("blocks.2.") or k.startswith("ln_final") for k in got)


def test_run_with_hooks_pattern_ablation_matches_jax():
    jax_model, port = jax_and_port(**BASE)
    x = _images()
    name = vit_prisma_tpu_torch.get_act_name("pattern", 1)
    assert name == vit_prisma_tpu.get_act_name("pattern", 1) == "blocks.1.attn.hook_pattern"

    def ablate_port(v, hook):
        v = v.clone()
        v[:, 3] = 0.0
        return v

    want = jax_model.run_with_hooks(
        jnp.asarray(x), fwd_hooks=[(name, lambda v, hook: v.at[:, 3].set(0.0))])
    got = port.run_with_hooks(torch.from_numpy(x), fwd_hooks=[(name, ablate_port)])
    assert_close(want, got, ATOL, "ablated output")
    assert (got - port(torch.from_numpy(x))).abs().max() > 1e-3


def test_full_width_b32_layer_matches_jax():
    cfg = jax_get_config("openai/clip-vit-base-patch32", n_layers=1)
    jax_model = vit_prisma_tpu.HookedViT(cfg, key=jax.random.PRNGKey(0))
    port = port_from_jax(jax_model)
    x = _images(size=224)
    for names in (None, _resid_post):
        want_out, want = jax_model.run_with_cache(
            jnp.asarray(x), names_filter=names, return_cache_object=False)
        got_out, got = port.run_with_cache(torch.from_numpy(x), names_filter=names)
        assert got["blocks.0.hook_resid_post"].shape == (2, 50, 768)
        assert_caches_close(want, got, ATOL)
        assert_close(want_out, got_out, ATOL, "output")


def test_registry_config_matches_jax():
    name = "openai/clip-vit-base-patch32"
    port_cfg = vit_prisma_tpu_torch.get_model_config(name)
    assert port_cfg.to_dict() == jax_get_config(name).to_dict()
    with pytest.raises(NotImplementedError, match="item 4"):
        vit_prisma_tpu_torch.get_model_config("openai/clip-vit-base-patch16")


def test_full_cache_golden_through_jax_converter():
    src = np.load(golden.SRC_NPZ)
    cfg = vit_prisma_tpu.ViTConfig(**golden.CFG)
    jax_model = load_hooked_model("openai/clip-test", cfg=cfg,
                                  state_dict={k: src[k] for k in src.files})
    port = port_from_jax(jax_model)
    out, cache = port.run_with_cache(torch.from_numpy(golden._input_image()))
    with open(golden.GOLDEN) as f:
        want = json.load(f)
    np.testing.assert_allclose(np.asarray(out, np.float64)[0, :8],
                               want["out_head"], atol=2e-5)
    assert set(cache) == set(want["cache"])
    for name, g in want["cache"].items():
        r = golden._entry_stats(cache[name].numpy())
        assert r["shape"] == g["shape"], name
        scale = max(abs(g["absmax"]), 1.0)
        for field in ("mean", "std", "absmax"):
            assert abs(r[field] - g[field]) <= 2e-5 * scale, f"{name}.{field}"
        np.testing.assert_allclose(r["picks"], g["picks"], atol=2e-5 * scale,
                                   err_msg=name)
