"""The port's video towers (tubelet embedding, ViViT and V-JEPA configs)
against the JAX package's, with the same numpy inputs and weights.

Tolerances: the tubelet patchify is a relayout, so exact; the tubelet
embedding (one float32 matmul) within 1e-5; model activations within 1e-4
per hook, as ``test_torch_vit.py``.  Both attention routes run: a short clip
takes the whole-T mix (B1's plain version here), a long one is past both
packages' whole-T gates and takes the flash route (B13's plain version)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import vit_prisma_tpu
import vit_prisma_tpu_torch
from tests._torch_parity import assert_caches_close, assert_close, jax_and_port, seeded
from tests.test_torch_flash import _spy_routes
from vit_prisma_tpu.models import layers as jax_layers
from vit_prisma_tpu.models.loading.registry import get_model_config as jax_get_config
from vit_prisma_tpu.ops import attention as jax_ops
from vit_prisma_tpu_torch.models import layers as port_layers
from vit_prisma_tpu_torch.models.loading.state_dict import port_state_dict
from vit_prisma_tpu_torch.ops import attention as port_ops

ACT_ATOL = 1e-4
EMBED_ATOL = 1e-5
VIDEO_MODELS = ("google/vivit-b-16x2-kinetics400", "google/vivit-l-16x2-kinetics400",
                "vjepa_v1_vit_huge")
# 4 frames in tubelets of 2 at 16 px, patch 8: T = 2 * 4 + 1 = 9 (whole-T mix)
SHORT = dict(n_layers=2, d_model=32, d_head=8, n_heads=4, d_mlp=64, patch_size=8,
             image_size=16, n_classes=7, activation_name="gelu_fast",
             is_video_transformer=True, video_tubelet_depth=2, video_num_frames=4,
             return_type="logits")
# V-JEPA's shape of output: no class token, pooled, pre-logits
NO_CLS = dict(SHORT, use_cls_token=False, classification_type="gaap",
              return_type="pre_logits", activation_name="gelu")
# 26 frames in tubelets of 2 at 32 px, patch 4: T = 13 * 64 + 1 = 833 at
# H = 32, past both packages' whole-T gates, so both take the flash route
LONG = dict(n_layers=2, d_model=128, d_head=32, n_heads=4, d_mlp=256, patch_size=4,
            image_size=32, n_classes=10, activation_name="gelu_fast",
            is_video_transformer=True, video_tubelet_depth=2, video_num_frames=26,
            return_type="logits")


def _clip(cfg_fields, n=2, seed=1):
    c = cfg_fields
    return seeded(seed, (n, 3, c["video_num_frames"], c["image_size"], c["image_size"]))


@pytest.mark.parametrize("fields", [SHORT, LONG], ids=["short", "long"])
def test_tubelet_patchify_equals_jax(fields):
    cfg = vit_prisma_tpu_torch.ViTConfig(**fields)
    x = _clip(fields)
    want = np.asarray(jax_layers.tubelet_patchify(vit_prisma_tpu.ViTConfig(**fields),
                                                  jnp.asarray(x)))
    got = port_layers.tubelet_patchify(cfg, torch.from_numpy(x)).numpy()
    P, D = cfg.patch_size, cfg.video_tubelet_depth
    assert got.shape == (2, cfg.n_image_patches, 3 * D * P * P)
    np.testing.assert_array_equal(got, want)


def test_tubelet_embedding_matches_jax():
    jax_model, port = jax_and_port(**SHORT)
    x = _clip(SHORT)
    want = jax_layers.tubelet_embedding(jax_model.params["embed"], jax_model.cfg,
                                        jnp.asarray(x))
    with torch.no_grad():
        got = port_layers.tubelet_embedding(port.embed, port.cfg, torch.from_numpy(x))
    assert tuple(port.embed.W.shape) == (3 * 2 * 8 * 8, 32)
    assert tuple(got.shape) == (2, 8, 32)
    assert_close(want, got, EMBED_ATOL, "tubelet embedding")


def test_conv3d_weight_converts_in_tubelet_order():
    """A Conv3d ``[d_model, C, D, P, P]`` kernel through ``port_state_dict``
    gives the ``embed.W`` whose product with the tubelets is the stride =
    kernel convolution, and JAX's tubelet patchify on the same clip agrees."""
    cfg = vit_prisma_tpu_torch.ViTConfig(**SHORT)
    rng = np.random.default_rng(5)
    # at the init's scale (kaiming over the 384 inputs), so outputs are O(1)
    weight = (rng.standard_normal((32, 3, 2, 8, 8)) * np.sqrt(2 / 384)).astype(np.float32)
    bias = rng.standard_normal(32).astype(np.float32)
    _, port = jax_and_port(**SHORT)
    flat = {k: v.numpy() for k, v in port.state_dict().items()
            if not k.startswith("embed.")}
    flat.update({"embed.proj.weight": weight, "embed.proj.bias": bias})
    port.load_state_dict(flat)
    assert tuple(port_state_dict(flat, cfg)["embed.W"].shape) == (384, 32)
    x = _clip(SHORT)
    conv = F.conv3d(torch.from_numpy(x), torch.from_numpy(weight), torch.from_numpy(bias),
                    stride=(2, 8, 8))  # [B, d, T/D, H/P, W/P]
    conv = conv.flatten(2).transpose(1, 2)
    with torch.no_grad():
        got = port_layers.tubelet_embedding(port.embed, cfg, torch.from_numpy(x))
    torch.testing.assert_close(got, conv, rtol=0, atol=EMBED_ATOL)
    jax_patches = np.asarray(jax_layers.tubelet_patchify(vit_prisma_tpu.ViTConfig(**SHORT),
                                                         jnp.asarray(x)))
    want = jax_patches @ weight.reshape(32, -1).T + bias
    assert_close(want, got, EMBED_ATOL, "against JAX's patchify")


@pytest.mark.parametrize("name", VIDEO_MODELS)
def test_video_registry_matches_jax(name):
    port_cfg = vit_prisma_tpu_torch.get_model_config(name)
    assert port_cfg.to_dict() == jax_get_config(name).to_dict()
    assert port_cfg.is_video_transformer


def test_video_registry_token_counts():
    get = vit_prisma_tpu_torch.get_model_config
    vivit, vjepa = get(VIDEO_MODELS[0]), get(VIDEO_MODELS[2])
    assert (vivit.n_tokens, vivit.d_head) == (16 * 196 + 1, 64)
    assert (vjepa.n_tokens, vjepa.d_head, vjepa.use_cls_token) == (8 * 196, 80, False)
    # both are past B1's gate, and the flash kernels take their padded T
    for c in (vivit, vjepa):
        assert not port_ops.mix_tnh_fits_smem(c.n_tokens, c.d_head)
        assert port_ops.flash_fits(-(-c.n_tokens // 128) * 128, c.d_head)


@pytest.mark.parametrize("fields,route", [
    (SHORT, "_fused_attention"), (NO_CLS, "_fused_attention"),
    (LONG, "_flash_attention_long")], ids=["short", "no_cls", "long"])
def test_video_forward_matches_jax_per_hook(monkeypatch, fields, route):
    jax_model, port = jax_and_port(**fields)
    cfg = port.cfg
    T = cfg.n_tokens
    fits = port_ops.mix_tnh_fits_smem(T, cfg.d_head)
    assert fits == jax_ops.mix_tnh_fits_vmem(T, cfg.n_heads * cfg.d_head, 4)
    assert fits == (route == "_fused_attention")
    routes = _spy_routes(monkeypatch)
    x = _clip(fields)
    names = lambda n: n.endswith("hook_resid_post") or n in ("hook_embed", "hook_full_embed")
    want_out, want = jax_model.run_with_cache(jnp.asarray(x), names_filter=names,
                                              return_cache_object=False)
    got_out, got = port.run_with_cache(torch.from_numpy(x), names_filter=names)
    assert routes == [route] * cfg.n_layers
    assert tuple(got["hook_full_embed"].shape) == (2, T, cfg.d_model)
    assert_caches_close(want, got, ACT_ATOL)
    assert_close(want_out, got_out, ACT_ATOL, "output")


@pytest.mark.parametrize("fields", [SHORT, NO_CLS], ids=["short", "no_cls"])
def test_video_full_cache_matches_jax(fields):
    """Every hook (the attention internals among them, so the einsum path)."""
    jax_model, port = jax_and_port(**fields)
    x = _clip(fields)
    want_out, want = jax_model.run_with_cache(jnp.asarray(x), return_cache_object=False)
    got_out, got = port.run_with_cache(torch.from_numpy(x))
    assert list(got) == vit_prisma_tpu_torch.hook_names(port.cfg)
    assert_caches_close(want, got, ACT_ATOL)
    assert_close(want_out, got_out, ACT_ATOL, "output")


def test_video_model_init_shapes():
    port = vit_prisma_tpu_torch.HookedViT(vit_prisma_tpu_torch.ViTConfig(**LONG),
                                          device="cpu")
    assert tuple(port.embed.W.shape) == (3 * 2 * 4 * 4, 128)
    assert tuple(port.pos_embed.W_pos.shape) == (833, 128)
    jax_params = jax.tree.map(
        np.shape, vit_prisma_tpu.HookedViT(vit_prisma_tpu.ViTConfig(**LONG),
                                           key=jax.random.PRNGKey(0)).params)
    assert jax_params["embed"]["W"] == tuple(port.embed.W.shape)


def test_video_serving_and_checkpoint_modules_import_without_jax():
    """The video, serving and checkpoint modules import with jax made
    unimportable."""
    code = ("import sys; sys.modules['jax'] = None; "
            "import vit_prisma_tpu_torch.models.vit, vit_prisma_tpu_torch.serving, "
            "vit_prisma_tpu_torch.sae.train, vit_prisma_tpu_torch.sae.sae, "
            "vit_prisma_tpu_torch.utils.saving_utils, "
            "vit_prisma_tpu_torch.models.loading.registry; "
            "bad = sorted(m for m, mod in sys.modules.items() if mod is not None and "
            "(m.startswith(('jax', 'vit_prisma_tpu.')) or m == 'vit_prisma_tpu')); "
            "assert not bad, bad")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=root)
