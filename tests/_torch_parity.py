"""Shared helpers for the PyTorch port's parity tests (``test_torch_*.py``):
the same numpy inputs and weights go through the JAX package and the port.

Not collected by pytest (no ``test_`` prefix)."""

import jax
import numpy as np
import torch

import vit_prisma_tpu
import vit_prisma_tpu_torch
from vit_prisma_tpu_torch.models.loading.state_dict import params_from_jax

# The suite runs under several xdist workers; keep each one's torch small.
torch.set_num_threads(2)


def seeded(seed, shape, scale=1.0, dtype=np.float32):
    """A seeded standard-normal numpy array, scaled."""
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(dtype)


def jax_and_port(seed=0, **cfg_fields):
    """A JAX HookedViT with random weights and the port's HookedViT holding
    the same weights, for one config dict."""
    jax_model = vit_prisma_tpu.HookedViT(vit_prisma_tpu.ViTConfig(**cfg_fields),
                                         key=jax.random.PRNGKey(seed))
    port = port_from_jax(jax_model)
    return jax_model, port


def port_from_jax(jax_model):
    """The port's HookedViT, or HookedTextTransformer for a JAX text tower,
    with the JAX model's weights."""
    if isinstance(jax_model, vit_prisma_tpu.HookedTextTransformer):
        cfg = vit_prisma_tpu_torch.TextTransformerConfig.from_dict(jax_model.cfg.to_dict())
        port = vit_prisma_tpu_torch.HookedTextTransformer(cfg, device="cpu")
    else:
        cfg = vit_prisma_tpu_torch.ViTConfig.from_dict(jax_model.cfg.to_dict())
        port = vit_prisma_tpu_torch.HookedViT(cfg, device="cpu")
    port.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jax_model.params)))
    return port


def assert_close(jax_value, port_value, atol, name=""):
    np.testing.assert_allclose(np.asarray(port_value.float()),
                               np.asarray(jax_value, np.float32),
                               rtol=0, atol=atol, err_msg=name)


def assert_caches_close(jax_cache, port_cache, atol):
    """Same keys in the same order, each entry within ``atol``."""
    assert list(port_cache) == list(jax_cache)
    for name in jax_cache:
        assert tuple(port_cache[name].shape) == tuple(jax_cache[name].shape), name
        assert_close(jax_cache[name], port_cache[name], atol, name)


def seeded_flat(fields, seed=0):
    """A flat reference-named state dict (numpy float32) for the config
    ``fields`` with every parameter drawn from ``seed``: LayerNorm weights
    near 1, biases and embeddings of scale 0.1-0.5, matrices scaled by
    1/sqrt(fan in); so no bias is zero and no LayerNorm is the identity."""
    from vit_prisma_tpu.models.loading.state_dict import unstack_params
    cfg = vit_prisma_tpu.ViTConfig(**fields)
    shapes = {k: np.shape(v) for k, v in
              unstack_params(vit_prisma_tpu.init_vit_params(cfg, jax.random.PRNGKey(0)),
                             cfg).items()}
    rng = np.random.default_rng(seed)
    flat = {}
    for k, shape in sorted(shapes.items()):
        z = rng.standard_normal(shape)
        leaf = k.rsplit(".", 1)[-1]
        if leaf == "w":  # a LayerNorm weight
            z = 1.0 + 0.1 * z
        elif leaf in ("b", "b_Q", "b_K", "b_V", "b_O", "b_in", "b_out", "b_H", "bias"):
            z = 0.1 * z
        elif k in ("cls_token", "pos_embed.W_pos"):
            z = 0.5 * z
        elif k == "embed.proj.weight":
            z = z / np.sqrt(np.prod(shape[1:]))
        else:  # [.., fan_in, fan_out]
            z = z / np.sqrt(shape[-2])
        flat[k] = z.astype(np.float32)
    return flat


def seeded_models(fields, seed=0):
    """The JAX package's HookedViT and the port's (on the CPU) holding the
    same :func:`seeded_flat` weights."""
    from vit_prisma_tpu.models.loading.state_dict import stack_params
    flat = seeded_flat(fields, seed)
    jax_model = vit_prisma_tpu.HookedViT(
        vit_prisma_tpu.ViTConfig(**fields),
        params=stack_params(flat, vit_prisma_tpu.ViTConfig(**fields)))
    port = vit_prisma_tpu_torch.HookedViT(vit_prisma_tpu_torch.ViTConfig(**fields), device="cpu")
    port.load_state_dict(flat)
    return jax_model, port
