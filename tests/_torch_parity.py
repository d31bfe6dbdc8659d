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
    """The port's HookedViT with the JAX model's weights."""
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
