"""The port's entry points build on the CUDA card unless the caller asks for
another device: ``device=None`` resolves to the card, and on a host without
one every entry point raises instead of building on the CPU."""

import numpy as np
import pytest
import torch

import vit_prisma_tpu_torch
import vit_prisma_tpu_torch.sae as port_sae
from vit_prisma_tpu_torch.utils.device import resolve_device

SAE = dict(d_in=32, expansion_factor=4, train_batch_size=64, context_size=5,
           model_name="custom", hook_point_layer=1)
VIT = dict(n_layers=1, d_model=32, d_head=8, n_heads=4, d_mlp=64, patch_size=8,
           image_size=16, n_classes=7)


def test_none_resolves_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device(None) == torch.device("cuda", 0)
    assert resolve_device("cpu") == torch.device("cpu")


def _entry_points():
    cfg = port_sae.SAERunnerConfig(**SAE)
    params = {k: np.zeros((2, 2), np.float32) for k in ("W_enc", "W_dec", "b_enc", "b_dec")}
    return {
        "HookedViT": lambda **d: vit_prisma_tpu_torch.HookedViT(
            vit_prisma_tpu_torch.ViTConfig(**VIT), **d),
        "HookedSAEViT": lambda **d: vit_prisma_tpu_torch.HookedSAEViT(
            vit_prisma_tpu_torch.ViTConfig(**VIT), **d),
        "init_sae_params": lambda **d: port_sae.init_sae_params(cfg, **d),
        "SparseAutoencoder": lambda **d: port_sae.SparseAutoencoder(cfg, **d),
        "init_train_state": lambda **d: port_sae.init_train_state(cfg, **d),
        "init_sweep_state": lambda **d: port_sae.init_sweep_state(
            cfg.replace(sweep_layers=(0, 1)), 2, **d),
        "VisionSAETrainer": lambda **d: port_sae.VisionSAETrainer(cfg, **d),
        "SAESweepTrainer": lambda **d: port_sae.SAESweepTrainer(
            cfg.replace(sweep_layers=(0, 1)), **d),
        "sae_params_from_jax": lambda **d: port_sae.sae_params_from_jax(params, **d),
    }


@pytest.mark.parametrize("name", list(_entry_points()))
def test_entry_points_default_to_the_card(name, monkeypatch):
    build = _entry_points()[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        build()
    built = build(device="cpu")  # the CPU only when asked for
    tensors = (list(built.parameters()) if isinstance(built, torch.nn.Module)
               else list(built.values()) if isinstance(built, dict)
               else list(built.state.params.values()) if hasattr(built, "state")
               else list(built.params.values()))
    assert tensors and all(t.device.type == "cpu" for t in tensors)


def test_train_state_from_jax_defaults_to_the_card(monkeypatch):
    import jax
    import vit_prisma_tpu.sae as jax_sae
    jc = jax_sae.SAERunnerConfig(**SAE)
    np_state = jax.tree.map(np.asarray, jax_sae.init_train_state(jc, key=jax.random.PRNGKey(0)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        port_sae.train_state_from_jax(np_state)
    state = port_sae.train_state_from_jax(np_state, device="cpu")
    assert state.params["W_enc"].device.type == "cpu" and state.step.device.type == "cpu"
