"""The port's HookedSAEViT against the JAX package's: spliced
``run_with_cache(incl_bwd=True)`` for ReLU and TopK SAEs, with and without
the error term, per key in float32; the clean forward under the error term;
attachment and reset; and demo 07's SAE-feature attribution at a small size.
The same numpy weights and inputs go through both.

Tolerances: activations within 1e-4 (as ``test_torch_vit.py``), gradients
within 1e-5 of max(1, their absmax): the two differ in summation order only.
The error-term forward equals the clean one within 1e-5 (recon + (x -
recon) rounds back to x within a float32 ulp of the residual)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_prisma_tpu
from tests._torch_parity import assert_close, seeded
from vit_prisma_tpu.models.sae_vit import HookedSAEViT as JaxHookedSAEViT
from vit_prisma_tpu.sae import SAERunnerConfig as JaxSAEConfig
from vit_prisma_tpu.sae import SparseAutoencoder as JaxSAE
from vit_prisma_tpu_torch import HookedSAEViT, ViTConfig
from vit_prisma_tpu_torch.models.loading.state_dict import params_from_jax
from vit_prisma_tpu_torch.sae import SAERunnerConfig, SparseAutoencoder

ACT_ATOL = 1e-4
GRAD_REL = 1e-5
CFG = dict(n_layers=3, d_model=32, d_head=8, n_heads=4, d_mlp=64, patch_size=8,
           image_size=16, n_classes=7, activation_name="quick_gelu",
           layer_norm_pre=True, return_type="class_logits")
SAE = dict(d_in=32, expansion_factor=4, hook_point_layer=1,
           layer_subtype="hook_resid_post", b_dec_init_method="zeros",
           log_to_wandb=False)
ACTIVATIONS = {"relu": {}, "topk": dict(activation_fn_str="topk",
                                        activation_fn_kwargs={"k": 8})}
HP = "blocks.1.hook_resid_post"


def _sae_params(d_in=32, d_sae=128):
    W_dec = seeded(21, (d_sae, d_in))
    W_dec /= np.linalg.norm(W_dec, axis=-1, keepdims=True)
    return {"W_enc": seeded(22, (d_in, d_sae), d_in ** -0.5), "W_dec": W_dec,
            "b_enc": seeded(23, (d_sae,), 0.1), "b_dec": seeded(24, (d_in,), 0.1)}


def _models(activation="relu"):
    jax_model = JaxHookedSAEViT(vit_prisma_tpu.ViTConfig(**CFG), key=jax.random.PRNGKey(0))
    port = HookedSAEViT(ViTConfig(**CFG), device="cpu")
    port.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jax_model.params)))
    fields = {**SAE, **ACTIVATIONS[activation]}
    params = _sae_params()
    jax_sae = JaxSAE(JaxSAEConfig(**fields), params={k: jnp.asarray(v) for k, v in params.items()})
    port_sae = SparseAutoencoder(SAERunnerConfig(**fields),
                                 params={k: torch.from_numpy(v) for k, v in params.items()},
                                 device="cpu")
    return jax_model, port, jax_sae, port_sae


def _x():
    return seeded(1, (2, 3, 16, 16))


def _metric(out):
    return (out[:, 3] - out[:, 5]).sum()


def _assert_cache_matches(want, got):
    assert list(got) == list(want)
    for k, w in want.items():
        w = np.asarray(w, np.float32)
        atol = (GRAD_REL * max(1.0, float(np.abs(w).max())) if k.endswith("_grad")
                else ACT_ATOL)
        assert_close(w, got[k], atol, k)


@pytest.mark.parametrize("use_error_term", [False, True])
@pytest.mark.parametrize("activation", list(ACTIVATIONS))
def test_spliced_grads_match_jax(activation, use_error_term):
    jax_model, port, jax_sae, port_sae = _models(activation)
    names = lambda n: n.startswith("blocks.1.") or n.startswith("blocks.2.hook_resid")
    with jax_model.saes([jax_sae], use_error_term=use_error_term):
        want_out, want = jax_model.run_with_cache(
            jnp.asarray(_x()), names_filter=names, incl_bwd=True, loss_fn=_metric,
            return_cache_object=False)
    with port.saes([port_sae], use_error_term=use_error_term):
        got_out, got = port.run_with_cache(torch.from_numpy(_x()), names_filter=names,
                                           incl_bwd=True, loss_fn=_metric)
    assert f"{HP}.hook_hidden_post_grad" in got and HP not in got
    _assert_cache_matches(want, got)
    assert_close(want_out, got_out, ACT_ATOL, "output")
    assert not port.acts_to_saes and not hasattr(port_sae, "_original_use_error_term")


@pytest.mark.parametrize("activation", list(ACTIVATIONS))
def test_spliced_forward_and_hooks_match_jax(activation):
    jax_model, port, jax_sae, port_sae = _models(activation)
    x = _x()
    want = jax_model.run_with_saes(jnp.asarray(x), saes=[jax_sae])
    got = port.run_with_saes(torch.from_numpy(x), saes=[port_sae])
    assert_close(want, got, ACT_ATOL, "spliced output")
    assert (got - port(torch.from_numpy(x))).abs().max() > 1e-3  # the splice acts
    want_out, want_cache = jax_model.run_with_cache_with_saes(
        jnp.asarray(x), saes=[jax_sae], return_cache_object=False)
    got_out, got_cache = port.run_with_cache_with_saes(torch.from_numpy(x), saes=[port_sae])
    _assert_cache_matches(want_cache, got_cache)
    ablate_j = lambda v, hook: v.at[..., 5].set(0.0)
    ablate_p = lambda v, hook: v.index_fill(-1, torch.tensor([5]), 0.0)
    want = jax_model.run_with_hooks_with_saes(
        jnp.asarray(x), saes=[jax_sae], fwd_hooks=[(f"{HP}.hook_hidden_post", ablate_j)])
    got = port.run_with_hooks_with_saes(
        torch.from_numpy(x), saes=[port_sae], fwd_hooks=[(f"{HP}.hook_hidden_post", ablate_p)])
    assert_close(want, got, ACT_ATOL, "ablated output")
    assert not port.acts_to_saes


def test_error_term_keeps_the_clean_forward_and_saes_reset():
    _, port, _, port_sae = _models()
    x = torch.from_numpy(_x())
    clean = port(x)
    with port.saes(port_sae, use_error_term=True):
        assert port_sae.use_error_term and list(port.acts_to_saes) == [HP]
        torch.testing.assert_close(port(x), clean, rtol=0, atol=1e-5)
        out, _ = port.run_with_cache(x, names_filter=HP + ".hook_sae_out", incl_bwd=True)
        torch.testing.assert_close(out, clean, rtol=0, atol=1e-5)
    assert not port.acts_to_saes and port_sae.use_error_term is False
    # attach, replace and reset by name
    port.add_sae(port_sae)
    other = SparseAutoencoder(port_sae.cfg, params=dict(port_sae.params), device="cpu")
    with port.saes(other):
        assert port.acts_to_saes[HP] is other
    assert port.acts_to_saes[HP] is port_sae
    port.reset_saes(HP)
    assert not port.acts_to_saes
    bad = SparseAutoencoder(port_sae.cfg.replace(hook_point_layer=7), params=dict(port_sae.params),
                            device="cpu")
    port.add_sae(bad)  # no such hook point: skipped
    assert not port.acts_to_saes


def test_demo07_feature_attribution_flow():
    # demos/07_sae_feature_attribution.py at a small size: error-term
    # splice, d metric / d feature, attribution, and an ablation that moves
    # the metric.
    _, port, _, port_sae = _models()
    x = torch.from_numpy(_x())
    clean_out = port(x)
    with port.saes([port_sae], use_error_term=True):
        out, cache = port.run_with_cache(x, names_filter=lambda n: n.startswith(HP),
                                         incl_bwd=True, loss_fn=_metric)
    torch.testing.assert_close(out, clean_out, rtol=0, atol=1e-5)
    feats = cache[f"{HP}.hook_hidden_post"]
    grads = cache[f"{HP}.hook_hidden_post_grad"]
    assert feats.shape == grads.shape == (2, 5, 128)
    per_feature = (feats * grads).abs().sum(dim=(0, 1))
    top = int(per_feature.argmax())
    assert per_feature[top] > 0
    ablate = lambda v, hook: v.index_fill(-1, torch.tensor([top]), 0.0)
    with port.saes([port_sae]):
        base = _metric(port.run_with_hooks(x))
        abl = _metric(port.run_with_hooks(x, fwd_hooks=[(f"{HP}.hook_hidden_post", ablate)]))
    assert abs(float(base) - float(abl)) > 0
