"""The port's SAE core against the JAX package's: the runner config and the
registry entry it names, the LR schedules, the geometric median, the SAE
forward with its losses and gradients, and the decoder constraints.  Same
numpy inputs and weights on both sides, float32, tolerances stated per
test."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_prisma_tpu_torch
from tests._torch_parity import assert_close, seeded
from vit_prisma_tpu.models.loading.registry import get_model_config as jax_get_config
from vit_prisma_tpu.sae import config as jax_config
from vit_prisma_tpu.sae import sae as jax_sae
from vit_prisma_tpu.sae.geometric_median import compute_geometric_median as jax_gm
from vit_prisma_tpu.sae.schedulers import get_schedule as jax_schedule
from vit_prisma_tpu_torch.sae import config as port_config
from vit_prisma_tpu_torch.sae import sae as port_sae
from vit_prisma_tpu_torch.sae.convert import sae_params_from_jax
from vit_prisma_tpu_torch.sae.geometric_median import compute_geometric_median as port_gm
from vit_prisma_tpu_torch.sae.schedulers import get_schedule as port_schedule

DERIVED = ("hook_point", "out_hook_point", "d_sae", "tokens_per_image",
           "tokens_per_buffer", "total_training_tokens", "total_training_steps",
           "num_patch", "activation_fn_kwargs_dict", "topk_k")
CONFIG_VARIANTS = {
    "defaults": {},
    "cls_only": dict(cls_token_only=True, hook_point_layer=3),
    "patches_only": dict(use_patches_only=True, n_batches_in_buffer=4),
    "override": dict(buffer_tokens_override=1234, total_training_images=5000,
                     num_epochs=3),
    "topk": dict(activation_fn_str="topk", activation_fn_kwargs={"k": 8}),
}


def _cfgs(**fields):
    return jax_config.SAERunnerConfig(**fields), port_config.SAERunnerConfig(**fields)


def test_config_fields_and_defaults_match_jax():
    jax_fields = [(f.name, f.default) for f in dataclasses.fields(jax_config.SAERunnerConfig)]
    port_fields = [(f.name, f.default) for f in dataclasses.fields(port_config.SAERunnerConfig)]
    assert port_fields == jax_fields


@pytest.mark.parametrize("variant", list(CONFIG_VARIANTS))
def test_config_derived_properties_match_jax(variant):
    jc, pc = _cfgs(**CONFIG_VARIANTS[variant])
    assert pc.to_dict() == jc.to_dict()
    for name in DERIVED:
        assert getattr(pc, name) == getattr(jc, name), name
    assert port_config.SAERunnerConfig.from_dict(jc.to_dict()) == pc
    assert pc.replace(lr=0.5).lr == 0.5 and pc.torch_dtype == torch.float32
    assert pc.replace(compute_dtype="bfloat16").compute_torch_dtype == torch.bfloat16


def test_config_save_load_round_trip(tmp_path):
    _, pc = _cfgs(d_in=64, expansion_factor=4, activation_fn_kwargs={"k": 3})
    path = os.path.join(tmp_path, "cfg.json")
    pc.save_config(path)
    assert port_config.SAERunnerConfig.load_config(path) == pc
    assert jax_config.SAERunnerConfig.load_config(path).to_dict() == pc.to_dict()


def test_sae_default_model_registry_entry_matches_jax():
    name = port_config.SAERunnerConfig().model_name
    assert vit_prisma_tpu_torch.get_model_config(name).to_dict() == \
        jax_get_config(name).to_dict()


SCHEDULES = ["constant", "constantwithwarmup", "linearwarmupdecay",
             "cosineannealing", "cosineannealingwarmup",
             "cosineannealingwarmrestarts"]


@pytest.mark.parametrize("name", SCHEDULES)
def test_schedules_match_jax(name):
    # float32 on both sides; cos may differ by an ulp.
    kw = dict(warm_up_steps=10, training_steps=100, lr_end=0.05, num_cycles=3)
    steps = np.array([0, 1, 5, 9, 10, 11, 33, 50, 99, 100, 150], np.int32)
    want = np.asarray(jax_schedule(name, **kw)(jnp.asarray(steps)), np.float32)
    got = port_schedule(name, **kw)(torch.from_numpy(steps))
    assert got.dtype == torch.float32
    assert_close(want, got, 1e-6, name)
    for s in (0, 12):  # Python ints too
        assert_close(np.asarray(jax_schedule(name, **kw)(s)),
                     port_schedule(name, **kw)(s), 1e-6, f"{name}@{s}")


def test_geometric_median_matches_jax():
    # Weiszfeld sums over 200 points in another order; 1e-5 on values ~1.
    pts = seeded(0, (200, 16))
    pts[:10] += 25.0  # outliers the median must resist
    want = jax_gm(jnp.asarray(pts), maxiter=100)
    got = port_gm(torch.from_numpy(pts), maxiter=100)
    assert_close(want.median, got.median, 1e-5, "median")
    np.testing.assert_allclose(got.new_weights.numpy(), np.asarray(want.new_weights),
                               rtol=1e-4)
    assert float(torch.linalg.norm(got.median - torch.from_numpy(pts).mean(0))) > 1.0


FORWARD_VARIANTS = {
    "relu_l1": {},
    "tanh_relu": dict(activation_fn_str="tanh-relu"),
    "relu_l2": dict(lp_norm=2.0),
    "tied_init": dict(initialization_method="encoder_transpose_decoder"),
}
SMALL = dict(d_in=48, expansion_factor=4, l1_coefficient=3e-3)


def _jax_params(jc, seed=0, b_dec_scale=0.3):
    params = jax_sae.init_sae_params(jc, jax.random.PRNGKey(seed))
    params = dict(params)
    # non-zero biases, so that their paths are checked too
    params["b_dec"] = jnp.asarray(seeded(seed + 7, (jc.d_in,), b_dec_scale))
    params["b_enc"] = jnp.asarray(seeded(seed + 8, (jc.d_sae,), 0.05))
    return params


@pytest.mark.parametrize("variant", list(FORWARD_VARIANTS))
def test_sae_forward_and_grads_match_jax(variant):
    jc, pc = _cfgs(**SMALL, **FORWARD_VARIANTS[variant])
    jparams = _jax_params(jc)
    x = seeded(1, (96, jc.d_in), 2.0)
    want = jax_sae.sae_forward(jparams, jc, jnp.asarray(x))
    pparams = sae_params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    leaves = {k: v.clone().requires_grad_(True) for k, v in pparams.items()}
    got = port_sae.sae_forward(leaves, pc, torch.from_numpy(x))
    # float32 GEMMs over 48 and 192 terms, summed in other orders
    for field in ("sae_out", "feature_acts", "loss", "mse_loss", "l1_loss"):
        assert_close(getattr(want, field), getattr(got, field).detach(), 1e-5, field)
    assert float(got.ghost_grad_loss) == 0.0

    jgrads = jax.grad(lambda p: jax_sae.sae_forward(p, jc, jnp.asarray(x)).loss)(jparams)
    pgrads = torch.autograd.grad(got.loss, list(leaves.values()))
    for k, g in zip(leaves, pgrads):
        scale = max(1.0, float(np.abs(np.asarray(jgrads[k])).max()))
        assert_close(jgrads[k], g, 1e-5 * scale, f"grad {k}")


def test_constraints_match_jax():
    jc, _ = _cfgs(**SMALL)
    jparams = _jax_params(jc)
    jparams["W_dec"] = jparams["W_dec"] * 3.0
    pparams = sae_params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    want = jax_sae.set_decoder_norm_to_unit_norm(jparams)
    got = port_sae.set_decoder_norm_to_unit_norm(pparams)
    assert_close(want["W_dec"], got["W_dec"], 1e-7, "unit-norm W_dec")
    assert got["W_enc"] is pparams["W_enc"]

    grads = {k: seeded(i, v.shape) for i, (k, v) in enumerate(jparams.items())}
    want_g = jax_sae.remove_gradient_parallel_to_decoder_directions(
        {k: jnp.asarray(v) for k, v in grads.items()}, want)
    got_g = port_sae.remove_gradient_parallel_to_decoder_directions(
        {k: torch.from_numpy(v) for k, v in grads.items()}, got)
    assert_close(want_g["W_dec"], got_g["W_dec"], 1e-6, "projected W_dec grad")
    rows = (got_g["W_dec"] * got["W_dec"]).sum(-1)
    assert float(rows.abs().max()) < 1e-5


def test_sae_module_matches_jax(tmp_path):
    jc, pc = _cfgs(**SMALL)
    jparams = _jax_params(jc)
    sae = port_sae.SparseAutoencoder(pc, params=sae_params_from_jax(
        jax.tree.map(np.asarray, jparams), device="cpu"))
    x = seeded(2, (16, jc.d_in))
    want = jax_sae.SparseAutoencoder(jc, params=jparams)
    assert_close(want.reconstruct(jnp.asarray(x)), sae.reconstruct(torch.from_numpy(x)),
                 1e-5, "reconstruct")
    assert_close(want.encode(jnp.asarray(x)), sae.encode(torch.from_numpy(x)), 1e-5, "encode")
    assert_close(want(jnp.asarray(x)).loss, sae(torch.from_numpy(x)).loss, 1e-5, "loss")
    assert sae.get_name() == want.get_name()
    assert not any(p.requires_grad for p in sae.parameters())
    # saved in the JAX package's format: both packages load it back
    sae.save_model(str(tmp_path / "sae"))
    back = port_sae.SparseAutoencoder.load_from_pretrained(str(tmp_path / "sae"), device="cpu")
    assert back.cfg == pc and all(torch.equal(back.params[k], v) for k, v in sae.params.items())
    jback = jax_sae.SparseAutoencoder.load_from_pretrained(str(tmp_path / "sae.npz"))
    np.testing.assert_array_equal(np.asarray(jback(jnp.asarray(x)).loss),
                                  np.asarray(want(jnp.asarray(x)).loss))


def test_port_init_is_unit_norm_and_seeded():
    _, pc = _cfgs(**SMALL)
    a = port_sae.init_sae_params(pc, torch.Generator().manual_seed(3), device="cpu")
    b = port_sae.init_sae_params(pc, torch.Generator().manual_seed(3), device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert tuple(a["W_enc"].shape) == (48, 192) and tuple(a["W_dec"].shape) == (192, 48)
    torch.testing.assert_close(torch.linalg.norm(a["W_dec"], dim=-1), torch.ones(192))
    torch.testing.assert_close(torch.linalg.norm(a["W_enc"], dim=0), torch.ones(192))


@pytest.mark.parametrize("fields,item", [
    (dict(architecture="gated"), "item 10"),
    (dict(architecture="transcoder", is_transcoder=True), "item 10"),
    (dict(activation_fn_str="topk"), "item 10"),
    (dict(use_ghost_grads=True), "item 5"),
    (dict(normalize_activations="layer_norm"), "item 5"),
])
def test_unported_variants_raise_naming_their_item(fields, item):
    _, pc = _cfgs(**SMALL, **fields)
    if pc.architecture == "gated":
        # gated is ported: the forward runs with its gate L1 and aux loss
        params = port_sae.init_sae_params(pc, device="cpu")
        out = port_sae.sae_forward(params, pc, torch.from_numpy(seeded(3, (4, 48))))
        assert torch.isfinite(out.loss) and float(out.aux_reconstruction_loss) > 0
        torch.testing.assert_close(out.loss, out.mse_loss + out.l1_loss
                                   + out.aux_reconstruction_loss)
        return
    if pc.activation_fn_str == "topk":
        # TopK is ported: the forward runs, without a sparsity loss; only
        # the approximate TopK (an XLA op of the TPU) still raises
        params = port_sae.init_sae_params(pc, device="cpu")
        out = port_sae.sae_forward(params, pc, torch.from_numpy(seeded(3, (4, 48))))
        assert out.l1_loss is None and torch.isfinite(out.loss) and out.loss == out.mse_loss
        assert ((out.feature_acts > 0).sum(-1) <= pc.topk_k).all()
        pc = pc.replace(topk_use_approx=True)
    with pytest.raises(NotImplementedError, match=item):
        port_sae.init_sae_params(pc)
    with pytest.raises(NotImplementedError, match=item):
        port_sae.sae_forward({}, pc, torch.zeros(2, 48))
