"""The SAE variants of the port against the JAX package's: ghost grads, the
two activation normalizations, transcoders with and without the skip
connection, and ``topk_use_approx`` (the JAX package's route off the TPU,
the exact top k).  The same numpy weights, inputs and dead-feature masks go
through both packages, in float32.

Tolerances: the forward and its losses within 1e-5, gradients within 1e-4,
the train state after three steps within 1e-5 of each leaf's absmax (at
least 1e-5), the steps' metrics within 1e-5 of max(1, |value|) (a
transcoder's loss against an unrelated target is ~4, and float32 means of
2,048 terms in two summation orders differ by a few 1e-6 of it); counters
exact.  Inputs are continuous draws, so TopK has no
ties and both packages keep the same k entries.

The ghost loss is ill-conditioned in float32, in both packages: it rescales
each element by ``mse / (mse_ghost + 1e-6)``, and an element whose ghost fit
is near exact (``mse_ghost`` ~1e-6, a few in every draw of 2,048) turns a
rounding of its fit into a change of ~0.1 of its gradient term.  JAX's own
ghost gradients move by 1e-5 to 6e-4 when x moves by one or two ulps.  So
where ghost grads are on, each compared value is held within the larger of
the tolerance above and twice the most JAX's own value moves under those
four perturbations of x (``_jax_spread``); the port stayed within 0.75 of
that spread over four seeds and three variants.  Then the variants through
the evals and the spliced forward, and a transcoder's file in either
package's format."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_prisma_tpu as jax_pkg
import vit_prisma_tpu.sae as jax_sae
import vit_prisma_tpu.sae.evals as jax_evals
import vit_prisma_tpu_torch.sae as port_sae
import vit_prisma_tpu_torch.sae.evals as port_evals
from tests._torch_parity import assert_close, seeded
from vit_prisma_tpu.models.sae_vit import HookedSAEViT as JaxHookedSAEViT
from vit_prisma_tpu.sae.train import _fused_single_ok as jax_single_gate
from vit_prisma_tpu.sae.train import _fused_step_ok as jax_gate
from vit_prisma_tpu.sae.train import sae_train_step as jax_step
from vit_prisma_tpu_torch import HookedSAEViT, ViTConfig
from vit_prisma_tpu_torch.models.loading.state_dict import params_from_jax
from vit_prisma_tpu_torch.sae.convert import (sae_params_from_jax, train_state_from_jax,
                                              train_state_to_numpy)
from vit_prisma_tpu_torch.sae.train import _fused_single_ok, _fused_step_ok

ATOL = 1e-5
GRAD_ATOL = 1e-4
STATE_REL = 1e-5
B = 64
CFG = dict(d_in=32, expansion_factor=4, train_batch_size=B, l1_coefficient=1e-3, lr=1e-3,
           lr_warm_up_steps=3, total_training_images=100_000, context_size=5,
           model_name="custom", hook_point_layer=1, dead_feature_window=10,
           b_dec_init_method="zeros")
TOPK = dict(activation_fn_str="topk", activation_fn_kwargs={"k": 8})
TRANSCODER = dict(architecture="transcoder", is_transcoder=True, d_out=32)
VARIANTS = {
    "ghost_grads": dict(use_ghost_grads=True),
    "ghost_grads_topk": dict(use_ghost_grads=True, **TOPK),
    "layer_norm": dict(normalize_activations="layer_norm"),
    "constant_norm_rescale": dict(normalize_activations="constant_norm_rescale"),
    "transcoder_skip": dict(TRANSCODER),
    "transcoder_no_skip": dict(TRANSCODER, transcoder_with_skip_connection=False),
    "transcoder_ghost_layer_norm": dict(TRANSCODER, use_ghost_grads=True,
                                        normalize_activations="layer_norm"),
    "topk_use_approx": dict(topk_use_approx=True, **TOPK),
}
COUNTERS = ("adam_count", "schedule_count", "step", "n_training_tokens",
            "n_frac_active_tokens", "act_freq_scores", "n_forward_passes_since_fired")


def _cfgs(**fields):
    fields = {**CFG, **fields}
    return jax_sae.SAERunnerConfig(**fields), port_sae.SAERunnerConfig(**fields)


def _jax_params(jc, seed=0):
    """JAX's init with every bias drawn off zero."""
    params = dict(jax_sae.init_sae_params(jc, jax.random.PRNGKey(seed)))
    params["b_dec"] = jnp.asarray(seeded(seed + 1, (jc.d_in,), 0.2))
    params["b_enc"] = jnp.asarray(seeded(seed + 2, (jc.d_sae,), 0.05))
    if "b_dec_out" in params:
        params["b_dec_out"] = jnp.asarray(seeded(seed + 3, (jc.d_out,), 0.2))
    return params


def _port_params(params):
    return sae_params_from_jax({k: np.asarray(v) for k, v in params.items()}, "cpu")


def _inputs(jc, seed=10):
    """x, the transcoder's target y (None otherwise) and a quarter of the
    features marked dead."""
    x = seeded(seed, (B, jc.d_in), 1.5) + 0.3
    y = seeded(seed + 1, (B, jc.d_out), 0.8) - 0.1 if jc.is_transcoder else None
    dead = np.random.default_rng(seed + 2).permutation(jc.d_sae) < jc.d_sae // 4
    return x, y, dead


# x scaled by one and two ulps either way
PERTURBATIONS = tuple(np.float32(1 + s * 2.0 ** -e) for e in (23, 22) for s in (1, -1))


def _jax_spread(fn, x, *rest):
    """{name: the most JAX's own float32 value moves} when x is perturbed by
    one or two ulps; ``fn(x, *rest)`` returns a dict of arrays."""
    base = fn(x, *rest)
    spread = {k: 0.0 for k in base}
    for f in PERTURBATIONS:
        moved = fn((x * f).astype(np.float32), *rest)
        for k in base:
            spread[k] = max(spread[k], float(np.abs(np.asarray(moved[k], np.float32)
                                                    - np.asarray(base[k], np.float32)).max()))
    return spread


def _tol(base, spread, name):
    return base if spread is None else max(base, 2 * spread[name])


def _forwards(variant):
    jc, pc = _cfgs(**VARIANTS[variant])
    params = _jax_params(jc)
    x, y, dead = _inputs(jc)
    want = jax_sae.sae_forward(params, jc, jnp.asarray(x),
                               y=None if y is None else jnp.asarray(y),
                               dead_neuron_mask=jnp.asarray(dead), training=True)
    got = port_sae.sae_forward(_port_params(params), pc, torch.from_numpy(x),
                               y=None if y is None else torch.from_numpy(y),
                               dead_neuron_mask=torch.from_numpy(dead), training=True)
    return jc, pc, want, got


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_and_losses_match_jax(variant):
    jc, pc, want, got = _forwards(variant)
    for field in want._fields:
        w, g = getattr(want, field), getattr(got, field)
        assert (w is None) == (g is None), field
        if w is not None:
            assert tuple(g.shape) == tuple(np.shape(w)), field
            assert_close(w, g, ATOL, field)
    if pc.use_ghost_grads:
        assert float(got.ghost_grad_loss) > 0
        torch.testing.assert_close(got.loss, got.mse_loss + (
            got.l1_loss if got.l1_loss is not None else 0) + got.ghost_grad_loss)
    else:
        assert float(got.ghost_grad_loss) == 0.0
    if pc.activation_fn_str == "topk":
        # exactly k a row, the same entries as JAX's exact route
        assert ((got.feature_acts > 0).sum(-1) <= pc.topk_k).all()
        np.testing.assert_array_equal((got.feature_acts != 0).numpy(),
                                      np.asarray(want.feature_acts) != 0)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_gradients_match_jax(variant):
    jc, pc = _cfgs(**VARIANTS[variant])
    params = _jax_params(jc)
    x, y, dead = _inputs(jc, seed=30)
    jy = None if y is None else jnp.asarray(y)
    jax_grads = lambda xx: jax.grad(lambda p: jax_sae.sae_forward(
        p, jc, jnp.asarray(xx), y=jy, dead_neuron_mask=jnp.asarray(dead)).loss)(params)
    want = jax_grads(x)
    spread = _jax_spread(jax_grads, x) if pc.use_ghost_grads else None
    leaves = {k: v.requires_grad_(True) for k, v in _port_params(params).items()}
    out = port_sae.sae_forward(leaves, pc, torch.from_numpy(x),
                               y=None if y is None else torch.from_numpy(y),
                               dead_neuron_mask=torch.from_numpy(dead))
    got = dict(zip(leaves, torch.autograd.grad(out.loss, list(leaves.values()))))
    assert set(got) == set(want)
    for k in want:
        assert_close(want[k], got[k], _tol(GRAD_ATOL, spread, k), k)


GHOST_VARIANTS = [v for v in VARIANTS if VARIANTS[v].get("use_ghost_grads")]


@pytest.mark.parametrize("variant", GHOST_VARIANTS)
def test_ghost_gradients_lie_within_the_spread_of_a_float64_anchor(variant):
    """The ghost-grads tolerance above hides no error of the port: the
    port's ghost-grads gradients computed in float64 (parameters and inputs
    cast up; TopK through the exact select, the float64 rows the threshold
    kernel does not take) anchor both float32 results, and the port's and
    JAX's float32 gradients each lie within the documented tolerance of it
    (the larger of GRAD_ATOL and twice JAX's own spread).  JAX's x64 config
    is left as it is."""
    jc, pc = _cfgs(**VARIANTS[variant])
    params = _jax_params(jc)
    x, y, dead = _inputs(jc, seed=30)
    jy = None if y is None else jnp.asarray(y)
    jax_grads = lambda xx: jax.grad(lambda p: jax_sae.sae_forward(
        p, jc, jnp.asarray(xx), y=jy, dead_neuron_mask=jnp.asarray(dead)).loss)(params)
    want32 = jax_grads(x)
    spread = _jax_spread(jax_grads, x)

    def port_grads(dtype, cfg):
        leaves = {k: v.to(dtype).requires_grad_(True) for k, v in _port_params(params).items()}
        out = port_sae.sae_forward(leaves, cfg, torch.from_numpy(x).to(dtype),
                                   y=None if y is None else torch.from_numpy(y).to(dtype),
                                   dead_neuron_mask=torch.from_numpy(dead))
        assert out.ghost_grad_loss.dtype == dtype and float(out.ghost_grad_loss.detach()) > 0
        return dict(zip(leaves, torch.autograd.grad(out.loss, list(leaves.values()))))

    anchor = port_grads(torch.float64, pc.replace(fused_topk=False))
    got32 = port_grads(torch.float32, pc)
    for k in want32:
        tol = _tol(GRAD_ATOL, spread, k)
        a = anchor[k].numpy()
        np.testing.assert_allclose(got32[k].double().numpy(), a, rtol=0, atol=tol,
                                   err_msg=f"port {k}")
        np.testing.assert_allclose(np.asarray(want32[k], np.float64), a, rtol=0, atol=tol,
                                   err_msg=f"jax {k}")


def test_ghost_grads_reach_only_the_dead_rows_of_w_dec():
    """The ghost loss's W_dec gradient lies on the dead features' rows; the
    alive rows' gradients equal those without ghost grads."""
    jc, pc = _cfgs(**VARIANTS["ghost_grads"])
    params = _port_params(_jax_params(jc))
    x, _, dead = _inputs(jc, seed=50)

    def grads(cfg):
        leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        out = port_sae.sae_forward(leaves, cfg, torch.from_numpy(x),
                                   dead_neuron_mask=torch.from_numpy(dead))
        return torch.autograd.grad(out.loss, leaves["W_dec"])[0]

    with_ghost, without = grads(pc), grads(pc.replace(use_ghost_grads=False))
    alive = torch.from_numpy(~dead)
    torch.testing.assert_close(with_ghost[alive], without[alive], rtol=0, atol=1e-7)
    assert (with_ghost[~alive] - without[~alive]).abs().amax(-1).min() > 0


def _jax_state(jc, seed=0):
    state = jax_sae.init_train_state(jc, params=_jax_params(jc, seed))
    dead = np.random.default_rng(seed + 7).permutation(jc.d_sae) < jc.d_sae // 4
    return state._replace(n_forward_passes_since_fired=jnp.asarray(
        np.where(dead, jc.dead_feature_window + 1.0, 0.0).astype(np.float32)))


def _flat(jax_state):
    return train_state_to_numpy(train_state_from_jax(jax.tree.map(np.asarray, jax_state),
                                                     device="cpu"))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_three_steps_match_jax(variant):
    """Three generic steps (the fused gate refuses every variant, as JAX's
    does), with a quarter of the features dead at the start."""
    jc, pc = _cfgs(**VARIANTS[variant])
    assert not _fused_single_ok(pc, B) and not _fused_step_ok(pc, B, 2)
    inputs = [_inputs(jc, seed=60 + 3 * i)[:2] for i in range(3)]

    def jax_steps(x0):
        """JAX's three steps (the first batch's x given): the state and
        each step's metrics, flat."""
        state, out = _jax_state(jc), {}
        for i, (x, y) in enumerate(inputs):
            state, m = jax_step(state, jnp.asarray(x0 if i == 0 else x), jc,
                                None if y is None else jnp.asarray(y))
            out.update({f"step {i} {f}": v for f, v in m._asdict().items()})
        return {**out, **_flat(state)}

    want = jax_steps(inputs[0][0])
    spread = _jax_spread(jax_steps, inputs[0][0]) if pc.use_ghost_grads else None
    pstate = train_state_from_jax(jax.tree.map(np.asarray, _jax_state(jc)), device="cpu")
    metrics = []
    for i, (x, y) in enumerate(inputs):
        pstate, pm = port_sae.sae_train_step(pstate, torch.from_numpy(x), pc,
                                             None if y is None else torch.from_numpy(y))
        metrics.append(pm)
        for f in pm._fields:
            k = f"step {i} {f}"
            base = ATOL * max(1.0, abs(float(want[k])))
            assert_close(want[k], getattr(pm, f), _tol(base, spread, k), k)
    got = train_state_to_numpy(pstate)
    for k in got:
        if k in COUNTERS:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            tol = _tol(STATE_REL * max(1.0, float(np.abs(want[k]).max())), spread, k)
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol, err_msg=k)
    if pc.use_ghost_grads:  # the first step had dead features
        assert float(metrics[0].ghost_grad_loss) > 0 and float(metrics[0].n_dead_features) > 0


# The fused gate on tile-aligned shapes, where JAX's takes the plain
# standard SAE: every variant stays off the fused kernels in both packages.
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_fused_gate_refuses_the_variants_as_jax(variant):
    fields = dict(d_in=128, expansion_factor=4, **VARIANTS[variant])
    jc, pc = _cfgs(**fields)
    for rows, layers in ((256, 1), (256, 2)):
        assert _fused_step_ok(pc, rows, layers) == jax_gate(jc, rows, layers) is False
    assert _fused_single_ok(pc, 256) == jax_single_gate(jc, 256) is False


def test_approx_topk_is_the_exact_top_k():
    """``topk_use_approx`` takes the exact top k (JAX's route off the TPU),
    also with ``fused_topk``: k entries a row, JAX's entries."""
    jc, pc = _cfgs(**VARIANTS["topk_use_approx"])
    assert pc.fused_topk
    x = torch.from_numpy(seeded(70, (B, pc.d_sae)))
    got = port_sae.sae.get_activation_fn(pc)(x)
    want = jax_sae.sae.get_activation_fn(jc)(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ((got > 0).sum(-1) == pc.topk_k).all()


# -- the SAE file ---------------------------------------------------------------

@pytest.mark.parametrize("skip", [True, False], ids=["skip", "no_skip"])
def test_transcoder_file_round_trips_through_both_packages(tmp_path, skip):
    jc, pc = _cfgs(**TRANSCODER, transcoder_with_skip_connection=skip)
    port = port_sae.SparseAutoencoder(pc, device="cpu")
    assert ("W_skip" in port.params) == skip and tuple(port.params["W_dec"].shape) == (128, 32)
    assert tuple(port.params["b_dec_out"].shape) == (32,)
    port.save_model(str(tmp_path / "port"))
    back = jax_sae.SparseAutoencoder.load_from_pretrained(str(tmp_path / "port.npz"))
    assert back.cfg.to_dict() == pc.to_dict() and set(back.params) == set(port.params)
    x = seeded(80, (8, 32))
    assert_close(back(jnp.asarray(x)).sae_out, port(torch.from_numpy(x)).sae_out, ATOL)
    jax_sae.SparseAutoencoder(jc, params=_jax_params(jc)).save_model(str(tmp_path / "jax"))
    loaded = port_sae.SparseAutoencoder.load_from_pretrained(str(tmp_path / "jax"), device="cpu")
    assert loaded.cfg == pc
    for k, v in _jax_params(jc).items():
        np.testing.assert_array_equal(loaded.params[k].numpy(), np.asarray(v), err_msg=k)


def test_transcoder_init_draws_the_jax_layout():
    _, pc = _cfgs(**{**TRANSCODER, "d_out": 24})
    p = port_sae.init_sae_params(pc, torch.Generator().manual_seed(3), device="cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "W_enc": (32, 128), "W_dec": (128, 24), "b_enc": (128,), "b_dec": (32,),
        "b_dec_out": (24,), "W_skip": (32, 32)}
    for k, dim in (("W_dec", -1), ("W_skip", -1), ("W_enc", 0)):
        torch.testing.assert_close(torch.linalg.norm(p[k], dim=dim),
                                   torch.ones(p[k].shape[1 - (dim % 2)]))


# -- evals and the spliced forward --------------------------------------------------

VIT = dict(n_layers=2, d_model=32, d_head=8, n_heads=4, d_mlp=64, patch_size=8,
           image_size=16, n_classes=6, return_type="class_logits")
EVAL_VARIANTS = ("ghost_grads", "layer_norm", "constant_norm_rescale")


@pytest.fixture(scope="module")
def models():
    jm = JaxHookedSAEViT(jax_pkg.ViTConfig(**VIT), key=jax.random.PRNGKey(0))
    port = HookedSAEViT(ViTConfig(**VIT), device="cpu")
    port.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jm.params)))
    return jm, port


def _saes(variant):
    jc, pc = _cfgs(**VARIANTS[variant])
    params = _jax_params(jc, seed=4)
    return (jax_sae.SparseAutoencoder(jc, params=params),
            port_sae.SparseAutoencoder(pc, params=_port_params(params)))


@pytest.mark.parametrize("variant", EVAL_VARIANTS)
def test_eval_step_matches_jax(variant, models):
    jm, pm = models
    jsae, psae = _saes(variant)
    rng = np.random.default_rng(5)
    images = rng.normal(size=(8, 3, 16, 16)).astype(np.float32)
    labels = rng.integers(0, 6, size=(8,))
    emb = rng.normal(size=(6, 6)).astype(np.float32)
    want = jax_evals.make_eval_step(jm, jsae)(jm.params, jsae.params, jnp.asarray(images),
                                              jnp.asarray(labels), jnp.asarray(emb))
    got = port_evals.make_eval_step(pm, psae)(pm, psae.params, torch.from_numpy(images),
                                              torch.from_numpy(labels), torch.from_numpy(emb))
    for field in want._fields:
        assert_close(getattr(want, field), getattr(got, field), ATOL, field)
    assert float(got.act_counts.sum()) > 0
    fids = [0, 5, 17]
    want_scores = jax_evals.make_feature_activation_step(jm, jsae, fids)(
        jm.params, jsae.params, jnp.asarray(images))
    got_scores = port_evals.make_feature_activation_step(pm, psae, fids)(
        pm, psae.params, torch.from_numpy(images))
    assert_close(want_scores, got_scores, ATOL, "feature scores")


@pytest.mark.parametrize("variant", EVAL_VARIANTS)
def test_spliced_cache_and_grads_match_jax(variant, models):
    jm, pm = models
    jsae, psae = _saes(variant)
    x = seeded(6, (2, 3, 16, 16))
    names = lambda n: n.startswith("blocks.1.")
    loss = lambda out: (out[:, 1] - out[:, 4]).sum()
    with jm.saes([jsae]):
        _, want = jm.run_with_cache(jnp.asarray(x), names_filter=names, incl_bwd=True,
                                    loss_fn=loss, return_cache_object=False)
    with pm.saes([psae]):
        _, got = pm.run_with_cache(torch.from_numpy(x), names_filter=names, incl_bwd=True,
                                   loss_fn=loss, return_cache_object=False)
    assert list(got) == list(want)
    for k, w in want.items():
        w = np.asarray(w, np.float32)
        atol = ATOL * max(1.0, float(np.abs(w).max())) if k.endswith("_grad") else 1e-4
        assert_close(w, got[k], atol, k)
