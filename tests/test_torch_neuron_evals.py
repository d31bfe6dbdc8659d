"""The neuron-basis and feature-list evals and ``SparsecoderEval``, the port
against the JAX package, on the same weights and images at a tiny size on
the CPU, for a standard SAE and a transcoder.  float32: scores and metrics
within 1e-5 of max(1, |value|), top-image indices equal (continuous draws:
no ties)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_prisma_tpu as jax_pkg
import vit_prisma_tpu.sae as jax_sae
import vit_prisma_tpu.sae.neuron_evals as jax_neuron
import vit_prisma_tpu_torch.sae as port_sae
import vit_prisma_tpu_torch.sae.neuron_evals as port_neuron
from tests._torch_parity import port_from_jax, seeded
from vit_prisma_tpu_torch.sae.convert import sae_params_from_jax

ATOL = 1e-5
VIT = dict(n_layers=2, d_model=16, d_head=4, n_heads=4, d_mlp=32, patch_size=4,
           image_size=8, n_classes=6, return_type="class_logits")
SAE = dict(d_in=16, expansion_factor=4, hook_point_layer=1, context_size=5,
           b_dec_init_method="zeros", model_name="custom")
SAES = {"standard": {},
        "transcoder": dict(architecture="transcoder", is_transcoder=True, d_out=16,
                           layer_subtype="hook_resid_mid", out_hook_point_layer=1),
        "layer_norm": dict(normalize_activations="layer_norm")}
N_IMAGES, BS = 40, 8


@pytest.fixture(scope="module")
def models():
    jm = jax_pkg.HookedViT(jax_pkg.ViTConfig(**VIT), key=jax.random.PRNGKey(0))
    return jm, port_from_jax(jm)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(N_IMAGES, 3, 8, 8)).astype(np.float32),
            rng.integers(0, 6, size=(N_IMAGES,)))


def _batches(images, labels):
    for i in range(0, len(images), BS):
        yield images[i:i + BS], labels[i:i + BS], np.arange(i, i + BS)


def _saes(kind):
    fields = {**SAE, **SAES[kind]}
    jc, pc = jax_sae.SAERunnerConfig(**fields), port_sae.SAERunnerConfig(**fields)
    params = dict(jax_sae.init_sae_params(jc, jax.random.PRNGKey(1)))
    params["b_dec"] = jnp.asarray(seeded(2, (jc.d_in,), 0.1))
    params["b_enc"] = jnp.asarray(seeded(3, (jc.d_sae,), 0.05))
    np_params = {k: np.asarray(v) for k, v in params.items()}
    return (jax_sae.SparseAutoencoder(jc, params=params),
            port_sae.SparseAutoencoder(pc, params=sae_params_from_jax(np_params, "cpu")))


def _close(want, got, name):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=ATOL * max(1.0, float(np.abs(want).max())), err_msg=name)


@pytest.mark.parametrize("sampling_type", ["avg", "cls"])
@pytest.mark.parametrize("sublayer", ["mlp.hook_post", "hook_resid_post"])
def test_top_neuron_activations_match_jax(models, data, sublayer, sampling_type):
    jm, pm = models
    images, labels = data
    neurons = [0, 3, 7, 11]
    kw = dict(sublayer=sublayer, top_k=5, sampling_type=sampling_type)
    want = jax_neuron.find_top_neuron_activations(_batches(images, labels), jm, 1, neurons, **kw)
    got = port_neuron.find_top_neuron_activations(_batches(images, labels), pm, 1, neurons, **kw)
    assert list(got) == list(want) == neurons
    for n in neurons:
        _close(want[n][0], got[n][0], f"neuron {n}")
        np.testing.assert_array_equal(got[n][1], want[n][1])
    step = port_neuron.make_neuron_activation_step(pm, 1, neurons, sublayer, sampling_type)
    assert tuple(step(pm, torch.from_numpy(images[:BS])).shape) == (BS, len(neurons))


@pytest.mark.parametrize("kind", list(SAES))
def test_eval_feature_list_matches_jax(models, data, kind):
    jm, pm = models
    images, labels = data
    jsae, psae = _saes(kind)
    fids = [1, 5, 30, 63]
    want = jax_neuron.eval_feature_list(lambda: _batches(images, labels), jm, jsae, fids, top_k=4)
    got = port_neuron.eval_feature_list(lambda: _batches(images, labels), pm, psae, fids, top_k=4)
    assert list(got) == list(want) == fids
    for f in fids:
        assert got[f]["top_image_indices"] == want[f]["top_image_indices"]
        for key in ("top_values", "max_activation", "mean_top_activation"):
            _close(want[f][key], got[f][key], f"{f} {key}")


@pytest.mark.parametrize("kind", list(SAES))
def test_sparsecoder_eval_matches_jax(models, data, kind):
    """The run's headline numbers, with a [d_emb, n_classes] probe (the
    transposed layout is turned round in both packages)."""
    jm, pm = models
    images, labels = data
    jsae, psae = _saes(kind)
    probe = seeded(4, (6, 6))
    cfg = jax_sae.evals.EvalConfig(batch_size=BS)
    want = jax_neuron.SparsecoderEval(jsae, jm, probe, cfg).run(lambda: _batches(images, labels))
    pcfg = port_sae.EvalConfig(batch_size=BS)
    got = port_neuron.SparsecoderEval(psae, pm, torch.from_numpy(probe), pcfg).run(
        lambda: _batches(images, labels))
    assert set(got) == set(want)
    for k in want:
        _close(want[k], got[k], k)
    assert got["avg_l0"] > 0


def test_load_dino_linear_classifier_matches_jax(tmp_path):
    W = seeded(5, (10, 12))
    state = {"module.linear.weight": torch.from_numpy(W), "module.linear.bias": torch.zeros(10)}
    torch.save({"state_dict": state}, str(tmp_path / "probe.pth"))
    for src in (state, str(tmp_path / "probe.pth")):
        got = port_neuron.load_dino_linear_classifier(src, dim=12, num_labels=10)
        want = jax_neuron.load_dino_linear_classifier(src, dim=12, num_labels=10)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
