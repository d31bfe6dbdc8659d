"""The port's SAE evals (``vit_prisma_tpu_torch.sae.evals``) and in-training
validation against the JAX package's, on the same weights
(``port_from_jax``, ``sae_params_from_jax``), at tiny sizes on the CPU.

Tolerance: float32, 1e-5 on every loss, cosine and L0 mean; firing counts,
top-image indices and the written dashboard are equal.  No wider bound is
needed: the forwards agree within ~1e-6 here (``test_torch_vit.py``), far
from any ReLU switch at these seeds."""

import json
import sys
import types

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
from tests._torch_parity import port_from_jax, seeded
from tests.test_torch_sae_train import _FixedStore
from vit_prisma_tpu.sae.train import init_sweep_state as jax_init_sweep
from vit_prisma_tpu_torch.sae.convert import sae_params_from_jax, train_state_from_jax

ATOL = 1e-5
VIT = dict(n_layers=2, d_model=16, d_head=4, n_heads=4, d_mlp=32, patch_size=4,
           image_size=8, n_classes=6, return_type="class_logits")
SAE = dict(d_in=16, expansion_factor=4, hook_point_layer=1, layer_subtype="hook_resid_post",
           context_size=5, b_dec_init_method="zeros", model_name="custom")
VARIANTS = {
    "plain": {},
    "cls_token_only": dict(cls_token_only=True),
    "use_patches_only": dict(use_patches_only=True),
    "head_hook_z": dict(layer_subtype="attn.hook_z", hook_point_head_index=1, d_in=4),
    "topk": dict(activation_fn_str="topk", activation_fn_kwargs=(("k", 8),)),
}
N_IMAGES, BS = 48, 16


@pytest.fixture(scope="module")
def models():
    jm = jax_pkg.HookedViT(jax_pkg.ViTConfig(**VIT), key=jax.random.PRNGKey(0))
    return jm, port_from_jax(jm)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    images = rng.normal(size=(N_IMAGES, 3, 8, 8)).astype(np.float32)
    labels = rng.integers(0, 6, size=(N_IMAGES,))
    class_emb = rng.normal(size=(6, 6)).astype(np.float32)  # logits space
    return images, labels, class_emb


def _saes(seed=1, **fields):
    """The same SAE in both packages: JAX's init, b_dec and b_enc nudged off
    zero so that every path of the SAE is exercised."""
    fields = {**SAE, **fields}
    jc, pc = jax_sae.SAERunnerConfig(**fields), port_sae.SAERunnerConfig(**fields)
    params = dict(jax_sae.init_sae_params(jc, jax.random.PRNGKey(seed)))
    params["b_dec"] = jnp.asarray(seeded(seed + 1, (jc.d_in,), 0.1))
    params["b_enc"] = jnp.asarray(seeded(seed + 2, (jc.d_sae,), 0.05))
    np_params = {k: np.asarray(v) for k, v in params.items()}
    return (jax_sae.SparseAutoencoder(jc, params=params),
            port_sae.SparseAutoencoder(pc, params=sae_params_from_jax(np_params, "cpu")))


def _batches(images, labels, bs=BS):
    for i in range(0, len(images), bs):
        yield images[i:i + bs], labels[i:i + bs], np.arange(i, min(i + bs, len(images)))


def _assert_stats_close(want, got, atol=ATOL):
    for field in want._fields:
        w = np.asarray(getattr(want, field), np.float32)
        g = getattr(got, field).float().cpu().numpy()
        assert g.shape == w.shape, field
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=field)


def _assert_dicts_close(want, got, atol=ATOL):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, (np.ndarray, list)):
            np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0, atol=atol, err_msg=k)
        elif isinstance(w, float) and np.isnan(w):
            assert np.isnan(g), k
        else:
            assert g == pytest.approx(w, abs=atol), k


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_eval_step_matches_jax(variant, models, data):
    jm, pm = models
    images, labels, class_emb = data
    jsae, psae = _saes(**VARIANTS[variant])
    want = jax_evals.make_eval_step(jm, jsae)(
        jm.params, jsae.params, jnp.asarray(images[:BS]), jnp.asarray(labels[:BS]),
        jnp.asarray(class_emb))
    got = port_evals.make_eval_step(pm, psae)(
        pm, psae.params, torch.from_numpy(images[:BS]), torch.from_numpy(labels[:BS]),
        torch.from_numpy(class_emb))
    _assert_stats_close(want, got)
    assert float(got.act_counts.sum()) > 0  # the SAE fires


def test_replacement_hook_gives_the_substituted_loss(models, data):
    _, pm = models
    images, labels, class_emb = data
    _, psae = _saes()
    x, y, e = (torch.from_numpy(a) for a in (images[:BS], labels[:BS], class_emb))
    s = port_evals.make_eval_step(pm, psae)(pm, psae.params, x, y, e)
    emb = pm.run_with_hooks(x, fwd_hooks=[(psae.cfg.hook_point,
                                           port_evals.make_replacement_hook(psae))])
    assert float(port_evals._ce(emb @ e.T, y)) == pytest.approx(float(s.recons_loss), abs=ATOL)
    zero = pm.run_with_hooks(x, fwd_hooks=[(psae.cfg.hook_point, port_evals.zero_ablate_hook)])
    assert float(port_evals._ce(zero @ e.T, y)) == pytest.approx(float(s.zero_abl_loss),
                                                                  abs=ATOL)


def _sweep_params(jc, L, seed=3):
    state = jax_init_sweep(jc, L, key=jax.random.PRNGKey(seed))
    params = dict(state.params)
    params["b_dec"] = jnp.asarray(seeded(seed + 1, (L, jc.d_in), 0.1))
    np_params = {k: np.asarray(v) for k, v in params.items()}
    return params, sae_params_from_jax(np_params, "cpu")


SWEEPS = {"resid_post_prefix": "hook_resid_post", "edit_hook": "hook_mlp_out"}


@pytest.mark.parametrize("subtype", list(SWEEPS.values()), ids=list(SWEEPS))
def test_sweep_eval_step_matches_jax(subtype, models, data):
    jm, pm = models
    images, labels, class_emb = data
    fields = {**SAE, "layer_subtype": subtype, "sweep_layers": (0, 1)}
    jc, pc = jax_sae.SAERunnerConfig(**fields), port_sae.SAERunnerConfig(**fields)
    jp, pp = _sweep_params(jc, 2)
    want = jax_evals.make_sweep_eval_step(jm, jc, (0, 1))(
        jm.params, jp, jnp.asarray(images[:BS]), jnp.asarray(labels[:BS]),
        jnp.asarray(class_emb))
    got = port_evals.make_sweep_eval_step(pm, pc, (0, 1))(
        pm, pp, torch.from_numpy(images[:BS]), torch.from_numpy(labels[:BS]),
        torch.from_numpy(class_emb))
    _assert_stats_close(want, got)
    # each layer's substitution against the single-SAE step with that SAE
    for i in range(2):
        psae = port_sae.SparseAutoencoder(pc.replace(sweep_layers=None, hook_point_layer=i),
                                          params={k: v[i] for k, v in pp.items()})
        one = port_evals.make_eval_step(pm, psae)(
            pm, psae.params, torch.from_numpy(images[:BS]), torch.from_numpy(labels[:BS]),
            torch.from_numpy(class_emb))
        for field in ("recons_loss", "zero_abl_loss", "l0_image"):
            np.testing.assert_allclose(getattr(got, field)[i].numpy(),
                                       getattr(one, field).numpy(), rtol=0, atol=ATOL)


def test_process_dataset_matches_jax(models, data):
    jm, pm = models
    images, labels, class_emb = data
    jsae, psae = _saes()
    cfg = jax_evals.EvalConfig(eval_max=40)
    pcfg = port_evals.EvalConfig(eval_max=40)  # stops after the third batch
    want = jax_evals.process_dataset(jm, jsae, ((a, b) for a, b, _ in _batches(images, labels)),
                                     class_emb, cfg)
    got = port_evals.process_dataset(pm, psae, ((a, b) for a, b, _ in _batches(images, labels)),
                                     class_emb, pcfg)
    _assert_dicts_close(want, got)
    assert 0 < got["alive_fraction"] <= 1


def test_sweep_process_dataset_matches_jax(models, data):
    jm, pm = models
    images, labels, class_emb = data
    fields = {**SAE, "sweep_layers": (0, 1)}
    jc, pc = jax_sae.SAERunnerConfig(**fields), port_sae.SAERunnerConfig(**fields)
    jp, pp = _sweep_params(jc, 2, seed=5)
    batches = lambda: ((a, b) for a, b, _ in _batches(images, labels))
    want = jax_evals.sweep_process_dataset(jm, jc, (0, 1), jp, batches(), class_emb,
                                           jax_evals.EvalConfig())
    got = port_evals.sweep_process_dataset(pm, pc, (0, 1), pp, batches(), class_emb,
                                           port_evals.EvalConfig())
    assert len(got) == len(want) == 2
    for w, g in zip(want, got):
        _assert_dicts_close(w, g)


def test_find_top_activations_heatmap_and_bins_match_jax(models, data):
    jm, pm = models
    images, labels, _ = data
    jsae, psae = _saes()
    feature_ids = [0, 5, 17, 40]
    want = jax_evals.find_top_activations(_batches(images, labels), jm, jsae, feature_ids,
                                          [False, True, False, False], top_k=4)
    got = port_evals.find_top_activations(_batches(images, labels), pm, psae, feature_ids,
                                          [False, True, False, False], top_k=4)
    assert list(got) == feature_ids
    for f in feature_ids:
        np.testing.assert_array_equal(got[f][1], want[f][1], err_msg=f"feature {f}")
        np.testing.assert_allclose(got[f][0], want[f][0], rtol=0, atol=ATOL)
    hm_want = jax_evals.get_heatmap(images[3], jm, jsae, 5)
    hm_got = port_evals.get_heatmap(images[3], pm, psae, 5)
    np.testing.assert_allclose(hm_got.numpy(), np.asarray(hm_want), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(port_evals.image_patch_heatmap(hm_got, pm.cfg),
                                  jax_evals.image_patch_heatmap(np.asarray(hm_got), jm.cfg))
    log_freq = np.random.default_rng(4).uniform(-9, 0.5, size=200)
    assert (port_evals.sample_features_from_bins(log_freq, 3, seed=7)
            == jax_evals.sample_features_from_bins(log_freq, 3, seed=7))


def test_evaluate_writes_jax_files(models, data, tmp_path):
    jm, pm = models
    images, labels, class_emb = data
    jsae, psae = _saes()
    runs = {}
    for name, evals, model, sae in (("jax", jax_evals, jm, jsae), ("port", port_evals, pm, psae)):
        out = tmp_path / name
        cfg = evals.EvalConfig(samples_per_bin=1, max_images_per_feature=4, sae_path=str(out))
        runs[name] = (evals.evaluate(cfg, sae, model, lambda: _batches(images, labels),
                                     class_emb), out)
    (want, jdir), (got, pdir) = runs["jax"], runs["port"]
    assert got["sampled_features"] == want["sampled_features"]
    assert list(got["top_images_per_feature"]) == list(want["top_images_per_feature"])
    for f, (vals, idx) in want["top_images_per_feature"].items():
        assert got["top_images_per_feature"][f][1] == idx
        np.testing.assert_allclose(got["top_images_per_feature"][f][0], vals, atol=ATOL)
    jstats = json.loads((jdir / "eval_stats.json").read_text())
    pstats = json.loads((pdir / "eval_stats.json").read_text())
    _assert_dicts_close(jstats, pstats)
    with np.load(jdir / "sparsity_TOTAL.npz") as j, np.load(pdir / "sparsity_TOTAL.npz") as p:
        for k in j.files:
            np.testing.assert_array_equal(p[k], j[k])
    html = "TOTAL_sparsity_dashboard.html"
    assert (pdir / html).read_text() == (jdir / html).read_text()
    assert "Cosine similarity" in (pdir / html).read_text()


# ---------------------------------------------------------------------------
# The trainers
# ---------------------------------------------------------------------------

TRAIN = dict(d_in=16, expansion_factor=4, train_batch_size=16, hook_point_layer=1,
             context_size=5, model_name="custom", b_dec_init_method="zeros",
             store_batch_size=12, lr_scheduler_name="constant")


def _eval_dataset(images, labels, n=12):
    return [(images[i], int(labels[i])) for i in range(n)]


@pytest.mark.parametrize("with_classes", [True, False], ids=["class_embeddings", "identity"])
def test_validate_matches_jax(with_classes, models, data):
    jm, pm = models
    images, labels, class_emb = data
    ds = _eval_dataset(images, labels)
    emb = class_emb if with_classes else None
    jc, pc = jax_sae.SAERunnerConfig(**TRAIN), port_sae.SAERunnerConfig(**TRAIN)
    jtr = jax_sae.VisionSAETrainer(jc, model=jm, eval_dataset=ds, class_embeddings=emb)
    ptr = port_sae.VisionSAETrainer(pc, model=pm, eval_dataset=ds, class_embeddings=emb,
                                    device="cpu")
    ptr.load_state(train_state_from_jax(jax.tree.map(np.asarray, jtr.state), device="cpu"))
    _assert_dicts_close(jtr.validate(), ptr.validate())


def test_sweep_validate_and_evaluate_match_jax(models, data):
    jm, pm = models
    images, labels, class_emb = data
    ds = _eval_dataset(images, labels)
    fields = {**TRAIN, "sweep_layers": (0, 1)}
    jc, pc = jax_sae.SAERunnerConfig(**fields), port_sae.SAERunnerConfig(**fields)
    jtr = jax_sae.SAESweepTrainer(jc, model=jm, eval_dataset=ds, class_embeddings=class_emb)
    ptr = port_sae.SAESweepTrainer(pc, model=pm, eval_dataset=ds, class_embeddings=class_emb,
                                   device="cpu")
    ptr.load_state(train_state_from_jax(jax.tree.map(np.asarray, jtr.state), device="cpu"))
    _assert_dicts_close(jtr.validate(), ptr.validate())
    batches = lambda: ((a, b) for a, b, _ in _batches(images, labels))
    for w, g in zip(jtr.evaluate(batches()), ptr.evaluate(batches())):
        _assert_dicts_close(w, g)


def _port_trainer(cls, models, data, n_steps=5, **fields):
    """A port trainer over fixed batches, with a model and an eval dataset,
    whose run ends after ``n_steps`` steps."""
    _, pm = models
    images, labels, _ = data
    sweep = cls is port_sae.SAESweepTrainer
    fields = {**TRAIN, "total_training_images": n_steps * TRAIN["train_batch_size"] // 5,
              **({"sweep_layers": (0, 1)} if sweep else {}), **fields}
    pc = port_sae.SAERunnerConfig(**fields)
    shape = (pc.train_batch_size, 2, pc.d_in) if sweep else (pc.train_batch_size, pc.d_in)
    store = _FixedStore([seeded(30 + i, shape) for i in range(n_steps)], torch.from_numpy)
    return cls(pc, model=pm, store=store, eval_dataset=_eval_dataset(images, labels),
               device="cpu")


def _count_validations(trainer):
    calls, inner = [], trainer.validate

    def validate():
        vals = inner()
        calls.append(vals)
        return vals
    trainer.validate = validate
    return calls


@pytest.mark.parametrize("cls", [port_sae.VisionSAETrainer, port_sae.SAESweepTrainer],
                         ids=["single", "sweep"])
def test_min_ce_recovered_aborts_run(cls, models, data):
    tr = _port_trainer(cls, models, data, n_validation_runs=2, min_ce_recovered=1e9)
    calls = _count_validations(tr)
    with pytest.raises(RuntimeError, match="CE-recovered"):
        tr.run()
    assert len(calls) == 1 and tr._host_step == 3  # the threshold at half the run
    ok = _port_trainer(cls, models, data, n_validation_runs=2, min_ce_recovered=-1e9)
    calls = _count_validations(ok)
    ok.run()
    assert len(calls) == 2 and ok._host_step == 5  # mid-run and at the end
    key = "validation_metrics/substitution_score"
    assert all(np.isfinite(v[key]) for v in calls)


@pytest.mark.parametrize("cls", [port_sae.VisionSAETrainer, port_sae.SAESweepTrainer],
                         ids=["single", "sweep"])
def test_log_to_wandb_with_a_stub_module_and_without_one(cls, models, data, monkeypatch):
    log = []
    stub = types.ModuleType("wandb")
    stub.init = lambda **kw: log.append(("init", kw["project"]))
    stub.log = lambda vals, step=None: log.append(("log", step, sorted(vals)))
    monkeypatch.setitem(sys.modules, "wandb", stub)
    tr = _port_trainer(cls, models, data, log_to_wandb=True, wandb_log_frequency=2,
                       n_validation_runs=1)
    assert tr._wandb is stub and log == [("init", tr.cfg.wandb_project)]
    tr.run()
    logged = [entry for entry in log if entry[0] == "log"]
    assert [step for _, step, _ in logged] == [2, 4, 5]  # two metric reads, the final validation
    assert "loss" in logged[0][2] and "validation_metrics/substitution_score" in logged[-1][2]
    monkeypatch.setitem(sys.modules, "wandb", None)  # not installed: the import fails
    tr = _port_trainer(cls, models, data, log_to_wandb=True, n_validation_runs=1)
    assert tr._wandb is None
    tr.run()
