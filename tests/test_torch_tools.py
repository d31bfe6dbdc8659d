"""The port's remaining tools against the JAX package's, on the same numpy
inputs at tiny sizes on the CPU: ``utils/constants``, ``enums``,
``wandb_utils``, ``get_activations`` (and its four deliberate differences
from JAX's), ``profiling``, the Kandinsky adapter and ``tutorial_utils``."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_prisma_tpu as jax_pkg
from tests._torch_parity import port_from_jax, seeded
from vit_prisma_tpu.sae import kandinsky_adapter as jax_ad
from vit_prisma_tpu.sae import sae as jax_sae
from vit_prisma_tpu.utils import constants as jax_const
from vit_prisma_tpu.utils import enums as jax_enums
from vit_prisma_tpu.utils import get_activations as jax_ga
from vit_prisma_tpu.utils import tutorial_utils as jax_tu
from vit_prisma_tpu.utils import wandb_utils as jax_wu
from vit_prisma_tpu_torch.sae import kandinsky_adapter as port_ad
from vit_prisma_tpu_torch.sae import sae as port_sae
from vit_prisma_tpu_torch.sae.convert import sae_params_from_jax
from vit_prisma_tpu_torch.utils import constants as port_const
from vit_prisma_tpu_torch.utils import enums as port_enums
from vit_prisma_tpu_torch.utils import get_activations as port_ga
from vit_prisma_tpu_torch.utils import profiling
from vit_prisma_tpu_torch.utils import tutorial_utils as port_tu
from vit_prisma_tpu_torch.utils import wandb_utils as port_wu

VIT = dict(n_layers=3, d_model=32, d_head=8, n_heads=4, d_mlp=64, patch_size=4,
           image_size=8, n_classes=6, return_type="logits")
ATOL = 2e-5


@pytest.fixture(scope="module")
def models():
    jm = jax_pkg.HookedViT(jax_pkg.ViTConfig(**VIT), key=jax.random.PRNGKey(0))
    return jm, port_from_jax(jm)


def _loader(n_batches=3, bs=4, labels=True, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        x = rng.normal(size=(bs, 3, 8, 8)).astype(np.float32)
        y = rng.integers(0, 6, size=(bs,))
        out.append((x, y) if labels else x)
    return out


# -- constants, enums, wandb_utils -------------------------------------------

def test_constants_enums_and_wandb_utils_match_jax():
    assert port_const.BASE_DIR == jax_const.BASE_DIR
    assert port_const.DATA_DIR == jax_const.DATA_DIR
    assert port_const.MODEL_DIR == jax_const.MODEL_DIR
    assert port_const.device("cpu") == torch.device("cpu")
    assert [(m.name, m.value) for m in port_enums.ModelType] == \
        [(m.name, m.value) for m in jax_enums.ModelType]

    @dataclasses.dataclass
    class Mutable:
        a: int = 1
        b: str = "x"

    @dataclasses.dataclass(frozen=True)
    class Frozen:
        a: int = 1

    upd = {"a": 5, "zzz": 0}
    for mod in (jax_wu, port_wu):
        assert mod.dataclass_to_dict(Mutable()) == {"a": 1, "b": "x"}
        m = Mutable()
        assert mod.update_dataclass_from_dict(m, upd) is m and m.a == 5
        assert mod.update_dataclass_from_dict(Frozen(), upd) == Frozen(a=5)


def test_constants_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        port_const.device()


# -- get_activations ------------------------------------------------------------

@pytest.mark.parametrize("hook", ["blocks.1.hook_resid_post", "blocks.0.attn.hook_pattern",
                                  "hook_embed", "hook_full_embed", "ln_final.hook_normalized",
                                  "resid_post", "mlp_out"])
def test_get_activations_matches_jax(models, hook):
    jm, pm = models
    loader = _loader()
    want, wl = jax_ga.get_activations(jm, hook, loader, return_labels=True)
    got, gl = port_ga.get_activations(pm, hook, loader, return_labels=True)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(gl.numpy(), wl)


@pytest.mark.parametrize("name", ["blocks.2.hook_resid_post", "hook_embed", "ln_final.hook_scale",
                                  "blocks.0.attn.hook_q"])
def test_hook_stop_layer_matches_jax(name):
    assert port_ga.hook_stop_layer(name, 3) == jax_ga.hook_stop_layer(name, 3)
    with pytest.raises(ValueError):
        port_ga.hook_stop_layer("blocks.3.hook_resid_post", 3)


def test_get_activations_max_count_and_test_run_match_jax(models):
    jm, pm = models
    loader = _loader(n_batches=4)
    for kw in (dict(max_count=2), dict(test_run=True), dict(max_count=0)):
        want = jax_ga.get_activations(jm, "blocks.0.hook_mlp_out", loader, **kw)
        got = port_ga.get_activations(pm, "blocks.0.hook_mlp_out", loader, **kw)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL, err_msg=str(kw))


def test_get_activations_unknown_dotted_name_raises(models):
    """Deliberate difference: JAX's last-layer fallback mangles a dotted
    name the model lacks into another name; the port raises, naming it."""
    _, pm = models
    with pytest.raises(ValueError, match="blocks.0.hook_nonexistent"):
        port_ga.get_activations(pm, "blocks.0.hook_nonexistent", _loader())
    with pytest.raises(ValueError, match="blocks.7.hook_resid_post"):
        port_ga.get_activations(pm, "blocks.7.hook_resid_post", _loader())


class _CountingLoader:
    def __init__(self, batches):
        self.batches = batches
        self.pulled = 0

    def __iter__(self):
        for b in self.batches:
            self.pulled += 1
            yield b


def test_get_activations_takes_exactly_max_count_batches(models):
    """Deliberate difference: JAX's loop pulls one batch past max_count
    (and drops it); the port pulls exactly max_count."""
    jm, pm = models
    jl, pl = _CountingLoader(_loader(4)), _CountingLoader(_loader(4))
    jax_ga.get_activations(jm, "resid_post", jl, max_count=2)
    port_ga.get_activations(pm, "resid_post", pl, max_count=2)
    assert jl.pulled == 3
    assert pl.pulled == 2


def test_get_activations_keeps_the_hook_dtype():
    """Deliberate difference: JAX casts to float32; the port keeps the
    model's dtype (bfloat16 here)."""
    cfg = jax_pkg.ViTConfig(**VIT)
    pm = port_from_jax(jax_pkg.HookedViT(cfg, key=jax.random.PRNGKey(0)))
    pbf = pm.with_cfg(dtype="bfloat16").to(torch.bfloat16)
    got = port_ga.get_activations(pbf, "blocks.0.hook_resid_post",
                                  [torch.as_tensor(x).to(torch.bfloat16) for x, _ in _loader(2)])
    assert got.dtype == torch.bfloat16
    want = jax_ga.get_activations(jax_pkg.HookedViT(cfg, key=jax.random.PRNGKey(0)),
                                  "blocks.0.hook_resid_post", [x for x, _ in _loader(2)])
    assert want.dtype == np.float32


def test_get_activations_without_labels_raises(models):
    """Deliberate difference: JAX fabricates zero labels when no batch had
    labels; the port raises."""
    jm, pm = models
    loader = _loader(labels=False)
    _, wl = jax_ga.get_activations(jm, "resid_post", loader, return_labels=True)
    assert not wl.any()
    with pytest.raises(ValueError, match="labels"):
        port_ga.get_activations(pm, "resid_post", loader, return_labels=True)
    acts = port_ga.get_activations(pm, "resid_post", loader)
    assert acts.shape[0] == 12


def test_get_activations_empty_loader_raises(models):
    _, pm = models
    with pytest.raises(ValueError, match="no batches"):
        port_ga.get_activations(pm, "resid_post", [])


# -- profiling ------------------------------------------------------------------

def test_profiling_on_the_cpu(tmp_path):
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2

    x = torch.ones(4)
    t = profiling.device_time(fn, x, iters=5, warmup=2)
    assert t >= 0 and len(calls) == 7
    assert profiling.flops_per_second(fn, 10.0, x, iters=3) > 0
    assert profiling.memory_stats() is None or torch.cuda.is_available()
    assert profiling.memory_stats("cpu") is None
    with profiling.profile_trace(str(tmp_path / "trace")) as prof:
        (torch.ones(8, 8) @ torch.ones(8, 8)).sum()
    assert os.path.exists(tmp_path / "trace" / "trace.json")
    assert len(prof.key_averages()) > 0


# -- the Kandinsky adapter ---------------------------------------------------

def _jax_adapter_params(seed=0, dims=(16, 32, 24)):
    return {k: np.asarray(v) for k, v in
            jax_ad.init_adapter_params(jax.random.PRNGKey(seed), *dims).items()}


def test_adapter_init_bounds_match_jax():
    dims = (16, 32, 24)
    jp = _jax_adapter_params(0, dims)
    pp = port_ad.init_adapter_params(torch.Generator().manual_seed(0), *dims, device="cpu")
    assert set(pp) == set(jp)
    for k in jp:
        assert tuple(pp[k].shape) == jp[k].shape and pp[k].dtype == torch.float32
        bound = np.abs(jp[k]).max()
        fan_in = jp["W" + k[1]].shape[0]
        want = (np.sqrt(1 / 3) * np.sqrt(3 / fan_in)) if k[0] == "W" else 1 / np.sqrt(fan_in)
        assert bound <= want and float(pp[k].abs().max()) <= want, k
        assert float(pp[k].abs().max()) > 0.8 * want, k


def test_adapter_forward_matches_jax_with_dropout_masks():
    jp = _jax_adapter_params(1)
    pp = {k: torch.from_numpy(v.copy()) for k, v in jp.items()}
    x = seeded(2, (8, 16))
    np.testing.assert_allclose(port_ad.adapter_forward(pp, torch.from_numpy(x)).numpy(),
                               np.asarray(jax_ad.adapter_forward(jp, jnp.asarray(x))),
                               rtol=0, atol=1e-5)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax_ad.adapter_forward(jp, jnp.asarray(x), dropout_key=key))
    k1, k2 = jax.random.split(key)
    masks = [torch.from_numpy(np.array(jax.random.bernoulli(k, 0.9, (8, 32))))
             for k in (k1, k2)]
    got = port_ad.adapter_forward(pp, torch.from_numpy(x), masks)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def _jax_train(src, tgt, params, n_epochs, bs, lr, seed):
    """JAX's train_adapter loop from given initial params, dropout off (the
    rate is a default of the JAX forward, so the key is withheld)."""
    import optax
    opt = optax.adam(lr)
    state = (params, opt.init(params))

    @jax.jit
    def step(p, o, s, t):
        def loss_fn(p):
            return jnp.mean(jnp.square(jax_ad.adapter_forward(p, s) - t))
        loss, g = jax.value_and_grad(loss_fn)(p)
        upd, o = opt.update(g, o, p)
        return optax.apply_updates(p, upd), o, loss

    p, o = state
    rng = np.random.default_rng(seed)
    for _ in range(n_epochs):
        order = rng.permutation(len(src))
        for i in range(0, len(src) - bs + 1, bs):
            idx = order[i:i + bs]
            p, o, loss = step(p, o, jnp.asarray(src[idx]), jnp.asarray(tgt[idx]))
    return {k: np.asarray(v) for k, v in p.items()}, float(loss)


def test_train_adapter_matches_jax_adam_and_files_cross_read(tmp_path):
    src, tgt = seeded(4, (40, 16)), seeded(5, (40, 24))
    jp = _jax_adapter_params(6)
    want, want_loss = _jax_train(src, tgt, jp, n_epochs=3, bs=8, lr=1e-3, seed=7)
    got, got_loss = port_ad.train_adapter(
        src, tgt, num_epochs=3, batch_size=8, lr=1e-3, seed=7, device="cpu",
        params={k: torch.from_numpy(v.copy()) for k, v in jp.items()},
        masks_fn=lambda step: None)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=2e-4, atol=2e-5, err_msg=k)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-4)
    # each package reads the other's .npz
    port_ad.save_adapter(str(tmp_path / "port"), got)
    jax_ad.save_adapter(str(tmp_path / "jax"), want)
    from_port = jax_ad.load_adapter(str(tmp_path / "port"))
    from_jax = port_ad.load_adapter(str(tmp_path / "jax"), device="cpu")
    for k in want:
        np.testing.assert_array_equal(np.asarray(from_port[k]), got[k].numpy())
        np.testing.assert_array_equal(from_jax[k].numpy(), want[k])


def test_train_adapter_defaults_run_with_dropout():
    src, tgt = seeded(8, (32, 16)), seeded(9, (32, 24))
    params, loss = port_ad.train_adapter(src, tgt, num_epochs=2, batch_size=8, hidden_dim=32,
                                         device="cpu")
    assert np.isfinite(loss) and tuple(params["W2"].shape) == (32, 32)


def test_dual_embedder_builds_pairs():
    emb = port_ad.DualEmbedder(lambda x: x.flatten(1)[:, :4], lambda x: x.flatten(1)[:, :2] * 2)
    src, tgt = emb.build_dataset([np.ones((3, 3, 2, 2), np.float32)] * 2)
    assert src.shape == (6, 4) and tgt.shape == (6, 2) and (tgt == 2).all()


# -- tutorial_utils ------------------------------------------------------------

def _saes():
    fields = dict(d_in=32, expansion_factor=2, hook_point_layer=1,
                  layer_subtype="hook_resid_post", b_dec_init_method="zeros",
                  log_to_wandb=False)
    jc, pc = jax_sae.SAERunnerConfig(**fields), port_sae.SAERunnerConfig(**fields)
    params = dict(jax_sae.init_sae_params(jc, jax.random.PRNGKey(1)))
    params["b_enc"] = jnp.asarray(seeded(2, (jc.d_sae,), 0.05))
    np_params = {k: np.asarray(v) for k, v in params.items()}
    return (jax_sae.SparseAutoencoder(jc, params=params),
            port_sae.SparseAutoencoder(pc, params=sae_params_from_jax(np_params, "cpu")))


def test_accuracy_and_substitution_match_jax(models):
    jm, pm = models
    js, ps = _saes()
    data = _loader(n_batches=4, bs=8, seed=3)
    classifier = seeded(4, (6, 6))
    for cls in (None, classifier):
        want = jax_tu.calculate_substitution_accuracy_delta(jm, js, lambda: iter(data), cls)
        got = port_tu.calculate_substitution_accuracy_delta(pm, ps, lambda: iter(data), cls)
        assert got == want
        assert port_tu.calculate_clean_accuracy(pm, data, cls) == \
            jax_tu.calculate_clean_accuracy(jm, data, cls)


def test_feature_activations_match_jax(models):
    jm, pm = models
    js, ps = _saes()
    x = seeded(5, (4, 3, 8, 8))
    want = np.asarray(jax_tu.get_feature_activations(x, jm, js))
    got = port_tu.get_feature_activations(x, pm, ps)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_load_clip_models_through_the_ports_loader(monkeypatch):
    calls = []

    def fake(name, model_type="vision", **kw):
        calls.append((name, model_type, kw))
        return model_type

    import vit_prisma_tpu_torch.models.loading.loader as loader
    monkeypatch.setattr(loader, "load_hooked_model", fake)
    assert port_tu.load_clip_models("m", device="cpu") == ("vision", "text")
    assert calls == [("m", "vision", {"device": "cpu"}), ("m", "text", {"device": "cpu"})]


def test_plot_helpers_run_under_agg(tmp_path):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    img = seeded(6, (3, 8, 8))
    ax = port_tu.plot_image(img)
    assert ax is not None
    values = np.abs(seeded(7, (64,)))
    idx, vals = port_tu.plot_act_distribution(values, n_top=5)
    widx, wvals = jax_tu.plot_act_distribution(values, n_top=5)
    np.testing.assert_array_equal(idx, widx)
    np.testing.assert_array_equal(vals, wvals)

    class Cfg:
        hook_point = "blocks.1.hook_resid_post"

    class Sae:
        cfg = Cfg()

    viz = [(np.clip(seeded(i, (3, 8, 8)), 0, 1), 0) for i in range(6)]
    fig = port_tu.plot_imgs_for_one_feature(3, [0, 2, 4], [0.5, 0.25, 0.1], viz, Cfg(), show=False)
    assert len(fig.axes) == 4
    figs = port_tu.plot_top_imgs_for_features(
        [1, 2], {1: {"indices": [0, 1], "values": [1.0, 0.5]},
                 2: {"indices": [3], "values": [0.2]}}, viz, Sae(), top_k=2, show=False)
    assert len(figs) == 2
    plt.close("all")


def test_new_modules_and_the_spawned_worlds_import_no_jax():
    """The parallel package, the tools, and the helper the spawned gloo
    worlds run import neither JAX nor the JAX package."""
    import subprocess
    import sys
    code = ("import sys, vit_prisma_tpu_torch.parallel, vit_prisma_tpu_torch.parallel.mesh, "
            "vit_prisma_tpu_torch.utils.get_activations, vit_prisma_tpu_torch.utils.profiling, "
            "vit_prisma_tpu_torch.utils.tutorial_utils, vit_prisma_tpu_torch.utils.constants, "
            "vit_prisma_tpu_torch.utils.enums, vit_prisma_tpu_torch.utils.wandb_utils, "
            "vit_prisma_tpu_torch.visualization, vit_prisma_tpu_torch.sae.kandinsky_adapter, "
            "tests._torch_dist; "
            "bad = sorted(m for m in sys.modules "
            "if m.startswith('jax') or m.startswith('vit_prisma_tpu.') "
            "or m in ('vit_prisma_tpu', 'optax')); "
            "assert not bad, bad")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=root)
