"""The port's SAE files, trainer checkpoints and train-state resume against
the JAX package's.

SAE files are the JAX package's ``.npz`` format, so a file written by one
package loads in the other to the bit.  A train state saved after N steps
and loaded into a fresh trainer gives, after M more steps on the same
batches, the state of N + M uninterrupted steps to the bit (one process,
the same kernels' plain versions, the same order of operations)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_prisma_tpu.sae as jax_sae
import vit_prisma_tpu_torch.sae as port_sae
from tests._torch_parity import assert_close, seeded
from tests.test_torch_sae_train import _FixedStore
from vit_prisma_tpu.utils import saving_utils as jax_saving
from vit_prisma_tpu_torch.sae.convert import train_state_from_jax, train_state_to_numpy
from vit_prisma_tpu_torch.utils import saving_utils as port_saving

CFG = dict(d_in=32, expansion_factor=4, train_batch_size=64, l1_coefficient=1e-3,
           lr=1e-3, lr_warm_up_steps=3, total_training_images=64, context_size=5,
           model_name="custom", hook_point_layer=1, b_dec_init_method="zeros")
# TopK on the fused single-SAE step (a stack of one; tile-aligned shapes)
TOPK = dict(d_in=128, expansion_factor=4, train_batch_size=256, lr=1e-3,
            lr_scheduler_name="constant", b_dec_init_method="zeros", context_size=5,
            model_name="custom", hook_point_layer=2, activation_fn_str="topk",
            activation_fn_kwargs=(("k", 32),), total_training_images=1024)
SWEEP = dict(d_in=128, expansion_factor=4, train_batch_size=256, lr=1e-3,
             lr_scheduler_name="constant", b_dec_init_method="zeros", l1_coefficient=1e-3,
             context_size=5, model_name="custom", sweep_layers=(0, 2),
             total_training_images=256)
VARIANTS = {
    "relu": (CFG, {}),
    "relu_adam_bf16_window": (CFG, dict(adam_dtype="bfloat16", feature_sampling_window=2)),
    "topk_fused": (TOPK, {}),
    "topk_bf16_compute": (TOPK, dict(compute_dtype="bfloat16", adam_dtype="bfloat16")),
}
ATOL = 1e-5


def _cfgs(base, **fields):
    fields = {**base, **fields}
    return jax_sae.SAERunnerConfig(**fields), port_sae.SAERunnerConfig(**fields)


def _batches(cfg, n, seed=20):
    shape = (cfg.train_batch_size, len(cfg.sweep_layers), cfg.d_in) if cfg.sweep_layers \
        else (cfg.train_batch_size, cfg.d_in)
    return [seeded(seed + i, shape, 1.5) + 0.3 for i in range(n)]


def _params(cfg, dtype=np.float32, seed=3):
    """Seeded SAE parameters in the config's layout."""
    params = {"W_enc": seeded(seed, (cfg.d_in, cfg.d_sae), 0.1),
              "W_dec": seeded(seed + 1, (cfg.d_sae, cfg.d_in), 0.1),
              "b_enc": seeded(seed + 2, (cfg.d_sae,), 0.1),
              "b_dec": seeded(seed + 3, (cfg.d_in,), 0.1)}
    return {k: v.astype(dtype) for k, v in params.items()}


def _words(a: np.ndarray) -> np.ndarray:
    """An array's raw bytes, for equality to the bit."""
    return np.ascontiguousarray(a).view(np.uint8)


def _assert_states_equal(a, b):
    fa, fb = train_state_to_numpy(a), train_state_to_numpy(b)
    assert set(fa) == set(fb)
    for k in fa:
        np.testing.assert_array_equal(_words(fb[k]), _words(fa[k]), err_msg=k)
    for x, y in ((a.opt_state[0].mu, b.opt_state[0].mu), (a.opt_state[0].nu, b.opt_state[0].nu)):
        assert all(x[k].dtype == y[k].dtype for k in x)


# -- SAE files ----------------------------------------------------------------------

@pytest.mark.parametrize("fields", [{}, dict(architecture="gated"),
                                    dict(activation_fn_str="topk",
                                         activation_fn_kwargs=(("k", 8),))],
                         ids=["standard", "gated", "topk"])
def test_sae_file_cross_loads_float32(tmp_path, fields):
    jc, pc = _cfgs(CFG, **fields)
    params = _params(pc)
    if pc.architecture == "gated":
        params.update(b_gate=seeded(9, (pc.d_sae,), 0.1), r_mag=seeded(10, (pc.d_sae,), 0.1),
                      b_mag=seeded(11, (pc.d_sae,), 0.1))
    port = port_sae.SparseAutoencoder(pc, params={k: torch.from_numpy(v)
                                                  for k, v in params.items()}, device="cpu")
    jsae = jax_sae.SparseAutoencoder(jc, params={k: jnp.asarray(v) for k, v in params.items()})
    port.save_model(str(tmp_path / "port" / "sae"))
    jsae.save_model(str(tmp_path / "jax" / "sae"))
    # port -> JAX
    back = jax_sae.SparseAutoencoder.load_from_pretrained(str(tmp_path / "port" / "sae"))
    assert back.cfg.to_dict() == jc.to_dict()
    for k, v in params.items():
        np.testing.assert_array_equal(_words(np.asarray(back.params[k])), _words(v), err_msg=k)
    # JAX -> port
    got = port_sae.SparseAutoencoder.load_from_pretrained(str(tmp_path / "jax" / "sae"),
                                                          device="cpu")
    assert got.cfg.to_dict() == pc.to_dict()
    for k, v in params.items():
        assert got.params[k].dtype == torch.float32
        np.testing.assert_array_equal(_words(got.params[k].numpy()), _words(v), err_msg=k)
    x = seeded(12, (16, pc.d_in))
    assert_close(jsae(jnp.asarray(x)).loss, got(torch.from_numpy(x)).loss, ATOL, "loss")


def test_sae_file_bfloat16_words(tmp_path):
    """The JAX package writes an ml_dtypes bfloat16 parameter as two-byte
    void words (``|V2``); the port reads them as bfloat16 to the bit and
    writes the same bytes.  (The JAX package's own loader cannot read such
    a file back: ``jnp.asarray`` refuses ``|V2``, for either package's file.)"""
    jc, pc = _cfgs(CFG, dtype="bfloat16")
    params = _params(pc)
    jparams = {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()}
    jax_sae.SparseAutoencoder(jc, params=jparams).save_model(str(tmp_path / "jax"))
    got = port_sae.SparseAutoencoder.load_from_pretrained(str(tmp_path / "jax"), device="cpu")
    for k, v in jparams.items():
        assert got.params[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(got.params[k].view(torch.int16).numpy(),
                                      np.asarray(v).view(np.int16), err_msg=k)
    got.save_model(str(tmp_path / "port.npz"))
    with np.load(tmp_path / "jax.npz") as zj, np.load(tmp_path / "port.npz") as zp:
        assert sorted(zj.files) == sorted(zp.files)
        assert str(zj["__config__"]) == str(zp["__config__"])
        for k in params:
            assert zj[k].dtype == zp[k].dtype == np.dtype("V2")
            np.testing.assert_array_equal(_words(zp[k]), _words(zj[k]), err_msg=k)
    for name in ("jax", "port"):
        with pytest.raises(TypeError):
            jax_sae.SparseAutoencoder.load_from_pretrained(str(tmp_path / name))


def test_saving_utils_match_jax(tmp_path):
    _, pc = _cfgs(CFG)
    port_saving.save_config_to_file(pc, str(tmp_path / "a" / "port.json"))
    jax_saving.save_config_to_file(pc, str(tmp_path / "b" / "jax.json"))
    assert open(tmp_path / "a" / "port.json").read() == open(tmp_path / "b" / "jax.json").read()
    d = port_saving.load_config_dict(str(tmp_path / "a" / "port.json"))
    assert d == jax_saving.load_config_dict(str(tmp_path / "a" / "port.json"))
    assert set(d) == set(pc.to_dict()) and d["d_in"] == pc.d_in

    class Plain:
        def __init__(self):
            self.a, self.b = 1, "x"
    port_saving.save_config_to_file(Plain(), str(tmp_path / "plain.json"))
    assert port_saving.load_config_dict(str(tmp_path / "plain.json")) == {"a": 1, "b": "x"}


# -- train state and resume -----------------------------------------------------------

@pytest.mark.parametrize("variant", list(VARIANTS))
def test_resume_equals_uninterrupted_run(tmp_path, variant):
    """N steps, save_train_state, a fresh trainer (other weights drawn) with
    load_state, M steps == N + M steps, to the bit: params, moments in their
    dtype, counters, and the host step."""
    base, fields = VARIANTS[variant]
    _, pc = _cfgs(base, **fields)
    n, m = 3, 2
    batches = _batches(pc, n + m, seed=40)
    whole = port_sae.VisionSAETrainer(pc, store=_FixedStore(batches, torch.from_numpy))
    whole.run(max_steps=n + m)

    first = port_sae.VisionSAETrainer(pc, store=_FixedStore(batches, torch.from_numpy))
    first.run(max_steps=n)
    path = port_sae.save_train_state(str(tmp_path / "state"), first.state, pc)
    assert path.endswith(".pt") and os.path.exists(path)
    state, cfg = port_sae.load_train_state(str(tmp_path / "state"), device="cpu")
    assert cfg == pc
    _assert_states_equal(first.state, state)

    rest = _FixedStore(batches, torch.from_numpy)
    rest.i = n
    fresh = port_sae.VisionSAETrainer(pc, store=rest,
                                      generator=torch.Generator().manual_seed(99))
    fresh.load_state(state)
    assert fresh._host_step == n
    fresh.run(max_steps=m)
    _assert_states_equal(whole.state, fresh.state)
    assert fresh._host_step == whole._host_step == n + m


def test_sweep_resume_equals_uninterrupted_run(tmp_path):
    _, pc = _cfgs(SWEEP)
    batches = _batches(pc, 4, seed=50)
    whole = port_sae.SAESweepTrainer(pc, device="cpu")
    for b in batches:
        whole.train_step(torch.from_numpy(b))
    first = port_sae.SAESweepTrainer(pc, device="cpu")
    for b in batches[:2]:
        first.train_step(torch.from_numpy(b))
    path = port_sae.save_train_state(str(tmp_path / "sweep"), first.state, pc)
    state, cfg = port_sae.load_train_state(path, device="cpu")
    fresh = port_sae.SAESweepTrainer(cfg, device="cpu",
                                     generator=torch.Generator().manual_seed(7)).load_state(state)
    for b in batches[2:]:
        fresh.train_step(torch.from_numpy(b))
    _assert_states_equal(whole.state, fresh.state)


def test_jax_train_state_resumes_in_the_port(tmp_path):
    """A JAX state after N steps (mapped by ``train_state_from_jax``), saved
    and loaded by the port, resumes where the JAX run goes on: within the
    step parity tests' bound."""
    jc, pc = _cfgs(CFG)
    batches = _batches(pc, 4, seed=60)
    jstate = jax_sae.init_train_state(jc, params=jax_sae.init_sae_params(
        jc, jax.random.PRNGKey(0)))
    from vit_prisma_tpu.sae.train import sae_train_step as jax_step
    for b in batches[:2]:
        jstate, _ = jax_step(jstate, jnp.asarray(b), jc)
    port = train_state_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
    state, _ = port_sae.load_train_state(port_sae.save_train_state(
        str(tmp_path / "s"), port, pc), device="cpu")
    tr = port_sae.VisionSAETrainer(pc, device="cpu").load_state(state)
    for b in batches[2:]:
        jstate, _ = jax_step(jstate, jnp.asarray(b), jc)
        tr.train_step(torch.from_numpy(b))
    want = train_state_to_numpy(train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                                     device="cpu"))
    got = train_state_to_numpy(tr.state)
    for k in want:
        if k in ("adam_count", "schedule_count", "step", "n_training_tokens"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        elif not k.startswith("nu/"):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL, err_msg=k)


def test_sharded_train_state_raises_naming_parallelism(tmp_path):
    """The sharded train state is ported (it raised here before): at a
    world of one, saved through a mesh and restored whole and into a mesh,
    it equals the state to the bit, beside ``config.json``
    (tests/test_torch_parallel_sae.py saves at 4 ranks and loads at 2 and
    1)."""
    from vit_prisma_tpu_torch.parallel import make_mesh
    from vit_prisma_tpu_torch.sae.train import (load_train_state_sharded,
                                                save_train_state_sharded)
    cfg = port_sae.SAERunnerConfig(d_in=32, expansion_factor=2, adam_dtype="bfloat16")
    state = port_sae.init_train_state(cfg, device="cpu")
    state, _ = port_sae.sae_train_step(state, torch.from_numpy(seeded(3, (64, 32))), cfg)
    mesh = make_mesh(1, 1, device="cpu")
    path = save_train_state_sharded(str(tmp_path / "ckpt"), state, cfg, mesh=mesh)
    assert os.path.exists(os.path.join(path, "config.json"))
    want = train_state_to_numpy(state)
    for kwargs in (dict(device="cpu"), dict(mesh=mesh)):
        back, back_cfg = load_train_state_sharded(path, **kwargs)
        assert back_cfg.to_dict() == cfg.to_dict()
        assert back.opt_state[0].mu["W_dec"].dtype == torch.bfloat16
        for k, v in train_state_to_numpy(back).items():
            np.testing.assert_array_equal(v, want[k], err_msg=k)


# -- trainer checkpoints --------------------------------------------------------------

def _listing(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_trainer_checkpoints_match_jax(tmp_path):
    """n_checkpoints = 2: a save at the token threshold and the "final"
    save, each an SAE file and its log feature sparsity, named as the JAX
    trainer names them; the files agree with JAX's within the step parity
    bound."""
    jc, pc = _cfgs(CFG, n_checkpoints=2, checkpoint_path=str(tmp_path / "jax"))
    pc = pc.replace(checkpoint_path=str(tmp_path / "port"))
    batches = _batches(pc, 5, seed=70)
    jtr = jax_sae.VisionSAETrainer(jc, store=_FixedStore(batches, jnp.asarray))
    ptr = port_sae.VisionSAETrainer(pc, store=_FixedStore(batches, torch.from_numpy))
    ptr.load_state(train_state_from_jax(jax.tree.map(np.asarray, jtr.state), device="cpu"))
    assert ptr.checkpoint_thresholds == jtr.checkpoint_thresholds == [160]
    jtr.run()
    ptr.run()
    names = _listing(tmp_path / "port")
    assert names == _listing(tmp_path / "jax")
    stem = "sparse_autoencoder_custom_blocks.1.hook_resid_post_128"
    assert names == sorted(f"{stem}_{tag}{suffix}" for tag in ("n_tokens_192", "final")
                           for suffix in (".npz", "_log_feature_sparsity.npy"))
    for name in names:
        a, b = tmp_path / "jax" / name, tmp_path / "port" / name
        if name.endswith(".npy"):
            np.testing.assert_allclose(np.load(b), np.load(a), rtol=0, atol=1e-4, err_msg=name)
            continue
        with np.load(a) as za, np.load(b) as zb:
            assert str(za["__config__"]) == str(zb["__config__"]).replace(
                str(tmp_path / "port"), str(tmp_path / "jax"))
            for k in za.files:
                if k != "__config__":
                    np.testing.assert_allclose(zb[k], za[k], rtol=0, atol=ATOL, err_msg=k)


def test_sweep_save_checkpoints(tmp_path):
    _, pc = _cfgs(SWEEP)
    tr = port_sae.SAESweepTrainer(pc, device="cpu")
    tr.train_step(torch.from_numpy(_batches(pc, 1)[0]))
    paths = tr.save_checkpoints(str(tmp_path / "out"))
    assert [os.path.basename(p) for p in paths] == [
        f"sparse_autoencoder_custom_blocks.{l}.hook_resid_post_512" for l in (0, 2)]
    for i, p in enumerate(paths):
        want = tr.sae_for_layer(i)
        got = port_sae.SparseAutoencoder.load_from_pretrained(p, device="cpu")
        jgot = jax_sae.SparseAutoencoder.load_from_pretrained(p)
        assert got.cfg == want.cfg and jgot.cfg.hook_point_layer == (0, 2)[i]
        for k, v in want.params.items():
            assert torch.equal(got.params[k], v), k
            np.testing.assert_array_equal(np.asarray(jgot.params[k]), v.numpy(), err_msg=k)


def test_sweep_threshold_and_final_saves_match_jax(tmp_path):
    jc, pc = _cfgs(SWEEP, n_checkpoints=2, checkpoint_path=str(tmp_path / "jax"))
    pc = pc.replace(checkpoint_path=str(tmp_path / "port"))
    batches = _batches(pc, 5, seed=80)
    from vit_prisma_tpu.sae.train import init_sweep_state as jax_init_sweep
    jstate = jax_init_sweep(jc, 2, key=jax.random.PRNGKey(0))
    jtr = jax_sae.SAESweepTrainer(jc, store=_FixedStore(batches, jnp.asarray))
    jtr.state = jstate
    ptr = port_sae.SAESweepTrainer(pc, store=_FixedStore(batches, torch.from_numpy))
    ptr.load_state(train_state_from_jax(jax.tree.map(np.asarray, jstate), device="cpu"))
    jtr.run()
    ptr.run()
    names = _listing(tmp_path / "port")
    assert names == _listing(tmp_path / "jax")
    assert sorted({n.split(os.sep)[0] for n in names}) == ["sweep_final", "sweep_n_tokens_768"]
    for name in names:
        with np.load(tmp_path / "jax" / name) as za, np.load(tmp_path / "port" / name) as zb:
            for k in za.files:
                if k != "__config__":
                    np.testing.assert_allclose(zb[k], za[k], rtol=0, atol=ATOL, err_msg=k)


class _StubWandb:
    """Records the artifacts a trainer logs, as wandb's API takes them."""

    class Artifact:
        def __init__(self, name, type, metadata=None):
            self.name, self.type, self.files = name, type, []

        def add_file(self, path):
            assert os.path.exists(path), path
            self.files.append(os.path.basename(path))

    def __init__(self):
        self.run = type("Run", (), {"id": "r1"})()
        self.logged = []

    def log_artifact(self, art, aliases=None):
        self.logged.append((art.name, art.type, art.files, aliases))


def test_checkpoint_uploads_wandb_artifacts_as_jax(tmp_path):
    """With ``wandb_checkpoint_artifacts`` both trainers log the SAE file and
    its sparsity as the same two artifacts, under the same names."""
    jc, pc = _cfgs(CFG, wandb_checkpoint_artifacts=True,
                   checkpoint_path=str(tmp_path / "jax"))
    pc = pc.replace(checkpoint_path=str(tmp_path / "port"))
    jtr = jax_sae.VisionSAETrainer(jc)
    ptr = port_sae.VisionSAETrainer(pc, device="cpu")
    jtr._wandb, ptr._wandb = _StubWandb(), _StubWandb()
    jtr.save_checkpoint("t")
    ptr.save_checkpoint("t")
    assert ptr._wandb.logged == jtr._wandb.logged
    name = "sparse_autoencoder_custom_blocks.1.hook_resid_post_128_t"
    assert ptr._wandb.logged == [
        (f"{name}_r1", "model", [f"{name}.npz"], ["latest", "step_0"]),
        (f"{name}_log_feature_sparsity_r1", "log_feature_sparsity",
         [f"{name}_log_feature_sparsity.npy"], None)]
