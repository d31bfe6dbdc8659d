"""The port's sharded SAE steps, the public ``mesh=`` runs (store, refills,
trainers) and the sharded train-state checkpoints, in gloo worlds of 4 and
2 processes on the CPU (``tests/_torch_dist.py``), against the JAX
package's mesh of the same shape on its 8 virtual CPU devices and the
port's world of one, from the same numpy states and batches.

Tolerances are JAX's own (``tests/test_parallel_fused.py``): counters
exact, parameters rtol 2e-4 / atol 2e-5 (3e-4 / 3e-5 over a multistep),
metrics rtol 2e-4 / atol 1e-5, the public runs atol 1e-4; checkpoints to
the bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_prisma_tpu as jax_pkg
import vit_prisma_tpu.sae as jax_sae
import vit_prisma_tpu_torch.sae as port_sae
from tests._torch_dist import public_run, run_world, vit_model
from tests._torch_parity import port_from_jax
from vit_prisma_tpu.parallel import make_mesh as jax_make_mesh
from vit_prisma_tpu.parallel.mesh import shard_sae_sweep_step as jax_sweep_step
from vit_prisma_tpu.parallel.mesh import shard_sae_train_step as jax_train_step
from vit_prisma_tpu.parallel.mesh import batch_sharding as jax_batch_sharding
from vit_prisma_tpu_torch.parallel import mesh as M
from vit_prisma_tpu_torch.sae.convert import train_state_from_jax, train_state_to_numpy
from vit_prisma_tpu_torch.sae.train import (_flatten_state, _unflatten_state,
                                            load_train_state_sharded, save_train_state_sharded)

COUNTERS = ("adam_count", "schedule_count", "step", "n_training_tokens",
            "n_frac_active_tokens", "act_freq_scores", "n_forward_passes_since_fired")
SINGLE = dict(d_in=32, expansion_factor=8, train_batch_size=64, lr=1e-3,
              lr_scheduler_name="constant", b_dec_init_method="zeros", log_to_wandb=False)
L, B, D_IN, D_SAE = 4, 512, 128, 512
SWEEP = dict(d_in=D_IN, expansion_factor=D_SAE // D_IN, train_batch_size=B,
             sweep_layers=tuple(range(L)), lr=1e-3, lr_scheduler_name="constant",
             b_dec_init_method="zeros", log_to_wandb=False, l1_coefficient=1e-4,
             context_size=1)
VARIANTS = {
    "relu": {},
    "topk": dict(activation_fn_str="topk", activation_fn_kwargs=(("k", 16),)),
    "gated": dict(architecture="gated"),
    "ghost": dict(use_ghost_grads=True, dead_feature_window=0),
}


def _single_state(fields, seed=0):
    jc = jax_sae.SAERunnerConfig(**fields)
    return jc, jax_sae.init_train_state(jc, key=jax.random.PRNGKey(seed))


def _sweep_state(fields, seed=0):
    jc = jax_sae.SAERunnerConfig(**fields)
    return jc, jax_sae.init_sweep_state(jc, L, key=jax.random.PRNGKey(seed))


def _port_flat(jax_state):
    return _flatten_state(train_state_from_jax(jax.tree.map(np.asarray, jax_state),
                                               device="cpu"))


def _np_flat(jax_state):
    return train_state_to_numpy(train_state_from_jax(jax.tree.map(np.asarray, jax_state),
                                                     device="cpu"))


def _single_batches(n, seed=1, d=32, b=64):
    return np.random.default_rng(seed).normal(size=(n, b, d)).astype(np.float32)


def _sweep_batches(n, seed=1):
    return np.random.default_rng(seed).normal(size=(n, B, L, D_IN)).astype(np.float32)


def _step_case(name, mesh, kind, variant, n=2):
    if kind.startswith("sweep"):
        fields = {**SWEEP, **VARIANTS[variant]}
        if kind == "sweep_generic":
            fields["fused_sae_step"] = False
        if kind.endswith("multistep"):
            fields["feature_sampling_window"] = 2
        _, js = _sweep_state(fields)
        batches = _sweep_batches(3 if kind.endswith("multistep") else n)
    else:
        fields = {**SINGLE, **VARIANTS[variant]}
        if kind.endswith("multistep"):
            fields["feature_sampling_window"] = 2
        _, js = _single_state(fields)
        batches = _single_batches(3 if kind.endswith("multistep") else n)
    return {"name": name, "mesh": mesh, "kind": kind.replace("sweep_generic", "sweep"),
            "cfg": fields, "state": _port_flat(js), "batches": batches}


STEP_CASES_4 = [
    ("relu_2x2", (2, 2), "single", "relu"), ("relu_4x1", (4, 1), "single", "relu"),
    ("relu_1x4", (1, 4), "single", "relu"), ("topk_1x4", (1, 4), "single", "topk"),
    ("topk_2x2", (2, 2), "single", "topk"), ("gated_2x2", (2, 2), "single", "gated"),
    ("ghost_2x2", (2, 2), "single", "ghost"), ("multi_2x2", (2, 2), "single_multistep", "relu"),
    ("sweep_relu_2x2", (2, 2), "sweep", "relu"), ("sweep_relu_4x1", (4, 1), "sweep", "relu"),
    ("sweep_relu_1x4", (1, 4), "sweep", "relu"), ("sweep_topk_2x2", (2, 2), "sweep", "topk"),
    ("sweep_gated_2x2", (2, 2), "sweep", "gated"),
    ("sweep_generic_2x2", (2, 2), "sweep_generic", "relu"),
    ("sweep_multi_2x2", (2, 2), "sweep_multistep", "relu"),
]
STEP_CASES_2 = [
    ("relu_2x1", (2, 1), "single", "relu"), ("relu_1x2", (1, 2), "single", "relu"),
    ("topk_1x2", (1, 2), "single", "topk"), ("sweep_relu_1x2", (1, 2), "sweep", "relu"),
]

VIT = dict(n_layers=2, d_model=32, d_head=8, n_heads=4, d_mlp=64, patch_size=8,
           image_size=16, n_classes=8, return_type="logits")
VIT_SWEEP = dict(VIT, n_layers=4)
STORE = dict(d_in=32, expansion_factor=8, context_size=5, hook_point_layer=1,
             layer_subtype="hook_resid_post", store_batch_size=8, n_batches_in_buffer=2,
             train_batch_size=40, total_training_images=100_000, lr=1e-3,
             lr_scheduler_name="constant", b_dec_init_method="zeros", log_to_wandb=False,
             feature_sampling_window=10_000)
STORE_SWEEP = dict(STORE, expansion_factor=4, sweep_layers=(0, 1, 2, 3))
PUBLIC_CASES_4 = [
    dict(name="single_2x2", mesh=(2, 2), sae=STORE, steps=4, multistep_k=1, cycles=1),
    dict(name="single_4x1", mesh=(4, 1), sae=dict(STORE, b_dec_init_method="mean"), steps=9),
    dict(name="sweep_2x2", mesh=(2, 2), sae=STORE_SWEEP, steps=9, sweep=True),
]
PUBLIC_CASES_2 = [
    dict(name="single_1x2", mesh=(1, 2), sae=STORE, steps=9),
    dict(name="sweep_1x2", mesh=(1, 2), sae=dict(STORE_SWEEP, b_dec_init_method="mean"),
         steps=5, sweep=True, cycles=1),
]


def _images():
    return np.random.default_rng(0).normal(size=(64, 3, 16, 16)).astype(np.float32)


def _vit(fields):
    jm = jax_pkg.HookedViT(jax_pkg.ViTConfig(**fields), key=jax.random.PRNGKey(0))
    pm = port_from_jax(jm)
    return pm.cfg.to_dict(), {k: v.detach().clone() for k, v in pm.state_dict().items()}


def _public_payload(cases, fields):
    cfg, sd = _vit(fields)
    return {"vit_cfg": cfg, "vit_sd": sd, "images": _images(), "cases": cases}


def _ckpt_state(fields, sweep=False):
    """A state after one step, with bfloat16 Adam moments."""
    fields = {**fields, "adam_dtype": "bfloat16"}
    if sweep:
        jc, js = _sweep_state(fields)
        js, _ = jax_sae.sae_sweep_train_step(js, jnp.asarray(_sweep_batches(1)[0]), jc)
    else:
        jc, js = _single_state(fields)
        js, _ = jax_sae.sae_train_step(js, jnp.asarray(_single_batches(1)[0]), jc)
    return fields, _port_flat(js)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    single_fields, single = _ckpt_state(SINGLE)
    sweep_fields, sweep = _ckpt_state(SWEEP, sweep=True)
    return {"root": root, "single": (single_fields, single), "sweep": (sweep_fields, sweep)}


@pytest.fixture(scope="module")
def world4(tmp_path_factory, ckpt):
    root = ckpt["root"]
    payload = [
        ("sae_step_world", {"cases": [_step_case(*c) for c in STEP_CASES_4]}),
        ("public_world", _public_payload(PUBLIC_CASES_4[:2], VIT)),
        ("public_world", None),  # placeholder replaced below
        ("checkpoint_world", {"save": [
            dict(name="single_2x2", mesh=(2, 2), cfg=ckpt["single"][0], state=ckpt["single"][1],
                 path=str(root / "single_2x2")),
            dict(name="sweep_1x4", mesh=(1, 4), cfg=ckpt["sweep"][0], state=ckpt["sweep"][1],
                 path=str(root / "sweep_1x4"))]}),
    ]
    payload[2] = ("public_world", _public_payload(PUBLIC_CASES_4[2:], VIT_SWEEP))
    out = run_world(tmp_path_factory.mktemp("w4"), 4, "multi_world", payload, timeout=420)[0]
    return out


@pytest.fixture(scope="module")
def world2(tmp_path_factory, ckpt, world4):
    root = ckpt["root"]
    payload = [
        ("sae_step_world", {"cases": [_step_case(*c) for c in STEP_CASES_2]}),
        ("public_world", _public_payload(PUBLIC_CASES_2[:1], VIT)),
        ("checkpoint_world", {
            "save": [dict(name="single_1x2", mesh=(1, 2), cfg=ckpt["single"][0],
                          state=ckpt["single"][1], path=str(root / "single_1x2"))],
            "load": [dict(name="single_2x2@1x2", mesh=(1, 2), path=str(root / "single_2x2")),
                     dict(name="single_2x2@2x1", mesh=(2, 1), path=str(root / "single_2x2")),
                     dict(name="sweep_1x4@2x1", mesh=(2, 1), path=str(root / "sweep_1x4")),
                     dict(name="sweep_1x4@1x2", mesh=(1, 2), path=str(root / "sweep_1x4"))]}),
    ]
    out = run_world(tmp_path_factory.mktemp("w2"), 2, "multi_world", payload, timeout=300)[0]
    sweep2 = run_world(tmp_path_factory.mktemp("w2s"), 2, "public_world",
                       _public_payload(PUBLIC_CASES_2[1:], VIT_SWEEP), timeout=300)[0]
    out["public_world"].update(sweep2)
    return out


# -- references --------------------------------------------------------------

def _port_single_reference(case):
    cfg = port_sae.SAERunnerConfig(**case["cfg"])
    state = _unflatten_state(case["state"])
    sweep = case["kind"].startswith("sweep")
    if case["kind"].endswith("multistep"):
        fn = port_sae.sae_sweep_train_multistep if sweep else port_sae.sae_train_multistep
        state, metrics = fn(state, torch.from_numpy(case["batches"]), cfg)
        return train_state_to_numpy(state), {f: np.asarray(v, np.float32) for f, v in
                                             metrics._asdict().items()}
    step = port_sae.sae_sweep_train_step if sweep else port_sae.sae_train_step
    for b in case["batches"]:
        state, metrics = step(state, torch.from_numpy(b), cfg)
    return train_state_to_numpy(state), {f: v.float().numpy() for f, v in
                                         metrics._asdict().items()}


def _assert_state(want, got, rtol=2e-4, atol=2e-5, where=""):
    assert set(want) == set(got), where
    for k in want:
        if k in COUNTERS:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{where}/{k}")
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                       err_msg=f"{where}/{k}")


def _assert_metrics(want, got, where=""):
    for f in ("loss", "mse_loss", "l1_loss", "l0", "explained_variance",
              "aux_reconstruction_loss", "ghost_grad_loss", "n_dead_features"):
        np.testing.assert_allclose(np.asarray(got[f], np.float32),
                                   np.asarray(want[f], np.float32), rtol=2e-4, atol=1e-5,
                                   err_msg=f"{where}/{f}")


def _check_step_case(case_def, results):
    case = _step_case(*case_def)
    want_state, want_m = _port_single_reference(case)
    got = results["sae_step_world"][case["name"]]
    loose = case["kind"].endswith("multistep")
    _assert_state(want_state, got["state"], 3e-4 if loose else 2e-4, 3e-5 if loose else 2e-5,
                  case["name"])
    _assert_metrics(want_m, got["metrics"], case["name"])
    return case, got


@pytest.mark.parametrize("case", STEP_CASES_4, ids=[c[0] for c in STEP_CASES_4])
def test_sharded_step_world4_matches_world_of_one(world4, case):
    _, got = _check_step_case(case, world4)
    mesh = case[1]
    if case[2].startswith("single"):
        # feature-parallel: W_enc's columns split over model
        assert got["local_W_enc"][1] == 32 * 8 // mesh[1]
    else:
        assert got["local_W_enc"][0] == L // mesh[1]


@pytest.mark.parametrize("case", STEP_CASES_2, ids=[c[0] for c in STEP_CASES_2])
def test_sharded_step_world2_matches_world_of_one(world2, case):
    _check_step_case(case, world2)


def test_sharded_single_step_matches_jax_mesh(world4):
    """JAX's shard_sae_train_step on its (2, 2) mesh, two steps, against the
    port's world of 4."""
    case = _step_case("relu_2x2", (2, 2), "single", "relu")
    jc, js = _single_state(case["cfg"])
    mesh = jax_make_mesh(2, 2)
    place, step = jax_train_step(jc, mesh, js)
    js = place(js)
    for b in case["batches"]:
        js, jm = step(js, jax.device_put(jnp.asarray(b), jax_batch_sharding(mesh)))
    got = world4["sae_step_world"]["relu_2x2"]
    _assert_state(_np_flat(js), got["state"], where="jax mesh")
    _assert_metrics({f: np.asarray(v) for f, v in jm._asdict().items()}, got["metrics"])


@pytest.mark.parametrize("variant", ["relu", "gated"])
def test_sharded_sweep_step_matches_jax_mesh(world4, variant):
    """JAX's shard_map'd fused sweep step on its (2, 2) mesh against the
    port's fused kernels per shard in the world of 4."""
    case = _step_case(f"sweep_{variant}_2x2", (2, 2), "sweep", variant)
    jc, js = _sweep_state(case["cfg"])
    place, step = jax_sweep_step(jc, jax_make_mesh(2, 2), js)
    js = place(js)
    for b in case["batches"]:
        js, jm = step(js, jnp.asarray(b))
    got = world4["sae_step_world"][case["name"]]
    _assert_state(_np_flat(js), got["state"], where="jax mesh")
    _assert_metrics({f: np.asarray(v) for f, v in jm._asdict().items()}, got["metrics"])


# -- public mesh= runs -------------------------------------------------------

def _public_reference(case, fields):
    cfg, sd = _vit(fields)
    return public_run(cfg, sd, case["sae"], _images(), None, case["steps"],
                      sweep=case.get("sweep", False), cycles=case.get("cycles", 0),
                      multistep_k=case.get("multistep_k", 0))


@pytest.mark.parametrize("case", PUBLIC_CASES_4, ids=[c["name"] for c in PUBLIC_CASES_4])
def test_public_mesh_run_world4_matches_world_of_one(world4, case):
    """Store harvest dp x tp, the row-sharded buffer and its refills, the
    trainer's steps (and train_steps, train_cycles): the same global row
    stream and the same trained state as one process."""
    fields = VIT_SWEEP if case.get("sweep") else VIT
    want = _public_reference(case, fields)
    got = world4["public_world"][case["name"]]
    assert got["step"] == want["step"]
    np.testing.assert_allclose(got["peek"], want["peek"], rtol=0, atol=1e-5)
    for k in want["state"]:
        if k in COUNTERS:
            np.testing.assert_array_equal(got["state"][k], want["state"][k], err_msg=k)
        else:
            np.testing.assert_allclose(got["state"][k], want["state"][k], rtol=0, atol=1e-4,
                                       err_msg=k)
    dp = case["mesh"][0]
    assert got["buffer_local"][0] == want["buffer_local"][0] // dp


@pytest.mark.parametrize("case", PUBLIC_CASES_2, ids=[c["name"] for c in PUBLIC_CASES_2])
def test_public_mesh_run_world2_matches_world_of_one(world2, case):
    fields = VIT_SWEEP if case.get("sweep") else VIT
    want = _public_reference(case, fields)
    got = world2["public_world"][case["name"]]
    assert got["step"] == want["step"]
    for k in want["state"]:
        if k in COUNTERS:
            np.testing.assert_array_equal(got["state"][k], want["state"][k], err_msg=k)
        else:
            np.testing.assert_allclose(got["state"][k], want["state"][k], rtol=0, atol=1e-4,
                                       err_msg=k)


def test_public_mesh_run_world_of_one_is_the_unsharded_run():
    """mesh=make_mesh(1, 1) through store and trainer equals no mesh to the
    bit."""
    case = PUBLIC_CASES_4[0]
    cfg, sd = _vit(VIT)
    want = public_run(cfg, sd, case["sae"], _images(), None, 4, cycles=1, multistep_k=1)
    got = public_run(cfg, sd, case["sae"], _images(), M.make_mesh(1, 1, device="cpu"), 4,
                     cycles=1, multistep_k=1)
    for k in want["state"]:
        np.testing.assert_array_equal(got["state"][k], want["state"][k], err_msg=k)
    np.testing.assert_array_equal(got["peek"], want["peek"])


# -- sharded checkpoints -----------------------------------------------------

def _whole(ckpt, name):
    return train_state_to_numpy(_unflatten_state(ckpt[name][1]))


def _assert_bitwise(want, got, where=""):
    assert set(want) == set(got), where
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{where}/{k}")


@pytest.mark.parametrize("name", ["single_2x2", "sweep_1x4"])
def test_checkpoint_round_trip_world4(world4, name):
    same, same_cfg = world4["checkpoint_world"][("roundtrip", name)]
    assert same and same_cfg


def test_checkpoint_round_trip_world2(world2):
    same, same_cfg = world2["checkpoint_world"][("roundtrip", "single_1x2")]
    assert same and same_cfg


@pytest.mark.parametrize("name,src", [("single_2x2@1x2", "single"), ("single_2x2@2x1", "single"),
                                      ("sweep_1x4@2x1", "sweep"), ("sweep_1x4@1x2", "sweep")])
def test_checkpoint_saved_at_4_loads_at_2(ckpt, world2, name, src):
    _assert_bitwise(_whole(ckpt, src), world2["checkpoint_world"][("load", name)], name)


@pytest.mark.parametrize("src,dirname", [("single", "single_2x2"), ("sweep", "sweep_1x4")])
def test_checkpoint_saved_at_4_loads_at_1(ckpt, world4, src, dirname):
    """Whole (no mesh), and into a world of one's mesh."""
    path = str(ckpt["root"] / dirname)
    state, cfg = load_train_state_sharded(path, device="cpu")
    assert cfg.to_dict() == port_sae.SAERunnerConfig(**ckpt[src][0]).to_dict()
    _assert_bitwise(_whole(ckpt, src), train_state_to_numpy(state), "whole")
    assert state.opt_state[0].mu["W_enc"].dtype == torch.bfloat16
    local, _ = load_train_state_sharded(path, mesh=M.make_mesh(1, 1, device="cpu"))
    _assert_bitwise(_whole(ckpt, src), train_state_to_numpy(local), "mesh (1, 1)")


def test_checkpoint_round_trip_world1(ckpt, tmp_path):
    fields, flat = ckpt["single"]
    state = _unflatten_state(flat)
    cfg = port_sae.SAERunnerConfig(**fields)
    path = save_train_state_sharded(str(tmp_path / "w1"), state, cfg)
    assert (tmp_path / "w1" / "config.json").exists()
    back, cfg2 = load_train_state_sharded(path, device="cpu")
    assert cfg2.to_dict() == cfg.to_dict()
    for k, v in _flatten_state(state).items():
        got = _flatten_state(back)[k]
        assert got.dtype == v.dtype and torch.equal(got, v), k


def test_cached_activations_through_a_mesh_equal_the_unsharded_store(tmp_path):
    """``generate_cached_activations`` under a mesh (the harvest split over
    ``data``, the chunk exchanged whole, one rank writing) writes the
    unsharded store's shards, at a world of one."""
    from vit_prisma_tpu_torch.sae import VisionActivationsStore
    cfg, sd = _vit(VIT)
    scfg = port_sae.SAERunnerConfig(**STORE)
    paths = {}
    for name, mesh in (("plain", None), ("mesh", M.make_mesh(1, 1, device="cpu"))):
        store = VisionActivationsStore(scfg, vit_model(cfg, sd), _images(), mesh=mesh)
        assert store.generate_cached_activations(str(tmp_path / name), 130,
                                                 tokens_per_file=50) == 3
        paths[name] = tmp_path / name
    for i in range(3):
        np.testing.assert_array_equal(np.load(paths["mesh"] / f"{i}.npy"),
                                      np.load(paths["plain"] / f"{i}.npy"))
