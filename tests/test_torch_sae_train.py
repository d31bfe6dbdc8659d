"""The port's SAE train step, multi-step loop and trainer against the JAX
package's, from the same state on the same batches; then the slice as a
whole (HookedViT -> activation store -> trainer) across a refill; and the
port's promise to import no JAX.

Adam's first steps move each weight by about lr * sign(g), so a near-zero
gradient whose sign differs between the two frameworks moves that weight by
up to 2 lr.  One step is held tightly; the multi-step trajectories have a
stated looser bound."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_prisma_tpu.sae as jax_sae
import vit_prisma_tpu_torch.sae as port_sae
from tests._torch_parity import assert_close, jax_and_port, seeded
from tests.test_torch_store import STORE, VIT, _jax_permutations
from vit_prisma_tpu.sae.train import sae_train_multistep as jax_multistep
from vit_prisma_tpu.sae.train import sae_train_step as jax_step
from vit_prisma_tpu_torch.sae.convert import train_state_from_jax, train_state_to_numpy

CFG = dict(d_in=32, expansion_factor=4, train_batch_size=64, l1_coefficient=1e-3,
           lr=1e-3, lr_warm_up_steps=3, total_training_images=100_000,
           context_size=5, model_name="custom", hook_point_layer=1)
STEP_VARIANTS = {
    "defaults": {},
    "adam_bf16": dict(adam_dtype="bfloat16"),
    "no_clip_constant_lr": dict(max_grad_norm=None, lr_scheduler_name="constant"),
    "tanh_relu_l2": dict(activation_fn_str="tanh-relu", lp_norm=2.0),
}
COUNTERS = ("adam_count", "schedule_count", "step", "n_training_tokens",
            "n_frac_active_tokens", "act_freq_scores", "n_forward_passes_since_fired")


def _cfgs(**fields):
    fields = {**CFG, **fields}
    return jax_sae.SAERunnerConfig(**fields), port_sae.SAERunnerConfig(**fields)


def _jax_state(jc, seed=0):
    params = dict(jax_sae.init_sae_params(jc, jax.random.PRNGKey(seed)))
    params["b_dec"] = jnp.asarray(seeded(seed + 1, (jc.d_in,), 0.2))
    return jax_sae.init_train_state(jc, params=params)


def _flat(jax_state):
    return train_state_to_numpy(train_state_from_jax(jax.tree.map(np.asarray, jax_state),
                                                     device="cpu"))


def _assert_states_close(want, got, atol, moment_atol=None, exact_counters=True):
    assert set(want) == set(got)
    for k in want:
        if k in COUNTERS:
            if exact_counters:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            continue
        tol = moment_atol if (moment_atol is not None and k[:3] in ("mu/", "nu/")) else atol
        if k.startswith("nu/"):
            tol = tol * max(1e-3, float(np.abs(want[k]).max()))
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol, err_msg=k)


def _batches(jc, n, seed=20):
    return [seeded(seed + i, (jc.train_batch_size, jc.d_in), 1.5) + 0.3 for i in range(n)]


@pytest.mark.parametrize("variant", list(STEP_VARIANTS))
def test_train_step_matches_jax(variant):
    jc, pc = _cfgs(**STEP_VARIANTS[variant])
    jstate = _jax_state(jc)
    pstate = train_state_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
    x = _batches(jc, 1)[0]
    W_enc_before = pstate.params["W_enc"].clone()
    jnew, jm = jax_step(jstate, jnp.asarray(x), jc)  # donates jstate
    pnew, pm = port_sae.sae_train_step(pstate, torch.from_numpy(x), pc)
    # One step from one state: the grads agree to float32 GEMM rounding, and
    # Adam's first step is lr * g / (|g| + eps), so params within 1e-6 (lr
    # 1e-3 times a relative grad error far below 1e-3); the moments are
    # (1-b1) g and (1-b2) g^2, relative 1e-5 of their largest entry (bf16
    # moments: one bf16 ulp, 2^-8).
    rel = 2.0 ** -8 if pc.adam_dtype == "bfloat16" else 1e-5
    got, want = train_state_to_numpy(pnew), _flat(jnew)
    for k in want:
        if k.startswith(("mu/", "nu/")):
            tol = rel * float(np.abs(want[k]).max())
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol, err_msg=k)
    _assert_states_close(want, got, atol=1e-6, moment_atol=np.inf)
    for field in jm._fields:
        assert_close(getattr(jm, field), getattr(pm, field), 1e-5, field)
    # the input state is left as it was
    assert torch.equal(pstate.params["W_enc"], W_enc_before)


def test_multistep_with_window_resets_matches_jax():
    jc, pc = _cfgs(feature_sampling_window=2)
    jstate = _jax_state(jc, seed=3)
    pstate = train_state_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
    xs = np.stack(_batches(jc, 5, seed=40))
    jnew, jm = jax_multistep(jstate, jnp.asarray(xs), jc)
    pnew, pm = port_sae.sae_train_multistep(pstate, torch.from_numpy(xs), pc)
    # Five Adam steps: see the module docstring; 2 lr per step bounds a sign
    # flip, and none is expected at these sizes, so 1e-5 is held.
    _assert_states_close(_flat(jnew), train_state_to_numpy(pnew), atol=1e-5)
    assert float(pnew.n_frac_active_tokens) == 64.0  # reset after step 4
    for field in jm._fields:
        assert getattr(pm, field).shape == (5,)
        assert_close(getattr(jm, field), getattr(pm, field), 1e-5, field)


class _FixedStore:
    """Serves the same batches to either package's trainer."""

    def __init__(self, batches, to):
        self.batches, self.i = [to(b) for b in batches], 0
        self.device = torch.device("cpu")
        self._to = to
        self._sample = np.concatenate(batches)

    def next_batch(self):
        self.i += 1
        return self.batches[self.i - 1]

    def peek_tokens(self, n):
        return self._to(self._sample[:n])


def _recording(trainer, log):
    inner = trainer.log_metrics

    def log_metrics(metrics, step=None):
        vals = inner(metrics, step)
        log.append(vals)
        return vals
    trainer.log_metrics = log_metrics


def test_trainer_run_matches_jax():
    jc, pc = _cfgs(wandb_log_frequency=1, feature_sampling_window=3)
    batches = _batches(jc, 5, seed=60)
    jtr = jax_sae.VisionSAETrainer(jc, store=_FixedStore(batches, jnp.asarray))
    ptr = port_sae.VisionSAETrainer(pc, store=_FixedStore(batches, torch.from_numpy))
    # the geometric-median b_dec init on the same sample (Weiszfeld sums in
    # another order)
    assert_close(jtr.state.params["b_dec"], ptr.state.params["b_dec"], 1e-5, "b_dec init")
    ptr.load_state(train_state_from_jax(jax.tree.map(np.asarray, jtr.state), device="cpu"))
    jlog, plog = [], []
    _recording(jtr, jlog)
    _recording(ptr, plog)
    jtr.run(max_steps=5)
    sae = ptr.run(max_steps=5)
    assert isinstance(sae, port_sae.SparseAutoencoder)
    _assert_states_close(_flat(jtr.state), train_state_to_numpy(ptr.state), atol=1e-5)
    assert len(plog) == len(jlog) == 5
    for j, p in zip(jlog, plog):
        assert set(p) == set(j)
        for k in j:
            assert abs(p[k] - j[k]) <= 1e-5 * max(1.0, abs(j[k])), k
    assert ptr._host_step == 5 and int(ptr.state.step) == 5


def test_slice_end_to_end_matches_jax():
    """HookedViT -> activation store -> trainer in both packages, 12 steps
    across one refill, with the JAX store's permutations replayed."""
    fields = {**STORE, **CFG, "train_batch_size": 20, "wandb_log_frequency": 4,
              "b_dec_init_method": "geometric_median"}
    jc, pc = jax_sae.SAERunnerConfig(**fields), port_sae.SAERunnerConfig(**fields)
    jax_model, port_model = jax_and_port(**VIT)
    images = seeded(9, (64, 3, 16, 16))
    perms = iter(_jax_permutations(fields["seed"], pc.tokens_per_buffer, 3))
    jstore = jax_sae.VisionActivationsStore(jc, jax_model, images)
    pstore = port_sae.VisionActivationsStore(pc, port_model, images,
                                             permutation=lambda n: next(perms))
    jtr = jax_sae.VisionSAETrainer(jc, jax_model, jstore)
    ptr = port_sae.VisionSAETrainer(pc, port_model, pstore)
    ptr.load_state(train_state_from_jax(jax.tree.map(np.asarray, jtr.state), device="cpu"))
    jtr.run(max_steps=12)
    ptr.run(max_steps=12)
    assert pstore.ptr == jstore.ptr == 40  # refilled at step 11
    # The harvested rows differ by up to 1e-4 (HARVEST_ATOL), so the grads
    # differ by about that relative amount; 12 Adam steps at lr <= 1e-3
    # stay within 1e-4 unless a gradient sign flips, which would cost 2 lr.
    got, want = train_state_to_numpy(ptr.state), _flat(jtr.state)
    _assert_states_close(want, got, atol=1e-4, exact_counters=False)
    for k in ("adam_count", "schedule_count", "step", "n_training_tokens",
              "n_frac_active_tokens"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # a feature's fired/act-freq count changes only where a pre-activation
    # lies within the harvest difference of zero
    assert np.abs(got["act_freq_scores"] - want["act_freq_scores"]).sum() <= 3


def test_train_state_from_jax_maps_every_leaf():
    jc, pc = _cfgs(adam_dtype="bfloat16")
    jstate, _ = jax_step(_jax_state(jc), jnp.asarray(_batches(jc, 1)[0]), jc)
    np_state = jax.tree.map(np.asarray, jstate)
    port = train_state_from_jax(np_state, device="cpu")
    adam, sched = port.opt_state
    assert port.params["W_enc"].dtype == torch.float32
    assert adam.mu["W_dec"].dtype == torch.bfloat16 and adam.count.dtype == torch.int32
    flat = train_state_to_numpy(port)
    np.testing.assert_array_equal(flat["nu/W_dec"],
                                  np.asarray(np_state.opt_state[0].nu["W_dec"], np.float32))
    np.testing.assert_array_equal(flat["params/b_enc"], np_state.params["b_enc"])
    assert int(flat["adam_count"]) == int(flat["schedule_count"]) == int(flat["step"]) == 1
    assert int(flat["n_training_tokens"]) == 64


@pytest.mark.parametrize("fields,kwargs,item", [
    (dict(n_checkpoints=2), {}, None),
    ({}, dict(mesh="world of one"), "item 15"),
])
def test_trainer_options_not_ported_raise(fields, kwargs, item):
    """Both options are ported (they raised here before).  ``n_checkpoints``
    (test_torch_checkpoints.py holds the saves against JAX's): both trainers
    build with it and take JAX's token thresholds.  ``mesh=``: at a world of
    one both trainers' sharded steps equal the unsharded steps to the bit
    (tests/test_torch_parallel_sae.py runs worlds of 2 and 4)."""
    jc, pc = _cfgs(**fields)
    if item is None:
        tr = port_sae.VisionSAETrainer(pc, device="cpu")
        assert tr.checkpoint_thresholds == jax_sae.VisionSAETrainer(jc).checkpoint_thresholds
        sweep = port_sae.SAESweepTrainer(pc.replace(sweep_layers=(0, 1)), device="cpu")
        assert len(sweep.checkpoint_thresholds) == 1
        return
    from vit_prisma_tpu_torch.parallel import make_mesh
    batch = torch.from_numpy(_batches(jc, 1)[0])
    for cls, cfg, x in ((port_sae.VisionSAETrainer, pc, batch),
                        (port_sae.SAESweepTrainer, pc.replace(sweep_layers=(0, 1)),
                         torch.stack([batch, batch * 0.5], dim=1))):
        plain = cls(cfg, device="cpu")
        sharded = cls(cfg, device="cpu", mesh=make_mesh(1, 1, device="cpu"))
        assert sharded.mesh is not None and plain.mesh is None
        for _ in range(2):
            want, got = plain.train_step(x), sharded.train_step(x)
        for a, b in zip(want, got):
            assert torch.equal(a, b)
        for a, b in zip(train_state_to_numpy(plain.state).values(),
                        train_state_to_numpy(sharded.whole_state()).values()):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fields", [dict(n_validation_runs=2), dict(log_to_wandb=True)],
                         ids=["n_validation_runs", "log_to_wandb"])
def test_trainer_validation_options_run(monkeypatch, fields):
    """Validation and wandb are ported: both trainers build with them, and
    without a model and eval data ``validate()`` has nothing to do (wandb is
    not installed here, so it is left off); ``test_torch_evals.py`` holds
    them against the JAX trainers.  wandb is made unimportable for the test:
    the reference oracle of other test files, run earlier in the same
    worker, stubs it."""
    monkeypatch.setitem(sys.modules, "wandb", None)
    jc, pc = _cfgs(**fields)
    for cls, jcls, c, j in ((port_sae.VisionSAETrainer, jax_sae.VisionSAETrainer, pc, jc),
                            (port_sae.SAESweepTrainer, jax_sae.SAESweepTrainer,
                             pc.replace(sweep_layers=(0, 1)), jc.replace(sweep_layers=(0, 1)))):
        tr, jtr = cls(c, device="cpu"), jcls(j)
        assert tr.validation_thresholds == jtr.validation_thresholds
        assert len(tr.validation_thresholds) == c.n_validation_runs - (c.n_validation_runs > 0)
        assert tr._wandb is None and tr.validate() is None and jtr.validate() is None


def test_import_loads_no_jax_including_sae():
    code = ("import sys, vit_prisma_tpu_torch, vit_prisma_tpu_torch.sae, "
            "vit_prisma_tpu_torch.ops.shuffle, vit_prisma_tpu_torch.ops.opt_step, "
            "vit_prisma_tpu_torch.ops.sae_step; "
            "bad = sorted(m for m in sys.modules "
            "if m.startswith('jax') or m.startswith('vit_prisma_tpu.') "
            "or m in ('vit_prisma_tpu', 'optax')); "
            "assert not bad, bad")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=root)
