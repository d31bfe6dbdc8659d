"""The all-layer sweep in the port against the JAX package: the sweep step
(fused and generic), the multi-step loop with window resets, the sweep
store, the fused cycle and ``SAESweepTrainer``.

The SAE shapes are the JAX package's tile-aligned ones (d_in 128, d_sae
512, B 256, L = 2), so the fused path (kernels B4-B6, their plain versions
on the CPU; Pallas in interpret mode on the JAX side) is taken.  The model
is a 3-layer, 128-wide ViT on 16-pixel images (5 tokens an image)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_prisma_tpu.ops.opt_step as jax_opt_step
import vit_prisma_tpu.sae as jax_sae
import vit_prisma_tpu_torch.sae as port_sae
import vit_prisma_tpu_torch.sae.train as port_train
from tests._torch_parity import assert_close, jax_and_port, seeded
from tests.test_torch_sae_train import _assert_states_close, _flat
from tests.test_torch_store import _jax_permutations
from vit_prisma_tpu_torch.sae.store import _index_iterator
from vit_prisma_tpu.sae.train import init_sweep_state as jax_init_sweep
from vit_prisma_tpu.sae.train import sae_sweep_train_multistep as jax_multistep
from vit_prisma_tpu.sae.train import sae_sweep_train_step as jax_step
from vit_prisma_tpu_torch.sae.convert import train_state_from_jax, train_state_to_numpy
from vit_prisma_tpu_torch.sae.train import _fused_step_ok

L, BS, D_IN = 2, 256, 128
CFG = dict(d_in=D_IN, expansion_factor=4, train_batch_size=BS, lr=1e-3,
           lr_scheduler_name="constant", b_dec_init_method="zeros", l1_coefficient=1e-3,
           context_size=5, model_name="custom", sweep_layers=(0, 2))
VIT = dict(n_layers=3, d_model=D_IN, d_head=32, n_heads=4, d_mlp=256, patch_size=8,
           image_size=16, n_classes=7)
# 1,024-row buffer: two batches per half; harvests of 16 images (80 rows).
STORE = dict(buffer_tokens_override=1024, store_batch_size=16, seed=5)
# The harvest forwards agree per hook within 1e-4 in float32
# (test_torch_vit.py); the store only moves rows.
HARVEST_ATOL = 1e-4


def _cfgs(**fields):
    fields = {**CFG, **fields}
    return jax_sae.SAERunnerConfig(**fields), port_sae.SAERunnerConfig(**fields)


def _jax_state(jc, seed=0):
    state = jax_init_sweep(jc, L, key=jax.random.PRNGKey(seed))
    params = dict(state.params)
    params["b_dec"] = jnp.asarray(seeded(seed + 1, (L, D_IN), 0.2))
    return state._replace(params=params)


def _batches(n, seed=20):
    return [seeded(seed + i, (BS, L, D_IN), 1.5) + 0.3 for i in range(n)]


def _metrics_close(jm, pm, atol, rel):
    for field in jm._fields:
        want = np.asarray(getattr(jm, field), np.float32)
        got = getattr(pm, field).float().numpy()
        assert got.shape == want.shape, field
        np.testing.assert_allclose(got, want, rtol=rel, atol=atol, err_msg=field)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "generic"])
def test_sweep_steps_match_jax(fused):
    jc, pc = _cfgs(fused_sae_step=fused)
    assert _fused_step_ok(pc, BS, L) == fused
    jstate = _jax_state(jc)
    pstate = train_state_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
    assert pstate.params["W_enc"].shape == (L, D_IN, 4 * D_IN)
    assert pstate.step.shape == (L,) and pstate.act_freq_scores.shape == (L, 4 * D_IN)
    for b in _batches(3):
        jstate, jm = jax_step(jstate, jnp.asarray(b), jc)
        pstate, pm = port_sae.sae_sweep_train_step(pstate, torch.from_numpy(b), pc)
        # the metrics of one step from the same params: float32 sums in
        # other orders, relative 1e-5
        _metrics_close(jm, pm, atol=1e-6, rel=1e-5)
    # Three Adam steps from one state, float32 grads to GEMM rounding: params
    # and moments within 1e-5 (see test_torch_sae_train.py); the counters,
    # which count pre-activations above 0, are equal.
    _assert_states_close(_flat(jstate), train_state_to_numpy(pstate), atol=1e-5)


def test_sweep_fused_and_generic_agree():
    """The port's fused step against its own generic step, as the JAX
    package's test_fused_step_matches_generic: counters equal, params within
    its bound (rtol 1e-4, atol 2e-5)."""
    jc, pc = _cfgs()
    states = {}
    for fused in (True, False):
        s = train_state_from_jax(jax.tree.map(np.asarray, _jax_state(jc)), device="cpu")
        for b in _batches(3, seed=30):
            s, _ = port_sae.sae_sweep_train_step(s, torch.from_numpy(b),
                                                 pc.replace(fused_sae_step=fused))
        states[fused] = train_state_to_numpy(s)
    for k in ("act_freq_scores", "n_forward_passes_since_fired"):
        np.testing.assert_array_equal(states[True][k], states[False][k], err_msg=k)
    for k in states[True]:
        if k.startswith("params/"):
            np.testing.assert_allclose(states[True][k], states[False][k], rtol=1e-4,
                                       atol=2e-5, err_msg=k)


def test_sweep_multistep_with_window_resets_matches_singles_and_jax():
    jc, pc = _cfgs(feature_sampling_window=2)
    xs = np.stack(_batches(4, seed=40))
    jnew, jm = jax_multistep(_jax_state(jc, seed=3), jnp.asarray(xs), jc)
    start = train_state_from_jax(jax.tree.map(np.asarray, _jax_state(jc, seed=3)),
                                 device="cpu")
    pnew, pm = port_sae.sae_sweep_train_multistep(start, torch.from_numpy(xs), pc)
    assert pm.loss.shape == (4, L)
    _assert_states_close(_flat(jnew), train_state_to_numpy(pnew), atol=1e-5)
    assert pnew.n_frac_active_tokens.tolist() == [0.0, 0.0]  # reset after step 4
    for field in jm._fields:
        np.testing.assert_allclose(getattr(pm, field).float().numpy(),
                                   np.asarray(getattr(jm, field), np.float32),
                                   rtol=1e-5, atol=1e-6, err_msg=field)
    # singles with the host-side resets reach the same state bitwise
    single = start
    for j, x in enumerate(xs):
        single, _ = port_sae.sae_sweep_train_step(single, torch.from_numpy(x), pc)
        if (j + 1) % pc.feature_sampling_window == 0:
            single = port_sae.reset_sparsity_counters(single)
    got, want = train_state_to_numpy(single), train_state_to_numpy(pnew)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_sweep_step_bf16_compute_matches_jax(monkeypatch):
    jc, pc = _cfgs(compute_dtype="bfloat16")
    jstate = _jax_state(jc, seed=5)
    pstate = train_state_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
    b = _batches(1, seed=50)[0]
    # the grads each step hands to its clip/project/Adam pass (the JAX step
    # imports its optimizer at call time, unjitted here so the grads are
    # concrete)
    grads = {}

    def recording(mod, key, take):
        inner = getattr(mod, "fused_clip_project_adam")

        def wrapper(*a, **k):
            grads[key] = {n: np.array(g, np.float32) for n, g in take(a, k).items()}
            return inner(*a, **k)
        monkeypatch.setattr(mod, "fused_clip_project_adam", wrapper)
    recording(jax_opt_step, "jax", lambda a, k: k["grads"])
    recording(port_train, "port", lambda a, k: {n: g.detach() for n, g in a[1].items()})
    with jax.disable_jit():
        jnew, jm = jax_step(jstate, jnp.asarray(b), jc)
    pnew, pm = port_sae.sae_sweep_train_step(pstate, torch.from_numpy(b), pc)
    assert pnew.params["W_enc"].dtype == torch.float32
    # The grads reach the float32 masters through the cast to bf16, so they
    # are bf16 values, as JAX's are; the two differ by bf16 products summed
    # in other orders, one bf16 ulp of the largest gradient (4e-3 of it
    # seen): within 1e-2 of the largest |JAX gradient| of each tensor.
    assert sorted(grads["port"]) == sorted(grads["jax"])
    for k, want in grads["jax"].items():
        got = grads["port"][k]
        np.testing.assert_array_equal(got, got.astype(jnp.bfloat16).astype(np.float32),
                                      err_msg=f"{k} grads are not bf16-rounded")
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-2 * np.abs(want).max(),
                                   err_msg=k)
    # bf16 products rounded in other places: the losses within 2e-2
    # relative, EV and L0 within 2e-2 of their scale.
    _metrics_close(jm, pm, atol=2e-2, rel=2e-2)
    # One Adam step moves each weight by lr * g / |g| (+-1e-3 here); a bf16
    # gradient whose sign differs moves it the other way, 2 lr apart.  The
    # mean difference stays far below that.
    got, want = train_state_to_numpy(pnew), _flat(jnew)
    for k in ("params/W_enc", "params/W_dec", "params/b_enc", "params/b_dec"):
        d = np.abs(got[k] - want[k])
        assert d.max() <= 2 * pc.lr + 1e-6, k
        assert d.mean() <= 0.1 * pc.lr, k
    np.testing.assert_array_equal(got["step"], want["step"])
    # a bf16 rounding can switch a pre-activation within rounding of 0
    flips = np.abs(got["act_freq_scores"] - want["act_freq_scores"]).sum()
    assert flips <= 1e-3 * BS * got["act_freq_scores"].size


# -- the sweep store -------------------------------------------------------------

def _stores(jc, pc, n_images=64):
    jax_model, port_model = jax_and_port(**VIT)
    images = seeded(9, (n_images, 3, 16, 16))
    perms = _jax_permutations(pc.seed, pc.tokens_per_buffer, 4)
    jstore = jax_sae.VisionActivationsStore(jc, jax_model, images, prefetch=False)
    pstore = port_sae.VisionActivationsStore(
        pc, port_model, images, permutation=lambda n, it=iter(perms): next(it))
    pstore.perms = perms
    return jax_model, port_model, jstore, pstore, images


def test_sweep_store_rows_match_jax_across_a_refill():
    jc, pc = _cfgs(**STORE)
    _, port_model, jstore, pstore, images = _stores(jc, pc)
    n = pc.tokens_per_buffer
    assert tuple(pstore.buffer.shape) == tuple(jstore.buffer.shape) == (n, L, D_IN)
    assert pstore._hook_names == ["blocks.0.hook_resid_post", "blocks.2.hook_resid_post"]
    assert_close(jstore.buffer, pstore.buffer, HARVEST_ATOL, "buffer after init")
    for slot in (None, 0, 1):
        assert_close(jstore.peek_tokens(100, layer_slot=slot),
                     pstore.peek_tokens(100, layer_slot=slot), HARVEST_ATOL, f"slot {slot}")
    rows = pstore.get_activations(torch.from_numpy(images[:2]))
    _, cache = port_model.run_with_cache(torch.from_numpy(images[:2]),
                                         names_filter=pstore._hook_names)
    assert tuple(rows.shape) == (10, L, D_IN)
    for slot, name in enumerate(pstore._hook_names):
        assert torch.equal(rows[:, slot], cache[name].reshape(-1, D_IN))
    for i in range(2):
        assert_close(jstore.next_batch(), pstore.next_batch(), HARVEST_ATOL, f"batch {i}")
    before = pstore.buffer.clone()
    for i in range(2):  # the first crosses the refill
        assert_close(jstore.next_batches(1), pstore.next_batches(1), HARVEST_ATOL,
                     f"refill batch {i}")
    assert_close(jstore.buffer, pstore.buffer, HARVEST_ATOL, "buffer after refill")

    # Bitwise inside the port: the fresh [rows, L, d] are the next images'
    # harvest, and the mix is the replayed permutation of [kept, fresh].
    n_fill = -(-n // pstore.tokens_per_store_batch)
    n_fresh = -(-(n // 2) // pstore.tokens_per_store_batch)
    order = _index_iterator(len(images), pc.store_batch_size, seed=pc.seed)
    batches = [next(order) for _ in range(n_fill + n_fresh)][n_fill:]
    fresh = torch.cat([pstore.get_activations(images[b]) for b in batches])[:n // 2]
    merged = torch.cat([before[n // 2:], fresh])
    assert torch.equal(pstore.buffer, merged[pstore.perms[1]])


def test_store_next_cycle_indices_follow_the_refill_stream():
    jc, pc = _cfgs(**STORE)
    *_, pstore, images = _stores(jc, pc)
    twin = port_sae.VisionActivationsStore(pc, pstore.model, images,
                                           permutation=lambda n: torch.arange(n))
    assert pstore.fused_cycle_available
    idx = pstore.next_cycle_indices()
    half = pc.tokens_per_buffer // 2
    assert idx.shape == (-(-half // pstore.tokens_per_store_batch), pc.store_batch_size)
    # the twin's next refill reads the same images
    batches = [next(twin._idx_iter) for _ in range(idx.shape[0])]
    np.testing.assert_array_equal(idx, np.stack(batches))
    host = port_sae.VisionActivationsStore(pc, pstore.model, list(images),
                                           permutation=lambda n: torch.arange(n))
    assert not host.fused_cycle_available


# -- the trainer -------------------------------------------------------------------

class _FixedStore:
    """Serves the same [B, L, d] batches to either package's trainer."""

    def __init__(self, batches, to):
        self.batches, self.i, self._to = [to(b) for b in batches], 0, to
        self.device = torch.device("cpu")

    def next_batch(self):
        self.i += 1
        return self.batches[self.i - 1]

    def next_batches(self, k):
        out = self.batches[self.i:self.i + k]
        self.i += k
        return jnp.stack(out) if self._to is jnp.asarray else torch.stack(out)


def _recording(trainer, log):
    inner = trainer.log_metrics

    def log_metrics(metrics, step=None):
        vals = inner(metrics, step)
        log.append(vals)
        return vals
    trainer.log_metrics = log_metrics


def test_sweep_trainer_run_matches_jax():
    jc, pc = _cfgs(wandb_log_frequency=1, feature_sampling_window=3, steps_per_dispatch=2)
    batches = _batches(5, seed=60)
    jtr = jax_sae.SAESweepTrainer(jc, store=_FixedStore(batches, jnp.asarray))
    ptr = port_sae.SAESweepTrainer(pc, store=_FixedStore(batches, torch.from_numpy))
    assert ptr.state.params["W_dec"].shape == (L, 4 * D_IN, D_IN)
    ptr.load_state(train_state_from_jax(jax.tree.map(np.asarray, _jax_state(jc)),
                                        device="cpu"))
    jtr.state = _jax_state(jc)
    jlog, plog = [], []
    _recording(jtr, jlog)
    _recording(ptr, plog)
    jtr.run(max_steps=5)
    saes = ptr.run(max_steps=5)
    assert [s.cfg.hook_point_layer for s in saes] == [0, 2]
    assert isinstance(saes[1], port_sae.SparseAutoencoder)
    assert torch.equal(saes[1].W_enc, ptr.state.params["W_enc"][1])
    _assert_states_close(_flat(jtr.state), train_state_to_numpy(ptr.state), atol=1e-5)
    assert len(plog) == len(jlog) == 5
    for j, p in zip(jlog, plog):
        assert set(p) == set(j) and "layer_2/l0" in p
        for k in j:
            assert abs(p[k] - j[k]) <= 1e-5 * max(1.0, abs(j[k])), k
    assert ptr._host_step == 5 and ptr.state.step.tolist() == [5, 5]


@pytest.mark.parametrize("fields,layer", [(dict(min_l0=1e9), 0),
                                          (dict(min_explained_variance=-1e9), None)],
                         ids=["l0_below", "within"])
def test_sweep_trainer_abort_names_the_layer(fields, layer):
    _, pc = _cfgs(wandb_log_frequency=1, **fields)
    tr = port_sae.SAESweepTrainer(pc, store=_FixedStore(_batches(2), torch.from_numpy))
    if layer is None:
        tr.run(max_steps=2)
        assert tr.check_run_tolerance(tr.train_step(tr.store.batches[0])) is None
    else:
        with pytest.raises(RuntimeError, match="sweep layer 0 below quality"):
            tr.run(max_steps=2)


def test_sweep_slice_end_to_end_matches_jax():
    """HookedViT -> sweep store -> SAESweepTrainer in both packages, 5 steps
    across a refill, with the JAX store's permutations replayed and the
    per-layer mean b_dec init from peek_tokens(layer_slot=)."""
    jc, pc = _cfgs(b_dec_init_method="mean", steps_per_dispatch=2, wandb_log_frequency=2,
                   **STORE)
    jax_model, port_model, jstore, pstore, _ = _stores(jc, pc)
    jtr = jax_sae.SAESweepTrainer(jc, jax_model, jstore)
    ptr = port_sae.SAESweepTrainer(pc, port_model, pstore)
    assert_close(jtr.state.params["b_dec"], ptr.state.params["b_dec"], HARVEST_ATOL,
                 "per-layer b_dec")
    ptr.load_state(train_state_from_jax(jax.tree.map(np.asarray, jtr.state), device="cpu"))
    jtr.run(max_steps=5)
    ptr.run(max_steps=5)
    assert pstore.ptr == jstore.ptr == 256  # refilled at step 3, one step served
    # The rows differ by the harvest's 1e-4, so the grads by about that
    # relative amount: 5 Adam steps at lr 1e-3 stay within 1e-4 unless a
    # gradient sign flips (2 lr).
    got, want = train_state_to_numpy(ptr.state), _flat(jtr.state)
    _assert_states_close(want, got, atol=1e-4, exact_counters=False)
    for k in ("adam_count", "schedule_count", "step", "n_training_tokens",
              "n_frac_active_tokens"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # a count changes only where a pre-activation lies within the harvest
    # difference of zero
    assert np.abs(got["act_freq_scores"] - want["act_freq_scores"]).sum() <= 3


@pytest.mark.parametrize("sweep", [True, False], ids=["sweep", "single"])
def test_train_cycles_serve_the_rows_of_next_batches(sweep):
    """train_cycles(n) against train_steps(next_batches(K)) x n, from the
    same state and the same store stream: the same rows, so the same states
    and buffers, bitwise."""
    fields = dict(STORE, steps_per_dispatch=2)
    if not sweep:
        fields.update(sweep_layers=None, hook_point_layer=2)
    _, pc = _cfgs(**fields)
    _, port_model = jax_and_port(**VIT)
    images = seeded(9, (64, 3, 16, 16))
    trainer_cls = port_sae.SAESweepTrainer if sweep else port_sae.VisionSAETrainer
    K = (pc.tokens_per_buffer // 2) // pc.train_batch_size
    runs = []
    for cycles in (False, True):
        perms = iter(_jax_permutations(5, pc.tokens_per_buffer, 5))
        store = port_sae.VisionActivationsStore(pc, port_model, images,
                                                permutation=lambda n: next(perms))
        tr = trainer_cls(pc, port_model, store)
        tr.train_steps(store.next_batches(K))  # serve the initial buffer
        if cycles:
            metrics = tr.train_cycles(2)
        else:
            for _ in range(2):
                metrics = tr.train_steps(store.next_batches(K))
        runs.append((tr, store, metrics))
    (ref, rs, rm), (cyc, cs, cm) = runs
    assert ref._host_step == cyc._host_step == 3 * K and cs.ptr == rs.ptr
    assert torch.equal(rs.buffer, cs.buffer)
    got, want = train_state_to_numpy(cyc.state), train_state_to_numpy(ref.state)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert cm.loss.shape == rm.loss.shape == ((K, L) if sweep else (K,))
    assert torch.equal(cm.loss, rm.loss)
    # entering a cycle with the half not served warns, as the JAX trainer does
    cs.next_batch()
    with pytest.warns(UserWarning, match="dropped unserved"):
        cyc.train_cycles(1)


def test_sweep_trainer_parts_not_ported_raise(tmp_path):
    _, pc = _cfgs()
    tr = port_sae.SAESweepTrainer(pc, device="cpu")
    # checkpoints are ported: one SAE file a layer, which JAX loads
    paths = tr.save_checkpoints(str(tmp_path / "out"))
    assert len(paths) == L and all(os.path.exists(p + ".npz") for p in paths)
    back = jax_sae.SparseAutoencoder.load_from_pretrained(paths[1])
    np.testing.assert_array_equal(np.asarray(back.params["W_enc"]),
                                  tr.state.params["W_enc"][1].numpy())
    # validation and evaluation are ported (test_torch_evals.py): without a
    # model there is nothing to validate, and evaluate() says what it needs
    assert tr.validate() is None
    with pytest.raises(ValueError, match="requires a model"):
        tr.evaluate(iter(()))
    with pytest.raises(ValueError, match="sweep_layers"):
        port_sae.SAESweepTrainer(pc.replace(sweep_layers=None))
    with pytest.raises(ValueError, match="device-resident"):
        port_sae.make_fused_cycle(pc, type("S", (), {"fused_cycle_available": False})())


def test_l14_registry_entry_matches_jax():
    """The sweep's model, copied from the JAX registry's resolved config."""
    import vit_prisma_tpu_torch
    from vit_prisma_tpu.models.loading.registry import get_model_config as jax_get_config
    name = "openai/clip-vit-large-patch14"
    cfg = vit_prisma_tpu_torch.get_model_config(name)
    assert cfg.to_dict() == jax_get_config(name).to_dict()
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_mlp, cfg.n_tokens) == (
        24, 1024, 16, 4096, 257)
