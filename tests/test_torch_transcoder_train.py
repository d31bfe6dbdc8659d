"""A transcoder's slice, the port against the JAX package: the two-hook
activation store (``blocks.1.hook_resid_mid`` -> ``blocks.1.hook_mlp_out``,
``[tokens, 2, d]`` rows), the steps that take the target slot, and the
trainer that splits the store's rows, across a refill.  The JAX store's
``jax.random`` permutations are replayed into the port, as in
``tests/test_torch_store.py``.

Buffers are held to the bit where both packages move the same rows: inside
the port (the refill's fresh rows are the next images' harvest, and the mix
is the replayed permutation), and between the packages' cached stores read
from one set of shards.  Between the live stores the harvests agree within
1e-4 (float32, two layers: ``HARVEST_ATOL``).  States: within 1e-5 of each
leaf's absmax (at least 1e-5) from the same rows, 1e-4 from the live
stores' rows; counters exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_prisma_tpu.sae as jax_sae
import vit_prisma_tpu_torch.sae as port_sae
from tests._torch_parity import assert_close, jax_and_port, seeded
from tests.test_torch_store import HARVEST_ATOL, VIT, _jax_permutations
from vit_prisma_tpu.sae.train import sae_train_multistep as jax_multistep
from vit_prisma_tpu_torch.sae.convert import train_state_from_jax, train_state_to_numpy
from vit_prisma_tpu_torch.sae.store import _index_iterator

# 400-row buffer of 5-token images, batches of 20 rows, harvests of 8 images.
FIELDS = dict(model_name="custom", architecture="transcoder", is_transcoder=True,
              hook_point_layer=1, layer_subtype="hook_resid_mid", out_hook_point_layer=1,
              layer_out_subtype="hook_mlp_out", d_in=32, d_out=32, expansion_factor=4,
              context_size=5, train_batch_size=20, n_batches_in_buffer=4, store_batch_size=8,
              seed=5, l1_coefficient=1e-3, lr=1e-3, lr_warm_up_steps=3,
              total_training_images=100_000, wandb_log_frequency=4, log_to_wandb=False)
COUNTERS = ("adam_count", "schedule_count", "step", "n_training_tokens",
            "n_frac_active_tokens", "act_freq_scores", "n_forward_passes_since_fired")
STATE_REL = 1e-5


def _cfgs(**extra):
    fields = {**FIELDS, **extra}
    return jax_sae.SAERunnerConfig(**fields), port_sae.SAERunnerConfig(**fields)


def _flat(jax_state):
    return train_state_to_numpy(train_state_from_jax(jax.tree.map(np.asarray, jax_state),
                                                     device="cpu"))


def _assert_states_close(want, got, rel, exact_counters=True):
    assert set(want) == set(got)
    for k in want:
        if k in COUNTERS:
            if exact_counters:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            continue
        tol = rel * max(1.0, float(np.abs(want[k]).max()))
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol, err_msg=k)


def _live_stores(**extra):
    jc, pc = _cfgs(**extra)
    jax_model, port_model = jax_and_port(**VIT)
    images = seeded(9, (64, 3, 16, 16))
    perms = _jax_permutations(pc.seed, pc.tokens_per_buffer, 4)
    jstore = jax_sae.VisionActivationsStore(jc, jax_model, images)
    pstore = port_sae.VisionActivationsStore(pc, port_model, images,
                                             permutation=lambda n, it=iter(perms): next(it))
    return jc, pc, jax_model, port_model, jstore, pstore, perms, images


def test_transcoder_store_rows_match_jax_across_a_refill():
    jc, pc, _, _, jstore, pstore, perms, images = _live_stores()
    n, half = pc.tokens_per_buffer, pc.tokens_per_buffer // 2
    assert pstore._hook_names == jstore._hook_names == [pc.hook_point, pc.out_hook_point]
    assert pstore._stop_at == jstore._stop_at == 2
    assert tuple(pstore.buffer.shape) == tuple(jstore.buffer.shape) == (n, 2, 32)
    assert_close(jstore.buffer, pstore.buffer, HARVEST_ATOL, "buffer after init")
    # the two slots hold different hooks; the b_dec sample is the input slot
    assert not torch.allclose(pstore.buffer[:, 0], pstore.buffer[:, 1])
    assert_close(jstore.peek_tokens(50), pstore.peek_tokens(50), HARVEST_ATOL, "peek")
    assert torch.equal(pstore.peek_tokens(50, layer_slot=1), pstore.buffer[:50, 1])
    for i in range(half // pc.train_batch_size):
        assert_close(jstore.next_batch(), pstore.next_batch(), HARVEST_ATOL, f"batch {i}")
    before = pstore.buffer.clone()
    assert_close(jstore.next_batch(), pstore.next_batch(), HARVEST_ATOL, "refill batch")
    assert_close(jstore.buffer, pstore.buffer, HARVEST_ATOL, "buffer after refill")
    # bitwise inside the port: the fresh rows are the next images' harvest
    # of both hooks, and the mix (B3 on the card) the replayed permutation
    order = _index_iterator(len(images), pc.store_batch_size, seed=pc.seed)
    n_fill = -(-n // pstore.tokens_per_store_batch)
    n_fresh = -(-half // pstore.tokens_per_store_batch)
    batches = [next(order) for _ in range(n_fill + n_fresh)][n_fill:]
    fresh = torch.cat([pstore.get_activations(images[b]) for b in batches])[:half]
    _, cache = pstore.model.run_with_cache(torch.from_numpy(images[batches[0]]),
                                           names_filter=pstore._hook_names,
                                           return_cache_object=False)
    for slot, name in enumerate(pstore._hook_names):
        assert torch.equal(fresh[:40, slot], cache[name].reshape(-1, 32))
    assert torch.equal(pstore.buffer, torch.cat([before[half:], fresh])[perms[1]])


@pytest.mark.parametrize("steps_per_dispatch", [1, 2])
def test_transcoder_slice_end_to_end_matches_jax(steps_per_dispatch):
    """HookedViT -> the two-hook store -> the trainer in both packages, 12
    steps across one refill; the trainers split the rows into input and
    target, and the b_dec init reads the input slot."""
    jc, pc, jax_model, port_model, jstore, pstore, _, _ = _live_stores(
        b_dec_init_method="geometric_median", steps_per_dispatch=steps_per_dispatch)
    jtr = jax_sae.VisionSAETrainer(jc, jax_model, jstore)
    ptr = port_sae.VisionSAETrainer(pc, port_model, pstore)
    # the geometric median of the input slot's rows (Weiszfeld sums in
    # another order, on rows that agree within HARVEST_ATOL)
    assert_close(jtr.state.params["b_dec"], ptr.state.params["b_dec"], 1e-4, "b_dec init")
    assert set(ptr.state.params) == {"W_enc", "W_dec", "b_enc", "b_dec", "b_dec_out", "W_skip"}
    ptr.load_state(train_state_from_jax(jax.tree.map(np.asarray, jtr.state), device="cpu"))
    jtr.run(max_steps=12)
    sae = ptr.run(max_steps=12)
    assert pstore.ptr == jstore.ptr == 40  # refilled at step 11
    assert isinstance(sae, port_sae.SparseAutoencoder) and sae.cfg.is_transcoder
    # the rows differ by up to HARVEST_ATOL, so 12 Adam steps stay within
    # 1e-4 unless a gradient's sign flips (see test_torch_sae_train.py)
    got, want = train_state_to_numpy(ptr.state), _flat(jtr.state)
    _assert_states_close(want, got, 1e-4, exact_counters=False)
    for k in ("adam_count", "schedule_count", "step", "n_training_tokens",
              "n_frac_active_tokens"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert np.abs(got["act_freq_scores"] - want["act_freq_scores"]).sum() <= 3


def test_transcoder_steps_take_their_targets_as_jax():
    """Three steps of ``sae_train_multistep`` with ``targets`` from one state
    on the same rows: the MSE and explained variance against the target."""
    jc, pc = _cfgs()
    params = dict(jax_sae.init_sae_params(jc, jax.random.PRNGKey(2)))
    params["b_dec_out"] = jnp.asarray(seeded(3, (32,), 0.2))
    jstate = jax_sae.init_train_state(jc, params=params)
    pstate = train_state_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
    xs = np.stack([seeded(40 + i, (20, 32), 1.5) for i in range(3)])
    ys = np.stack([seeded(50 + i, (20, 32), 0.7) for i in range(3)])
    jnew, jm = jax_multistep(jstate, jnp.asarray(xs), jc, jnp.asarray(ys))
    pnew, pm = port_sae.sae_train_multistep(pstate, torch.from_numpy(xs), pc,
                                            torch.from_numpy(ys))
    _assert_states_close(_flat(jnew), train_state_to_numpy(pnew), STATE_REL)
    for field in jm._fields:
        w = np.asarray(getattr(jm, field))
        assert_close(w, getattr(pm, field), 1e-5 * max(1.0, float(np.abs(w).max())), field)
    # without the targets the step reconstructs x: another loss
    _, own = port_sae.sae_train_multistep(pstate, torch.from_numpy(xs), pc)
    assert not torch.allclose(own.mse_loss, pm.mse_loss)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """The JAX store's float16 shards of ``[tokens, 2, d]`` rows."""
    jc, _ = _cfgs(b_dec_init_method="zeros")
    jax_model, _ = jax_and_port(**VIT)
    root = tmp_path_factory.mktemp("transcoder_shards")
    store = jax_sae.VisionActivationsStore(jc, jax_model, seeded(9, (64, 3, 16, 16)),
                                           prefetch=False)
    assert store.generate_cached_activations(str(root), 700, 300) == 3
    return root


@pytest.mark.parametrize("steps_per_dispatch", [1, 2])
def test_transcoder_cached_store_and_trainer_match_jax(shards, steps_per_dispatch):
    """Both cached stores read the same ``[tokens, 2, d]`` shards: equal
    buffers and batches to the bit across a refill; the trainers on them
    give states within 1e-5."""
    jc, pc = _cfgs(b_dec_init_method="zeros", cached_activations_path=str(shards),
                   steps_per_dispatch=steps_per_dispatch)
    perms = _jax_permutations(pc.seed, pc.tokens_per_buffer, 4)
    jstore = jax_sae.CachedActivationsStore(jc)
    pstore = port_sae.CachedActivationsStore(pc, device="cpu",
                                             permutation=lambda n, it=iter(perms): next(it))
    assert tuple(pstore.buffer.shape) == (400, 2, 32)
    np.testing.assert_array_equal(pstore.buffer.numpy(), np.asarray(jstore.buffer))
    assert torch.equal(pstore.peek_tokens(9), pstore.buffer[:9, 0])
    jtr = jax_sae.VisionSAETrainer(jc, store=jstore)
    ptr = port_sae.VisionSAETrainer(pc, store=pstore, device="cpu")
    ptr.load_state(train_state_from_jax(jax.tree.map(np.asarray, jtr.state), device="cpu"))
    jtr.run(max_steps=12)
    ptr.run(max_steps=12)
    assert pstore.ptr == jstore.ptr == 40
    np.testing.assert_array_equal(pstore.buffer.numpy(), np.asarray(jstore.buffer))
    _assert_states_close(_flat(jtr.state), train_state_to_numpy(ptr.state), STATE_REL)
