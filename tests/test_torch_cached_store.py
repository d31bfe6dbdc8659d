"""The port's cached activation shards and ``CachedActivationsStore``
against the JAX package's.  Both packages' live stores write float16
``{i}.npy`` shards of the same images; both cached stores, built from the
same shards with the JAX store's ``jax.random`` permutations replayed into
the port (as in ``tests/test_torch_store.py``), serve equal rows, bitwise,
across refills and the wrap-around to the first shard."""

import os

import jax
import numpy as np
import pytest
import torch

import vit_prisma_tpu.sae as jax_sae
import vit_prisma_tpu_torch.sae as port_sae
from tests._torch_parity import jax_and_port, seeded

VIT = dict(n_layers=2, d_model=32, d_head=8, n_heads=4, d_mlp=64, patch_size=8,
           image_size=16, n_classes=7)
# 128-row buffer of 5-token images, batches of 32 rows, harvests of 8 images.
STORE = dict(model_name="custom", hook_point_layer=1, context_size=5, d_in=32,
             expansion_factor=4, train_batch_size=32, n_batches_in_buffer=2,
             buffer_tokens_override=128, store_batch_size=8, seed=5,
             b_dec_init_method="zeros", log_to_wandb=False)
N_TOKENS = 300
# Shards of two float16 harvests that agree within 1e-4 (float32) differ by
# at most one float16 step at the rows' scale (|x| < 8: 2^-8).
SHARD_ATOL = 2.0 ** -8


def _jax_permutations(seed, n, count):
    key, perms = jax.random.PRNGKey(seed), []
    for _ in range(count):
        key, sub = jax.random.split(key)
        perms.append(torch.from_numpy(np.array(jax.random.permutation(sub, n))))
    return perms


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Both packages' shards of the same image stream, two shard sizes."""
    jax_model, port_model = jax_and_port(**VIT)
    images = seeded(9, (96, 3, 16, 16))
    out = {}
    for per_file in (128, 25):
        root = tmp_path_factory.mktemp(f"shards{per_file}")
        port_store = port_sae.VisionActivationsStore(port_sae.SAERunnerConfig(**STORE),
                                                     port_model, images)
        jax_store = jax_sae.VisionActivationsStore(jax_sae.SAERunnerConfig(**STORE),
                                                   jax_model, images, prefetch=False)
        n_port = port_store.generate_cached_activations(str(root / "port"), N_TOKENS, per_file)
        n_jax = jax_store.generate_cached_activations(str(root / "jax"), N_TOKENS, per_file)
        out[per_file] = (root, n_port, n_jax, port_store, images)
    return out


@pytest.mark.parametrize("per_file", [128, 25])
def test_shards_match_jax(shards, per_file):
    root, n_port, n_jax, _, _ = shards[per_file]
    assert n_port == n_jax == -(-N_TOKENS // per_file)
    assert sorted(os.listdir(root / "port")) == sorted(os.listdir(root / "jax"))
    for i in range(n_port):
        got = np.load(root / "port" / f"{i}.npy")
        want = np.load(root / "jax" / f"{i}.npy")
        assert got.dtype == want.dtype == np.float16 and got.shape == want.shape
        assert got.shape == (min(per_file, N_TOKENS - i * per_file), 32)
        np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32),
                                   rtol=0, atol=SHARD_ATOL)


def test_shards_are_the_float16_harvest_of_the_stream(shards):
    """The first shard is the float16 rounding of the harvest of the images
    after the store's fill, in the stream's order."""
    from vit_prisma_tpu_torch.sae.store import _index_iterator
    root, _, _, store, images = shards[128]
    order = _index_iterator(len(images), 8, seed=STORE["seed"])
    batches = [next(order) for _ in range(4 + 4)][4:]  # the fill took 4 store batches
    want = torch.cat([store.get_activations(images[b]) for b in batches])[:128]
    np.testing.assert_array_equal(np.load(root / "port" / "0.npy"),
                                  want.to(torch.float16).numpy())


@pytest.mark.parametrize("per_file", [128, 25])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cached_stores_serve_jax_rows(shards, per_file, dtype):
    """Built from the same shards, the two cached stores serve equal rows
    through six refills (the 128-row shards wrap to the first shard after
    the third) in ``dtype``."""
    root = shards[per_file][0] / "port"
    fields = {**STORE, "dtype": dtype}
    jstore = jax_sae.CachedActivationsStore(jax_sae.SAERunnerConfig(**fields), str(root))
    perms = _jax_permutations(STORE["seed"], 128, 8)
    pstore = port_sae.CachedActivationsStore(
        port_sae.SAERunnerConfig(**fields), str(root), device="cpu",
        permutation=lambda n, it=iter(perms): next(it))
    assert pstore.buffer.dtype == getattr(torch, dtype)
    assert pstore._shards == jstore._shards  # by integer name: 10 after 9
    np.testing.assert_array_equal(pstore.buffer.float().numpy(),
                                  np.asarray(jstore.buffer.astype(np.float32)))
    for i in range(14):  # 2 batches a half: six refills
        got = pstore.next_batch() if i % 3 else pstore.next_batches(1)[0]
        want = jstore.next_batch() if i % 3 else jstore.next_batches(1)[0]
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(np.float32)),
                                      err_msg=f"batch {i}")
    assert pstore._next_shard == jstore._next_shard
    np.testing.assert_array_equal(pstore.peek_tokens(5).float().numpy(),
                                  np.asarray(jstore.peek_tokens(5).astype(np.float32)))


def test_cached_store_refill_keeps_the_upper_half(shards):
    """The refill keeps ``buffer[n//2:]`` (the JAX class's arithmetic) and
    mixes it with the next shard's rows; the default permutations come from
    the store's generator."""
    root = shards[128][0] / "port"
    cfg = port_sae.SAERunnerConfig(**STORE)
    a = port_sae.CachedActivationsStore(cfg, str(root), device="cpu")
    b = port_sae.CachedActivationsStore(cfg, str(root), device="cpu")
    c = port_sae.CachedActivationsStore(cfg, str(root), device="cpu", seed=6)
    assert torch.equal(a.buffer, b.buffer) and not torch.equal(a.buffer, c.buffer)
    kept = a.buffer[64:].clone()
    a.next_batches(2)
    a.next_batch()  # refills
    fresh = torch.from_numpy(np.load(root / "1.npy")[:64]).float()
    assert sorted(map(tuple, a.buffer.tolist())) == \
        sorted(map(tuple, torch.cat([kept, fresh]).tolist()))
    with pytest.raises(ValueError, match="half the buffer"):
        a.next_batches(3)


def test_cached_store_needs_shards(tmp_path):
    with pytest.raises(FileNotFoundError, match="No .npy shards"):
        port_sae.CachedActivationsStore(port_sae.SAERunnerConfig(**STORE), str(tmp_path),
                                        device="cpu")
