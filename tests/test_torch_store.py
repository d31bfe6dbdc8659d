"""Kernel B3's plain version and the port's activation store against the
JAX package's.  The gather is exact, so it is held bitwise to ``take_rows``
(``jnp.take`` on the CPU).  The stores run the same model weights on the same
images in the same order, with the JAX store's ``jax.random`` permutations
replayed into the port.  The CUDA kernel itself is held to the plain version
on the card by ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_prisma_tpu.sae as jax_sae
import vit_prisma_tpu_torch.sae as port_sae
from tests._torch_parity import assert_close, jax_and_port, seeded
from vit_prisma_tpu.ops.shuffle import take_rows as jax_take_rows
from vit_prisma_tpu_torch.ops import shuffle as port_shuffle
from vit_prisma_tpu_torch.sae.store import _index_iterator

VIT = dict(n_layers=2, d_model=32, d_head=8, n_heads=4, d_mlp=64, patch_size=8,
           image_size=16, n_classes=7)
# 400-row buffer of 5-token images, batches of 20 rows, harvests of 8 images.
STORE = dict(model_name="custom", hook_point_layer=1, context_size=5, d_in=32,
             expansion_factor=4, train_batch_size=20, n_batches_in_buffer=4,
             store_batch_size=8, seed=5)
SELECTIONS = {
    "all_tokens": {},
    "cls_only": dict(cls_token_only=True, train_batch_size=4),
    "patches_only": dict(use_patches_only=True, train_batch_size=16),
    "head_index": dict(layer_subtype="attn.hook_z", hook_point_head_index=2, d_in=8),
}
# The two packages' harvest forwards agree per hook within 1e-4 (float32,
# two layers; see test_torch_vit.py), and the store only moves rows.
HARVEST_ATOL = 1e-4


@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32", "float32_3d"])
def test_take_rows_matches_jax_bitwise(dtype, idx_dtype):
    shape = (37, 4, 6) if dtype == "float32_3d" else (37, 24)
    x = seeded(0, shape, 10.0)
    idx = np.random.default_rng(1).integers(0, 37, size=53).astype(idx_dtype)
    if dtype == "bfloat16":
        jx, px = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    elif dtype == "int32":
        jx, px = jnp.asarray(x.astype(np.int32)), torch.from_numpy(x.astype(np.int32))
    else:
        jx, px = jnp.asarray(x), torch.from_numpy(x)
    want = np.asarray(jax_take_rows(jx, jnp.asarray(idx)).astype(jnp.float32))
    before = port_shuffle.take_rows.launches
    got = port_shuffle.take_rows(px, torch.from_numpy(idx))
    assert port_shuffle.take_rows.launches == before  # CPU: plain version
    assert got.dtype == px.dtype and tuple(got.shape) == (53,) + shape[1:]
    np.testing.assert_array_equal(got.float().numpy(), want)


# Rows the card's kernel takes on its other route or in chunks: a
# sweep-like row ([24, 16] bfloat16), 3-byte rows, and an unaligned view
# (x[1:] of bfloat16 rows of odd width); M != N, with repeats.
@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("case", ["sweep_like_bf16", "three_bytes_u8", "unaligned_view_bf16"])
def test_take_rows_plain_matches_jax_on_odd_rows(case, idx_dtype):
    rng = np.random.default_rng(3)
    if case == "sweep_like_bf16":
        x = seeded(4, (37, 24, 16), 10.0)
        jx, px = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    elif case == "three_bytes_u8":
        x = rng.integers(0, 256, size=(37, 3)).astype(np.uint8)
        jx, px = jnp.asarray(x), torch.from_numpy(x)
    else:
        x = seeded(5, (38, 7), 10.0)
        jx, px = jnp.asarray(x, jnp.bfloat16)[1:], torch.from_numpy(x).bfloat16()[1:]
        assert px.is_contiguous() and px.data_ptr() % 16 != 0
    idx = rng.integers(0, 37, size=61).astype(idx_dtype)
    assert len(np.unique(idx)) < len(idx)  # repeats
    want = np.asarray(jnp.take(jx, jnp.asarray(idx), axis=0).astype(jnp.float32))
    got = port_shuffle.take_rows(px, torch.from_numpy(idx))
    assert got.dtype == px.dtype and tuple(got.shape) == (61,) + tuple(px.shape[1:])
    np.testing.assert_array_equal(got.float().numpy(), want)


# row bytes, source and output pointers, the widest access all three allow
ROUTES = [(3072, 0, 0, 16), (1536, 4096, 512, 16), (49152, 0, 0, 16), (16, 16, 32, 16),
          (48, 16, 16, 16), (3072, 8, 0, 8), (3072, 0, 4, 4), (1534, 1534, 0, 2),
          (24, 0, 0, 8), (20, 0, 0, 4), (3, 0, 0, 1), (3072, 1, 0, 1)]


@pytest.mark.parametrize("row_bytes,x_ptr,out_ptr,vec", ROUTES)
def test_take_rows_route_by_width_and_alignment(row_bytes, x_ptr, out_ptr, vec):
    """The kernel's access width (its route: 16-byte vectors for the
    stores' rows, narrower for odd widths and unaligned views) is chosen
    from the row width and both base pointers before the launch."""
    assert port_shuffle._vector_bytes(row_bytes, x_ptr, out_ptr) == vec


def test_permute_rows_from_indices_and_generator():
    x = torch.from_numpy(seeded(2, (50, 8)))
    idx = torch.randperm(50, generator=torch.Generator().manual_seed(0))
    assert torch.equal(port_shuffle.permute_rows(idx, x), x[idx])
    a = port_shuffle.permute_rows(torch.Generator().manual_seed(3), x)
    b = port_shuffle.permute_rows(torch.Generator().manual_seed(3), x)
    assert torch.equal(a, b)
    assert sorted(a[:, 0].tolist()) == sorted(x[:, 0].tolist())
    with pytest.raises(TypeError, match="int32 or int64"):
        port_shuffle.take_rows(x, idx.float())


def _jax_permutations(seed, n, count):
    """The JAX store's permutation chain: one key split per shuffle."""
    key, perms = jax.random.PRNGKey(seed), []
    for _ in range(count):
        key, sub = jax.random.split(key)
        perms.append(torch.from_numpy(np.array(jax.random.permutation(sub, n))))
    return perms


def _stores(selection, n_images=64, **extra):
    fields = {**STORE, **SELECTIONS[selection], **extra}
    jcfg, pcfg = jax_sae.SAERunnerConfig(**fields), port_sae.SAERunnerConfig(**fields)
    jax_model, port_model = jax_and_port(**VIT)
    images = seeded(9, (n_images, 3, 16, 16))
    perms = _jax_permutations(fields["seed"], pcfg.tokens_per_buffer, 3)
    jstore = jax_sae.VisionActivationsStore(jcfg, jax_model, images)
    pstore = port_sae.VisionActivationsStore(
        pcfg, port_model, images, permutation=lambda n, it=iter(perms): next(it))
    return jstore, pstore, perms, images


@pytest.mark.parametrize("selection", list(SELECTIONS))
def test_store_rows_match_jax_across_a_refill(selection):
    jstore, pstore, perms, images = _stores(selection)
    cfg = pstore.cfg
    n = cfg.tokens_per_buffer
    assert tuple(pstore.buffer.shape) == tuple(jstore.buffer.shape) == (n, cfg.d_in)
    assert not pstore.buffer.is_inference()  # autograd may save the rows
    assert_close(jstore.buffer, pstore.buffer, HARVEST_ATOL, "buffer after init")

    half = n // 2
    for i in range(half // cfg.train_batch_size):
        assert_close(jstore.next_batch(), pstore.next_batch(), HARVEST_ATOL, f"batch {i}")
    before = pstore.buffer.clone()
    # the next batch crosses the refill
    assert_close(jstore.next_batch(), pstore.next_batch(), HARVEST_ATOL, "refill batch")
    assert_close(jstore.buffer, pstore.buffer, HARVEST_ATOL, "buffer after refill")

    # Bitwise inside the port: the refill's fresh rows are the next images'
    # harvest, and the mix is the replayed permutation of [kept, fresh].
    order = _index_iterator(len(images), cfg.store_batch_size, seed=cfg.seed)
    n_fill = -(-n // pstore.tokens_per_store_batch)
    n_fresh = -(-half // pstore.tokens_per_store_batch)
    batches = [next(order) for _ in range(n_fill + n_fresh)][n_fill:]
    fresh = torch.cat([pstore.get_activations(images[b]) for b in batches])[:half]
    merged = torch.cat([before[half:], fresh])
    assert torch.equal(pstore.buffer, merged[perms[1]])


def test_store_host_and_device_datasets_serve_identical_rows():
    _, dev, _, images = _stores("all_tokens")
    fields = {**STORE}
    _, port_model = jax_and_port(**VIT)
    host = port_sae.VisionActivationsStore(
        port_sae.SAERunnerConfig(**fields), port_model, list(images),
        generator=torch.Generator().manual_seed(0),
        permutation=lambda n, it=iter(_jax_permutations(5, 400, 3)): next(it))
    assert host._dev_images is None and dev._dev_images is not None
    assert torch.equal(host.buffer, dev.buffer)
    for _ in range(12):
        assert torch.equal(host.next_batch(), dev.next_batch())


def test_store_default_permutations_come_from_its_generator():
    _, model = jax_and_port(**VIT)
    images = seeded(9, (64, 3, 16, 16))
    cfg = port_sae.SAERunnerConfig(**STORE)
    a = port_sae.VisionActivationsStore(cfg, model, images)
    b = port_sae.VisionActivationsStore(cfg, model, images)
    c = port_sae.VisionActivationsStore(cfg, model, images, seed=6)
    assert torch.equal(a.buffer, b.buffer) and not torch.equal(a.buffer, c.buffer)
    rows = torch.cat([a.next_batches(5).reshape(-1, 32), a.next_batches(5).reshape(-1, 32)])
    assert torch.equal(rows[:100], b.peek_tokens(100))
    assert torch.equal(rows, torch.cat([b.next_batch() for _ in range(10)]))
    assert torch.equal(a.next_batches(2).reshape(-1, 32),
                       torch.cat([b.next_batch(), b.next_batch()]))


@pytest.mark.parametrize("kwargs,match", [
    (dict(mesh=object()), "item 15"),
])
def test_store_options_not_ported_raise(kwargs, match):
    """``mesh=`` raises, naming its item; a transcoder's store, which raised
    here before, is ported: two hooks, ``[tokens, 2, d]`` rows
    (tests/test_torch_transcoder_train.py holds it to the JAX store)."""
    _, model = jax_and_port(**VIT)
    cfg = port_sae.SAERunnerConfig(**STORE)
    with pytest.raises(NotImplementedError, match=match):
        port_sae.VisionActivationsStore(cfg, model, seeded(9, (64, 3, 16, 16)), **kwargs)
    store = port_sae.VisionActivationsStore(
        cfg.replace(is_transcoder=True, layer_subtype="hook_resid_mid", out_hook_point_layer=1),
        model, seeded(9, (64, 3, 16, 16)))
    assert store._hook_names == ["blocks.1.hook_resid_mid", "blocks.1.hook_mlp_out"]
    assert tuple(store.buffer.shape) == (cfg.tokens_per_buffer, 2, cfg.d_in)
    assert torch.equal(store.peek_tokens(7), store.buffer[:7, 0])


# The options that once raised here (augment, device_norm, a uint8 dataset,
# CachedActivationsStore); tests/test_torch_store_wire.py and
# tests/test_torch_cached_store.py hold them to the JAX package.
@pytest.mark.parametrize("option", ["augment", "device_norm", "uint8", "cached"])
def test_store_options_once_raising_now_run(option, tmp_path):
    _, model = jax_and_port(**VIT)
    cfg = port_sae.SAERunnerConfig(**STORE)
    images = seeded(9, (64, 3, 16, 16))
    raw = np.random.default_rng(9).integers(0, 256, (64, 3, 16, 16), dtype=np.uint8)
    plain = port_sae.VisionActivationsStore(cfg, model, images)
    if option == "augment":
        store = port_sae.VisionActivationsStore(cfg, model, images, augment=lambda g, x: x)
        assert torch.equal(store.buffer, plain.buffer)
    elif option == "device_norm":
        store = port_sae.VisionActivationsStore(cfg, model, raw, device_norm=(0.5, 0.5))
        want = port_sae.VisionActivationsStore(cfg.replace(store_wire_dtype="float32"), model,
                                               (raw.astype(np.float32) / 255.0 - 0.5) / 0.5)
        torch.testing.assert_close(store.buffer, want.buffer, rtol=1e-5, atol=1e-5)
    elif option == "uint8":
        store = port_sae.VisionActivationsStore(cfg, model, raw)
        assert store._dev_images.dtype == torch.uint8 and store.device_norm is not None
    else:
        plain.generate_cached_activations(str(tmp_path), 800, tokens_per_file=400)
        store = port_sae.CachedActivationsStore(cfg.replace(cached_activations_path=str(tmp_path)),
                                                device="cpu")
    assert tuple(store.buffer.shape) == (cfg.tokens_per_buffer, cfg.d_in)
    assert torch.isfinite(store.next_batch()).all()
