"""The port's activation-store wire against the JAX package's
(``tests/test_store_wire.py``'s cases, ported): uint8 images normalized on
the device, the wire picks and rejections, the model's statistics, a uint8
device-resident dataset, staged prefetch, a ``NativeBatchLoader`` feeding
the store, and ``augment``.  The JAX store's ``jax.random`` permutations are
replayed into the port, as in ``tests/test_torch_store.py``; the two
packages' harvests agree within ``HARVEST_ATOL``, and everything inside the
port is held bitwise."""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_prisma_tpu.dataloaders.native as jax_native
import vit_prisma_tpu.sae as jax_sae
import vit_prisma_tpu_torch.sae as port_sae
from tests._torch_parity import assert_close, jax_and_port
from vit_prisma_tpu_torch.dataloaders import native
from vit_prisma_tpu_torch.sae.store import VisionActivationsStore

MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
VIT = dict(n_layers=2, d_model=16, d_head=4, n_heads=4, d_mlp=32, patch_size=8,
           image_size=16, n_classes=8, return_type="class_logits")
# 128-row buffer of 5-token images, batches of 32 rows, harvests of 8 images.
STORE = dict(d_in=16, expansion_factor=2, hook_point_layer=1, context_size=5,
             store_batch_size=8, n_batches_in_buffer=2, buffer_tokens_override=128,
             train_batch_size=32, b_dec_init_method="zeros", log_to_wandb=False)
# The two packages' harvest forwards agree per hook within 1e-4 (float32,
# two layers; see test_torch_vit.py); the stores only move rows.
HARVEST_ATOL = 1e-4
# A uint8 image normalized on the device against the same image normalized
# on the host in float32 (tests/test_store_wire.py's limit).
NORM_TOL = 1e-5
FIXTURES = Path(__file__).resolve().parent / "fixtures" / "jpeg"
JPEGS = [str(FIXTURES / f["name"]) for f in
         json.loads((FIXTURES / "MANIFEST.json").read_text())["files"]]


@pytest.fixture(scope="module")
def models():
    return jax_and_port(**VIT)


def _cfg(**kw):
    return port_sae.SAERunnerConfig(**{**STORE, **kw})


def _raw(seed, n=16):
    return np.random.default_rng(seed).integers(0, 256, size=(n, 3, 16, 16), dtype=np.uint8)


def _host_norm(raw):
    return (raw.astype(np.float32) / 255.0 - MEAN[None, :, None, None]) / STD[None, :, None, None]


def _jax_permutations(seed, n, count):
    key, perms = jax.random.PRNGKey(seed), []
    for _ in range(count):
        key, sub = jax.random.split(key)
        perms.append(torch.from_numpy(np.array(jax.random.permutation(sub, n))))
    return perms


def _replay(seed=42, n=128, count=6):
    it = iter(_jax_permutations(seed, n, count))
    return lambda m: next(it)


def _batches(dataset, bs=8):
    """An iterator of store batches over ``dataset`` in a fixed order."""
    while True:
        for i in range(0, len(dataset) - bs + 1, bs):
            yield dataset[i:i + bs]


def _rows(store, n=6):
    """n training batches, crossing refills."""
    return torch.cat([store.next_batch() for _ in range(n)])


def test_uint8_decode_matches_jax_bitwise(models):
    """The device normalize runs the JAX harvest's operations in its order."""
    raw = _raw(0)
    _, port = models
    store = VisionActivationsStore(_cfg(store_wire_dtype="uint8"), port, raw,
                                   device_norm=(MEAN, STD))
    got = store._decode(torch.from_numpy(raw))
    x = jnp.asarray(raw).astype(jnp.float32) / 255.0
    want = (x - jnp.asarray(MEAN).reshape(1, -1, 1, 1)) / jnp.asarray(STD).reshape(1, -1, 1, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(got.numpy(), _host_norm(raw), rtol=NORM_TOL, atol=NORM_TOL)


@pytest.mark.parametrize("device_dataset", [True, False])
def test_uint8_wire_matches_host_normalized_f32_and_jax(models, device_dataset):
    """uint8 dataset + device_norm == the host-normalized float32 dataset;
    and the JAX store's rows, on both the device and the host paths."""
    raw = _raw(0)
    jmodel, port = models
    a = VisionActivationsStore(_cfg(store_wire_dtype="uint8"), port, raw,
                               device_norm=(MEAN, STD), device_dataset=device_dataset,
                               permutation=_replay())
    b = VisionActivationsStore(_cfg(store_wire_dtype="float32"), port, _host_norm(raw),
                               device_dataset=device_dataset, permutation=_replay())
    j = jax_sae.VisionActivationsStore(jax_sae.SAERunnerConfig(**STORE, store_wire_dtype="uint8"),
                                       jmodel, raw, device_norm=(MEAN, STD),
                                       device_dataset=device_dataset)
    assert (a._dev_images is not None) == device_dataset
    np.testing.assert_allclose(a.buffer.numpy(), b.buffer.numpy(), rtol=NORM_TOL, atol=NORM_TOL)
    assert_close(j.buffer, a.buffer, HARVEST_ATOL, "buffer")
    for i in range(6):  # crosses refills
        assert_close(j.next_batch(), a.next_batch(), HARVEST_ATOL, f"batch {i}")


@pytest.mark.parametrize("kind", ["ndarray", "tensor", "list", "pairs", "iterator"])
def test_auto_picks_uint8_for_uint8_datasets(models, kind):
    raw = _raw(1)
    data = {"ndarray": raw, "tensor": torch.from_numpy(raw), "list": list(raw),
            "pairs": [(im, 0) for im in raw], "iterator": None}[kind]
    if kind == "iterator":
        class Loader:  # a batch iterator that declares its dtype
            dtype = np.uint8

            def __init__(self):
                self.it = _batches(raw)

            def __next__(self):
                return next(self.it)
        data = Loader()
    store = VisionActivationsStore(_cfg(), models[1], data, device_norm=(MEAN, STD))
    assert store._wire_dtype == torch.uint8
    ref = VisionActivationsStore(_cfg(), models[1], raw, device_norm=(MEAN, STD))
    if kind in ("ndarray", "tensor", "list", "pairs"):  # the index stream's order
        assert torch.equal(store.buffer, ref.buffer)


def test_bf16_wire_identical_for_bf16_model():
    """bf16 models: 'auto' ships bf16 pixels, and the rows equal the
    float32 wire's (the model casts to bf16 either way)."""
    _, port = jax_and_port(**{**VIT, "dtype": "bfloat16"})
    port = port.to(torch.bfloat16)
    imgs = np.random.default_rng(1).normal(size=(16, 3, 16, 16)).astype(np.float32)
    for device_dataset in (True, False):
        auto = VisionActivationsStore(_cfg(), port, imgs, device_dataset=device_dataset)
        assert auto._wire_dtype == torch.bfloat16
        if device_dataset:
            assert auto._dev_images.dtype == torch.bfloat16
        f32 = VisionActivationsStore(_cfg(store_wire_dtype="float32"), port, imgs,
                                     device_dataset=device_dataset)
        assert f32._wire_dtype is None
        assert torch.equal(auto.buffer, f32.buffer)
        assert torch.equal(_rows(auto), _rows(f32))


@pytest.mark.parametrize("source", ["list", "iterator", "host_ndarray", "uint8_list"])
def test_prefetch_off_matches_on(models, source):
    """prefetch only changes when images are staged, never the rows."""
    imgs = np.random.default_rng(2).normal(size=(24, 3, 16, 16)).astype(np.float32)
    raw = _raw(2, 24)

    def data():
        return {"list": lambda: list(imgs), "iterator": lambda: _batches(imgs),
                "host_ndarray": lambda: imgs, "uint8_list": lambda: list(raw)}[source]()
    kw = dict(device_dataset=False) if source == "host_ndarray" else {}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # the staging thread and the train loop interleave finely
    try:
        on = VisionActivationsStore(_cfg(), models[1], data(), prefetch=True, **kw)
        off = VisionActivationsStore(_cfg(), models[1], data(), prefetch=False, **kw)
        assert on._staged is not None and off._staged is None
        assert torch.equal(on.buffer, off.buffer)
        assert torch.equal(_rows(on, 9), _rows(off, 9))  # four refills
    finally:
        sys.setswitchinterval(interval)
    # prefetch has staged the next refill's 2 store batches as well
    on.close()  # waits for the staging thread
    assert on._stage_pool is None
    item = 3 * 16 * 16 * (1 if source == "uint8_list" else 4)
    assert off.bytes_to_device == item * 8 * (4 + 4 * 2)
    assert on.bytes_to_device == off.bytes_to_device + item * 8 * 2


def test_prefetch_does_nothing_for_a_device_dataset(models):
    imgs = np.random.default_rng(3).normal(size=(16, 3, 16, 16)).astype(np.float32)
    store = VisionActivationsStore(_cfg(), models[1], imgs, prefetch=True)
    assert store._dev_images is not None and store._staged is None
    assert store.fused_cycle_available
    _rows(store)
    assert store._staged is None and store._stage_pool is None


def test_uint8_wire_resolves_model_norm_stats(models):
    """uint8 wire without device_norm normalizes with the model's statistics
    (CLIP's for the default model), not raw /255 pixels."""
    raw = _raw(3)
    store = VisionActivationsStore(_cfg(store_wire_dtype="uint8"), models[1], raw)
    np.testing.assert_array_equal(store.device_norm[0], MEAN)
    np.testing.assert_array_equal(store.device_norm[1], STD)
    explicit = VisionActivationsStore(_cfg(store_wire_dtype="uint8"), models[1], raw,
                                      device_norm=(MEAN, STD))
    assert torch.equal(store.buffer, explicit.buffer)
    imnet = VisionActivationsStore(_cfg(store_wire_dtype="uint8", model_name="custom"),
                                   models[1], raw, device_norm=None)
    np.testing.assert_array_equal(imnet.device_norm[0], np.float32([0.485, 0.456, 0.406]))


def test_uint8_wire_rejects_float_datasets(models):
    imgs = np.random.default_rng(4).normal(size=(16, 3, 16, 16)).astype(np.float32)
    for data in (imgs, list(imgs), torch.from_numpy(imgs)):
        with pytest.raises(ValueError, match="uint8"):
            VisionActivationsStore(_cfg(store_wire_dtype="uint8"), models[1], data)
    with pytest.raises(ValueError, match="requires a uint8 dataset"):
        VisionActivationsStore(_cfg(store_wire_dtype="uint8"), models[1], _batches(imgs))


def test_uint8_dataset_rejects_float_wire(models):
    raw = np.zeros((16, 3, 16, 16), np.uint8)
    for data in (raw, list(raw)):
        with pytest.raises(ValueError, match="raw-pixel"):
            VisionActivationsStore(_cfg(store_wire_dtype="bfloat16"), models[1], data)


def test_small_dataset_and_iterator_device_dataset_raise(models):
    imgs = np.random.default_rng(5).normal(size=(4, 3, 16, 16)).astype(np.float32)
    with pytest.raises(ValueError, match="at least one full batch"):
        VisionActivationsStore(_cfg(), models[1], imgs)
    with pytest.raises(ValueError, match="indexable ndarray"):
        VisionActivationsStore(_cfg(), models[1], _batches(imgs), device_dataset=True)
    short = iter([np.zeros((3, 3, 16, 16), np.float32)])
    with pytest.raises(ValueError, match="exactly store_batch_size=8"):
        VisionActivationsStore(_cfg(), models[1], short)


def test_device_dataset_limit_counts_wire_bytes(models, monkeypatch):
    """The device-resident choice counts the dataset in the wire dtype (the
    port once counted the dataset's own bytes)."""
    imgs = np.random.default_rng(6).normal(size=(16, 3, 16, 16)).astype(np.float32)
    monkeypatch.setattr(VisionActivationsStore, "_DEVICE_DATASET_AUTO_BYTES",
                        imgs.nbytes // 2 + 1)
    assert VisionActivationsStore(_cfg(store_wire_dtype="bfloat16"), models[1],
                                  imgs)._dev_images is not None
    host = VisionActivationsStore(_cfg(store_wire_dtype="float32"), models[1], imgs)
    assert host._dev_images is None
    raw = _raw(6)
    monkeypatch.setattr(VisionActivationsStore, "_DEVICE_DATASET_AUTO_BYTES", raw.nbytes)
    dev = VisionActivationsStore(_cfg(), models[1], raw)
    assert dev._dev_images is not None and dev._dev_images.dtype == torch.uint8
    assert dev.bytes_to_device == raw.nbytes


def test_device_dataset_uint8_wire_normalizes(models):
    """Device-resident + uint8 wire: pixels stay uint8 on the device; the
    harvest still normalizes; the host stream serves the same rows."""
    raw = _raw(8)
    dev = VisionActivationsStore(_cfg(store_wire_dtype="uint8"), models[1], raw,
                                 device_norm=(MEAN, STD), device_dataset=True)
    assert dev._dev_images.dtype == torch.uint8
    f32 = VisionActivationsStore(_cfg(store_wire_dtype="float32"), models[1], _host_norm(raw),
                                 device_dataset=False)
    np.testing.assert_allclose(dev.buffer.numpy(), f32.buffer.numpy(),
                               rtol=NORM_TOL, atol=NORM_TOL)
    host = VisionActivationsStore(_cfg(store_wire_dtype="uint8"), models[1], raw,
                                  device_norm=(MEAN, STD), device_dataset=False)
    assert torch.equal(dev.buffer, host.buffer)
    assert torch.equal(_rows(dev), _rows(host))
    # the host stream's bytes: the fill's 4 store batches, 2 refills' 2 and
    # the next refill's 2, staged
    host.close()
    assert host.bytes_to_device == 8 * 3 * 16 * 16 * (4 + 2 * 2 + 2)


@pytest.fixture
def jax_on_port_lib(monkeypatch):
    monkeypatch.setattr(jax_native, "_LIB_PATH", str(native.build_library()[0]))
    monkeypatch.setattr(jax_native, "_lib", native.get_lib())
    return jax_native


@pytest.mark.parametrize("uint8_wire", [False, True])
def test_native_loader_drives_the_store(models, uint8_wire, jax_on_port_lib):
    """A NativeBatchLoader (one worker: batches in order) feeds the store on
    its wire: the rows equal the same images fed as arrays, with prefetch
    on and off, and JAX's store fed by JAX's loader."""
    jmodel, port = models
    kw = dict(batch_size=8, out_size=16, n_workers=1, seed=3, uint8_wire=uint8_wire)
    loaders = [native.NativeBatchLoader(JPEGS, **kw) for _ in range(3)]
    jloader = jax_on_port_lib.NativeBatchLoader(JPEGS, **kw)
    try:
        cfg = _cfg(store_wire_dtype="uint8" if uint8_wire else "auto")
        on = VisionActivationsStore(cfg, port, loaders[0], permutation=_replay())
        off = VisionActivationsStore(cfg, port, loaders[1], prefetch=False,
                                     permutation=_replay())
        assert on._wire_dtype == (torch.uint8 if uint8_wire else None)
        arrays = VisionActivationsStore(cfg, port, iter(loaders[2]), permutation=_replay())
        j = jax_sae.VisionActivationsStore(
            jax_sae.SAERunnerConfig(**STORE, store_wire_dtype=cfg.store_wire_dtype),
            jmodel, jloader)
        assert torch.equal(on.buffer, off.buffer) and torch.equal(on.buffer, arrays.buffer)
        assert_close(j.buffer, on.buffer, HARVEST_ATOL, "buffer")
        for i in range(6):
            got = on.next_batch()
            assert torch.equal(got, off.next_batch()) and torch.equal(got, arrays.next_batch())
            assert_close(j.next_batch(), got, HARVEST_ATOL, f"batch {i}")
        item = 3 * 16 * 16 * (1 if uint8_wire else 4)
        on.close()
        assert off.bytes_to_device == item * 8 * (4 + 2 * 2)
        assert on.bytes_to_device == item * 8 * (4 + 2 * 2 + 2)  # the next refill's, staged
        assert all(ld.decode_failures() == 0 for ld in loaders)
    finally:
        for store in (locals().get("on"), locals().get("arrays")):
            if store is not None:
                store.close()
        for ld in loaders + [jloader]:
            ld.close()


def _flip(key_or_generator, images):
    return images.flip(-1) if isinstance(images, torch.Tensor) else images[..., ::-1]


def _noise(generator, images):
    return images + 0.1 * torch.randn(images.shape, generator=generator,
                                      device=images.device, dtype=images.dtype)


@pytest.mark.parametrize("device_dataset", [True, False])
def test_augment_without_randomness_matches_jax(models, device_dataset):
    """An augment that ignores its generator gives JAX's rows with the same
    augment on JAX's key (after the uint8 decode in both)."""
    raw = _raw(9)
    jmodel, port = models
    a = VisionActivationsStore(_cfg(), port, raw, device_norm=(MEAN, STD), augment=_flip,
                               device_dataset=device_dataset, permutation=_replay())
    j = jax_sae.VisionActivationsStore(jax_sae.SAERunnerConfig(**STORE), jmodel, raw,
                                       device_norm=(MEAN, STD), augment=_flip,
                                       device_dataset=device_dataset)
    plain = VisionActivationsStore(_cfg(), port, raw, device_norm=(MEAN, STD),
                                   device_dataset=device_dataset, permutation=_replay())
    assert_close(j.buffer, a.buffer, HARVEST_ATOL, "buffer")
    assert not torch.allclose(a.buffer, plain.buffer)
    for i in range(6):
        assert_close(j.next_batch(), a.next_batch(), HARVEST_ATOL, f"batch {i}")


def test_augment_stream_replays_and_is_its_own(models):
    """The augmentation stream is the store's own: one generator a store
    batch, replayed by a store with the same seed, changed by another seed,
    and not shared with the mix permutations."""
    imgs = np.random.default_rng(10).normal(size=(16, 3, 16, 16)).astype(np.float32)
    port = models[1]
    seen = []

    def drawing_identity(generator, images):
        seen.append(int(torch.randint(0, 2 ** 31, (), generator=generator)))
        return images
    a = VisionActivationsStore(_cfg(), port, imgs, augment=_noise)
    b = VisionActivationsStore(_cfg(), port, list(imgs), augment=_noise)
    c = VisionActivationsStore(_cfg(), port, imgs, augment=_noise, seed=7)
    d = VisionActivationsStore(_cfg(), port, imgs, augment=drawing_identity)
    e = VisionActivationsStore(_cfg(), port, imgs)
    assert torch.equal(a.buffer, b.buffer) and not torch.allclose(a.buffer, c.buffer)
    assert torch.equal(_rows(a), _rows(b))
    assert torch.equal(d.buffer, e.buffer) and torch.equal(_rows(d), _rows(e))
    # one draw a store batch: the fill's 4, then 2 a refill
    assert len(seen) == 4 + 2 * 2 and len(set(seen)) == len(seen)


def test_fused_cycle_consumes_the_augment_stream(models):
    """train_cycles on a uint8 device dataset with a seeded augment serves
    the stepwise path's rows: the same images, permutations and draws."""
    raw = _raw(11)
    cfg = _cfg(n_batches_in_buffer=2)
    stores = [VisionActivationsStore(cfg, models[1], raw, augment=_noise) for _ in range(2)]
    trainers = [port_sae.VisionSAETrainer(cfg, models[1], s, device="cpu") for s in stores]
    half = stores[0].buffer.shape[0] // 2
    K = half // cfg.train_batch_size
    for t, s in zip(trainers, stores):
        t.train_steps(s.next_batches(K))
    trainers[0].train_cycles(2)
    for _ in range(2):
        trainers[1].train_steps(stores[1].next_batches(K))
    assert torch.equal(stores[0].buffer, stores[1].buffer)
    for k in trainers[0].state.params:
        assert torch.equal(trainers[0].state.params[k], trainers[1].state.params[k]), k


@pytest.mark.parametrize("prefetch", [True, False])
def test_a_stream_that_ends_raises_at_the_refill(models, prefetch):
    """A finite stream that covers only the fill: the refill raises what
    taking from the stream raised, whichever thread took it."""
    imgs = np.random.default_rng(12).normal(size=(32, 3, 16, 16)).astype(np.float32)
    store = VisionActivationsStore(_cfg(), models[1], iter([imgs[i:i + 8] for i in range(0, 32, 8)]),
                                   prefetch=prefetch)
    store.next_batches(2)
    with pytest.raises(RuntimeError, match="image stream ended"):
        store.next_batch()
    store.close()
