"""The port's native image pipeline (``vit_prisma_tpu_torch/dataloaders/
native.py``) against the JAX package's module.

The port builds its own copies of the C++ sources under a cross-process
lock.  For the comparisons, the JAX module is pointed at the port's library
(its ``_LIB_PATH`` and ``_lib`` monkeypatched), so these tests never build
or load ``csrc/libimage_pipeline.so``.  The same library runs the same code
on the same bytes, so every output is held bitwise.  The fixture JPEGs of
``tests/fixtures/jpeg/`` are held to their manifest."""

import hashlib
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

import vit_prisma_tpu.dataloaders.native as jax_native
from vit_prisma_tpu_torch.dataloaders import native
from vit_prisma_tpu_torch.dataloaders.transforms import CLIP_MEAN, CLIP_STD, IMAGENET_MEAN, IMAGENET_STD

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures" / "jpeg"
MANIFEST = json.loads((FIXTURES / "MANIFEST.json").read_text())
FILES = [FIXTURES / f["name"] for f in MANIFEST["files"]]


@pytest.fixture
def jax_on_port_lib(monkeypatch):
    """The JAX module, bound to the port's library."""
    monkeypatch.setattr(jax_native, "_LIB_PATH", str(native.build_library()[0]))
    monkeypatch.setattr(jax_native, "_lib", native.get_lib())
    return jax_native


@pytest.fixture
def fresh_lib():
    """Forget the loaded library around a test that breaks the build."""
    native.get_lib.cache_clear()
    yield
    native.get_lib.cache_clear()


def test_sources_are_byte_equal_copies():
    for name in native.SOURCES:
        assert (native.HOST_SRC / name).read_bytes() == (ROOT / "csrc" / name).read_bytes()
    # the library builds from the port's copies into the gitignored build tree
    lib = native.build_library()[0]
    assert lib.parent.parent == native.BUILD_ROOT and lib.parent.name.startswith("host-")
    assert lib != ROOT / "csrc" / "libimage_pipeline.so"


def test_four_processes_building_at_once_build_once(tmp_path):
    """Four processes that start the build together all load one library;
    the lock lets one of them compile it."""
    script = textwrap.dedent("""
        import ctypes, sys, time
        from vit_prisma_tpu_torch.dataloaders import native
        time.sleep(max(0.0, float(sys.argv[2]) - time.time()))
        path, built = native.build_library(sys.argv[1])
        ctypes.CDLL(str(path)).ip_free(None)
        print(path, int(built))
    """)
    start = time.time() + 8.0
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    procs = [subprocess.Popen([sys.executable, "-c", script, str(tmp_path), str(start)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=ROOT) for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, [e for _, e in outs]
    lines = [o.split() for o, _ in outs]
    assert len({path for path, _ in lines}) == 1
    assert sorted(int(built) for _, built in lines) == [0, 0, 0, 1]
    built_dir = Path(lines[0][0]).parent
    assert sorted(p.name for p in built_dir.iterdir()) == ["build.log", "libimage_pipeline.so",
                                                           "lock"]


def test_missing_compiler_raises_with_its_error(monkeypatch, tmp_path, fresh_lib):
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no-such-compiler") as err:
        native.decode_jpeg(FILES[0].read_bytes())
    assert "FileNotFoundError" in str(err.value)
    with pytest.raises(RuntimeError, match="native image pipeline"):
        native.NativeBatchLoader([str(p) for p in FILES], batch_size=4, out_size=32)
    assert not list(tmp_path.glob("host-*/*.so"))


def test_compiler_failure_raises_with_its_output(monkeypatch, tmp_path, fresh_lib):
    cxx = tmp_path / "cxx"
    cxx.write_text("#!/bin/sh\necho 'jpeglib.h: No such file or directory' >&2\nexit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "CXX", str(cxx))
    with pytest.raises(RuntimeError, match="jpeglib.h: No such file") as err:
        native.build_library()
    assert "exit 1" in str(err.value)
    assert not list((tmp_path / "build").glob("host-*/*.so*"))


def test_fixtures_match_their_manifest():
    assert 24 <= len(FILES) <= 32
    assert sum(p.stat().st_size for p in FILES) <= 2 * 1024 * 1024
    kinds = {f["kind"] for f in MANIFEST["files"]}
    assert {"gray", "progressive", "rgb"} <= kinds
    assert any(min(f["width"], f["height"]) < 224 for f in MANIFEST["files"])
    for rec, path in zip(MANIFEST["files"], FILES):
        data = path.read_bytes()
        assert hashlib.sha256(data).hexdigest() == rec["sha256"], path.name
        out = native.decode_and_preprocess(data, MANIFEST["out_size"])
        # the manifest was written with the libjpeg the tests link: bitwise
        assert hashlib.sha256(out.tobytes()).hexdigest() == rec["out_sha256"], path.name
        assert float(np.abs(out).max()) == rec["out_absmax"]
        pool = MANIFEST["pool"]
        got = out.reshape(3, pool, 224 // pool, pool, 224 // pool).mean(axis=(2, 4))
        np.testing.assert_allclose(got, rec["out_pool8"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("path", FILES[:8] + FILES[-1:], ids=lambda p: p.name)
def test_decode_matches_jax_bitwise(path, jax_on_port_lib):
    data = path.read_bytes()
    rgb = native.decode_jpeg(data)
    assert rgb.dtype == np.uint8 and rgb.ndim == 3 and rgb.shape[2] == 3
    np.testing.assert_array_equal(rgb, jax_on_port_lib.decode_jpeg(data))
    for size, mean, std in ((224, CLIP_MEAN, CLIP_STD), (96, IMAGENET_MEAN, IMAGENET_STD)):
        got = native.decode_and_preprocess(data, size, mean, std)
        assert got.shape == (3, size, size) and got.dtype == np.float32
        np.testing.assert_array_equal(got, jax_on_port_lib.decode_and_preprocess(data, size,
                                                                                  mean, std))
        # the fused call is decode, then preprocess
        np.testing.assert_array_equal(got, native.preprocess_rgb(rgb, size, mean, std))


@pytest.mark.parametrize("kind", ["rgb", "gray_hw", "gray_hw1", "float01"])
def test_preprocess_matches_jax_bitwise(kind, jax_on_port_lib):
    rng = np.random.default_rng(0)
    img = {"rgb": lambda: rng.integers(0, 256, (300, 400, 3), dtype=np.uint8),
           "gray_hw": lambda: rng.integers(0, 256, (120, 90), dtype=np.uint8),
           "gray_hw1": lambda: rng.integers(0, 256, (90, 120, 1), dtype=np.uint8),
           "float01": lambda: rng.random((64, 48, 3)).astype(np.float32)}[kind]()
    for size in (32, 224):
        got = native.preprocess_rgb(img, size)
        np.testing.assert_array_equal(got, jax_on_port_lib.preprocess_rgb(img, size))


def test_preprocess_batch_and_transform_match_jax(jax_on_port_lib):
    rng = np.random.default_rng(1)
    batch = rng.integers(0, 256, (5, 70, 90, 3), dtype=np.uint8)
    got = native.preprocess_batch(batch, 48, n_threads=3)
    np.testing.assert_array_equal(got, jax_on_port_lib.preprocess_batch(batch, 48, n_threads=2))
    np.testing.assert_array_equal(got[2], native.preprocess_rgb(batch[2], 48))
    ours = native.make_native_transform(40)
    theirs = jax_on_port_lib.make_native_transform(40)
    data = FILES[3].read_bytes()
    np.testing.assert_array_equal(ours(data), theirs(data))
    np.testing.assert_array_equal(ours(bytearray(data)), theirs(data))
    chw = batch[0].transpose(2, 0, 1)
    np.testing.assert_array_equal(ours(chw), theirs(chw))
    np.testing.assert_array_equal(ours(chw), native.preprocess_rgb(batch[0], 40))


def _refs(paths, size, **kw):
    return [native.decode_and_preprocess(Path(p).read_bytes(), size, **kw) for p in paths]


def test_loader_one_epoch_covers_every_file_and_matches_jax(jax_on_port_lib):
    paths = [str(p) for p in FILES]
    refs = _refs(paths, 32)
    kw = dict(batch_size=4, out_size=32, n_workers=1, queue_depth=2, seed=7)
    ours = native.NativeBatchLoader(paths, **kw)
    theirs = jax_on_port_lib.NativeBatchLoader(paths, **kw)
    try:
        assert theirs._handle is not None  # the native loader, not JAX's thread
        assert ours.dtype == np.float32 and not ours.uint8_wire
        per_epoch = len(paths) // 4
        epochs = []
        for _ in range(2):
            seen = []
            for _ in range(per_epoch):
                batch = next(ours)
                np.testing.assert_array_equal(batch, next(theirs))
                assert batch.shape == (4, 3, 32, 32)
                for img in batch:
                    hits = [i for i, r in enumerate(refs) if np.array_equal(img, r)]
                    assert len(hits) == 1
                    seen.append(hits[0])
            assert sorted(seen) == list(range(len(paths)))
            epochs.append(seen)
        assert epochs[0] != epochs[1]  # a new shuffle each epoch
        assert ours.decode_failures() == 0
    finally:
        ours.close()
        theirs.close()
    with pytest.raises(RuntimeError, match="closed"):
        next(ours)


def test_loader_uint8_wire_gives_resized_pixels(jax_on_port_lib):
    paths = [str(p) for p in FILES[:8]]
    kw = dict(batch_size=8, out_size=48, n_workers=1, seed=3, uint8_wire=True)
    ours = native.NativeBatchLoader(paths, **kw)
    theirs = jax_on_port_lib.NativeBatchLoader(paths, **kw)
    try:
        batch = next(ours)
        assert ours.dtype == np.uint8 and batch.dtype == np.uint8
        np.testing.assert_array_equal(batch, next(theirs))
    finally:
        ours.close()
        theirs.close()
    # the resized pixels: the float pipeline with identity statistics,
    # rounded half up; and within one step of the normalized output undone
    pixels = [np.clip(r + 0.5, 0, 255).astype(np.uint8) for r in
              _refs(paths, 48, mean=(0.0, 0.0, 0.0), std=(1 / 255,) * 3)]
    m = np.asarray(CLIP_MEAN, np.float32)[:, None, None]
    s = np.asarray(CLIP_STD, np.float32)[:, None, None]
    undone = [np.clip((r * s + m) * 255.0 + 0.5, 0, 255).astype(np.uint8)
              for r in _refs(paths, 48)]
    for img in batch:
        hits = [i for i, p in enumerate(pixels) if np.array_equal(img, p)]
        assert len(hits) == 1
        assert np.abs(img.astype(int) - undone[hits[0]].astype(int)).max() <= 1


def test_loader_counts_a_corrupt_file(tmp_path):
    paths = [str(p) for p in FILES[:7]]
    bad = tmp_path / "corrupt.jpg"
    bad.write_bytes(FILES[0].read_bytes()[:200] + b"\x00" * 50)
    paths.append(str(bad))
    ld = native.NativeBatchLoader(paths, batch_size=4, out_size=32, n_workers=1, seed=0)
    try:
        batches = np.concatenate([next(ld), next(ld)])
        assert ld.decode_failures() == 1
        zero = [i for i, img in enumerate(batches) if not img.any()]
        assert len(zero) == 1
    finally:
        ld.close()
    assert ld.decode_failures() == 0  # closed


def test_loader_refuses_bad_geometry():
    paths = [str(p) for p in FILES[:4]]
    with pytest.raises(ValueError, match="full batch"):
        native.NativeBatchLoader(paths, batch_size=5)
    with pytest.raises(ValueError, match="n_workers=0"):
        native.NativeBatchLoader(paths, batch_size=4, n_workers=0)
