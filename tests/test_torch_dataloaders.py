"""The port's dataloaders (``vit_prisma_tpu_torch/dataloaders/``: transforms,
image folders, CIFAR-10, captions) and ``VisionSAETrainer.load_dataset``
against the JAX package's, on files made in the test: the same code on the
same bytes gives the same items, held bitwise.  JAX's native module is
pointed at the port's library wherever it would run, so its own library is
never built here."""

import pickle
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

import vit_prisma_tpu.dataloaders as jax_dl
import vit_prisma_tpu.dataloaders.native as jax_native
import vit_prisma_tpu.sae as jax_sae
import vit_prisma_tpu_torch.dataloaders as port_dl
import vit_prisma_tpu_torch.sae as port_sae
from vit_prisma_tpu.dataloaders import cifar as jax_cifar
from vit_prisma_tpu.dataloaders import transforms as jax_tf
from vit_prisma_tpu_torch.dataloaders import cifar as port_cifar
from vit_prisma_tpu_torch.dataloaders import native
from vit_prisma_tpu_torch.dataloaders import transforms as port_tf

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "jpeg"
JPEGS = sorted(FIXTURES.glob("*.jpg"))


def _equal_items(a, b):
    assert type(a) is type(b) or isinstance(a, tuple)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal_items(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal_items(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.fixture
def folder(tmp_path):
    """Two classes of JPEGs, a PNG-free ImageNet-style train folder."""
    for c, files in (("cat", JPEGS[:3]), ("dog", JPEGS[3:6])):
        (tmp_path / c).mkdir()
        for f in files:
            shutil.copy(f, tmp_path / c / f.name)
    return tmp_path


def test_constants_and_exports_match_jax():
    for name in ("CLIP_MEAN", "CLIP_STD", "IMAGENET_MEAN", "IMAGENET_STD"):
        assert getattr(port_tf, name) == getattr(jax_tf, name)
    assert port_cifar.CIFAR10_CLASSES == jax_cifar.CIFAR10_CLASSES
    assert (port_cifar.CIFAR10_MEAN, port_cifar.CIFAR10_STD) == \
        (jax_cifar.CIFAR10_MEAN, jax_cifar.CIFAR10_STD)
    assert set(dir(jax_dl)) - set(dir(port_dl)) <= {"synthetic", "transforms", "imagenet",
                                                    "cifar", "conceptual_captions",
                                                    "imagenet_names", "native"}


@pytest.mark.parametrize("size", [32, 224])
def test_transforms_match_jax_bitwise(size):
    from PIL import Image
    rng = np.random.default_rng(0)
    inputs = [Image.open(JPEGS[0]), Image.open(JPEGS[5]),  # RGB, grayscale
              rng.integers(0, 256, (40, 60, 3), dtype=np.uint8),
              rng.random((3, 50, 30)).astype(np.float32)]  # CHW floats
    ours = port_tf.get_clip_val_transforms(size)
    theirs = jax_tf.get_clip_val_transforms(size)
    for img in inputs:
        got = ours(img)
        assert got.shape == (3, size, size) and got.dtype == np.float32
        np.testing.assert_array_equal(got, theirs(img))
    imnet = port_tf.make_transform(size, port_tf.IMAGENET_MEAN, port_tf.IMAGENET_STD)
    np.testing.assert_array_equal(
        imnet(inputs[2]), jax_tf.make_transform(size, jax_tf.IMAGENET_MEAN,
                                                jax_tf.IMAGENET_STD)(inputs[2]))


@pytest.mark.parametrize("name", ["open-clip:laion/CLIP-ViT-B-32-DataComp.XL-s13B-b90K",
                                  "openai/clip-vit-base-patch32"])
def test_model_transform_params_match_jax_for_clip(name):
    assert port_tf.get_model_transform_params(name) == jax_tf.get_model_transform_params(name)
    img = np.random.default_rng(2).integers(0, 256, (30, 20, 3), dtype=np.uint8)
    np.testing.assert_array_equal(port_tf.get_model_transforms(name)(img),
                                  jax_tf.get_model_transforms(name)(img))


def test_model_transform_params_offline_answer_and_one_lookup(monkeypatch):
    """Without transformers (or offline) a non-CLIP model gets ImageNet's
    statistics, the JAX module's offline answer; the package is looked up
    once per process, not once per call."""
    monkeypatch.setitem(sys.modules, "transformers", None)  # the import fails
    monkeypatch.setattr(port_tf, "_AUTO_IMAGE_PROCESSOR", [])
    for _ in range(3):
        assert port_tf.get_model_transform_params("google/vit-base-patch16-224") == \
            (224, port_tf.IMAGENET_MEAN, port_tf.IMAGENET_STD)
    assert port_tf._AUTO_IMAGE_PROCESSOR == [None]


def test_model_transform_params_never_reach_the_network(monkeypatch):
    """A model not in the local cache gets ImageNet's statistics from local
    files only."""
    calls = []

    class Processor:
        @staticmethod
        def from_pretrained(name, **kwargs):
            calls.append((name, kwargs))
            raise OSError("not cached")

    monkeypatch.setattr(port_tf, "_AUTO_IMAGE_PROCESSOR", [Processor])
    assert port_tf.get_model_transform_params("custom") == \
        (224, port_tf.IMAGENET_MEAN, port_tf.IMAGENET_STD)
    assert calls == [("custom", {"local_files_only": True})]


def test_image_folder_matches_jax(folder):
    tf_port, tf_jax = port_tf.get_clip_val_transforms(32), jax_tf.get_clip_val_transforms(32)
    ours = port_dl.ImageFolderDataset(str(folder), transform=tf_port)
    theirs = jax_dl.ImageFolderDataset(str(folder), transform=tf_jax)
    assert ours.class_to_idx == theirs.class_to_idx == {"cat": 0, "dog": 1}
    assert ours.samples == theirs.samples and len(ours) == 6
    for i in range(len(ours)):
        _equal_items(ours[i], theirs[i])
    raw = port_dl.ImageFolderDataset(str(folder))
    _equal_items(raw[4], jax_dl.ImageFolderDataset(str(folder))[4])
    for kw in (dict(batch_size=4), dict(batch_size=4, shuffle=True, seed=3, with_indices=True)):
        for a, b in zip(port_dl.numpy_batches(ours, **kw), jax_dl.numpy_batches(theirs, **kw)):
            _equal_items(tuple(a), tuple(b))


def test_imagenet_validation_matches_jax(tmp_path):
    for f in JPEGS[:5]:
        shutil.copy(f, tmp_path / f.name)
    (tmp_path / "notes.txt").write_text("not an image")
    labels = tmp_path.parent / f"{tmp_path.name}_labels.txt"
    labels.write_text("".join(f"n0000{i} {7 * i % 5}\n" for i in range(5)))
    tf_port, tf_jax = port_tf.get_clip_val_transforms(32), jax_tf.get_clip_val_transforms(32)
    for kw in (dict(), dict(labels_path=str(labels), return_index=True)):
        ours = port_dl.ImageNetValidationDataset(str(tmp_path), transform=tf_port, **kw)
        theirs = jax_dl.ImageNetValidationDataset(str(tmp_path), transform=tf_jax, **kw)
        assert ours.files == theirs.files and len(ours) == 5
        for i in range(5):
            _equal_items(ours[i], theirs[i])


def _cifar_dir(root, n=20):
    """The python pickle batches of CIFAR-10, at ``n`` images a batch."""
    d = root / "cifar-10-batches-py"
    d.mkdir()
    rng = np.random.default_rng(5)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(d / name, "wb") as fh:
            pickle.dump({b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                         b"labels": rng.integers(0, 10, n).tolist()}, fh)
    return root


@pytest.mark.parametrize("augmentation,visualisation", [(False, False), (True, True)])
def test_cifar_matches_jax(tmp_path, augmentation, visualisation):
    root = str(_cifar_dir(tmp_path))
    kw = dict(split_size=0.75, augmentation=augmentation, image_size=48,
              visualisation=visualisation, seed=3)
    ours, theirs = port_cifar.load_cifar_10(root, **kw), jax_cifar.load_cifar_10(root, **kw)
    assert [len(d) for d in ours] == [len(d) for d in theirs] == [75, 25, 20]
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.images, b.images)
        for i in (0, 1, len(a) - 1):
            _equal_items(a[i], b[i])
    x = np.random.default_rng(1).random((2, 3, 32, 32)).astype(np.float32)
    np.testing.assert_array_equal(port_cifar._resize_bilinear(x, 45),
                                  jax_cifar._resize_bilinear(x, 45))
    with pytest.raises(FileNotFoundError, match="cifar-10-batches-py"):
        port_cifar.load_cifar_10(str(tmp_path / "cifar-10-batches-py" / "missing"))


def test_conceptual_captions_match_jax(tmp_path):
    images = tmp_path / "images"
    images.mkdir()
    for i, f in enumerate(JPEGS[:3]):
        shutil.copy(f, images / f"id{i}.jpg")
    for delimiter, name in (("\t", "captions.tsv"), (",", "captions.csv")):
        (tmp_path / name).write_text(delimiter.join(["id0", "a red field"]) + "\n"
                                     + delimiter.join(["id2", "noise, mostly"]) + "\n"
                                     + "lonely\n")
        tf = port_tf.get_clip_val_transforms(32)
        ours = port_dl.ConceptualCaptionsLocalDataset(str(images), str(tmp_path / name),
                                                      transform=tf, delimiter=delimiter)
        theirs = jax_dl.ConceptualCaptionsLocalDataset(
            str(images), str(tmp_path / name), transform=jax_tf.get_clip_val_transforms(32),
            delimiter=delimiter)
        assert len(ours) == len(theirs) == 3
        for i in range(3):
            _equal_items(ours[i], theirs[i])
        assert ours[1]["caption"] == ""


def _cfgs(**fields):
    base = dict(image_size=32, store_batch_size=2, d_in=16, expansion_factor=2,
                context_size=5, log_to_wandb=False, **fields)
    return port_sae.SAERunnerConfig(**base), jax_sae.SAERunnerConfig(**base)


def test_load_dataset_imagenet_matches_jax(folder):
    pcfg, jcfg = _cfgs(dataset_name="imagenet1k", dataset_path=str(folder))
    ours = port_sae.VisionSAETrainer.load_dataset(pcfg)
    theirs = jax_sae.VisionSAETrainer.load_dataset(jcfg)
    for a, b in zip(ours, theirs):
        assert len(a) == len(b) == 6
        _equal_items(a[2], b[2])


@pytest.mark.parametrize("wire", ["float32", "uint8"])
def test_load_dataset_native_loader_matches_jax(folder, wire, monkeypatch):
    monkeypatch.setattr(jax_native, "_LIB_PATH", str(native.build_library()[0]))
    monkeypatch.setattr(jax_native, "_lib", native.get_lib())
    pcfg, jcfg = _cfgs(dataset_name="imagenet1k", dataset_path=str(folder),
                       use_native_loader=True, store_wire_dtype=wire, seed=4)
    (ours, oval), (theirs, tval) = (port_sae.VisionSAETrainer.load_dataset(pcfg),
                                    jax_sae.VisionSAETrainer.load_dataset(jcfg))
    try:
        assert isinstance(ours, native.NativeBatchLoader) and theirs._handle is not None
        assert ours.dtype == (np.uint8 if wire == "uint8" else np.float32)
        assert (ours.out_size, tuple(ours.mean)) == (32, port_tf.CLIP_MEAN)
        # the default four workers deliver batches out of order: each image
        # of either loader is one file's pipeline output
        mean, std = ((0.0,) * 3, (1 / 255,) * 3) if wire == "uint8" else \
            (port_tf.CLIP_MEAN, port_tf.CLIP_STD)
        refs = [native.decode_and_preprocess(Path(p).read_bytes(), 32, mean, std)
                for p, _ in oval.samples]
        if wire == "uint8":
            refs = [np.clip(r + 0.5, 0, 255).astype(np.uint8) for r in refs]
        refs = {r.tobytes() for r in refs}
        for loader in (ours, theirs):
            for _ in range(3):
                batch = next(loader)
                assert batch.shape == (2, 3, 32, 32) and batch.dtype == ours.dtype
                assert {img.tobytes() for img in batch} <= refs
        _equal_items(oval[5], tval[5])
    finally:
        ours.close()
        theirs.close()


def test_load_dataset_native_loader_keeps_folders_with_pngs(folder):
    from PIL import Image
    Image.new("RGB", (40, 40), (10, 20, 30)).save(folder / "dog" / "extra.png")
    pcfg, _ = _cfgs(dataset_name="imagenet1k", dataset_path=str(folder), use_native_loader=True)
    with pytest.warns(UserWarning, match="non-JPEG"):
        train, _ = port_sae.VisionSAETrainer.load_dataset(pcfg)
    assert isinstance(train, port_dl.ImageFolderDataset) and len(train) == 7


def test_load_dataset_cifar_and_folder_match_jax(tmp_path, folder):
    (tmp_path / "c").mkdir()
    root = str(_cifar_dir(tmp_path / "c"))
    pcfg, jcfg = _cfgs(dataset_name="cifar10", dataset_path=root)
    for a, b in zip(port_sae.VisionSAETrainer.load_dataset(pcfg),
                    jax_sae.VisionSAETrainer.load_dataset(jcfg)):
        assert len(a) == len(b)
        _equal_items(a[3], b[3])
    pcfg, jcfg = _cfgs(dataset_name=str(folder), dataset_path=str(folder), seed=11)
    ours, theirs = (port_sae.VisionSAETrainer.load_dataset(pcfg),
                    jax_sae.VisionSAETrainer.load_dataset(jcfg))
    assert [len(d) for d in ours] == [len(d) for d in theirs] == [4, 2]
    _equal_items(list(ours), list(theirs))


def test_port_modules_import_without_jax():
    """The slice's modules import neither jax nor the JAX package."""
    import subprocess
    code = ("import sys; sys.modules['jax'] = None; sys.modules['vit_prisma_tpu'] = None\n"
            "import vit_prisma_tpu_torch.dataloaders, vit_prisma_tpu_torch.dataloaders.native\n"
            "import vit_prisma_tpu_torch.sae.store, vit_prisma_tpu_torch.sae.train\n"
            "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'vit_prisma_tpu')"
            " and sys.modules[m] is not None]\n")
    root = Path(__file__).resolve().parent.parent
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root, timeout=300)
