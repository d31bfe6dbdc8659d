"""CIFAR-10 loading (numpy only; a copy of
``vit_prisma_tpu/dataloaders/cifar.py``, which the port may not import,
held equal to it by ``tests/test_torch_dataloaders.py``).

Images are decoded once from the standard CIFAR-10 python pickle batches
into one numpy array and resized (``_resize_bilinear``) and augmented with
vectorized numpy.  Works offline from a local extracted
``cifar-10-batches-py`` directory; torchvision's downloader is tried only
when that directory is missing and torchvision imports.

The returned datasets are indexable ``(image[C,H,W] float32, label)``
sequences, the protocol every loader in this package uses.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional, Sequence, Tuple

import numpy as np

CIFAR10_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR10_STD = (0.2023, 0.1994, 0.2010)
CIFAR10_CLASSES = ["airplane", "automobile", "bird", "cat", "deer",
                   "dog", "frog", "horse", "ship", "truck"]


def _find_batches_dir(root: str) -> Optional[str]:
    for cand in (root, os.path.join(root, "cifar-10-batches-py")):
        if os.path.exists(os.path.join(cand, "data_batch_1")):
            return cand
    return None


def _load_pickle_batches(batch_dir: str, train: bool
                         ) -> Tuple[np.ndarray, np.ndarray]:
    files = [f"data_batch_{i}" for i in range(1, 6)] if train \
        else ["test_batch"]
    imgs, labels = [], []
    for f in files:
        with open(os.path.join(batch_dir, f), "rb") as fh:
            d = pickle.load(fh, encoding="bytes")
        imgs.append(np.asarray(d[b"data"], np.uint8))
        labels.append(np.asarray(d[b"labels"], np.int64))
    data = np.concatenate(imgs).reshape(-1, 3, 32, 32)
    return data, np.concatenate(labels)


def _resize_bilinear(batch: np.ndarray, size: int) -> np.ndarray:
    """[N,C,32,32] float32 -> [N,C,size,size] via separable bilinear interp
    (vectorized numpy; matches align_corners=False convention)."""
    n, c, h, w = batch.shape
    if size == h:
        return batch

    def axis_weights(out, inp):
        pos = (np.arange(out) + 0.5) * inp / out - 0.5
        lo = np.clip(np.floor(pos).astype(np.int64), 0, inp - 1)
        hi = np.clip(lo + 1, 0, inp - 1)
        frac = np.clip(pos - lo, 0.0, 1.0).astype(np.float32)
        return lo, hi, frac

    ylo, yhi, yf = axis_weights(size, h)
    xlo, xhi, xf = axis_weights(size, w)
    rows = batch[:, :, ylo] * (1 - yf)[None, None, :, None] + \
        batch[:, :, yhi] * yf[None, None, :, None]
    out = rows[:, :, :, xlo] * (1 - xf) + rows[:, :, :, xhi] * xf
    return out.astype(np.float32)


def get_cifar_transform(augmentation: bool = False, image_size: int = 128,
                        normalize: bool = False, seed: int = 0):
    """Batch transform [N,C,32,32] uint8 -> [N,C,S,S] float32 in [0,1]
    (cifar_10_utils.py:10-30).  ``normalize`` applies the CIFAR mean/std
    (the reference's ``visualisation`` flag).  Augmentation = random crop
    (scale 0.8-1.0) + horizontal flip + brightness/contrast jitter — the
    moderate-augmentation recipe of the reference without the
    PIL/RandAugment dependency chain."""
    rng = np.random.default_rng(seed)

    def transform(batch: np.ndarray) -> np.ndarray:
        x = np.asarray(batch, np.float32) / 255.0
        if x.ndim == 3:
            x = x[None]
        if augmentation:
            n, c, h, w = x.shape
            # random resized crop, scale in [0.8, 1.0]
            scale = rng.uniform(0.8, 1.0)
            ch = max(1, int(round(h * np.sqrt(scale))))
            y0 = rng.integers(0, h - ch + 1)
            x0 = rng.integers(0, w - ch + 1)
            x = x[:, :, y0:y0 + ch, x0:x0 + ch]
            # horizontal flip
            if rng.random() < 0.5:
                x = x[:, :, :, ::-1]
            # brightness / contrast jitter (+-0.2)
            x = x * rng.uniform(0.8, 1.2)
            x = (x - x.mean()) * rng.uniform(0.8, 1.2) + x.mean()
            x = np.clip(x, 0.0, 1.0)
        x = _resize_bilinear(np.ascontiguousarray(x), image_size)
        if normalize:
            mean = np.asarray(CIFAR10_MEAN, np.float32).reshape(1, 3, 1, 1)
            std = np.asarray(CIFAR10_STD, np.float32).reshape(1, 3, 1, 1)
            x = (x - mean) / std
        return x

    return transform


class CIFARDataset:
    """Indexable (image, label) dataset with an optional per-item
    transform; images are pre-resized lazily in chunks."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 transform=None):
        self.images = images
        self.labels = labels
        self.transform = transform

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i: int):
        img = self.images[i]
        if self.transform is not None:
            img = self.transform(img)[0]
        else:
            img = np.asarray(img, np.float32) / 255.0
        return img, int(self.labels[i])


def load_cifar_10(dataset_path: str, split_size: float = 0.8,
                  augmentation: bool = False, image_size: int = 128,
                  visualisation: bool = False, seed: int = 42
                  ) -> Tuple[CIFARDataset, CIFARDataset, CIFARDataset]:
    """(train, val, test) datasets (cifar_10_utils.py:33-85).

    ``dataset_path`` must contain the extracted ``cifar-10-batches-py``
    pickle batches (offline-first); if absent, torchvision's downloader is
    tried as a convenience.  The train/val split uses a fixed seed like the
    reference's ``manual_seed(42)``."""
    batch_dir = _find_batches_dir(dataset_path)
    if batch_dir is None:
        try:  # optional online path
            from torchvision import datasets as tvd
            tvd.CIFAR10(root=dataset_path, train=True, download=True)
            batch_dir = _find_batches_dir(dataset_path)
        except Exception:
            pass
    if batch_dir is None:
        raise FileNotFoundError(
            f"No cifar-10-batches-py under {dataset_path!r} and no "
            "torchvision download available")

    train_imgs, train_labels = _load_pickle_batches(batch_dir, train=True)
    test_imgs, test_labels = _load_pickle_batches(batch_dir, train=False)

    rng = np.random.default_rng(seed)
    order = rng.permutation(len(train_labels))
    n_train = int(len(train_labels) * split_size)
    tr, va = order[:n_train], order[n_train:]

    train_tf = get_cifar_transform(augmentation, image_size,
                                   normalize=visualisation, seed=seed)
    eval_tf = get_cifar_transform(False, image_size,
                                  normalize=visualisation, seed=seed)
    train_ds = CIFARDataset(train_imgs[tr], train_labels[tr], train_tf)
    val_ds = CIFARDataset(train_imgs[va], train_labels[va], eval_tf)
    test_ds = CIFARDataset(test_imgs, test_labels, eval_tf)
    return train_ds, val_ds, test_ds
