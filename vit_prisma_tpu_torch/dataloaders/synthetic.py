"""Synthetic mech-interp datasets (numpy only; a copy of
``vit_prisma_tpu/dataloaders/synthetic.py``, which the port may not import,
held equal to it by ``tests/test_torch_trainer.py``).

``InductionDataset`` (two shapes drawn in a row or column; the label encodes
same/different x horizontal/vertical), ``CircleDataset`` (two points on a
circle, label = sum mod p) and ``DSpritesDataset`` (shape classification
from the standard dSprites npz), with ``train_test_dataset``,
``IndexedDataset`` and, from the JAX package's ``dataloaders/imagenet.py``,
``numpy_batches``.

Datasets are indexable: ``ds[i] -> (image [C,H,W] float32, label int)`` —
the duck type the trainer consumes.
"""

from __future__ import annotations

import os

import numpy as np

IM_SIZE = 32


# -- shape primitives (induction.py:53-81) ----------------------------------

def draw_circle(image, r0, c0, radius=2, im_size=IM_SIZE):
    rr, cc = np.ogrid[:im_size, :im_size]
    image[(rr - r0) ** 2 + (cc - c0) ** 2 <= radius ** 2] = 1
    return image


def draw_line(image, r0, c0, line_length=4, im_size=IM_SIZE):
    for i in range(-line_length // 2, line_length // 2 + 1):
        if 0 <= r0 + i < im_size and 0 <= c0 < im_size:
            image[r0 + i, c0] = 1
    return image


def draw_x(image, r0, c0, x_length=5, im_size=IM_SIZE):
    for i in range(x_length):
        r = r0 - x_length // 2 + i
        if 0 <= r < im_size:
            c1 = c0 - x_length // 2 + i
            c2 = c0 + x_length // 2 - i
            if 0 <= c1 < im_size:
                image[r, c1] = 1
            if 0 <= c2 < im_size:
                image[r, c2] = 1
    return image


def draw_diagonal(image, r0, c0, line_length=4, im_size=IM_SIZE):
    for i in range(-line_length // 2, line_length // 2 + 1):
        if 0 <= r0 + i < im_size and 0 <= c0 + i < im_size:
            image[r0 + i, c0 + i] = 1
    return image


DRAW_FUNCTIONS = [draw_circle, draw_line, draw_x, draw_diagonal]


def generate_induction_arrays(padding: int = 4, offset: int = 7,
                              seed: int = 0, balance: bool = True):
    """All two-shape images (induction.py:100-155).  Labels:
    0=vertical+same, 1=vertical+diff, 2=horizontal+same, 3=horizontal+diff."""
    images, labels = [], []
    for vertical in (True, False):
        for a in range(padding, IM_SIZE - padding):
            for b in range(padding, IM_SIZE - padding - offset):
                for A in DRAW_FUNCTIONS:
                    for B in DRAW_FUNCTIONS:
                        img = np.zeros((IM_SIZE, IM_SIZE), np.float32)
                        A(img, a, b)
                        B(img, a, b + offset)
                        if vertical:
                            img = img.T
                        images.append(img)
                        same = A is B
                        labels.append(0 if (vertical and same) else
                                      1 if vertical else
                                      2 if same else 3)
    images = np.stack(images)
    labels = np.asarray(labels, np.int64)
    if balance:
        rng = np.random.default_rng(seed)
        counts = np.bincount(labels)
        n = counts.min()
        keep = np.concatenate([
            rng.permutation(np.nonzero(labels == l)[0])[:n]
            for l in range(len(counts))])
        keep = rng.permutation(keep)
        images, labels = images[keep], labels[keep]
    return images, labels


class InductionDataset:
    """Cached train/test split of the induction images (induction.py:8-50)."""

    def __init__(self, train_or_test: str = "train",
                 dir_path: str = "data/induction", transform=None,
                 test_fraction: float = 0.2, seed: int = 0):
        self.transform = transform
        cache = os.path.join(dir_path, f"all_{train_or_test}.npz")
        if not os.path.exists(cache):
            os.makedirs(dir_path, exist_ok=True)
            images, labels = generate_induction_arrays(seed=seed)
            n_test = int(len(images) * test_fraction)
            np.savez(os.path.join(dir_path, "all_test.npz"),
                     images=images[:n_test], labels=labels[:n_test])
            np.savez(os.path.join(dir_path, "all_train.npz"),
                     images=images[n_test:], labels=labels[n_test:])
        loaded = np.load(cache)
        self.images = loaded["images"]
        self.labels = loaded["labels"]

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        image = self.images[idx][None].astype(np.float32)
        if self.transform is not None:
            image = self.transform(image)
        return image, int(self.labels[idx])


class CircleDataset:
    """Modular-arithmetic-on-a-circle images (circle.py:114): two points at
    angles 2*pi*a/p and 2*pi*b/p; label = (a+b) mod p."""

    def __init__(self, p: int = 13, im_size: int = IM_SIZE, radius: int = 12,
                 dot_radius: int = 1, n_channels: int = 1, transform=None):
        self.p = p
        self.transform = transform
        imgs, labels, points = [], [], []
        center = im_size // 2
        for a in range(p):
            for b in range(p):
                img = np.zeros((im_size, im_size), np.float32)
                for v in (a, b):
                    theta = 2 * np.pi * v / p
                    r0 = int(round(center + radius * np.sin(theta)))
                    c0 = int(round(center + radius * np.cos(theta)))
                    draw_circle(img, r0, c0, dot_radius, im_size)
                if n_channels == 3:
                    img = np.repeat(img[None], 3, axis=0)
                else:
                    img = img[None]
                imgs.append(img)
                labels.append((a + b) % p)
                points.append((a, b))
        self.imgs = np.stack(imgs)
        self.labels = np.asarray(labels, np.int64)
        self.data_points = np.asarray(points)

    def __len__(self):
        return len(self.imgs)

    def __getitem__(self, idx):
        image = self.imgs[idx]
        if self.transform is not None:
            image = self.transform(image)
        return image, int(self.labels[idx])


class DSpritesDataset:
    """Shape classification over the standard dSprites archive
    (dsprites.py:8-23); labels are latents_values[:, 1] - 1."""

    def __init__(self, data_path: str):
        data = np.load(data_path, allow_pickle=True, encoding="latin1")
        self.images = data["imgs"]
        self.labels = data["latents_values"][:, 1]

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        image = self.images[idx][None].astype(np.float32)
        return image, int(self.labels[idx] - 1)


def train_test_dataset(dataset, test_split: float = 0.25, seed: int = 0):
    """Split an indexable dataset (dsprites.py:26-31)."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(dataset))
    n_test = int(len(dataset) * test_split)

    class _Subset:
        def __init__(self, base, indices):
            self.base, self.indices = base, indices

        def __len__(self):
            return len(self.indices)

        def __getitem__(self, i):
            return self.base[int(self.indices[i])]

    return {"train": _Subset(dataset, idx[n_test:]),
            "test": _Subset(dataset, idx[:n_test])}


class IndexedDataset:
    """Wrap a dataset so items come back as (image, label, index) — used by
    the eval pipelines (evals.py IndexedDataset)."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        item = self.dataset[idx]
        if isinstance(item, tuple):
            return (*item, idx)
        return item, idx


def generate_polygenic_induction_arrays(padding: int = 4, offset: int = 7,
                                        im_size: int = 64, seed: int = 0,
                                        stride: int = 4, balance: bool = True):
    """Four-shape arrangement images (polygenic_induction.py:54-130):
    two shape types A/B placed in one of six arrangement patterns
    (AAAA/ABAB/ABBA/AABB/ABBB/AAAB), horizontal or vertical; 12 labels.

    ``stride`` subsamples the position grid (the reference enumerates every
    position, producing a very large array; stride=1 reproduces that)."""
    max_shape = 5
    arrangements = ["A A A A", "A B A B", "A B B A",
                    "A A B B", "A B B B", "A A A B"]
    max_a = im_size - 3 * offset - 2 * (padding + max_shape)
    max_b = im_size - padding - max_shape
    images, labels = [], []
    for vertical in (True, False):
        for a in range(padding + max_shape, max_a, stride):
            for b in range(padding + max_shape, max_b, stride):
                for A in DRAW_FUNCTIONS:
                    for B in DRAW_FUNCTIONS:
                        if A is B:
                            continue  # A/B must differ for arrangements to be distinct
                        for ai, arr in enumerate(arrangements):
                            img = np.zeros((im_size, im_size), np.float32)
                            shapes = [A if w == "A" else B for w in arr.split()]
                            for i, fn in enumerate(shapes):
                                fn(img, a + i * offset, b, im_size=im_size)
                            if vertical:
                                img = img.T
                            images.append(img)
                            labels.append(ai + (0 if vertical else 6))
    images = np.stack(images)
    labels = np.asarray(labels, np.int64)
    if balance:
        rng = np.random.default_rng(seed)
        counts = np.bincount(labels)
        n = counts.min()
        keep = np.concatenate([
            rng.permutation(np.nonzero(labels == l)[0])[:n]
            for l in range(len(counts))])
        keep = rng.permutation(keep)
        images, labels = images[keep], labels[keep]
    return images, labels


class PolygenicInductionDataset:
    """Cached train/test split of four-shape arrangement images
    (polygenic_induction.py:9-50)."""

    def __init__(self, train_or_test: str = "train",
                 dir_path: str = "data/polygenic_induction", transform=None,
                 test_fraction: float = 0.2, seed: int = 0, stride: int = 4):
        self.transform = transform
        cache = os.path.join(dir_path, f"all_{train_or_test}.npz")
        if not os.path.exists(cache):
            os.makedirs(dir_path, exist_ok=True)
            images, labels = generate_polygenic_induction_arrays(
                seed=seed, stride=stride)
            n_test = int(len(images) * test_fraction)
            np.savez(os.path.join(dir_path, "all_test.npz"),
                     images=images[:n_test], labels=labels[:n_test])
            np.savez(os.path.join(dir_path, "all_train.npz"),
                     images=images[n_test:], labels=labels[n_test:])
        loaded = np.load(cache)
        self.images = loaded["images"]
        self.labels = loaded["labels"]

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        image = self.images[idx][None].astype(np.float32)
        if self.transform is not None:
            image = self.transform(image)
        return image, int(self.labels[idx])


def numpy_batches(dataset, batch_size: int, shuffle: bool = False,
                  seed: int = 0, with_indices: bool = False):
    """Minimal DataLoader replacement: yields stacked numpy batches."""
    order = (np.random.default_rng(seed).permutation(len(dataset))
             if shuffle else np.arange(len(dataset)))
    for i in range(0, len(dataset), batch_size):
        idx = order[i:i + batch_size]
        items = [dataset[int(j)] for j in idx]
        images = np.stack([np.asarray(it[0]) for it in items])
        labels = np.asarray([it[1] for it in items])
        if with_indices:
            yield images, labels, idx
        else:
            yield images, labels
