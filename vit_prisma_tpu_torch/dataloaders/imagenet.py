"""Filesystem image datasets (numpy and PIL; a copy of
``vit_prisma_tpu/dataloaders/imagenet.py``, which the port may not import,
held equal to it by ``tests/test_torch_dataloaders.py``).

``ImageNetValidationDataset`` (a flat directory of images and a label file,
optional index return) and ``ImageFolderDataset``, the class-per-folder
layout the SAE trainer's ``load_dataset`` reads.  Items come back as float32
CHW numpy.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Tuple

import numpy as np

from vit_prisma_tpu_torch.dataloaders.synthetic import numpy_batches  # noqa: F401

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp", ".JPEG", ".JPG")


def _load_image(path: str, transform: Optional[Callable]):
    from PIL import Image
    img = Image.open(path).convert("RGB")
    if transform is not None:
        return transform(img)
    arr = np.asarray(img, np.float32) / 255.0
    return arr.transpose(2, 0, 1)


class ImageFolderDataset:
    """class-per-subdirectory layout -> (image, class_index)."""

    def __init__(self, root: str, transform: Optional[Callable] = None):
        self.root = root
        self.transform = transform
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples: List[Tuple[str, int]] = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fname in sorted(os.listdir(cdir)):
                if fname.endswith(IMG_EXTENSIONS):
                    self.samples.append((os.path.join(cdir, fname),
                                         self.class_to_idx[c]))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        path, label = self.samples[idx]
        return _load_image(path, self.transform), label


class ImageNetValidationDataset:
    """Flat directory of validation images + a label file with one integer
    per line (sorted-filename order), optional index return
    (imagenet_dataset.py:94)."""

    def __init__(self, images_dir: str, labels_path: Optional[str] = None,
                 transform: Optional[Callable] = None,
                 return_index: bool = False):
        self.images_dir = images_dir
        self.transform = transform
        self.return_index = return_index
        self.files = sorted(f for f in os.listdir(images_dir)
                            if f.endswith(IMG_EXTENSIONS))
        if labels_path is not None:
            with open(labels_path) as f:
                self.labels = [int(line.strip().split()[-1])
                               for line in f if line.strip()]
            assert len(self.labels) >= len(self.files), \
                "label file shorter than image list"
        else:
            self.labels = [0] * len(self.files)

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx):
        img = _load_image(os.path.join(self.images_dir, self.files[idx]),
                          self.transform)
        label = self.labels[idx]
        if self.return_index:
            return img, label, idx
        return img, label
