"""Conceptual-Captions-style local dataset (a copy of
``vit_prisma_tpu/dataloaders/conceptual_captions.py``, which the port may
not import, held equal to it by ``tests/test_torch_dataloaders.py``):
images in a directory and a TSV/CSV of (image_id, caption); items come back
as ``{'image', 'caption', 'image_id'}``.
"""

from __future__ import annotations

import csv
import os
from typing import Callable, Dict, Optional

import numpy as np

from vit_prisma_tpu_torch.dataloaders.imagenet import IMG_EXTENSIONS, _load_image


class ConceptualCaptionsLocalDataset:
    def __init__(self, image_dir: str, captions_path: str,
                 transform: Optional[Callable] = None,
                 delimiter: str = "\t"):
        self.image_dir = image_dir
        self.transform = transform
        self.id_to_caption: Dict[str, str] = {}
        with open(captions_path, newline="") as f:
            for row in csv.reader(f, delimiter=delimiter):
                if len(row) >= 2:
                    self.id_to_caption[row[0]] = row[1]
        self.files = sorted(
            f for f in os.listdir(image_dir)
            if f.endswith(IMG_EXTENSIONS))

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> Dict[str, object]:
        fname = self.files[idx]
        image_id = os.path.splitext(fname)[0]
        image = _load_image(os.path.join(self.image_dir, fname),
                            self.transform)
        return {"image": image,
                "caption": self.id_to_caption.get(image_id, ""),
                "image_id": image_id}
