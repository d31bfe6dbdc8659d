"""ImageNet class-name and emoji tables (a copy of
``vit_prisma_tpu/dataloaders/imagenet_names.py``, which the port may not
import, with its own copy of the three ``data/*.json`` tables; both are held
equal to the originals by ``tests/test_torch_analysis.py``).

The 1,000-entry index->name and index->emoji tables are public constants and
the surface of the patch-level logit lens.  An explicit JSON path argument
or ``$IMAGENET_CLASSES_JSON`` overrides the packaged table (e.g. for a
custom label set).
"""

from __future__ import annotations

import json
import os
from functools import lru_cache
from typing import Dict, Optional

_DATA_DIR = os.path.join(os.path.dirname(__file__), "data")


@lru_cache(maxsize=4)
def load_imagenet_dict(path: Optional[str] = None,
                       n_classes: int = 1000) -> Dict[int, str]:
    if path is None:
        path = os.environ.get("IMAGENET_CLASSES_JSON")
    if path and os.path.exists(path):
        with open(path) as f:
            raw = json.load(f)
        return {int(k): v for k, v in raw.items()} if isinstance(raw, dict) \
            else {i: v for i, v in enumerate(raw)}
    vendored = os.path.join(_DATA_DIR, "imagenet_dict.json")
    if n_classes == 1000 and os.path.exists(vendored):
        with open(vendored) as f:
            return {int(k): v for k, v in json.load(f).items()}
    return {i: f"class_{i}" for i in range(n_classes)}


@lru_cache(maxsize=1)
def load_imagenet100_classes() -> Dict[str, str]:
    """wnid -> class name for the ImageNet-100 subset (reference
    ``imagenet100_classes.py``, vendored)."""
    with open(os.path.join(_DATA_DIR, "imagenet100_classes.json")) as f:
        return json.load(f)


@lru_cache(maxsize=1)
def load_imagenet_emoji() -> Dict[int, str]:
    """Index->emoji map used by the patch-level logit lens (reference
    ``imagenet_emoji.py``, consumed by patch_level_logit_lens.py:9-31)."""
    with open(os.path.join(_DATA_DIR, "imagenet_emoji.json")) as f:
        return {int(k): v for k, v in json.load(f).items()}


def imagenet_index_from_word(word: str,
                             mapping: Optional[Dict[int, str]] = None) -> int:
    """First index whose class name contains ``word``
    (reference imagenet_utils.imagenet_index_from_word)."""
    mapping = mapping or load_imagenet_dict()
    word = word.lower()
    for idx, name in mapping.items():
        if word in str(name).lower():
            return idx
    raise KeyError(f"No ImageNet class matches {word!r}")


def get_imagenet_text_labels(mapping: Optional[Dict[int, str]] = None):
    mapping = mapping or load_imagenet_dict()
    return [mapping[i] for i in range(len(mapping))]


def save_imagenet_dict(path: str, mapping: Dict[int, str]):
    with open(path, "w") as f:
        json.dump({str(k): v for k, v in mapping.items()}, f)
