"""Image preprocessing pipelines (numpy and PIL; a copy of
``vit_prisma_tpu/dataloaders/transforms.py``, which the port may not import,
held equal to it by ``tests/test_torch_dataloaders.py``).

Bicubic resize of the shorter side (PIL, torchvision's
``InterpolationMode.BICUBIC``), center crop, RGB convert, [0, 1] scale and
mean/std normalize, emitted as float32 CHW numpy.  PIL is imported only when
a transform runs.

The one change from the JAX module: :func:`get_model_transform_params` asks
``transformers`` for a model's statistics from local files only, so it never
reaches the network, and looks the package up once per process (a failed
import is not cached by Python, and retrying it costs seconds a call).
Offline it gives what the JAX module gives offline: CLIP's statistics for
CLIP models, ImageNet's for the rest.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _to_pil(image):
    from PIL import Image
    if isinstance(image, Image.Image):
        return image
    arr = np.asarray(image)
    if arr.ndim == 3 and arr.shape[0] in (1, 3):  # CHW -> HWC
        arr = arr.transpose(1, 2, 0)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    return Image.fromarray(arr)


def resize_shorter_side(img, size: int):
    """torchvision Resize(size) semantics: scale the shorter side to
    ``size``, bicubic."""
    from PIL import Image
    w, h = img.size
    if w <= h:
        new_w, new_h = size, max(1, round(h * size / w))
    else:
        new_w, new_h = max(1, round(w * size / h)), size
    return img.resize((new_w, new_h), Image.BICUBIC)


def center_crop(img, size: int):
    w, h = img.size
    left = (w - size) // 2
    top = (h - size) // 2
    return img.crop((left, top, left + size, top + size))


def make_transform(image_size: int, mean: Sequence[float],
                   std: Sequence[float]) -> Callable:
    mean = np.asarray(mean, np.float32).reshape(3, 1, 1)
    std = np.asarray(std, np.float32).reshape(3, 1, 1)

    def transform(image) -> np.ndarray:
        img = _to_pil(image)
        img = resize_shorter_side(img, image_size)
        img = center_crop(img, image_size)
        img = img.convert("RGB")
        arr = np.asarray(img, np.float32) / 255.0     # HWC
        arr = arr.transpose(2, 0, 1)                   # CHW
        return (arr - mean) / std

    return transform


def get_clip_val_transforms(image_size: int = 224, mean=CLIP_MEAN,
                            std=CLIP_STD) -> Callable:
    """CLIP validation preprocessing."""
    return make_transform(image_size, mean, std)


_AUTO_IMAGE_PROCESSOR = []  # [class or None], filled at the first lookup


def _auto_image_processor():
    """``transformers.AutoImageProcessor``, or None when the package does
    not import; looked up once per process."""
    if not _AUTO_IMAGE_PROCESSOR:
        try:
            from transformers import AutoImageProcessor
        except Exception:
            AutoImageProcessor = None
        _AUTO_IMAGE_PROCESSOR.append(AutoImageProcessor)
    return _AUTO_IMAGE_PROCESSOR[0]


def get_model_transform_params(model_name: str):
    """(image_size, mean, std) for a model's preprocessing — the data
    behind :func:`get_model_transforms`, for callers that apply the
    pipeline elsewhere (the native batch loader, on-device normalize)."""
    if model_name.startswith("open-clip:") or "clip" in model_name.lower():
        return 224, CLIP_MEAN, CLIP_STD
    processor = _auto_image_processor()
    try:
        proc = processor.from_pretrained(model_name, local_files_only=True)
        size = proc.size.get("height") or proc.size.get("shortest_edge", 224)
        return size, tuple(proc.image_mean), tuple(proc.image_std)
    except Exception:
        return 224, IMAGENET_MEAN, IMAGENET_STD


def get_model_transforms(model_name: str) -> Callable:
    """Per-model transforms: the CLIP pipeline for CLIP models, the
    locally cached ``AutoImageProcessor``'s statistics otherwise (ImageNet's
    when there are none)."""
    return make_transform(*get_model_transform_params(model_name))
