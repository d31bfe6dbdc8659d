"""Patch-level logit-lens image overlays (a numpy copy of
``vit_prisma_tpu/visualization/patch_level_logit_lens.py`` for the PyTorch port).

The arrays and HTML equal the JAX package's for the same inputs;
matplotlib is imported inside each plotting function.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from vit_prisma_tpu_torch.dataloaders.transforms import CLIP_MEAN, CLIP_STD


def denormalize_image(image, mean=CLIP_MEAN, std=CLIP_STD) -> np.ndarray:
    """CHW normalized -> HWC [0,1] for display."""
    img = np.asarray(image, np.float32)
    if img.ndim == 3 and img.shape[0] in (1, 3):
        mean = np.asarray(mean, np.float32).reshape(-1, 1, 1)
        std = np.asarray(std, np.float32).reshape(-1, 1, 1)
        img = img * std[: img.shape[0]] + mean[: img.shape[0]]
        img = img.transpose(1, 2, 0)
    return np.clip(img, 0, 1)


def patch_heatmap_overlay(values: Sequence[float], image_size: int,
                          patch_size: int) -> np.ndarray:
    """Per-patch scalar values (no CLS) -> pixel heatmap [H, W]."""
    n = image_size // patch_size
    vals = np.asarray(values, np.float32).reshape(n, n)
    return np.kron(vals, np.ones((patch_size, patch_size), np.float32))


def patch_text_positions(image_size: int, patch_size: int
                         ) -> List[Tuple[int, int]]:
    """Center pixel of each patch, row-major (for text labels)."""
    n = image_size // patch_size
    half = patch_size // 2
    return [(c * patch_size + half, r * patch_size + half)
            for r in range(n) for c in range(n)]


def display_grid_on_image(image, patch_size: int = 32, ax=None,
                          color: str = "white"):
    """Draw the patch grid over an image (visualize_image.py:9)."""
    import matplotlib.pyplot as plt
    img = denormalize_image(image)
    if ax is None:
        _, ax = plt.subplots()
    ax.imshow(img)
    H = img.shape[0]
    for p in range(patch_size, H, patch_size):
        ax.axhline(p - 0.5, color=color, linewidth=0.5)
        ax.axvline(p - 0.5, color=color, linewidth=0.5)
    ax.axis("off")
    return ax


def display_grid_on_image_with_heatmap(image, patch_values,
                                       patch_size: int = 32, alpha: float = 0.6,
                                       cmap: str = "viridis", ax=None):
    """Overlay a per-patch heatmap on the image
    (patch_level_logit_lens.py:11)."""
    import matplotlib.pyplot as plt
    img = denormalize_image(image)
    H = img.shape[0]
    heat = patch_heatmap_overlay(patch_values, H, patch_size)
    if ax is None:
        _, ax = plt.subplots()
    ax.imshow(img)
    hm = ax.imshow(heat, alpha=alpha, cmap=cmap)
    ax.axis("off")
    return ax, hm


def display_patch_logit_lens(image, patch_dictionary: Dict[int, list],
                             layer_idx: int = -1, patch_size: int = 32,
                             fontsize: int = 5, alpha: float = 0.55,
                             cmap: str = "viridis",
                             use_emoji: bool = False,
                             class_to_emoji: Optional[Dict[int, str]] = None,
                             save_path: Optional[str] = None, show: bool = True):
    """Annotate each patch with its predicted class at ``layer_idx``
    (patch_level_logit_lens.py:131).  ``patch_dictionary`` is the output of
    :func:`vit_prisma_tpu_torch.prisma.logit_lens.get_patch_logit_dictionary`.

    ``use_emoji`` annotates patches with emoji instead of class-name text
    (reference :16-33, ``imagenet_class_to_emoji``); ``class_to_emoji``
    defaults to the vendored ImageNet emoji table."""
    import matplotlib
    if save_path and not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    img = denormalize_image(image)
    H = img.shape[0]
    # patch 0 is CLS; spatial patches start at 1
    spatial = {k: v for k, v in patch_dictionary.items() if k >= 1}
    logits = [v[layer_idx][0] for _, v in sorted(spatial.items())]
    names = [v[layer_idx][1] for _, v in sorted(spatial.items())]
    if use_emoji:
        if class_to_emoji is None:
            from vit_prisma_tpu_torch.dataloaders.imagenet_names import load_imagenet_emoji
            class_to_emoji = load_imagenet_emoji()
        # entries carry (logit, name, class_index, ...) — reference :131
        idxs = [v[layer_idx][2] if len(v[layer_idx]) > 2 else -1
                for _, v in sorted(spatial.items())]
        names = [class_to_emoji.get(int(i), "?") for i in idxs]
        fontsize = max(fontsize, 10)

    fig, ax = plt.subplots(figsize=(8, 8))
    ax.imshow(img)
    heat = patch_heatmap_overlay(logits, H, patch_size)
    ax.imshow(heat, alpha=alpha, cmap=cmap)
    for (x, y), name in zip(patch_text_positions(H, patch_size), names):
        ax.text(x, y, str(name).split(",")[0], fontsize=fontsize,
                ha="center", va="center", color="white")
    ax.axis("off")
    if save_path:
        fig.savefig(save_path, bbox_inches="tight", dpi=200)
    if show:
        plt.show()
    else:
        plt.close(fig)
    return fig
