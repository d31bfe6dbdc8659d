"""Notebook and tutorial helpers (PyTorch port of
``vit_prisma_tpu/utils/tutorial_utils.py``).

``load_clip_models`` through the port's ``load_hooked_model``; top-1
accuracy over (images, labels) iterables, clean or with an SAE's
reconstruction substituted at its hook point (``run_with_hooks`` with
``make_replacement_hook``); SAE feature activations; and the
matplotlib-only plotting helpers, which import matplotlib when called.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from vit_prisma_tpu_torch.sae.evals import make_replacement_hook
from vit_prisma_tpu_torch.sae.sae import SparseAutoencoder


def load_clip_models(model_name: str = "open-clip:laion/CLIP-ViT-B-32-DataComp.XL-s13B-b90K",
                     **kwargs):
    """(vision, text) pair for a CLIP checkpoint (tutorial_utils.py:25);
    ``kwargs`` go to both ``load_hooked_model`` calls (``state_dict=``,
    ``device=``, ...)."""
    from vit_prisma_tpu_torch.models.loading.loader import load_hooked_model
    vision = load_hooked_model(model_name, **kwargs)
    text = load_hooked_model(model_name, model_type="text", **kwargs)
    return vision, text


def calculate_clean_accuracy(model, data_iter: Iterable,
                             classifier=None,
                             sae: Optional[SparseAutoencoder] = None) -> float:
    """Top-1 accuracy, optionally with the SAE reconstruction substituted at
    its hook point (tutorial_utils.py:60-140).  ``classifier`` ``[d, n]``:
    if given, logits = output @ classifier; else the model output is
    already logits."""
    device = next(model.parameters()).device
    fwd_hooks = None
    if sae is not None:
        fwd_hooks = [(sae.cfg.hook_point, make_replacement_hook(sae))]
    cls = None if classifier is None else torch.as_tensor(classifier).to(device)
    correct = n = 0
    for images, labels in data_iter:
        images = torch.as_tensor(np.asarray(images)).to(device)
        labels = np.asarray(labels)
        if fwd_hooks is not None:
            out = model.run_with_hooks(images, fwd_hooks=fwd_hooks)
        else:
            out = model(images)
        if cls is not None:
            out = out @ cls.to(out.dtype)
        pred = torch.argmax(out, dim=-1).cpu().numpy()
        correct += int((pred == labels).sum())
        n += len(labels)
    return correct / max(n, 1)


def calculate_substitution_accuracy_delta(model, sae, data_iter_fn,
                                          classifier=None) -> Tuple[float, float]:
    """(clean_acc, substituted_acc) over a re-iterable dataset."""
    clean = calculate_clean_accuracy(model, data_iter_fn(), classifier)
    subbed = calculate_clean_accuracy(model, data_iter_fn(), classifier, sae=sae)
    return clean, subbed


# ---------------------------------------------------------------------------
# Notebook plotting helpers (reference tutorial_utils.py:117-218).
# Matplotlib-only (no plotly/pandas dependency); figures render inline in
# notebooks and can be saved via the returned Figure objects.
# ---------------------------------------------------------------------------

def plot_image(image, unstandardise=True, ax=None):
    """Show one CHW image; undoes ImageNet normalization when asked
    (tutorial_utils.py:117-131)."""
    import matplotlib.pyplot as plt
    import numpy as np
    img = np.asarray(image, np.float32)
    if unstandardise:
        mean = np.asarray([0.485, 0.456, 0.406], np.float32).reshape(-1, 1, 1)
        std = np.asarray([0.229, 0.224, 0.225], np.float32).reshape(-1, 1, 1)
        img = img * std[: img.shape[0]] + mean[: img.shape[0]]
    img = np.clip(img.transpose(1, 2, 0), 0, 1)
    if ax is None:
        _, ax = plt.subplots()
    ax.imshow(img)
    ax.axis("off")
    return ax


def get_feature_activations(model_input, model, sae):
    """SAE feature activations at the SAE's hook point
    (tutorial_utils.py:133-142), on the model's device."""
    from vit_prisma_tpu_torch.sae.sae import sae_forward
    device = next(model.parameters()).device
    _, cache = model.run_with_cache(torch.as_tensor(model_input).to(device),
                                    names_filter=sae.cfg.hook_point,
                                    return_cache_object=False)
    acts = cache[sae.cfg.hook_point]
    out = sae_forward(sae.params, sae.cfg, acts, training=False)
    return out.feature_acts


def plot_act_distribution(values, n_top: int = 10, threshold: float = 0.01,
                          ax=None):
    """Bar plot of feature activations above threshold with the top-n
    highlighted; returns (top_indices, top_values)
    (tutorial_utils.py:144-183)."""
    import matplotlib.pyplot as plt
    import numpy as np
    data = np.asarray(values).reshape(-1)
    top_indices = np.argsort(data)[-n_top:]
    top_values = data[top_indices]
    if ax is None:
        _, ax = plt.subplots(figsize=(12, 4))
    keep = data > threshold
    ax.bar(np.nonzero(keep)[0], data[keep], width=2.0, color="#4c72b0")
    ax.scatter(top_indices, top_values, color="red", s=18, zorder=3)
    for idx, val in zip(top_indices, top_values):
        ax.annotate(str(int(idx)), (idx, val), fontsize=7,
                    ha="center", va="bottom")
    ax.set_xlabel("Feature Index")
    ax.set_ylabel("Feature Value")
    ax.set_title("Feature Activations")
    return top_indices, top_values


def plot_imgs_for_one_feature(feature_idx, image_indices, activation_values,
                              viz_data, cfg, show=True):
    """Grid of the top-activating images for one feature
    (tutorial_utils.py:185-206)."""
    import math
    import matplotlib.pyplot as plt
    import numpy as np
    n = len(image_indices)
    grid = int(math.ceil(math.sqrt(n)))
    rows = int(math.ceil(n / grid))
    fig, axs = plt.subplots(rows, grid, figsize=(3 * grid, 3 * rows),
                            squeeze=False)
    fig.suptitle(f"Layer: {cfg.hook_point}, Feature: {feature_idx}")
    axs = axs.flatten()
    i = -1
    for i, (image_idx, act) in enumerate(zip(image_indices,
                                             activation_values)):
        item = viz_data[int(image_idx)]
        img = np.asarray(item[0] if isinstance(item, (tuple, list)) else item)
        axs[i].imshow(np.clip(img.transpose(1, 2, 0), 0, 1))
        axs[i].set_title(f"Img idx: {int(image_idx)} Act: {float(act):.3f}",
                         fontsize=8)
        axs[i].axis("off")
    for j in range(i + 1, len(axs)):
        axs[j].axis("off")
    fig.tight_layout()
    if show:
        plt.show()
    return fig


def plot_top_imgs_for_features(top_indices, ref_imgs_per_feat, viz_data, sae,
                               top_k: int = 10, show=True):
    """Top-activating-image grids for the top-k features
    (tutorial_utils.py:208-218).  ``ref_imgs_per_feat`` maps feature index
    -> {"values": acts, "indices": image indices} (the output of the
    eval suite's top-image mining)."""
    figs = []
    for feature_idx in list(top_indices)[-top_k:]:
        v = ref_imgs_per_feat[int(feature_idx)]
        figs.append(plot_imgs_for_one_feature(
            int(feature_idx), v["indices"], v["values"], viz_data, sae.cfg,
            show=show))
    return figs
