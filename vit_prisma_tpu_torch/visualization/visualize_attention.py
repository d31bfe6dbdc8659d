"""Attention-head grid visualization (a numpy copy of
``vit_prisma_tpu/visualization/visualize_attention.py`` for the PyTorch port).

The arrays and HTML equal the JAX package's for the same inputs;
matplotlib is imported inside each plotting function.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _log10_stable(x):
    return np.log10(np.maximum(x, 1e-6))


def prepare_attn_grid_data(total_activations, n_layers: int, n_heads: int,
                           log_transform: bool = False,
                           fourier_transform_global: bool = False,
                           fourier_transform_local: bool = False,
                           global_min_max: bool = False,
                           global_normalize: bool = False):
    """total_activations: [n_layers*n_heads, T, T] (or [L, H, T, T]).

    Returns (data [L*H, T, T], vmin, vmax) after the requested transforms
    (visualize_attention.py:33-47)."""
    acts = np.asarray(total_activations, dtype=np.float32)
    if acts.ndim == 4:
        acts = acts.reshape(-1, *acts.shape[-2:])
    data = acts.copy()
    if log_transform:
        data = _log10_stable(data)
    if fourier_transform_global:
        data = np.abs(np.fft.fftshift(np.fft.fft2(data, axes=(-2, -1)),
                                      axes=(-2, -1)))
    if fourier_transform_local:
        data = np.abs(np.fft.fftshift(np.fft.fft2(data, axes=(-2, -1)),
                                      axes=(-2, -1)))
    vmin, vmax = float(data.min()), float(data.max())
    if global_normalize:
        data = -1 + 2 * (data - vmin) / (vmax - vmin + 1e-12)
        vmin, vmax = -1.0, 1.0
    if not (global_min_max or global_normalize):
        vmin = vmax = None
    return data, vmin, vmax


def plot_attn_heads(total_activations, n_heads: int = 12, n_layers: int = 12,
                    img_shape: int = 50, idx: int = 0,
                    figsize: Tuple[int, int] = (20, 20),
                    global_min_max: bool = False,
                    global_normalize: bool = False,
                    fourier_transform_local: bool = False,
                    log_transform: bool = False,
                    fourier_transform_global: bool = False,
                    graph_type: str = "imshow_graph", cmap: str = "viridis",
                    save_path: Optional[str] = None, show: bool = True):
    """Render the head grid (requires matplotlib)."""
    data, vmin, vmax = prepare_attn_grid_data(
        total_activations, n_layers, n_heads, log_transform,
        fourier_transform_global, fourier_transform_local,
        global_min_max, global_normalize)

    import matplotlib
    if save_path and not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(n_layers, n_heads, figsize=figsize, squeeze=False)
    im = None
    for i in range(n_layers):
        for j in range(n_heads):
            d = data[i * n_heads + j]
            ax = axes[i, j]
            if graph_type == "histogram_graph":
                ax.hist(d.flatten(), bins=100, log=log_transform)
            else:
                im = ax.imshow(d, vmin=vmin, vmax=vmax, cmap=cmap)
                ax.axis("off")
            if i == 0:
                ax.set_title(f"Head {j}", fontsize=12, pad=5)
            if j == 0:
                ax.text(-0.3, 0.5, f"Layer {i}", fontsize=12, rotation=90,
                        ha="center", va="center", transform=ax.transAxes)
    if graph_type == "imshow_graph" and im is not None and vmin is not None:
        cbar_ax = fig.add_axes([0.92, 0.15, 0.02, 0.7])
        fig.colorbar(im, cax=cbar_ax)
        cbar_ax.set_title("Attention", size=12)
    plt.subplots_adjust(wspace=0.2, hspace=0.4)
    plt.suptitle(f"Attention for Image Idx {idx}", fontsize=20, y=0.93)
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
    if show:
        plt.show()
    else:
        plt.close(fig)
    return fig
