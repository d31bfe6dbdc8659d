"""SAE sparsity / eval dashboards (a numpy copy of
``vit_prisma_tpu/visualization/sae_dashboards.py`` for the PyTorch port).

Per-token and per-image log-feature-frequency histograms and rare-direction
cosine-similarity histograms, written to ``cfg.save_figure_dir``.  Rendering
goes through plotly when importable, else matplotlib (Agg).  All statistics
are computed in numpy before any plotting, so the data path is test-covered
without a display stack.  An SAE's ``W_enc`` may be a PyTorch tensor on any
device: it is copied to the host first (:func:`as_numpy`).
"""

from __future__ import annotations

import os
import textwrap
from typing import Sequence

import numpy as np


def _save_dir(cfg) -> str:
    d = getattr(cfg, "save_figure_dir", None) or "figures"
    os.makedirs(d, exist_ok=True)
    return d


def hist(cfg, values, save_name: str, title: str = "",
         xlabel: str = "", bins: int = 80, show: bool = False) -> str:
    """Histogram (percent-normalized) saved as PNG+SVG (evals.py:699-746).
    Returns the PNG path."""
    values = np.asarray(values).reshape(-1)
    base = os.path.join(_save_dir(cfg), save_name)
    try:
        import plotly.express as px
        fig = px.histogram(x=values, histnorm="percent", template="ggplot2",
                           labels={"x": xlabel})
        fig.update_layout(title={"text": "<br>".join(
            textwrap.wrap(title, width=60)), "x": 0.5}, bargap=0.1)
        fig.write_image(base + ".png")
        fig.write_image(base + ".svg")
        if show:
            fig.show()
        # a stubbed/kaleido-less plotly can no-op: only trust a real file
        if os.path.exists(base + ".png"):
            return base + ".png"
    except Exception:
        pass
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(8, 5))
    weights = np.full(values.shape, 100.0 / max(len(values), 1))
    ax.hist(values, bins=bins, weights=weights, color="#4c72b0",
            edgecolor="white")
    ax.set_title("\n".join(textwrap.wrap(title, width=60)), fontsize=10)
    ax.set_xlabel(xlabel)
    ax.set_ylabel("percent")
    fig.tight_layout()
    fig.savefig(base + ".png", dpi=150)
    fig.savefig(base + ".svg")
    plt.close(fig)
    return base + ".png"


def as_numpy(a) -> np.ndarray:
    """A numpy array from an array or a tensor on any device (without
    importing torch: a tensor is recognised by its ``detach``)."""
    if hasattr(a, "detach"):
        a = a.detach().float().cpu().numpy()
    return np.asarray(a)


def rare_direction_cosine_sims(W_enc, condition: np.ndarray,
                               n_samples: int = 10_000,
                               seed: int = 0) -> np.ndarray:
    """Pairwise cosine similarities of the encoder directions selected by
    ``condition`` (a bool mask over features), randomly sampled
    (evals.py:783-793)."""
    W = as_numpy(W_enc)[:, np.asarray(condition)]
    if W.shape[1] == 0:
        return np.zeros((0,), np.float32)
    W = W / (np.linalg.norm(W, axis=0, keepdims=True) + 1e-12)
    sims = (W.T @ W).reshape(-1)
    rng = np.random.default_rng(seed)
    return sims[rng.integers(0, sims.shape[0], size=min(n_samples,
                                                        sims.shape[0] * 4))]


def visualize_sparsities(cfg, log_freq_tokens, log_freq_images,
                         conditions: Sequence[np.ndarray],
                         condition_texts: Sequence[str],
                         name: str, sparse_autoencoder,
                         show: bool = False) -> dict:
    """Full sparsity dashboard (evals.py:752-801): token/image
    log-frequency histograms plus a cosine-similarity histogram per
    feature-frequency condition (e.g. "rare" features).  Returns
    {figure_name: path}."""
    paths = {}
    log_freq_tokens = np.asarray(log_freq_tokens)
    log_freq_images = np.asarray(log_freq_images)
    paths["tokens"] = hist(
        cfg, log_freq_tokens, f"{name}_frequency_tokens_histogram",
        title=f"{name} Log Frequency of Features by Token",
        xlabel="log10(freq)", show=show)
    paths["images"] = hist(
        cfg, log_freq_images, f"{name}_frequency_images_histogram",
        title=f"{name} Log Frequency of Features by Image",
        xlabel="log10(freq)", show=show)

    W_enc = sparse_autoencoder.params["W_enc"] \
        if hasattr(sparse_autoencoder, "params") else sparse_autoencoder
    for condition, text in zip(conditions, condition_texts):
        condition = np.asarray(condition)
        pct = 100.0 * condition.sum() / max(log_freq_tokens.shape[0], 1)
        if pct == 0:
            continue
        sims = rare_direction_cosine_sims(W_enc, condition)
        paths[text] = hist(
            cfg, sims, f"{name}_low_prop_similarity_{text}",
            title=(f"{name} Cosine similarities of random {text} encoder "
                   f"directions with each other ({int(round(pct))}% of "
                   f"features)"),
            xlabel="Cosine sim", show=show)
    return paths


def default_frequency_conditions(log_freq: np.ndarray):
    """The reference's standard frequency buckets (rare/medium/high) as
    condition masks + labels."""
    log_freq = np.asarray(log_freq)
    conditions = [log_freq < -6, (log_freq >= -6) & (log_freq < -3),
                  log_freq >= -3]
    texts = ["rare", "medium", "high"]
    return conditions, texts
