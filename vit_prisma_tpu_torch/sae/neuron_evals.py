"""Neuron-basis and feature-list evaluation (PyTorch port of
``vit_prisma_tpu/sae/neuron_evals.py``): top images of raw MLP neurons
instead of SAE features, reports on chosen feature ids, and
:class:`SparsecoderEval`, the class-based eval with a linear-probe head that
takes transcoders too.  Every forward runs on the model's device under
``torch.inference_mode()``; the attention kernel (B1) runs wherever no
attention-internal hook is requested.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence

import numpy as np
import torch

from vit_prisma_tpu_torch.models.vit import vit_forward
from vit_prisma_tpu_torch.prisma.hooks import HookRuntime
from vit_prisma_tpu_torch.sae.evals import (EvalConfig, _device, _on, find_top_activations,
                                            process_dataset)
from vit_prisma_tpu_torch.sae.sae import SparseAutoencoder, sae_forward
from vit_prisma_tpu_torch.visualization.sae_dashboards import as_numpy


# ---------------------------------------------------------------------------
# Neuron-basis top images
# ---------------------------------------------------------------------------

def make_neuron_activation_step(model, layer: int, neuron_ids: Sequence[int],
                                sublayer: str = "mlp.hook_post", sampling_type: str = "avg"):
    """``step(model, images)`` -> ``[B, n_neurons]`` per-image scores of raw
    neurons at ``blocks.{layer}.{sublayer}`` (the forward stops after that
    block)."""
    vcfg = model.cfg
    hook = f"blocks.{layer}.{sublayer}"
    nid = torch.as_tensor(list(neuron_ids), dtype=torch.int64, device=_device(model))

    @torch.inference_mode()
    def step(params, images):
        rt = HookRuntime(names_filter=hook)
        vit_forward(params, vcfg, images, rt, stop_at_layer=layer + 1)
        acts = rt.cache[hook][..., nid]          # [B, ctx, n]
        if sampling_type == "cls":
            return acts[:, 0, :]
        return acts.mean(1)

    return step


def find_top_neuron_activations(data_iter: Iterable, model, layer: int,
                                neuron_ids: Sequence[int], sublayer: str = "mlp.hook_post",
                                top_k: int = 16, max_samples: int = 50_000,
                                sampling_type: str = "avg"):
    """Running top-k (value, image index) per neuron; ``data_iter`` yields
    ``(images, ..., indices)`` batches."""
    step = make_neuron_activation_step(model, layer, neuron_ids, sublayer, sampling_type)
    best_vals = best_idx = None
    processed = 0
    for batch in data_iter:
        images, indices = (batch[0], batch[-1]) if len(batch) >= 2 else batch
        (images,) = _on(model, images)
        indices = as_numpy(indices)
        scores = as_numpy(step(model, images))
        if best_vals is None:
            best_vals = scores
            best_idx = np.broadcast_to(indices[:, None], scores.shape).copy()
        else:
            best_vals = np.concatenate([best_vals, scores], 0)
            best_idx = np.concatenate(
                [best_idx, np.broadcast_to(indices[:, None], scores.shape)], 0)
        if best_vals.shape[0] > 4 * top_k:
            order = np.argsort(-best_vals, axis=0)[:top_k]
            best_vals = np.take_along_axis(best_vals, order, 0)
            best_idx = np.take_along_axis(best_idx, order, 0)
        processed += images.shape[0]
        if processed >= max_samples:
            break
    order = np.argsort(-best_vals, axis=0)[:top_k]
    best_vals = np.take_along_axis(best_vals, order, 0)
    best_idx = np.take_along_axis(best_idx, order, 0)
    return {int(n): (best_vals[:, i], best_idx[:, i]) for i, n in enumerate(neuron_ids)}


# ---------------------------------------------------------------------------
# Feature-list eval
# ---------------------------------------------------------------------------

def eval_feature_list(data_iter_fn, model, sae: SparseAutoencoder, feature_ids: Sequence[int],
                      top_k: int = 16, max_samples: int = 50_000,
                      sampling_type: str = "avg") -> Dict[int, Dict]:
    """Top images and activation stats of the given feature ids."""
    tops = find_top_activations(data_iter_fn(), model, sae, list(feature_ids), top_k=top_k,
                                max_samples=max_samples, sampling_type=sampling_type)
    out = {}
    for fid, (vals, idx) in tops.items():
        out[int(fid)] = {
            "top_values": np.asarray(vals).tolist(),
            "top_image_indices": np.asarray(idx).tolist(),
            "max_activation": float(np.max(vals)) if len(vals) else 0.0,
            "mean_top_activation": float(np.mean(vals)) if len(vals) else 0.0,
        }
    return out


# ---------------------------------------------------------------------------
# SparsecoderEval
# ---------------------------------------------------------------------------

def load_dino_linear_classifier(path_or_state, dim: int = 1536,
                                num_labels: int = 1000) -> np.ndarray:
    """The DINO linear-probe weights as a ``[num_labels, dim]`` float32
    matrix, :class:`SparsecoderEval`'s classifier: from a local
    ``.pth``/``.pt`` file or a loaded state dict (``module.`` and
    ``linear.`` prefixes dropped)."""
    if isinstance(path_or_state, str):
        blob = torch.load(path_or_state, map_location="cpu", weights_only=False)
        state = blob.get("state_dict", blob)
    else:
        state = path_or_state
    norm = {k.replace("module.", "").replace("linear.", ""): v for k, v in state.items()}
    W = np.asarray(as_numpy(norm["weight"]), np.float32)
    assert W.shape == (num_labels, dim), W.shape
    return W


class SparsecoderEval:
    """The eval metrics of one SAE or transcoder with a linear-probe head:
    ``classifier`` ``[n_classes, d_emb]`` (or its transpose) stands for the
    reference's DINO ``LinearClassifier``."""

    def __init__(self, sae: SparseAutoencoder, model, classifier,
                 cfg: Optional[EvalConfig] = None):
        self.sae = sae
        self.model = model
        classifier = np.asarray(as_numpy(classifier))
        # rows must be [n_classes, d_emb] for the eval step
        self.classifier = classifier.T if classifier.shape[0] != model.cfg.n_classes \
            else classifier
        self.cfg = cfg or EvalConfig()

    @torch.inference_mode()
    def explained_variance(self, images) -> float:
        """The EV of the SAE's output at its hook point on a batch, the
        trainer's formula (a transcoder's output held to its input rows, as
        the JAX package computes it)."""
        scfg = self.sae.cfg
        rt = HookRuntime(names_filter=scfg.hook_point)
        (images,) = _on(self.model, images)
        vit_forward(self.model, self.model.cfg, images, rt)
        acts = rt.cache[scfg.hook_point]
        if scfg.hook_point_head_index is not None:
            acts = acts[:, :, scfg.hook_point_head_index]
        acts = acts.reshape(-1, acts.shape[-1])
        out = sae_forward(self.sae.params, scfg, acts, training=False)
        resid = torch.square(acts - out.sae_out).sum(-1)
        total = torch.square(acts - acts.mean(0)).sum(-1)
        return float((1 - resid / total).mean())

    def run(self, data_iter_fn) -> Dict[str, float]:
        stats = process_dataset(self.model, self.sae,
                                ((im, lb) for im, lb, *_ in data_iter_fn()),
                                self.classifier, self.cfg)
        # the EV on the first eval batch
        ev = self.explained_variance(next(iter(data_iter_fn()))[0])
        return {
            "explained_variance": ev,
            "avg_l0": stats["avg_l0"],
            "avg_l0_cls": stats["avg_l0_cls"],
            "avg_cos_sim": stats["avg_cos_sim"],
            "ce_clean": stats["avg_loss"],
            "ce_recon": stats["avg_reconstruction_loss"],
            "ce_zero_abl": stats["avg_zero_abl_loss"],
            "pct_ce_recovered": 100.0 * stats["ce_recovered"],
            "pct_alive": 100.0 * stats["alive_fraction"],
        }
