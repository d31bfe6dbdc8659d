"""SAE evaluation (PyTorch port of ``vit_prisma_tpu/sae/evals.py``).

``process_dataset`` aggregates, over a labelled dataset, the clean,
SAE-substituted and zero-ablated cross-entropies (and the CE recovered from
them), L0 per patch, CLS token and image, the cosine similarity of input and
reconstruction, and each feature's firing frequency;
``sweep_process_dataset`` does the same for all layers of an SAE sweep at
once.  ``find_top_activations`` mines each feature's top images,
``get_heatmap``/``image_patch_heatmap`` map one feature over an image's
patches, and ``evaluate`` runs the whole pipeline and writes its files.

Each dataset batch is one eval step (:func:`make_eval_step`): the clean
forward caching the hook, the SAE's forward, and the substituted and
zero-ablated forwards, all on the model's device under
``torch.inference_mode()``.  The batch's statistics stay on the device; the
host reads them once every ``_FETCH_EVERY`` batches, in one transfer.  The
sweep step (:func:`make_sweep_eval_step`) runs one clean forward for all
layers and, for ``hook_resid_post`` without a head index, each layer's
substituted and zero-ablated forwards as one 2B-batch suffix from the next
block (``start_at_layer``); other hook points take a full 2B forward with an
editing hook per layer.  The model's blocks run the attention kernel (B1)
wherever no attention-internal hook is requested, as in any forward.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, NamedTuple, Optional

import numpy as np
import torch

from vit_prisma_tpu_torch.models.vit import vit_forward
from vit_prisma_tpu_torch.prisma.hooks import HookRuntime
from vit_prisma_tpu_torch.sae.sae import SparseAutoencoder, encode, sae_forward
from vit_prisma_tpu_torch.visualization.sae_dashboards import as_numpy


# ---------------------------------------------------------------------------
# Hooks
# ---------------------------------------------------------------------------

def zero_ablate_hook(value, hook):
    return torch.zeros_like(value)


def _set_head(value, head, new):
    """``value`` with its head ``head`` (axis 2) replaced by ``new``."""
    out = value.clone()
    out[:, :, head] = new.to(value.dtype)
    return out


def make_replacement_hook(sae: SparseAutoencoder):
    """A hook replacing the activation by the SAE's reconstruction (the
    head's slice for a head-index SAE)."""
    scfg = sae.cfg
    params = sae.params
    head = scfg.hook_point_head_index

    def replacement(value, hook):
        if head is None:
            recon = sae_forward(params, scfg, value, training=False).sae_out
            return recon.to(value.dtype)
        new = sae_forward(params, scfg, value[:, :, head], training=False).sae_out
        return _set_head(value, head, new)

    return replacement


# ---------------------------------------------------------------------------
# Eval config
# ---------------------------------------------------------------------------

@dataclass
class EvalConfig:
    batch_size: int = 32
    eval_max: int = 2048              # max samples for stats
    samples_per_bin: int = 2          # features sampled per sparsity bin
    max_images_per_feature: int = 16  # top-k images per feature
    sampling_type: str = "avg"        # 'avg' | 'cls'
    top_image_max_samples: int = 50_000
    sae_path: str = "."
    verbose: bool = False


class BatchStats(NamedTuple):
    loss: torch.Tensor
    recons_loss: torch.Tensor
    zero_abl_loss: torch.Tensor
    l0_patches: torch.Tensor          # [B] mean over non-CLS tokens
    l0_cls: torch.Tensor              # [B]
    l0_image: torch.Tensor            # [B] sum over all tokens
    cos_sim: torch.Tensor             # scalar
    act_counts: torch.Tensor          # [d_sae] (#tokens where feature fired)
    n_tokens: torch.Tensor            # scalar


def _ce(logits, labels):
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels[:, None]).mean()


def _logits(emb, class_emb):
    """``emb @ class_emb.T`` in the promoted dtype, as JAX promotes."""
    dt = torch.promote_types(emb.dtype, class_emb.dtype)
    return emb.to(dt) @ class_emb.to(dt).T


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _on(model, images, labels=None, class_emb=None):
    """The step's inputs as tensors on the model's device (labels int64)."""
    dev = _device(model)
    out = [torch.as_tensor(images).to(dev)]
    if labels is not None:
        out.append(torch.as_tensor(labels).to(dev, torch.int64))
    if class_emb is not None:
        out.append(torch.as_tensor(class_emb).to(dev))
    return out


def _l0_split(l0_tok, use_cls_token: bool):
    """(l0_patches, l0_cls) of per-token L0 ``[..., ctx]``: the CLS/patches
    split exists only for models with a CLS token at position 0."""
    if use_cls_token:
        return l0_tok[..., 1:].mean(-1), l0_tok[..., 0]
    return l0_tok.mean(-1), l0_tok.mean(-1)


def make_eval_step(model, sae: SparseAutoencoder):
    """The per-batch eval program: ``step(model, sae_params, images, labels,
    class_embeddings) -> BatchStats``.  ``class_embeddings`` ``[n_classes,
    d]`` are zero-shot text embeddings (CLIP) or a linear-probe matrix;
    logits are ``emb @ E^T``.

    Token-subset SAEs (``cls_token_only`` / ``use_patches_only``) define a
    reconstruction only for the rows they were trained on: the substituted
    forward writes back only those rows and the zero-ablated forward zeroes
    the same rows, as in the JAX package."""
    vcfg = model.cfg
    scfg = sae.cfg
    hook = scfg.hook_point
    head = scfg.hook_point_head_index
    cls_only = bool(getattr(scfg, "cls_token_only", False))
    patches_only = bool(getattr(scfg, "use_patches_only", False))

    def _rows(a):
        if cls_only:
            return a[:, :1]
        if patches_only:
            return a[:, 1:]
        return a

    def _set_rows(value, new):
        new = new.to(value.dtype)
        if not (cls_only or patches_only):
            return new
        out = value.clone()
        if cls_only:
            out[:, :1] = new
        else:
            out[:, 1:] = new
        return out

    @torch.inference_mode()
    def step(params, sae_params, images, labels, class_emb):
        rt = HookRuntime(names_filter=hook)
        clean_emb = vit_forward(params, vcfg, images, rt)
        act = rt.cache[hook]
        act_for_sae = _rows(act[:, :, head] if head is not None else act)

        out = sae_forward(sae_params, scfg, act_for_sae, training=False)
        feats = out.feature_acts       # [B, rows, d_sae]
        sae_out = out.sae_out

        def subst(value, h):
            if head is None:
                return _set_rows(value, sae_out)
            return _set_head(value, head, _set_rows(value[:, :, head], sae_out))

        def zero(value, h):
            if not (cls_only or patches_only):
                return zero_ablate_hook(value, h)
            return _set_rows(value, torch.zeros_like(_rows(value)))

        rt_sub = HookRuntime(names_filter=(), fwd_hooks=((hook, subst),), record=False)
        recons_emb = vit_forward(params, vcfg, images, rt_sub)
        rt_zero = HookRuntime(names_filter=(), fwd_hooks=((hook, zero),), record=False)
        zero_emb = vit_forward(params, vcfg, images, rt_zero)

        loss = _ce(_logits(clean_emb, class_emb), labels)
        recons_loss = _ce(_logits(recons_emb, class_emb), labels)
        zero_loss = _ce(_logits(zero_emb, class_emb), labels)

        l0_tok = (feats > 0).float().sum(-1)          # [B, rows]
        if cls_only:
            l0_cls = l0_tok[:, 0]
            l0_patches = torch.zeros_like(l0_cls)
        elif patches_only:
            l0_patches = l0_tok.mean(-1)
            l0_cls = torch.zeros_like(l0_patches)
        else:
            l0_patches, l0_cls = _l0_split(l0_tok, vcfg.use_cls_token)
        return BatchStats(
            loss=loss, recons_loss=recons_loss, zero_abl_loss=zero_loss,
            l0_patches=l0_patches, l0_cls=l0_cls, l0_image=l0_tok.sum(-1),
            cos_sim=_token_cos_sim(act_for_sae, sae_out),
            act_counts=(feats.abs() > 0).reshape(-1, feats.shape[-1]).float().sum(0),
            n_tokens=torch.tensor(float(feats.shape[0] * feats.shape[1]), device=feats.device))

    return step


def make_sweep_eval_step(model, cfg, layers):
    """The all-layer sweep eval program: ``step(model, sweep_params, images,
    labels, class_embeddings) -> BatchStats`` with a leading ``[L]`` layer
    axis, ``sweep_params`` the sweep trainer's stacked ``[L, ...]`` SAE
    params.

    One clean forward caches every sweep layer's activations; each layer's
    SAE forward follows, and for the ``hook_resid_post`` sweep without a
    head index its substituted and zero-ablated forwards share the clean
    prefix: one 2B-batch suffix from block l + 1.  Total block cost L +
    sum over l of (L - l - 1) instead of 2 L per layer.  Each layer's
    statistics are taken as soon as its SAE has run, so the ``[L, B, ctx,
    d_sae]`` activations of all layers never exist at once."""
    vcfg = model.cfg
    layers = tuple(int(l) for l in layers)
    scfg = cfg.replace(sweep_layers=None, hook_point_layer=layers[0])
    head = cfg.hook_point_head_index
    hook_names = tuple(f"blocks.{l}.{cfg.layer_subtype}" for l in layers)
    # prefix sharing is exact only where the hook value IS the residual
    # stream entering the next block; other subtypes (or a head slice)
    # take a full 2B forward with an editing hook per layer.
    resid_fast = cfg.layer_subtype == "hook_resid_post" and head is None

    @torch.inference_mode()
    def step(params, sweep_params, images, labels, class_emb):
        rt = HookRuntime(names_filter=hook_names)
        clean_emb = vit_forward(params, vcfg, images, rt)
        clean_loss = _ce(_logits(clean_emb, class_emb), labels)
        B = images.shape[0]
        per_layer = []
        for i, l in enumerate(layers):
            act = rt.cache[hook_names[i]]
            act_for_sae = act[:, :, head] if head is not None else act
            out = sae_forward({k: v[i] for k, v in sweep_params.items()}, scfg,
                              act_for_sae, training=False)
            feats, sae_out = out.feature_acts, out.sae_out
            if resid_fast:
                sub = sae_out.to(act.dtype)
                both = torch.cat([sub, torch.zeros_like(sub)], dim=0)
                emb = vit_forward(params, vcfg, both, start_at_layer=l + 1)
            else:
                def edit(value, hook, sae_out=sae_out):
                    if head is None:
                        rec = sae_out.to(value.dtype)
                        return torch.cat([rec, torch.zeros_like(rec)], dim=0)
                    rec = _set_head(value[:B], head, sae_out)
                    # zero_ablate_hook zeros the WHOLE hook value, head
                    # slice or not, as make_eval_step does
                    return torch.cat([rec, torch.zeros_like(value[B:])], dim=0)

                rt_e = HookRuntime(names_filter=(), fwd_hooks=((hook_names[i], edit),),
                                   record=False)
                emb = vit_forward(params, vcfg, torch.cat([images, images], dim=0), rt_e)
            logits = _logits(emb, class_emb)
            l0_tok = (feats > 0).float().sum(-1)          # [B, ctx]
            l0_patches, l0_cls = _l0_split(l0_tok, vcfg.use_cls_token)
            per_layer.append(BatchStats(
                loss=clean_loss, recons_loss=_ce(logits[:B], labels),
                zero_abl_loss=_ce(logits[B:], labels),
                l0_patches=l0_patches, l0_cls=l0_cls, l0_image=l0_tok.sum(-1),
                cos_sim=_token_cos_sim(act_for_sae, sae_out),
                act_counts=(feats.abs() > 0).reshape(-1, feats.shape[-1]).float().sum(0),
                n_tokens=torch.tensor(float(feats.shape[0] * feats.shape[1]),
                                      device=feats.device)))
            del feats, sae_out, out
        return BatchStats(*(torch.stack(f) for f in zip(*per_layer)))

    return step


def _token_cos_sim(a, b):
    """Cosine similarity as the reference computes it: across the flattened
    token axis, averaged over d."""
    a = a.reshape(-1, a.shape[-1])
    b = b.reshape(-1, b.shape[-1])
    an = a / (torch.linalg.norm(a, dim=0, keepdim=True) + 1e-8)
    bn = b / (torch.linalg.norm(b, dim=0, keepdim=True) + 1e-8)
    return (an * bn).sum(0).mean()


def calculate_log_frequencies(total_acts, total_count):
    if total_acts is None:  # zero batches processed
        return np.zeros((0,), np.float32)
    return np.log10(np.asarray(total_acts) / max(total_count, 1) + 1e-12)


_FETCH_EVERY = 8  # eval batches buffered on the device between host fetches


def _fetch(stats: List[BatchStats]) -> List[BatchStats]:
    """Each batch's statistics as float32 numpy arrays, from one
    device-to-host transfer for all of them."""
    flat = [f.reshape(-1).float() for s in stats for f in s]
    host = torch.cat(flat).cpu().numpy()
    out, at, fields = [], 0, iter(flat)
    for s in stats:
        vals = []
        for f in s:
            n = next(fields).numel()
            vals.append(host[at:at + n].reshape(tuple(f.shape)))
            at += n
        out.append(BatchStats(*vals))
    return out


def _summary(acc, n, l0s, l0s_cls, l0s_img, cos, act_counts, total_tokens, total_images):
    avg_loss = acc["loss"] / n
    avg_recons = acc["recons"] / n
    avg_zero = acc["zero"] / n
    ce_recovered = ((avg_zero - avg_recons) / (avg_zero - avg_loss)
                    if avg_zero != avg_loss else float("nan"))
    return {
        "avg_loss": avg_loss,
        "avg_reconstruction_loss": avg_recons,
        "avg_zero_abl_loss": avg_zero,
        "ce_recovered": ce_recovered,
        "avg_l0": float(np.mean(l0s)) if l0s else 0.0,
        "avg_l0_cls": float(np.mean(l0s_cls)) if l0s_cls else 0.0,
        "avg_l0_image": float(np.mean(l0s_img)) if l0s_img else 0.0,
        "avg_cos_sim": float(np.mean(cos)) if cos else 0.0,
        "log_frequencies_per_token": calculate_log_frequencies(act_counts, total_tokens),
        "log_frequencies_per_image": calculate_log_frequencies(act_counts, total_images),
        "alive_fraction": float((act_counts > 0).mean()) if act_counts is not None else 0.0,
    }


def process_dataset(model, sae: SparseAutoencoder, data_iter: Iterable,
                    class_embeddings, cfg: EvalConfig) -> Dict[str, Any]:
    """Aggregate metrics over a labelled dataset; ``data_iter`` yields
    ``(images, labels)`` batches (numpy arrays or tensors).  The batches'
    statistics stay on the device and reach the host in one transfer every
    ``_FETCH_EVERY`` batches."""
    step = make_eval_step(model, sae)
    totals = dict(loss=0.0, recons=0.0, zero=0.0)
    l0s, l0s_cls, l0s_img, cos = [], [], [], []
    act_counts = None
    total_tokens, samples = 0, 0
    pending: List[Any] = []  # [(B, device BatchStats), ...]

    def flush():
        nonlocal act_counts, total_tokens
        if not pending:
            return
        for (B, _), s in zip(pending, _fetch([s for _, s in pending])):
            totals["loss"] += float(s.loss) * B
            totals["recons"] += float(s.recons_loss) * B
            totals["zero"] += float(s.zero_abl_loss) * B
            l0s.extend(s.l0_patches.tolist())
            l0s_cls.extend(s.l0_cls.tolist())
            l0s_img.extend(s.l0_image.tolist())
            cos.append(float(s.cos_sim))
            act_counts = s.act_counts if act_counts is None else act_counts + s.act_counts
            total_tokens += int(s.n_tokens)
        pending.clear()

    (class_emb,) = _on(model, class_embeddings)
    for images, labels in data_iter:
        images, labels = _on(model, images, labels)
        B = images.shape[0]
        pending.append((B, step(model, sae.params, images, labels, class_emb)))
        samples += B
        if len(pending) >= _FETCH_EVERY:
            flush()
        if samples >= cfg.eval_max:
            break
    flush()
    return _summary(totals, max(samples, 1), l0s, l0s_cls, l0s_img, cos, act_counts,
                    total_tokens, samples)


def sweep_process_dataset(model, cfg, layers, sweep_params, data_iter: Iterable,
                          class_embeddings, eval_cfg: EvalConfig) -> List[Dict[str, Any]]:
    """:func:`process_dataset` for an all-layer sweep: every batch runs one
    :func:`make_sweep_eval_step` covering all L layers.  Returns one metric
    dict per sweep layer."""
    step = make_sweep_eval_step(model, cfg, layers)
    L = len(layers)
    acc = [dict(loss=0.0, recons=0.0, zero=0.0) for _ in range(L)]
    l0s = [[] for _ in range(L)]
    l0s_cls = [[] for _ in range(L)]
    l0s_img = [[] for _ in range(L)]
    cos = [[] for _ in range(L)]
    act_counts: List[Optional[np.ndarray]] = [None] * L
    total_tokens, samples = 0, 0
    pending: List[Any] = []

    def flush():
        nonlocal total_tokens
        if not pending:
            return
        for (B, _), s in zip(pending, _fetch([s for _, s in pending])):
            for i in range(L):
                acc[i]["loss"] += float(s.loss[i]) * B
                acc[i]["recons"] += float(s.recons_loss[i]) * B
                acc[i]["zero"] += float(s.zero_abl_loss[i]) * B
                l0s[i].extend(s.l0_patches[i].tolist())
                l0s_cls[i].extend(s.l0_cls[i].tolist())
                l0s_img[i].extend(s.l0_image[i].tolist())
                cos[i].append(float(s.cos_sim[i]))
                act_counts[i] = s.act_counts[i] if act_counts[i] is None \
                    else act_counts[i] + s.act_counts[i]
            total_tokens += int(s.n_tokens[0])
        pending.clear()

    (class_emb,) = _on(model, class_embeddings)
    for images, labels in data_iter:
        images, labels = _on(model, images, labels)
        B = images.shape[0]
        pending.append((B, step(model, sweep_params, images, labels, class_emb)))
        samples += B
        if len(pending) >= _FETCH_EVERY:
            flush()
        if samples >= eval_cfg.eval_max:
            break
    flush()
    return [{"layer": int(layer),
             **_summary(acc[i], max(samples, 1), l0s[i], l0s_cls[i], l0s_img[i], cos[i],
                        act_counts[i], total_tokens, samples)}
            for i, layer in enumerate(layers)]


# ---------------------------------------------------------------------------
# Sparsity intervals + feature sampling
# ---------------------------------------------------------------------------

SPARSITY_INTERVALS = [
    (-8, -6), (-6, -5), (-5, -4), (-4, -3), (-3, -2), (-2, -1),
    (-float("inf"), -8), (-1, float("inf")),
]


def get_intervals_for_sparsities(log_freq: np.ndarray):
    conditions = [np.logical_and(log_freq >= lo, log_freq < hi)
                  for lo, hi in SPARSITY_INTERVALS]
    texts = [f"TOTAL_logfreq_[{lo},{hi}]" for lo, hi in SPARSITY_INTERVALS]
    return SPARSITY_INTERVALS, conditions, texts


def sample_features_from_bins(log_freq: np.ndarray, samples_per_bin: int,
                              seed: int = 0):
    rng = np.random.default_rng(seed)
    _, conditions, texts = get_intervals_for_sparsities(log_freq)
    indices, values, categories = [], [], []
    for cond, text in zip(conditions, texts):
        pool = np.nonzero(cond)[0]
        take = pool[rng.permutation(len(pool))[:samples_per_bin]]
        indices.extend(take.tolist())
        values.extend(log_freq[take].tolist())
        categories.extend([text] * len(take))
    return indices, values, categories


# ---------------------------------------------------------------------------
# Top-activating image mining
# ---------------------------------------------------------------------------

def make_feature_activation_step(model, sae: SparseAutoencoder, feature_ids: List[int],
                                 sampling_type: str = "avg"):
    """``step(model, sae_params, images)`` -> per-image activation score
    ``[B, n_features]`` of the selected features, through the SAE's own
    encode (gated and TopK SAEs rank by their real activations).  The
    forward stops after the hook's block."""
    vcfg = model.cfg
    scfg = sae.cfg
    hook = scfg.hook_point
    head = scfg.hook_point_head_index
    fid = torch.as_tensor(feature_ids, dtype=torch.int64, device=_device(model))

    @torch.inference_mode()
    def step(params, sae_params, images):
        rt = HookRuntime(names_filter=hook)
        vit_forward(params, vcfg, images, rt, stop_at_layer=scfg.hook_point_layer + 1)
        act = rt.cache[hook]
        if head is not None:          # [B, ctx, heads, d_head] hooks
            act = act[:, :, head]
        feats = encode(sae_params, scfg, act)[1][..., fid]
        if sampling_type == "cls":
            return feats[:, 0, :]
        return feats.mean(1)

    return step


def find_top_activations(data_iter, model, sae: SparseAutoencoder, feature_ids: List[int],
                         is_cls_list: Optional[List[bool]] = None, top_k: int = 16,
                         max_samples: int = 50_000, sampling_type: str = "avg"):
    """Running top-k (value, global image index) per feature.  ``data_iter``
    yields ``(images, labels, indices)`` or ``(images, indices)``."""
    step = make_feature_activation_step(model, sae, feature_ids, sampling_type)
    cls_step = (make_feature_activation_step(model, sae, feature_ids, "cls")
                if is_cls_list and any(is_cls_list) else None)
    best_vals = None
    best_idx = None
    processed = 0
    for batch in data_iter:
        if len(batch) == 3:
            images, _, indices = batch
        else:
            images, indices = batch
        (images,) = _on(model, images)
        indices = as_numpy(indices)
        scores = as_numpy(step(model, sae.params, images))
        if cls_step is not None:
            cls_scores = as_numpy(cls_step(model, sae.params, images))
            scores = np.where(np.asarray(is_cls_list)[None, :], cls_scores, scores)
        if best_vals is None:
            best_vals = scores
            best_idx = np.broadcast_to(indices[:, None], scores.shape).copy()
        else:
            best_vals = np.concatenate([best_vals, scores], axis=0)
            best_idx = np.concatenate(
                [best_idx, np.broadcast_to(indices[:, None], scores.shape)], axis=0)
        # keep only the current top_k rows per feature
        if best_vals.shape[0] > 4 * top_k:
            order = np.argsort(-best_vals, axis=0)[:top_k]
            best_vals = np.take_along_axis(best_vals, order, axis=0)
            best_idx = np.take_along_axis(best_idx, order, axis=0)
        processed += images.shape[0]
        if processed >= max_samples:
            break
    order = np.argsort(-best_vals, axis=0)[:top_k]
    best_vals = np.take_along_axis(best_vals, order, axis=0)
    best_idx = np.take_along_axis(best_idx, order, axis=0)
    return {f: (best_vals[:, i], best_idx[:, i]) for i, f in enumerate(feature_ids)}


# ---------------------------------------------------------------------------
# Heatmaps
# ---------------------------------------------------------------------------

@torch.inference_mode()
def get_heatmap(image, model, sae: SparseAutoencoder, feature_id: int):
    """Per-token pre-activation of one feature for one image, through the
    SAE's own encode (head-index hooks and gated params resolve there)."""
    vcfg = model.cfg
    scfg = sae.cfg
    rt = HookRuntime(names_filter=scfg.hook_point)
    (image,) = _on(model, image)
    vit_forward(model, vcfg, image[None], rt, stop_at_layer=scfg.hook_point_layer + 1)
    act = rt.cache[scfg.hook_point][0]
    if scfg.hook_point_head_index is not None:
        act = act[:, scfg.hook_point_head_index]
    hidden_pre = encode(sae.params, scfg, act)[2]
    return hidden_pre[..., feature_id]


def image_patch_heatmap(activation_values, cfg) -> np.ndarray:
    """Expand per-patch activations (minus CLS) to a pixel heatmap."""
    n = cfg.image_size // cfg.patch_size
    vals = as_numpy(activation_values)[1:].reshape(n, n)
    return np.kron(vals, np.ones((cfg.patch_size, cfg.patch_size)))


# ---------------------------------------------------------------------------
# Sparsity visualization: histogram data and the HTML dashboard; plots only
# if matplotlib is importable
# ---------------------------------------------------------------------------

def visualize_sparsities(cfg: EvalConfig, log_freq_tokens, log_freq_images,
                         name: str, sae=None):
    os.makedirs(cfg.sae_path, exist_ok=True)
    np.savez(os.path.join(cfg.sae_path, f"sparsity_{name}.npz"),
             log_freq_tokens=np.asarray(log_freq_tokens),
             log_freq_images=np.asarray(log_freq_images))
    # the interactive dashboard: self-contained HTML with hover tooltips and
    # table views; with the SAE it adds the per-condition cosine-similarity
    # histograms
    from vit_prisma_tpu_torch.visualization.sae_dashboards import (
        default_frequency_conditions)
    from vit_prisma_tpu_torch.visualization.sae_dashboards_html import (
        interactive_sparsity_dashboard)

    class _Dir:
        save_figure_dir = cfg.sae_path
    conditions, texts = ([], []) if sae is None else \
        default_frequency_conditions(np.asarray(log_freq_tokens))
    interactive_sparsity_dashboard(
        _Dir(), log_freq_tokens, log_freq_images, conditions, texts,
        name, sae if sae is not None else np.zeros((1, 1)))
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(1, 2, figsize=(10, 4))
        ax[0].hist(np.asarray(log_freq_tokens), bins=50)
        ax[0].set_title(f"{name} log10 feature freq (tokens)")
        ax[1].hist(np.asarray(log_freq_images), bins=50)
        ax[1].set_title(f"{name} log10 feature freq (images)")
        fig.savefig(os.path.join(cfg.sae_path, f"sparsity_{name}.png"))
        plt.close(fig)
    except Exception:
        pass


def save_stats(path: str, stats: Dict[str, Any]):
    os.makedirs(path, exist_ok=True)
    out = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
           for k, v in stats.items()}
    with open(os.path.join(path, "eval_stats.json"), "w") as f:
        json.dump(out, f, indent=2)


# ---------------------------------------------------------------------------
# Full pipeline
# ---------------------------------------------------------------------------

def evaluate(cfg: EvalConfig, sae: SparseAutoencoder, model, val_data_iter_fn,
             class_embeddings, seed: int = 0) -> Dict[str, Any]:
    """Run the full eval: stats -> sparsity files -> per-bin feature sampling
    -> top-image mining.  ``val_data_iter_fn()`` returns a fresh iterator of
    ``(images, labels, indices)`` batches."""
    stats = process_dataset(model, sae, ((im, lb) for im, lb, _ in val_data_iter_fn()),
                            class_embeddings, cfg)
    save_stats(cfg.sae_path, stats)

    log_freq_tokens = stats["log_frequencies_per_token"]
    visualize_sparsities(cfg, log_freq_tokens, stats["log_frequencies_per_image"],
                         "TOTAL", sae=sae)

    indices, values, categories = sample_features_from_bins(
        log_freq_tokens, cfg.samples_per_bin, seed)
    top_per_feature = {}
    if indices:
        top_per_feature = find_top_activations(
            val_data_iter_fn(), model, sae, indices, [False] * len(indices),
            cfg.max_images_per_feature, cfg.top_image_max_samples, cfg.sampling_type)
    stats["sampled_features"] = {"indices": indices, "values": values,
                                 "categories": categories}
    stats["top_images_per_feature"] = {
        int(f): (v.tolist(), i.tolist()) for f, (v, i) in top_per_feature.items()}
    return stats
