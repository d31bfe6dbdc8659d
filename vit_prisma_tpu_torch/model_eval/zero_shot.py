"""Zero-shot CLIP classification: classifier construction and ImageNet-style
evaluation (PyTorch port of ``vit_prisma_tpu/model_eval/zero_shot.py``).

The text encoder is the port's ``HookedTextTransformer`` (or any callable
mapping token batches to embeddings); tokenization defaults to the
self-contained CLIP BPE (``utils/clip_tokenizer.py``), and any other
callable may be passed.  The arithmetic runs in torch on the models'
device: a class's prompts are tokenized on the host and moved to the text
encoder's device once, and ``run`` moves each batch to the image model's.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vit_prisma_tpu_torch.utils.openai_templates import OPENAI_IMAGENET_TEMPLATE_STRINGS


def _device(model, default=None):
    """The device of a module's parameters, else ``default``."""
    if isinstance(model, torch.nn.Module):
        for p in model.parameters():
            return p.device
    return default


def zero_shot_classifier(text_encoder: Callable,
                         tokenizer: Optional[Callable],
                         classnames: Sequence[str],
                         templates: Sequence[str] = OPENAI_IMAGENET_TEMPLATE_STRINGS,
                         batch_size: int = 64) -> torch.Tensor:
    """Zero-shot weights [d, n_classes]: encode the template(class)
    prompts, L2-normalize, mean over templates, renormalize, stack.

    ``tokenizer(texts: List[str]) -> int array [n, ctx]``; ``None`` uses
    the built-in CLIP BPE (utils/clip_tokenizer.py);
    ``text_encoder(tokens) -> [n, d]`` embeddings, in the encoder's dtype.
    """
    if tokenizer is None:
        from vit_prisma_tpu_torch.utils.clip_tokenizer import get_default_tokenizer
        tokenizer = get_default_tokenizer()
    device = _device(text_encoder)
    weights = []
    for classname in classnames:
        texts = [t.format(c=classname) if isinstance(t, str) else t(classname)
                 for t in templates]
        tokens = torch.as_tensor(np.asarray(tokenizer(texts))).to(device)
        embs = [text_encoder(tokens[i:i + batch_size])
                for i in range(0, tokens.shape[0], batch_size)]
        emb = torch.cat(embs, dim=0)
        emb = emb / torch.linalg.norm(emb, dim=-1, keepdim=True)
        class_emb = emb.mean(0)
        weights.append(class_emb / torch.linalg.norm(class_emb))
    return torch.stack(weights, dim=1)  # [d, n_classes]


def accuracy(logits: torch.Tensor, target: torch.Tensor,
             topk: Tuple[int, ...] = (1,)) -> List[float]:
    """Top-k correct counts.  The ranking is a stable sort of ``-logits``,
    so tied logits rank by class index, as ``jnp.argsort`` ranks them."""
    maxk = max(topk)
    pred = torch.argsort(-logits, dim=-1, stable=True)[:, :maxk]
    correct = pred == target.to(pred.device)[:, None]
    return [float(correct[:, :k].any(dim=-1).sum()) for k in topk]


def run(model, classifier, data_iter: Iterable, fwd_hooks=None
        ) -> Tuple[float, float]:
    """Top-1/top-5 accuracy over an (images, labels) iterator, with
    ``logits = 100 * image_features @ classifier``; ``fwd_hooks`` runs the
    image model under interventions.  As in the JAX package, the product
    takes the promoted dtype of the two (a bfloat16 model's scaled features
    against a float32 classifier multiply in float32)."""
    classifier = torch.as_tensor(classifier)
    device = _device(model, classifier.device)
    classifier = classifier.to(device)
    top1 = top5 = n = 0.0
    for images, target in data_iter:
        images = torch.as_tensor(images).to(device)
        target = torch.as_tensor(target).to(device)
        if fwd_hooks is not None and hasattr(model, "run_with_hooks"):
            output = model.run_with_hooks(images, fwd_hooks=fwd_hooks)
        else:
            output = model(images)
        scaled = 100.0 * output
        dtype = torch.promote_types(scaled.dtype, classifier.dtype)
        logits = scaled.to(dtype) @ classifier.to(dtype)
        acc1, acc5 = accuracy(logits, target, topk=(1, 5))
        top1 += acc1
        top5 += acc5
        n += images.shape[0]
    return top1 / n, top5 / n


def zero_shot_eval(model, data: Dict[str, Iterable], model_name: str = "",
                   pretrained_classifier=None,
                   text_encoder: Optional[Callable] = None,
                   tokenizer: Optional[Callable] = None,
                   classnames: Optional[Sequence[str]] = None,
                   fwd_hooks=None) -> Dict[str, float]:
    """Zero-shot ImageNet evaluation.

    ``data`` maps split names ('imagenet-val', 'imagenet-v2') to
    (images, labels) iterables.  Pass a prebuilt classifier or the
    (text_encoder, tokenizer, classnames) triple to build one.
    """
    if not any(k in data for k in ("imagenet-val", "imagenet-v2")):
        return {}
    if pretrained_classifier is None:
        if text_encoder is None or classnames is None:
            raise ValueError("need text_encoder+classnames to build a classifier")
        classifier = zero_shot_classifier(text_encoder, tokenizer, classnames)
    else:
        classifier = pretrained_classifier

    results: Dict[str, float] = {}
    if "imagenet-val" in data:
        top1, top5 = run(model, classifier, data["imagenet-val"], fwd_hooks=fwd_hooks)
        results["imagenet-zeroshot-val-top1"] = top1
        results["imagenet-zeroshot-val-top5"] = top5
    if "imagenet-v2" in data:
        top1, top5 = run(model, classifier, data["imagenet-v2"], fwd_hooks=fwd_hooks)
        results["imagenetv2-zeroshot-val-top1"] = top1
        results["imagenetv2-zeroshot-val-top5"] = top5
    return results


def load_classifier(path: str) -> torch.Tensor:
    """A prebuilt ``.npy`` classifier (as :func:`save_classifier` or the
    JAX package writes it), on the host."""
    from vit_prisma_tpu_torch.sae.sae import numpy_to_tensor
    return numpy_to_tensor(np.load(path))


def save_classifier(path: str, classifier) -> None:
    """Save a classifier as ``.npy``; bfloat16 as its two-byte words."""
    from vit_prisma_tpu_torch.sae.sae import tensor_to_numpy
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.save(path, tensor_to_numpy(torch.as_tensor(classifier)))
