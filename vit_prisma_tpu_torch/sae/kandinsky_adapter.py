"""TinyCLIP -> Kandinsky embedding adapter (PyTorch port of
``vit_prisma_tpu/sae/kandinsky_adapter.py``).

A 3-layer MLP that maps TinyCLIP image embeddings (512) into the Kandinsky
2.2 prior's image-embedding space (1280), so that SAE-edited TinyCLIP
embeddings can drive Kandinsky generation.  The parameters are a dict of
tensors (``W1 [in, hidden]``, ``b1``, ``W2``, ``b2``, ``W3``, ``b3``) with
the JAX package's layout and ``.npz`` file, so each package reads the
other's adapter.  Training is Adam on the MSE (``torch.optim.Adam``, as the
JAX package uses optax's Adam, not the SAE step's fused kernel).  Dropout
masks come from a ``torch.Generator`` or are passed in (``masks``), which
is how the tests replay JAX's ``bernoulli`` draws.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from vit_prisma_tpu_torch.utils.device import resolve_device

Params = Dict[str, torch.Tensor]


def init_adapter_params(generator: Optional[torch.Generator] = None,
                        input_dim: int = 512, hidden_dim: int = 2048,
                        output_dim: int = 1280, dtype=torch.float32,
                        device=None) -> Params:
    """nn.Linear's default init, as the JAX package's: weights uniform in
    ``±sqrt(1/3)·sqrt(3/fan_in)`` (Kaiming-uniform, a = sqrt(5)) and biases
    uniform in ``±1/sqrt(fan_in)``, drawn on the CPU from ``generator``
    (seed 0 when None) and moved to ``device`` (the CUDA card when None)."""
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    device = resolve_device(device)

    def uniform(shape, bound):
        return (torch.rand(shape, generator=g, dtype=torch.float32) * (2 * bound) - bound).to(dtype)

    params = {}
    for i, (fan_in, fan_out) in enumerate(((input_dim, hidden_dim), (hidden_dim, hidden_dim),
                                           (hidden_dim, output_dim)), start=1):
        params[f"W{i}"] = uniform((fan_in, fan_out), math.sqrt(1.0 / 3.0) * math.sqrt(3.0 / fan_in))
        params[f"b{i}"] = uniform((fan_out,), 1.0 / math.sqrt(fan_in))
    return {k: v.to(device) for k, v in params.items()}


def dropout_masks(generator: torch.Generator, batch: int, hidden_dim: int,
                  dropout_rate: float = 0.1, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two keep masks ``[batch, hidden_dim]`` of one training forward."""
    draw = lambda: torch.rand((batch, hidden_dim), generator=generator,
                              device=generator.device) < 1.0 - dropout_rate
    return draw().to(device), draw().to(device)


def adapter_forward(params: Params, x: torch.Tensor,
                    masks: Optional[Sequence[torch.Tensor]] = None,
                    dropout_rate: float = 0.1) -> torch.Tensor:
    """linear -> relu -> dropout -> linear -> relu -> dropout -> linear.
    ``masks``: the two keep masks (inverted dropout, ``h / (1 - rate)`` where
    kept); None is the eval forward."""
    def drop(h, keep):
        if keep is None or dropout_rate == 0.0:
            return h
        return torch.where(keep, h / (1.0 - dropout_rate), torch.zeros((), dtype=h.dtype,
                                                                       device=h.device))

    m1, m2 = (None, None) if masks is None else masks
    h = drop(torch.relu(x @ params["W1"] + params["b1"]), m1)
    h = drop(torch.relu(h @ params["W2"] + params["b2"]), m2)
    return h @ params["W3"] + params["b3"]


class DualEmbedder:
    """(source, target) embedding pairs from two image encoders: ``src_fn``
    and ``tgt_fn`` map an image batch ``[B, C, H, W]`` to embeddings (a
    TinyCLIP ``HookedViT`` and a Kandinsky one)."""

    def __init__(self, src_fn: Callable, tgt_fn: Callable):
        self.src_fn = src_fn
        self.tgt_fn = tgt_fn

    def get_embeddings(self, images) -> Tuple[torch.Tensor, torch.Tensor]:
        images = torch.as_tensor(images)
        return self.src_fn(images), self.tgt_fn(images)

    def build_dataset(self, image_batches) -> Tuple[np.ndarray, np.ndarray]:
        srcs, tgts = [], []
        for batch in image_batches:
            s, t = self.get_embeddings(batch)
            srcs.append(torch.as_tensor(s).detach().float().cpu().numpy())
            tgts.append(torch.as_tensor(t).detach().float().cpu().numpy())
        return np.concatenate(srcs), np.concatenate(tgts)


def train_adapter(src_embeds, tgt_embeds, num_epochs: int = 10,
                  batch_size: int = 256, lr: float = 1e-4,
                  hidden_dim: int = 2048, seed: int = 0,
                  verbose: bool = False, device=None,
                  params: Optional[Params] = None,
                  masks_fn: Optional[Callable[[int], Sequence[torch.Tensor]]] = None,
                  dropout_rate: float = 0.1) -> Tuple[Params, float]:
    """Adam on the MSE over shuffled full batches (the JAX loop: a numpy
    ``default_rng(seed)`` permutation an epoch, the last partial batch
    dropped).  ``params``: the initial parameters (drawn from ``seed`` when
    None); ``masks_fn(step) -> (mask1, mask2)`` gives each step's dropout
    masks (drawn from a generator seeded with ``seed`` when None; return
    None for no dropout).  Returns (params on the CPU, the last loss)."""
    device = resolve_device(device)
    src = torch.as_tensor(np.asarray(src_embeds, np.float32), device=device)
    tgt = torch.as_tensor(np.asarray(tgt_embeds, np.float32), device=device)
    if params is None:
        params = init_adapter_params(torch.Generator().manual_seed(seed), src.shape[-1],
                                     hidden_dim, tgt.shape[-1], device=device)
    leaves = {k: torch.as_tensor(v).detach().to(device).clone().requires_grad_(True)
              for k, v in params.items()}
    opt = torch.optim.Adam(list(leaves.values()), lr=lr, eps=1e-8)
    if masks_fn is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        masks_fn = lambda step: dropout_masks(gen, batch_size, leaves["W1"].shape[1],
                                              dropout_rate, device)
    rng = np.random.default_rng(seed)
    n = len(src)
    loss = torch.tensor(float("nan"))
    step = 0
    for epoch in range(num_epochs):
        order = rng.permutation(n)
        total, batches = 0.0, 0
        for i in range(0, n - batch_size + 1, batch_size):
            idx = torch.as_tensor(order[i:i + batch_size], device=device)
            with torch.enable_grad():
                pred = adapter_forward(leaves, src[idx], masks_fn(step), dropout_rate)
                loss = torch.mean(torch.square(pred - tgt[idx]))
                opt.zero_grad(set_to_none=True)
                loss.backward()
            opt.step()
            step += 1
            if verbose:
                total += float(loss)
            batches += 1
        if verbose:
            print(f"epoch {epoch + 1}/{num_epochs} loss {total / max(batches, 1):.6f}")
    return {k: v.detach().cpu() for k, v in leaves.items()}, float(loss.detach())


def save_adapter(path: str, params: Params):
    """The JAX package's ``.npz``: one float array a parameter."""
    np.savez(path if path.endswith(".npz") else path + ".npz",
             **{k: torch.as_tensor(v).detach().cpu().numpy() for k, v in params.items()})


def load_adapter(path: str, device=None) -> Params:
    """Read :func:`save_adapter`'s (or the JAX package's) file onto
    ``device`` (the CUDA card when None)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    device = resolve_device(device)
    with np.load(path) as z:
        return {k: torch.from_numpy(np.array(z[k])).to(device) for k in z.files}
