"""Activation store (PyTorch port of ``vit_prisma_tpu/sae/store.py``): a
shuffled token buffer on the model's device, fed by hooked forwards.

The harvest is ``run_with_cache`` on the requested hook point with
``stop_at_layer`` just past it, then the CLS-only, patches-only or
head-index slicing.  A sweep store (``cfg.sweep_layers``) caches
``blocks.{l}.{layer_subtype}`` for every listed layer in the same forward
and stacks the rows to ``[tokens, L, d]``; its buffer is 3-D and every
operation below moves whole ``[L, d]`` rows.  The buffer is filled, then
shuffled by a row permutation through kernel B3
(:func:`~vit_prisma_tpu_torch.ops.shuffle.take_rows`).
When half of it has been served, the unserved half is kept, a fresh half is
harvested, and the two are shuffled together.

Differences from the JAX store, none of which changes which rows are
served:

* The JAX store dispatches the next refill's harvest early, between train
  steps (``prefetch``).  The port harvests at refill time, in the same image
  order.
* The JAX mix donates the old buffer.  Here the fresh rows are written over
  the served half and the gather writes a new buffer, after which the old
  one is dropped: the peak is two buffers.  Batches are copies, so a refill
  never changes a batch already handed out.
* The mix permutations come from the store's ``torch.Generator`` (or from
  ``permutation``, a callable ``n -> [n] indices``, which the tests use to
  replay the JAX store's ``jax.random`` permutations).  The image order is
  :func:`_index_iterator`, the JAX package's numpy stream, so both packages
  read the same images.

* The fused cycle (``train_cycles``) refills from the image indices that
  :meth:`VisionActivationsStore.next_cycle_indices` draws from the same
  stream, so it reads the same images.

Not ported yet, and raising ``NotImplementedError``: ``mesh`` (ROADMAP queue
A, item 15), ``augment``, the uint8 wire with ``device_norm``,
:class:`CachedActivationsStore` (item 6's remainder), and transcoder hooks
(item 10).
"""

from __future__ import annotations

import warnings
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from vit_prisma_tpu_torch.ops.shuffle import take_rows
from vit_prisma_tpu_torch.sae.config import SAERunnerConfig


def _index_iterator(n: int, batch_size: int, seed: int = 0) -> Iterator[np.ndarray]:
    """Infinite shuffled epoch stream of index batches — the single source
    of the store's image order (both the host and the device-resident
    dataset paths draw from it, so they serve identical streams)."""
    rng = np.random.default_rng(seed)
    if n < batch_size:
        raise ValueError(
            f"dataset has {n} images but store_batch_size={batch_size}; "
            "the store needs at least one full batch")
    while True:
        order = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            yield order[i:i + batch_size]


def _image_iterator(dataset, batch_size: int, seed: int = 0) -> Iterator[np.ndarray]:
    """Infinite shuffled iterator over an indexable dataset of images.
    Accepts numpy arrays [N,C,H,W], lists, or torch-style datasets yielding
    (img, label) tuples."""
    for idx in _index_iterator(len(dataset), batch_size, seed):
        if isinstance(dataset, np.ndarray):
            yield dataset[idx]
        else:
            items = [dataset[int(j)] for j in idx]
            if isinstance(items[0], (tuple, list)):
                items = [it[0] for it in items]
            items = [np.asarray(it) for it in items]
            yield np.stack(items)


def _is_uint8(dataset) -> bool:
    if isinstance(dataset, (np.ndarray, torch.Tensor)):
        return dataset.dtype in (np.uint8, torch.uint8)
    if hasattr(dataset, "__next__"):
        return getattr(dataset, "dtype", None) == np.uint8
    if len(dataset):
        item = dataset[0]
        if isinstance(item, (tuple, list)):
            item = item[0]
        return np.asarray(item).dtype == np.uint8
    return False


class VisionActivationsStore:
    """Streaming activation buffer over a HookedViT.

    ``dataset``: images ``[N, C, H, W]`` as a numpy array or a torch tensor,
    a list or torch-style dataset of images or (image, label) pairs, or an
    iterator of ``[store_batch_size, C, H, W]`` batches.  A torch tensor, or
    an ndarray of at most 256 MB, is kept on ``device`` and indexed there
    (``device_dataset`` forces the choice).  ``device`` defaults to the
    model's.  ``generator``, a ``torch.Generator`` on ``device``, draws the
    mix permutations (seeded with ``seed`` or ``cfg.seed`` when None)."""

    _DEVICE_DATASET_AUTO_BYTES = 256 * 1024 * 1024

    def __init__(self, cfg: SAERunnerConfig, model, dataset,
                 eval_dataset=None, seed: Optional[int] = None,
                 mesh=None, device_norm=None,
                 device_dataset: Optional[bool] = None, augment=None,
                 device=None, generator: Optional[torch.Generator] = None,
                 permutation: Optional[Callable[[int], torch.Tensor]] = None):
        if mesh is not None:
            raise NotImplementedError(
                "a sharded store (mesh=) is not ported yet (ROADMAP queue A, item 15)")
        if augment is not None:
            raise NotImplementedError(
                "device-side augmentation (augment=) is not ported yet (ROADMAP "
                "queue A, item 6)")
        if device_norm is not None or cfg.store_wire_dtype == "uint8" or _is_uint8(dataset):
            raise NotImplementedError(
                "the uint8 image wire with on-device normalization is not ported "
                "yet (ROADMAP queue A, item 6); pass float images")
        if cfg.is_transcoder:
            raise NotImplementedError(
                "transcoder stores (two hooks, targets) are not ported yet "
                "(ROADMAP queue A, item 10)")
        self.cfg = cfg
        self.model = model
        self.dataset = dataset
        self.eval_dataset = eval_dataset
        param = next(model.parameters())
        self.device = torch.device(device) if device is not None else param.device
        self._model_dtype = param.dtype
        # 'auto' and 'bfloat16' round float pixels to bf16 as the JAX wire
        # does ('auto' only for a bf16 model, where the forward casts anyway)
        self._wire_dtype = (torch.bfloat16 if cfg.store_wire_dtype == "bfloat16"
                            or (cfg.store_wire_dtype == "auto"
                                and param.dtype == torch.bfloat16) else None)
        seed = cfg.seed if seed is None else seed
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        self.generator = generator
        self._permutation = permutation or (lambda n: torch.randperm(
            n, generator=self.generator, device=self.device))
        self._warned_early_refill = False

        self._dev_images = None
        if device_dataset is None:
            device_dataset = isinstance(dataset, torch.Tensor) or (
                isinstance(dataset, np.ndarray)
                and dataset.nbytes <= self._DEVICE_DATASET_AUTO_BYTES)
        if device_dataset:
            if not isinstance(dataset, (np.ndarray, torch.Tensor)):
                raise ValueError("device_dataset requires an ndarray or tensor "
                                 f"dataset (got {type(dataset).__name__})")
            self._dev_images = torch.as_tensor(dataset).to(self.device)
            self._idx_iter = _index_iterator(len(dataset), cfg.store_batch_size,
                                             seed=cfg.seed)
        elif hasattr(dataset, "__next__"):
            self.image_iter = dataset
        else:
            self.image_iter = _image_iterator(dataset, cfg.store_batch_size,
                                              seed=cfg.seed)

        if cfg.sweep_layers:
            self._hook_names = [f"blocks.{l}.{cfg.layer_subtype}" for l in cfg.sweep_layers]
            self._stop_at = max(cfg.sweep_layers) + 1
        else:
            self._hook_names = [cfg.hook_point]
            self._stop_at = cfg.hook_point_layer + 1
        self.tokens_per_store_batch = cfg.store_batch_size * cfg.tokens_per_image
        self.buffer_tokens = cfg.tokens_per_buffer

        self.buffer = self._fill(self.buffer_tokens)
        self.buffer = take_rows(self.buffer, self._perm(self.buffer.shape[0]))
        self.ptr = 0

    # -- harvesting ------------------------------------------------------
    def get_activations(self, images) -> torch.Tensor:
        """One harvested batch of token rows: ``[tokens, d]``, or ``[tokens,
        L, d]`` for a sweep."""
        images = torch.as_tensor(images).to(self.device)
        if self._wire_dtype is not None:
            images = images.to(self._wire_dtype)
        images = images.to(self._model_dtype)
        _, cache = self.model.run_with_cache(
            images, names_filter=self._hook_names, stop_at_layer=self._stop_at,
            return_cache_object=False)
        outs = []
        for name in self._hook_names:
            act = cache[name]  # [B, ctx, d] (or [B, ctx, heads, d_head])
            if self.cfg.hook_point_head_index is not None:
                act = act[:, :, self.cfg.hook_point_head_index]
            if self.cfg.cls_token_only:
                act = act[:, :1]
            elif self.cfg.use_patches_only:
                act = act[:, 1:]
            outs.append(act.reshape(-1, act.shape[-1]))
        return outs[0] if len(outs) == 1 else torch.stack(outs, dim=1)

    def _image_batches(self, n_batches: int, indices=None):
        """The next ``n_batches`` store batches of images, in the order of
        :func:`_index_iterator`, or the rows ``indices`` ``[n_batches,
        store_batch_size]`` of a device-resident dataset."""
        sb = self.cfg.store_batch_size
        for i in range(n_batches):
            if self._dev_images is not None:
                idx = next(self._idx_iter) if indices is None else indices[i]
                yield self._dev_images[torch.as_tensor(idx, device=self.device)]
                continue
            batch = next(self.image_iter)
            if batch.shape[0] != sb:
                raise ValueError(
                    f"image iterator yielded a batch of {batch.shape[0]} rows; "
                    f"the store requires exactly store_batch_size={sb}")
            yield batch

    def _fill(self, n_tokens: int, out: Optional[torch.Tensor] = None,
              indices=None) -> torch.Tensor:
        """Harvest ``n_tokens`` rows into ``out[:n_tokens]`` (a new tensor
        when None) and return ``out``.  Whole store batches are harvested and
        the rows past ``n_tokens`` dropped, as in the JAX store."""
        n_batches = -(-n_tokens // self.tokens_per_store_batch)
        row = 0
        for images in self._image_batches(n_batches, indices):
            rows = self.get_activations(images)
            if out is None:
                out = torch.empty((n_tokens,) + tuple(rows.shape[1:]), dtype=rows.dtype,
                                  device=self.device)
            take = min(rows.shape[0], n_tokens - row)
            out[row:row + take].copy_(rows[:take])
            row += take
        return out

    def _perm(self, n: int) -> torch.Tensor:
        idx = torch.as_tensor(self._permutation(n), device=self.device)
        if tuple(idx.shape) != (n,):
            raise ValueError(f"permutation({n}) returned shape {tuple(idx.shape)}")
        return idx

    # -- buffer protocol -------------------------------------------------
    def next_batch(self) -> torch.Tensor:
        """[train_batch_size, d_in] token rows (a copy; ``[B, L, d_in]`` for
        a sweep)."""
        bs = self.cfg.train_batch_size
        half = self.buffer.shape[0] // 2
        if bs > half:
            raise ValueError(
                f"train_batch_size({bs}) must fit in half the buffer ({half} "
                "tokens) — rows past the half would be re-served after the "
                "next mix")
        if self.ptr + bs > half:
            self._refill_half()
        out = self.buffer[self.ptr:self.ptr + bs].clone()
        self.ptr += bs
        return out

    def next_batches(self, k: int) -> torch.Tensor:
        """[k, train_batch_size, d]: k consecutive training batches in one
        copy.  Row content is identical to k ``next_batch()`` calls when
        ``k`` divides the number of batches served per half-buffer."""
        bs = self.cfg.train_batch_size
        half = self.buffer.shape[0] // 2
        if k * bs > half:
            raise ValueError(
                f"steps_per_dispatch({k}) x train_batch_size({bs}) must fit in "
                f"half the buffer ({half} tokens)")
        if self.ptr + k * bs > half:
            if self.ptr + bs <= half and not self._warned_early_refill:
                warnings.warn(
                    f"next_batches({k}): refilling with "
                    f"{(half - self.ptr) // bs} batch(es) of the half-buffer"
                    " unserved because k doesn't divide the half's batch "
                    "count; the row stream differs from k x next_batch()",
                    stacklevel=2)
                self._warned_early_refill = True
            self._refill_half()
        out = self.buffer[self.ptr:self.ptr + k * bs].clone()
        self.ptr += k * bs
        return out.reshape((k, bs) + tuple(self.buffer.shape[1:]))

    def _refill_half(self, indices=None):
        """Keep the unserved half, harvest a fresh half, re-permute.  The
        fresh half's images are the next of the image stream, or the
        device-resident dataset's rows ``indices`` (the fused cycle's).

        The JAX store permutes ``concat([buffer[n//2:], fresh])``.  Here the
        fresh rows are written over the served rows ``buffer[:n//2]`` and
        the permutation's indices are mapped onto that layout, so one gather
        (kernel B3) reads the buffer once and writes the new one."""
        n = self.buffer.shape[0]
        n_fresh, n_kept = n // 2, n - n // 2
        self._fill(n_fresh, out=self.buffer, indices=indices)
        perm = self._perm(n)
        src = torch.where(perm < n_kept, perm + n_fresh, perm - n_kept)
        self.buffer = take_rows(self.buffer, src)
        self.ptr = 0

    # -- fused cycle -------------------------------------------------------
    @property
    def fused_cycle_available(self) -> bool:
        """The fused cycle gathers its own images: it needs a device-resident
        dataset."""
        return self._dev_images is not None

    def next_cycle_indices(self) -> np.ndarray:
        """Image indices ``[n_batches, store_batch_size]`` for one fresh
        half-buffer, drawn from the same stream as a refill's."""
        n_fresh = self.buffer.shape[0] // 2
        n_batches = -(-n_fresh // self.tokens_per_store_batch)
        return np.stack([next(self._idx_iter) for _ in range(n_batches)])

    def peek_tokens(self, n: int, layer_slot: Optional[int] = None) -> torch.Tensor:
        """A copy of the first n rows (for the b_dec init); ``layer_slot``
        picks a layer of a sweep buffer (the first when None)."""
        rows = self.buffer[:n]
        if rows.ndim == 3:
            rows = rows[:, layer_slot if layer_slot is not None else 0]
        return rows.clone()

    # -- not ported yet --------------------------------------------------
    def generate_cached_activations(self, path: str, n_tokens: int,
                                    tokens_per_file: int = 1_000_000):
        raise NotImplementedError(
            "cached activation shards are not ported yet (ROADMAP queue A, item 6)")


class CachedActivationsStore:
    """Shard-backed store; not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "CachedActivationsStore is not ported yet (ROADMAP queue A, item 6)")
