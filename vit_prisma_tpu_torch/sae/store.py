"""Activation store (PyTorch port of ``vit_prisma_tpu/sae/store.py``): a
shuffled token buffer on the model's device, fed by hooked forwards.

The harvest is ``run_with_cache`` on the requested hook point with
``stop_at_layer`` just past it, then the CLS-only, patches-only or
head-index slicing.  A sweep store (``cfg.sweep_layers``) caches
``blocks.{l}.{layer_subtype}`` for every listed layer in the same forward
and stacks the rows to ``[tokens, L, d]``; its buffer is 3-D and every
operation below moves whole ``[L, d]`` rows.  A transcoder's store
(``cfg.is_transcoder``) caches the input hook and the output hook
(``cfg.out_hook_point``) in one forward stopped past the later, and stacks
them to ``[tokens, 2, d]`` rows in the same way: slot 0 the input, slot 1
the target.  The buffer is filled, then
shuffled by a row permutation through kernel B3
(:func:`~vit_prisma_tpu_torch.ops.shuffle.take_rows`).
When half of it has been served, the unserved half is kept, a fresh half is
harvested, and the two are shuffled together.

Images cross to the device in the wire dtype (``cfg.store_wire_dtype``), as
in the JAX store: 'auto' ships a uint8 dataset (or a batch iterator that
declares ``dtype == np.uint8``, as ``NativeBatchLoader(uint8_wire=True)``
does) as uint8 and a bfloat16 model's float pixels as bfloat16; a float
wire on raw pixels raises.  uint8 images are normalized on the device, in
the JAX store's order, ``x.float() / 255`` then ``(x - mean) / std`` with
``device_norm`` (default: the model's preprocessing statistics).
``augment(generator, images)`` runs next, on the decoded batch, with a
``torch.Generator`` on the device seeded by one draw per store batch, in
harvest order, from the store's own augmentation stream (``aug_generator``,
which the mix permutations do not share); the fused cycle harvests through
the same call, so it consumes the same stream.

A host-fed stream (an iterator, a list, or an ndarray above 256 MB of wire
bytes) is staged: store batches are taken from the stream in order and
copied through a ring of two pinned host buffers into one device block on a
side CUDA stream; the harvest stream waits on the copy's event, and the
block is marked in use by it (``record_stream``).  With ``prefetch`` (the
default, as in JAX) the next refill's block is staged on a worker thread as
soon as a refill is done, so the bytes cross while the current half trains;
only that thread takes from the stream while it runs, so rows never depend
on ``prefetch``.  ``bytes_to_device`` counts the image bytes sent from the
host in the wire dtype.  A
device-resident dataset (a tensor, or an ndarray of at most 256 MB of wire
bytes, uploaded once in the wire dtype) gathers its images on the device:
``prefetch`` does nothing there, and ``fused_cycle_available`` is as it was.
Call :meth:`close` before closing a native loader the store reads.

Differences from the JAX store, none of which changes which rows are
served:

* The JAX store dispatches the next refill's harvest early, between train
  steps.  The port stages its images early and harvests at refill time.
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

:class:`CachedActivationsStore` serves rows from float16 ``{i}.npy`` shards
that :meth:`VisionActivationsStore.generate_cached_activations` writes.

With ``mesh`` (a ``(data, model)`` mesh, ``parallel/mesh.py``) the model
is made tensor-parallel over ``model`` (``HookedViT.shard``), each rank
harvests its rows of every store batch's images (the forward dp x tp), and
the buffer is row-sharded over ``data`` (a sweep buffer's layer axis split
over ``model`` too).  Every rank serves its rows of the same global row
stream as the single-process store: the buffer's global rows are dealt to
the ranks in blocks of ``train_batch_size / data`` rows, so a global batch
is one block of each rank and ``next_batch`` needs no communication.  The
fill and every mix apply one global permutation (the same on every rank)
through :func:`~vit_prisma_tpu_torch.parallel.collectives.exchange_rows`:
each rank gathers with B3 the rows each other rank needs from it, one
``all_to_all_single`` moves every row once, and a second B3 gather orders
what arrived.  An all-gather of the buffer followed by a local gather
would move ``data - 1`` times the buffer into each rank; the exchange
moves each row once.
"""

from __future__ import annotations

import os
import warnings
from contextlib import nullcontext
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import wait as wait_futures
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from vit_prisma_tpu_torch.dataloaders.transforms import get_model_transform_params
from vit_prisma_tpu_torch.ops.shuffle import take_rows
from vit_prisma_tpu_torch.parallel.collectives import SINGLE, exchange_rows
from vit_prisma_tpu_torch.sae.config import SAERunnerConfig
from vit_prisma_tpu_torch.utils.device import resolve_device


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


def _is_uint8(array) -> bool:
    return getattr(array, "dtype", None) in (np.uint8, torch.uint8)


class VisionActivationsStore:
    """Streaming activation buffer over a HookedViT.

    ``dataset``: images ``[N, C, H, W]`` as a numpy array or a torch tensor,
    a list or torch-style dataset of images or (image, label) pairs, or an
    iterator of ``[store_batch_size, C, H, W]`` batches (a
    ``NativeBatchLoader``).  A torch tensor, or an ndarray of at most 256 MB
    in the wire dtype, is kept on ``device`` and indexed there
    (``device_dataset`` forces the choice).  ``device`` defaults to the
    model's.  ``generator``, a ``torch.Generator`` on ``device``, draws the
    mix permutations (seeded with ``seed`` or ``cfg.seed`` when None).
    ``mesh``: see the module note; ``next_batch`` then gives this rank's
    ``train_batch_size / data`` rows of each global batch."""

    _DEVICE_DATASET_AUTO_BYTES = 256 * 1024 * 1024
    _STAGE_CHUNK_BATCHES = 8  # store batches a pinned ring buffer holds

    def __init__(self, cfg: SAERunnerConfig, model, dataset,
                 eval_dataset=None, seed: Optional[int] = None,
                 mesh=None, device_norm=None, prefetch: bool = True,
                 device_dataset: Optional[bool] = None, augment=None,
                 device=None, generator: Optional[torch.Generator] = None,
                 permutation: Optional[Callable[[int], torch.Tensor]] = None):
        self.cfg = cfg
        self.mesh = mesh
        self._data = self._model = SINGLE
        if mesh is not None:
            self._setup_mesh(cfg, model, mesh)
        self.model = model
        self.dataset = dataset
        self.eval_dataset = eval_dataset
        param = next(model.parameters())
        self.device = torch.device(device) if device is not None else param.device
        self._model_dtype = param.dtype
        seed = cfg.seed if seed is None else seed
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        self.generator = generator
        self._permutation = permutation or (lambda n: torch.randperm(
            n, generator=self.generator, device=self.device))
        self._warned_early_refill = False
        self.augment = augment
        self.aug_generator = torch.Generator().manual_seed(
            int(np.random.SeedSequence([seed, 0xA06]).generate_state(1, np.uint64)[0]))

        self._wire_dtype = self._pick_wire_dtype(cfg.store_wire_dtype)
        if self._wire_dtype == torch.uint8 and device_norm is None:
            # raw pixels: the normalize of the float transform moves to the
            # device, with the model's preprocessing statistics
            _, mean, std = get_model_transform_params(cfg.model_name)
            device_norm = (np.asarray(mean, np.float32), np.asarray(std, np.float32))
        self.device_norm = device_norm
        self._norm = None if device_norm is None else tuple(
            torch.as_tensor(np.asarray(v, np.float32), device=self.device)
            for v in device_norm)

        self.prefetch = prefetch
        self.bytes_to_device = 0
        self._staged = None       # future of the next refill's staged block
        self._stage_pool = None
        self._ring = None         # two pinned host buffers and their copy events
        self._side_stream = None

        self._dev_images = None
        if device_dataset is None:
            device_dataset = isinstance(dataset, torch.Tensor) or (
                isinstance(dataset, np.ndarray)
                and dataset.size * self._wire_itemsize(dataset)
                <= self._DEVICE_DATASET_AUTO_BYTES)
        if device_dataset:
            if not isinstance(dataset, (np.ndarray, torch.Tensor)):
                raise ValueError("device_dataset requires an indexable ndarray or tensor "
                                 f"dataset (got {type(dataset).__name__})")
            self._dev_images = self._upload(dataset)
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
            if cfg.is_transcoder:
                self._hook_names.append(cfg.out_hook_point)
                self._stop_at = max(cfg.hook_point_layer, cfg.out_hook_point_layer) + 1
        self.tokens_per_store_batch = cfg.store_batch_size * cfg.tokens_per_image
        self.buffer_tokens = cfg.tokens_per_buffer
        dp = self._data.size
        self.local_batch_size = cfg.train_batch_size // dp
        if dp > 1 and self.buffer_tokens % cfg.train_batch_size:
            raise ValueError(f"under a mesh the buffer ({self.buffer_tokens} tokens) must be "
                             f"a multiple of train_batch_size ({cfg.train_batch_size})")

        if self.mesh is None:
            self.buffer = self._fill(self.buffer_tokens)
            self.buffer = take_rows(self.buffer, self._perm(self.buffer.shape[0]))
        else:
            rows, held = self._fill_sharded(self.buffer_tokens)
            perm = self._perm(self.buffer_tokens)
            self.buffer = exchange_rows(rows, held, [perm[self._positions(r)] for r in range(dp)],
                                        self._data, take_rows)
        self.ptr = 0
        if self.prefetch and self._dev_images is None:
            self._staged = self._stage_async(self._fresh_batches())

    # -- the mesh ----------------------------------------------------------
    def _setup_mesh(self, cfg: SAERunnerConfig, model, mesh):
        from vit_prisma_tpu_torch.parallel.mesh import axis
        self._data, self._model = axis(mesh, "data"), axis(mesh, "model")
        dp = self._data.size
        for name, n in (("store_batch_size", cfg.store_batch_size),
                        ("train_batch_size", cfg.train_batch_size)):
            if n % dp:
                raise ValueError(f"{name}({n}) must divide over data={dp}")
        if cfg.sweep_layers and len(cfg.sweep_layers) % self._model.size:
            raise ValueError(f"{len(cfg.sweep_layers)} sweep layers do not divide over "
                             f"model={self._model.size}")
        if getattr(model, "mesh", None) is None:
            model.shard(mesh)

    def _positions(self, rank: int) -> torch.Tensor:
        """The global buffer positions of data rank ``rank``'s local rows:
        blocks of ``train_batch_size / data`` rows dealt round the ranks,
        so global batch ``s`` is local block ``s`` of every rank."""
        dp, bs = self._data.size, self.cfg.train_batch_size
        bl = bs // dp
        j = torch.arange(self.buffer_tokens // dp, device=self.device)
        return (j // bl) * bs + rank * bl + j % bl

    def _my_images(self, images: torch.Tensor) -> torch.Tensor:
        """This rank's images of a store batch (rows over ``data``)."""
        return self._data.slice(images, 0)

    def _my_layers(self, rows: torch.Tensor) -> torch.Tensor:
        """This rank's layer slots of a sweep's rows (layers over
        ``model``)."""
        if self.cfg.sweep_layers and rows.ndim == 3 and self._model.size > 1:
            return self._model.slice(rows, 1).contiguous()
        return rows

    def _fill_sharded(self, n_tokens: int, indices=None, staged=None):
        """Harvest the first ``n_tokens`` rows of the next store batches
        split over ``data``: each rank runs its images of every store batch.
        Returns (this rank's rows, the harvest positions every rank holds)."""
        dp, me = self._data.size, self._data.rank
        per = self.tokens_per_store_batch // dp
        n_batches = -(-n_tokens // self.tokens_per_store_batch)
        chunks = []
        for images in self._image_batches(n_batches, indices, staged):
            chunks.append(self._my_layers(self.get_activations(self._my_images(images))))
        starts = torch.arange(n_batches, device=self.device) * self.tokens_per_store_batch
        held = []
        for r in range(dp):
            pos = (starts[:, None] + r * per + torch.arange(per, device=self.device)).reshape(-1)
            held.append(pos[pos < n_tokens])
        rows = torch.cat(chunks)[:held[me].numel()]
        return rows, held

    def _gather_positions(self, positions: torch.Tensor) -> torch.Tensor:
        """The buffer's rows at global ``positions`` on every rank of
        ``data`` (this rank's layer slots)."""
        dp = self._data.size
        return exchange_rows(self.buffer, [self._positions(r) for r in range(dp)],
                             [positions] * dp, self._data, take_rows)

    # -- the image wire --------------------------------------------------
    def _dataset_is_uint8(self) -> bool:
        probe = self.dataset
        if hasattr(probe, "__next__"):
            return getattr(probe, "dtype", None) == np.uint8
        if not isinstance(probe, (np.ndarray, torch.Tensor)) and len(probe):
            probe = probe[0]
            if isinstance(probe, (tuple, list)):
                probe = probe[0]
            probe = np.asarray(probe)
        return _is_uint8(probe)

    def _pick_wire_dtype(self, wire: str) -> Optional[torch.dtype]:
        """The dtype images cross to the device in (None: their own)."""
        if wire == "float32":
            return None
        if wire in ("bfloat16", "uint8"):
            if wire != "uint8" and self._dataset_is_uint8():
                # the /255 + normalize decode keys on the uint8 wire; raw
                # 0-255 pixels shipped as floats would reach the model
                # unscaled with no error
                raise ValueError(
                    "uint8 (raw-pixel) datasets must use "
                    "store_wire_dtype='uint8' or 'auto', not float wires")
            return torch.uint8 if wire == "uint8" else torch.bfloat16
        if self._dataset_is_uint8():  # 'auto'
            return torch.uint8
        return torch.bfloat16 if self._model_dtype == torch.bfloat16 else None

    def _wire_itemsize(self, array) -> int:
        if self._wire_dtype is not None:
            return self._wire_dtype.itemsize
        return array.dtype.itemsize

    def _check_wire(self, array) -> None:
        if self._wire_dtype == torch.uint8 and not _is_uint8(array):
            # float -> uint8 would truncate normalized values into garbage;
            # the uint8 wire is for datasets of raw pixel bytes
            raise ValueError(
                "store_wire_dtype='uint8' requires a uint8 dataset "
                f"(got {array.dtype}); use 'bfloat16'/'float32' for "
                "preprocessed float images")

    def _upload(self, dataset) -> torch.Tensor:
        """The whole dataset on the device, in the wire dtype."""
        self._check_wire(dataset)
        images = torch.as_tensor(dataset)
        if self._wire_dtype is not None:
            images = images.to(self._wire_dtype)
        if images.device.type == "cpu":
            self.bytes_to_device += images.nbytes
        return images.to(self.device)

    def _decode(self, images: torch.Tensor) -> torch.Tensor:
        """Wire images -> the model's input: uint8 scaled and normalized,
        then ``augment``, then the model's dtype."""
        if images.dtype == torch.uint8:
            x = images.float() / 255.0
            if self._norm is not None:
                shape = (1, -1) + (1,) * (images.ndim - 2)
                x = (x - self._norm[0].reshape(shape)) / self._norm[1].reshape(shape)
            images = x
        if self.augment is not None:
            images = self.augment(self._next_aug_generator(), images)
        return images.to(self._model_dtype)

    def _next_aug_generator(self) -> torch.Generator:
        """One draw of the augmentation stream (one a store batch, in
        harvest order): a generator on the device seeded with it."""
        seed = int(torch.randint(0, 2 ** 63 - 1, (), generator=self.aug_generator))
        return torch.Generator(device=self.device).manual_seed(seed)

    # -- staging host-fed images -------------------------------------------
    def _next_host_batch(self):
        try:
            batch = next(self.image_iter)
        except StopIteration:
            raise RuntimeError("the store's image stream ended") from None
        sb = self.cfg.store_batch_size
        if batch.shape[0] != sb:
            raise ValueError(
                f"image iterator yielded a batch of {batch.shape[0]} rows; "
                f"the store requires exactly store_batch_size={sb}")
        self._check_wire(batch)
        return torch.as_tensor(batch)

    def _ring_slot(self, shape, dtype):
        """The next of two reused pinned host buffers, once the copy that
        last read it has finished."""
        if self._ring is None or self._ring[0][0].shape != shape \
                or self._ring[0][0].dtype != dtype:
            self._ring = [[torch.empty(shape, dtype=dtype, pin_memory=True), None]
                          for _ in range(2)]
            self._ring_next = 0
        slot = self._ring[self._ring_next]
        self._ring_next ^= 1
        if slot[1] is not None:
            slot[1].synchronize()
        return slot

    def _stage(self, n_batches: int):
        """The next ``n_batches`` store batches of the host stream, in
        order, as one device block in the wire dtype, and the event of its
        last copy (None on the CPU)."""
        sb, chunk = self.cfg.store_batch_size, self._STAGE_CHUNK_BATCHES
        cuda = self.device.type == "cuda"
        if cuda and self._side_stream is None:
            self._side_stream = torch.cuda.Stream(self.device)
        block, event = None, None
        for c0 in range(0, n_batches, chunk):
            nb = min(chunk, n_batches - c0)
            first = self._next_host_batch()
            dtype = self._wire_dtype or first.dtype
            if block is None:  # allocated for the side stream, which writes it
                with torch.cuda.stream(self._side_stream) if cuda else nullcontext():
                    block = torch.empty((n_batches * sb,) + tuple(first.shape[1:]),
                                        dtype=dtype, device=self.device)
            rows = block[c0 * sb:(c0 + nb) * sb]
            host = rows
            if cuda:
                slot = self._ring_slot((chunk * sb,) + tuple(block.shape[1:]), dtype)
                host = slot[0][:nb * sb]
            for j in range(nb):
                host[j * sb:(j + 1) * sb].copy_(first if j == 0 else self._next_host_batch())
            if cuda:
                with torch.cuda.stream(self._side_stream):
                    rows.copy_(host, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record(self._side_stream)
                slot[1] = event
        self.bytes_to_device += block.nbytes
        return block, event

    def _take(self, staged) -> torch.Tensor:
        """A staged block, once the harvest stream may read it."""
        block, event = staged
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            block.record_stream(stream)
        return block

    def _stage_async(self, n_batches: int):
        if self._stage_pool is None:
            self._stage_pool = ThreadPoolExecutor(max_workers=1,
                                                  thread_name_prefix="store-stage")
        return self._stage_pool.submit(self._stage, n_batches)

    def _wait_staging(self):
        """Let an in-flight staging finish taking from the stream."""
        if self._staged is not None:
            wait_futures([self._staged])

    def close(self):
        """Wait for an in-flight staging (raising what it raised) and stop
        its thread, before the stream it reads, say a native loader, is
        closed."""
        staged, self._staged = self._staged, None
        if staged is not None:
            staged.result()
        if self._stage_pool is not None:
            self._stage_pool.shutdown()
            self._stage_pool = None

    # -- harvesting ------------------------------------------------------
    def get_activations(self, images) -> torch.Tensor:
        """One harvested batch of token rows: ``[tokens, d]``, or ``[tokens,
        L, d]`` for a sweep (``[tokens, 2, d]`` for a transcoder)."""
        images = self._decode(torch.as_tensor(images).to(self.device))
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

    def _image_batches(self, n_batches: int, indices=None, staged=None):
        """The next ``n_batches`` store batches of images on the device, in
        the order of the image stream: rows ``indices`` ``[n_batches,
        store_batch_size]`` (else the next of :func:`_index_iterator`) of a
        device-resident dataset, the block ``staged``, or blocks staged now."""
        sb = self.cfg.store_batch_size
        if self._dev_images is not None:
            for i in range(n_batches):
                idx = next(self._idx_iter) if indices is None else indices[i]
                yield self._dev_images[torch.as_tensor(idx, device=self.device)]
            return
        for block in self._host_blocks(n_batches, staged):
            for i in range(block.shape[0] // sb):
                yield block[i * sb:(i + 1) * sb]

    def _host_blocks(self, n_batches: int, staged=None):
        """Device blocks of the next ``n_batches`` store batches of the host
        stream: ``staged``, or blocks staged now, a chunk at a time."""
        if staged is not None:
            yield self._take(staged)
            return
        self._wait_staging()  # a staged block comes first in the stream
        for c0 in range(0, n_batches, self._STAGE_CHUNK_BATCHES):
            yield self._take(self._stage(min(self._STAGE_CHUNK_BATCHES, n_batches - c0)))

    def _fill(self, n_tokens: int, out: Optional[torch.Tensor] = None,
              indices=None, staged=None) -> torch.Tensor:
        """Harvest ``n_tokens`` rows into ``out[:n_tokens]`` (a new tensor
        when None) and return ``out``.  Whole store batches are harvested and
        the rows past ``n_tokens`` dropped, as in the JAX store."""
        n_batches = -(-n_tokens // self.tokens_per_store_batch)
        row = 0
        for images in self._image_batches(n_batches, indices, staged):
            rows = self.get_activations(images)
            if out is None:
                out = torch.empty((n_tokens,) + tuple(rows.shape[1:]), dtype=rows.dtype,
                                  device=self.device)
            take = min(rows.shape[0], n_tokens - row)
            out[row:row + take].copy_(rows[:take])
            row += take
        return out

    def _fresh_batches(self) -> int:
        """Store batches a refill harvests."""
        return -(-(self.buffer_tokens // 2) // self.tokens_per_store_batch)

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
        half = self.buffer_tokens // 2
        if bs > half:
            raise ValueError(
                f"train_batch_size({bs}) must fit in half the buffer ({half} "
                "tokens) — rows past the half would be re-served after the "
                "next mix")
        if self.ptr + bs > half:
            self._refill_half()
        lo, n = self.ptr // self._data.size, self.local_batch_size
        out = self.buffer[lo:lo + n].clone()
        self.ptr += bs
        return out

    def next_batches(self, k: int) -> torch.Tensor:
        """[k, train_batch_size, d]: k consecutive training batches in one
        copy.  Row content is identical to k ``next_batch()`` calls when
        ``k`` divides the number of batches served per half-buffer."""
        bs = self.cfg.train_batch_size
        half = self.buffer_tokens // 2
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
        lo, n = self.ptr // self._data.size, self.local_batch_size
        out = self.buffer[lo:lo + k * n].clone()
        self.ptr += k * bs
        return out.reshape((k, n) + tuple(self.buffer.shape[1:]))

    def _refill_half(self, indices=None):
        """Keep the unserved half, harvest a fresh half, re-permute.  The
        fresh half's images are the next of the image stream (the block
        staged since the last refill, with ``prefetch``), or the
        device-resident dataset's rows ``indices`` (the fused cycle's).

        The JAX store permutes ``concat([buffer[n//2:], fresh])``.  Here the
        fresh rows are written over the served rows ``buffer[:n//2]`` and
        the permutation's indices are mapped onto that layout, so one gather
        (kernel B3) reads the buffer once and writes the new one.  Under a
        mesh the kept rows and this rank's fresh rows are exchanged
        (module note)."""
        n = self.buffer_tokens
        n_fresh, n_kept = n // 2, n - n // 2
        staged, self._staged = self._staged, None
        if self.mesh is not None:
            self._refill_half_sharded(n_fresh, n_kept, indices, staged)
            return
        self._fill(n_fresh, out=self.buffer, indices=indices,
                   staged=None if staged is None else staged.result())
        if self.prefetch and self._dev_images is None:
            self._staged = self._stage_async(self._fresh_batches())
        perm = self._perm(n)
        src = torch.where(perm < n_kept, perm + n_fresh, perm - n_kept)
        self.buffer = take_rows(self.buffer, src)
        self.ptr = 0

    def _refill_half_sharded(self, n_fresh: int, n_kept: int, indices, staged):
        """The mix of ``concat([buffer[n//2:], fresh])`` by the global
        permutation, over a row-sharded buffer: rows of the global row space
        (kept rows at ``position - n//2``, fresh ones at ``n_kept +
        harvest position``) are exchanged to the ranks whose positions the
        permutation maps them to."""
        dp, me = self._data.size, self._data.rank
        fresh, fresh_held = self._fill_sharded(
            n_fresh, indices=indices, staged=None if staged is None else staged.result())
        if self.prefetch and self._dev_images is None:
            self._staged = self._stage_async(self._fresh_batches())
        held = []
        for r in range(dp):
            pos = self._positions(r)
            held.append(torch.cat([pos[pos >= n_fresh] - n_fresh, fresh_held[r] + n_kept]))
        mine = self._positions(me)
        rows = torch.cat([self.buffer[mine >= n_fresh], fresh])
        perm = self._perm(self.buffer_tokens)
        self.buffer = exchange_rows(rows, held, [perm[self._positions(r)] for r in range(dp)],
                                    self._data, take_rows)
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
        return np.stack([next(self._idx_iter) for _ in range(self._fresh_batches())])

    def peek_tokens(self, n: int, layer_slot: Optional[int] = None) -> torch.Tensor:
        """A copy of the first n rows (for the b_dec init); ``layer_slot``
        picks a slot of a sweep's or a transcoder's buffer (the first when
        None).  Under a mesh, the global first n rows, on every rank."""
        if self._data.size == 1:  # the global rows are the local ones
            rows = self.buffer[:n]
        else:
            rows = self._gather_positions(torch.arange(n, device=self.device))
        if self.cfg.sweep_layers and rows.ndim == 3:
            rows = self._model.all_gather(rows, dim=1)
        if rows.ndim == 3:
            rows = rows[:, layer_slot if layer_slot is not None else 0]
        return rows.clone()

    # -- disk caching ----------------------------------------------------
    def generate_cached_activations(self, path: str, n_tokens: int,
                                    tokens_per_file: int = 1_000_000) -> int:
        """Harvest ``n_tokens`` rows of the image stream into float16
        ``{path}/{i}.npy`` shards of ``tokens_per_file`` rows; returns the
        number of shards."""
        os.makedirs(path, exist_ok=True)
        written, shard = 0, 0
        while written < n_tokens:
            m = min(tokens_per_file, n_tokens - written)
            if self.mesh is None:
                chunk = self._fill(m)
            else:
                # the whole chunk on every rank, in harvest order; rank 0 writes
                rows, held = self._fill_sharded(m)
                chunk = exchange_rows(rows, held, [torch.arange(m, device=self.device)]
                                      * self._data.size, self._data, take_rows)
                if chunk.ndim == 3 and self.cfg.sweep_layers:
                    chunk = self._model.all_gather(chunk, dim=1)
                if torch.distributed.get_rank() != 0:
                    written += chunk.shape[0]
                    shard += 1
                    continue
            np.save(os.path.join(path, f"{shard}.npy"),
                    chunk.to(torch.float16).cpu().numpy())
            written += chunk.shape[0]
            shard += 1
        return shard


class CachedActivationsStore:
    """Shard-backed store: loads ``{path}/{i}.npy`` shards (sorted by their
    integer name, read round robin; rows of any shape, a transcoder's
    ``[tokens, 2, d]`` too) instead of running the model, casts them
    to ``cfg.dtype`` on ``device`` (the CUDA card when None) and mixes
    through kernel B3, with the live store's buffer protocol.  Its refill
    keeps ``buffer[n//2:]`` and permutes ``[kept, fresh]``, as the JAX class
    does.  The permutations come from a generator seeded with ``seed``
    (``cfg.seed`` when None), or from ``permutation``, as in the live
    store."""

    def __init__(self, cfg: SAERunnerConfig, path: Optional[str] = None,
                 seed: Optional[int] = None, device=None,
                 permutation: Optional[Callable[[int], torch.Tensor]] = None):
        self.cfg = cfg
        self.path = path or cfg.cached_activations_path
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed if seed is None else seed)
        self._permutation = permutation or (lambda n: torch.randperm(
            n, generator=self.generator, device=self.device))
        self._shards = sorted(
            (f for f in os.listdir(self.path) if f.endswith(".npy")),
            key=lambda f: int(f.split(".")[0]))
        if not self._shards:
            raise FileNotFoundError(f"No .npy shards under {self.path}")
        self._next_shard = 0
        self.buffer = self._load_tokens(cfg.tokens_per_buffer)
        self.buffer = take_rows(self.buffer, self._perm(self.buffer.shape[0]))
        self.ptr = 0

    _perm = VisionActivationsStore._perm

    def _load_tokens(self, n: int) -> torch.Tensor:
        chunks, have = [], 0
        while have < n:
            shard = np.load(os.path.join(self.path, self._shards[self._next_shard]))
            self._next_shard = (self._next_shard + 1) % len(self._shards)
            chunks.append(torch.from_numpy(shard).to(self.device).to(self.cfg.torch_dtype))
            have += shard.shape[0]
        return torch.cat(chunks)[:n]

    def _refill_half(self):
        half = self.buffer.shape[0] // 2
        retained = self.buffer[half:]
        fresh = self._load_tokens(self.buffer.shape[0] - retained.shape[0])
        merged = torch.cat([retained, fresh])
        self.buffer = take_rows(merged, self._perm(merged.shape[0]))
        self.ptr = 0

    def next_batch(self) -> torch.Tensor:
        bs = self.cfg.train_batch_size
        if self.ptr + bs > self.buffer.shape[0] // 2:
            self._refill_half()
        out = self.buffer[self.ptr:self.ptr + bs].clone()
        self.ptr += bs
        return out

    def next_batches(self, k: int) -> torch.Tensor:
        """[k, train_batch_size, d]: k batches in one copy (see
        ``VisionActivationsStore.next_batches``)."""
        bs = self.cfg.train_batch_size
        half = self.buffer.shape[0] // 2
        if k * bs > half:
            raise ValueError(
                f"steps_per_dispatch({k}) x train_batch_size({bs}) must fit in "
                f"half the buffer ({half} tokens)")
        if self.ptr + k * bs > half:
            self._refill_half()
        out = self.buffer[self.ptr:self.ptr + k * bs].clone()
        self.ptr += k * bs
        return out.reshape((k, bs) + tuple(self.buffer.shape[1:]))

    _data = _model = SINGLE  # unsharded: peek_tokens reads the buffer's first rows
    peek_tokens = VisionActivationsStore.peek_tokens
