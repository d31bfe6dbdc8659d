"""Row gather for the activation store (PyTorch port of
``vit_prisma_tpu/ops/shuffle.py``).

:func:`take_rows` is kernel B3, ``x[idx]`` along the rows of a contiguous
``[N, ...]`` tensor of any dtype; it is exact.  On a CUDA tensor it launches
the hand-written copy kernel in ``csrc/take_rows.cu`` for every row width
(the JAX package's "rows under 4 KB take ``jnp.take``" gate was a TPU DMA
cost and is not carried over); on a CPU tensor it runs
:func:`take_rows_reference`.  :func:`permute_rows` shuffles the rows with a
permutation drawn from a ``torch.Generator`` or given as indices.
"""

from __future__ import annotations

from typing import Union

import torch

from vit_prisma_tpu_torch.ops import _build

_INDEX_CODES = {torch.int32: 0, torch.int64: 1}


def take_rows_reference(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the gather."""
    return x.index_select(0, idx)


def _vector_bytes(row_bytes: int, *ptrs: int) -> int:
    """The widest access (16, 8, 4, 2 or 1 bytes) that every row start of
    the source and output is aligned to."""
    for v in (16, 8, 4, 2):
        if row_bytes % v == 0 and all(p % v == 0 for p in ptrs):
            return v
    return 1


def _launch(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if idx.device != x.device:
        raise ValueError(f"take_rows: idx is on {idx.device}, x on {x.device}")
    if not x.is_contiguous():
        raise ValueError("take_rows: x must be contiguous")
    idx = idx.contiguous()
    n, m = x.shape[0], idx.shape[0]
    # One reduction and one sync: the kernel trusts its indices.
    if m:
        lo, hi = torch.stack(torch.aminmax(idx)).tolist()
        if lo < 0 or hi >= n:
            raise IndexError(f"take_rows: an index lies outside [0, {n})")
    out = torch.empty((m,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    row_bytes = x[0].numel() * x.element_size() if n else 0
    if m == 0 or row_bytes == 0:
        return out
    lib = _build.load_library()
    stream = torch.cuda.current_stream(x.device)
    rc = lib.take_rows(x.data_ptr(), idx.data_ptr(), out.data_ptr(), m, row_bytes,
                       _INDEX_CODES[idx.dtype],
                       _vector_bytes(row_bytes, x.data_ptr(), out.data_ptr()),
                       x.device.index, stream.cuda_stream)
    _build.check(lib, rc, "take_rows")
    take_rows.launches += 1
    return out


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along axis 0 -> ``[M, ...]`` in x's dtype (kernel B3).

    ``idx``: ``[M]`` int32 or int64, each in ``[0, N)``.  CUDA tensors
    launch the hand-written kernel and add one to ``take_rows.launches``;
    CPU tensors run the plain version."""
    if idx.ndim != 1 or idx.dtype not in _INDEX_CODES:
        raise TypeError(f"take_rows: idx must be a 1-D int32 or int64 tensor, "
                        f"got {idx.dtype} {tuple(idx.shape)}")
    if x.ndim < 1:
        raise ValueError("take_rows: x must have a row axis")
    if x.device.type == "cpu":
        return take_rows_reference(x, idx)
    return _launch(x, idx)


take_rows.launches = 0


def permute_rows(generator_or_idx: Union[torch.Generator, torch.Tensor],
                 x: torch.Tensor) -> torch.Tensor:
    """A random row permutation of ``x`` through :func:`take_rows`: the
    permutation is ``torch.randperm`` from the generator (which must live on
    x's device), or the given ``[N]`` indices."""
    if isinstance(generator_or_idx, torch.Generator):
        idx = torch.randperm(x.shape[0], generator=generator_or_idx,
                             device=x.device)
    else:
        idx = generator_or_idx.to(x.device)
    return take_rows(x, idx)
