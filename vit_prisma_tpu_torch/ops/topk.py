"""Per-row k-th-largest threshold for TopK SAEs (PyTorch port of
``vit_prisma_tpu/ops/topk.py``).

The TopK activation needs no sorted values, only "zero everything below
the row's k-th largest".  :func:`kth_value` (kernel B10,
``csrc/kth_value.cu``) finds that value by a bitwise binary search over the
IEEE-754 patterns mapped onto unsigned integers in value order: 32 passes
for float32 rows, 16 for bfloat16 rows (their float32 patterns have zero low
halves).  :func:`topk_mask_activation` then keeps ``relu(x)`` where ``x >=
t``, with ``t`` detached, so autograd flows through the mask alone.

Tie semantics: a row whose k-th value is tied keeps every tied entry
(>= k entries); distinct values give exactly k.  For bfloat16 rows whose
k-th value is negative, ``t`` is a separator just below that value, not
the value itself; the mask ``x >= t`` is exact either way.

The JAX package's ``topk_mask_activation_approx`` (``lax.approx_max_k``, an
XLA op of the TPU, not a Pallas kernel) has no counterpart: a config that
asks for it raises (ROADMAP queue A, item 10).
"""

from __future__ import annotations

import torch

from vit_prisma_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SIGN = 0x80000000
_MASK32 = 0xFFFFFFFF


def _check(x: torch.Tensor, k: int):
    if x.dim() != 2:
        raise ValueError(f"kth_value: x must be [rows, D], got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"kth_value: x must be float32 or bfloat16, got {x.dtype}")
    if not 1 <= k <= x.shape[1]:
        raise ValueError(f"kth_value: k={k} outside [1, {x.shape[1]}]")


def kth_value_reference(x: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version of B10: the kernel's bitwise search in torch ops, so it
    gives the kernel's exact bits.  ``x`` ``[R, D]`` float32 or bfloat16 ->
    ``[R, 1]`` float32."""
    _check(x, k)
    n_bits = 16 if x.dtype == torch.bfloat16 else 32
    bits = x.float().view(torch.int32).to(torch.int64) & _MASK32
    # order-preserving map: positives set the sign bit, negatives flip
    u = torch.where(bits & _SIGN != 0, ~bits & _MASK32, bits | _SIGN)
    acc = torch.zeros(x.shape[0], 1, dtype=torch.int64, device=x.device)
    for b in range(31, 31 - n_bits, -1):
        cand = acc | (1 << b)
        cnt = (u >= cand).sum(dim=1, keepdim=True)
        acc = torch.where(cnt >= k, cand, acc)
    back = torch.where(acc & _SIGN != 0, acc & (_MASK32 ^ _SIGN), ~acc & _MASK32)
    back = torch.where(back >= _SIGN, back - (1 << 32), back)  # as a signed pattern
    return back.to(torch.int32).view(torch.float32)


def kth_value(x: torch.Tensor, k: int) -> torch.Tensor:
    """Kernel B10: per-row k-th largest of ``x`` ``[R, D]`` (float32 or
    bfloat16, contiguous) -> ``[R, 1]`` float32 (a separator for bfloat16
    rows with a negative k-th value; see the module note).  CUDA tensors
    launch ``csrc/kth_value.cu`` and add one to ``kth_value.launches``; CPU
    tensors run the plain version."""
    _check(x, k)
    if x.device.type == "cpu":
        return kth_value_reference(x, k)
    if not x.is_contiguous():
        raise ValueError("kth_value: x must be contiguous")
    R, D = x.shape
    t = torch.empty(R, 1, dtype=torch.float32, device=x.device)
    if R == 0:
        return t
    lib = _build.load_library()
    rc = lib.kth_value(x.data_ptr(), t.data_ptr(), R, D, k, _DTYPE_CODES[x.dtype],
                       x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "kth_value")
    kth_value.launches += 1
    return t


kth_value.launches = 0


def topk_mask_activation(x: torch.Tensor, k: int) -> torch.Tensor:
    """TopK activation by threshold masking over the last axis: ``relu(x)``
    where ``x`` is at least its row's k-th largest, 0 elsewhere.  The
    threshold is detached: gradients flow through the kept entries only."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    t = kth_value(x2.detach().contiguous(), k)
    out = torch.where(x2 >= t, torch.relu(x2), torch.zeros((), dtype=x.dtype, device=x.device))
    return out.reshape(shape)
