"""Per-row k-th-largest threshold for TopK SAEs (PyTorch port of
``vit_prisma_tpu/ops/topk.py``).

The TopK activation needs no sorted values, only "zero everything below
the row's k-th largest".  :func:`kth_value` (kernel B10,
``csrc/kth_value.cu`` on ``csrc/radix_select.cuh``, whose radix select
B8's bf16 Hopper route shares) finds that value over the IEEE-754
patterns mapped onto unsigned integers in value order: its plain version
by a bitwise binary search (32 passes for float32 rows, 16 for bfloat16
rows, whose float32 patterns have zero low halves), the kernel by a radix
select on 8-bit digits (4 or 2 passes) that gives the same bits.  The
kernel's route depends on the row width alone (:func:`kth_value_route`).
:func:`topk_mask_activation` then keeps ``relu(x)`` where ``x >= t``, with
``t`` detached, so autograd flows through the mask alone.

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
# The kernel's routes (``plan`` in csrc/radix_select.cuh): a block stages up to
# KTH_STAGE_CAP bytes of a row; a wider row is split over a cluster of at
# most KTH_MAX_CLUSTER blocks, KTH_CLUSTER_PART bytes each where it can be.
KTH_STAGE_CAP = 64 * 1024
KTH_CLUSTER_PART = 32 * 1024
KTH_MAX_CLUSTER = 8


def kth_value_route(D: int, dtype: torch.dtype) -> dict:
    """The route of :func:`kth_value`'s kernel for rows of ``D`` elements,
    as ``plan`` in ``csrc/radix_select.cuh`` computes it: ``"block"`` (one
    block stages the row in shared memory), ``"cluster"`` (a cluster of 3-8
    blocks, each staging a part) or ``"streamed"`` (a cluster of 8 reading
    its parts from device memory in every digit pass); ``cluster`` blocks a
    row, ``part`` elements a block (a multiple of 16 bytes), and
    ``stage_bytes`` of dynamic shared memory a block."""
    elem = 2 if dtype == torch.bfloat16 else 4
    vec = 16 // elem
    nbytes = D * elem
    cluster = (1 if nbytes <= KTH_STAGE_CAP
               else min(KTH_MAX_CLUSTER, -(-nbytes // KTH_CLUSTER_PART)))
    staged = nbytes <= KTH_MAX_CLUSTER * KTH_STAGE_CAP
    part = -(-(-(-D // cluster)) // vec) * vec
    route = "block" if cluster == 1 else "cluster" if staged else "streamed"
    return {"route": route, "cluster": cluster, "part": part,
            "stage_bytes": part * elem + 16 if staged else 0}


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
    launch ``csrc/kth_value.cu`` on the route :func:`kth_value_route` gives
    and add one to ``kth_value.launches``; CPU tensors run the plain
    version."""
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
