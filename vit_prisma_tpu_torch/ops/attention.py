"""Attention-mix kernels (PyTorch port of ``vit_prisma_tpu/ops/attention.py``).

:func:`attention_mix_tnh` is the forward of kernel B1: per-head
``softmax(q kᵀ) v`` over token-major ``[B, T, N·H]`` tensors with a
pre-scaled q, float32 scores and softmax, p rounded to the input dtype before
the PV product, and an optional causal mask.  On a CUDA tensor it launches
the hand-written kernel in ``csrc/attention_mix_tnh.cu``; on a CPU tensor it
runs :func:`attention_mix_tnh_reference`, the plain PyTorch version.

Not ported yet: the backward (B2), the tiled flash kernel for long token axes
(B13), and the JAX package's two kernels without a caller on the main path,
``attention_mix`` and ``fused_attention_block`` (ROADMAP queue B).
"""

from __future__ import annotations

import torch

from vit_prisma_tpu_torch.ops import _build

# Must match smem_bytes() in csrc/attention_mix_tnh.cu.
_WARPS = 8
_MAX_SMEM_BYTES = 232448  # 227 KB: what one block may use on an H100
MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def mix_tnh_smem_bytes(T: int, H: int) -> int:
    """Shared memory the kernel needs for one (batch, head) at T tokens:
    float32 K (rows padded for float4 reads) and V, plus one q row and one
    p row per warp."""
    h4 = -(-H // 4) * 4
    return 4 * (T * (h4 + 4) + _WARPS * h4 + T * H + _WARPS * T)


def mix_tnh_fits_smem(T: int, H: int) -> bool:
    """Whether the kernel takes a head of width H at T tokens."""
    return H <= MAX_HEAD_DIM and mix_tnh_smem_bytes(T, H) <= _MAX_SMEM_BYTES


def attention_mix_tnh_reference(q, k, v, n_heads: int, causal: bool = False):
    """Plain PyTorch version of the mix, with the kernel's float32 and cast
    points: the tests use it as the oracle, and the wrapper runs it for CPU
    tensors."""
    B, T, NH = q.shape
    H = NH // n_heads
    qf = q.reshape(B, T, n_heads, H).float()
    kf = k.reshape(B, T, n_heads, H).float()
    s = torch.einsum("bqnh,bknh->bnqk", qf, kf)
    if causal:
        keep = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    s = s - s.amax(dim=-1, keepdim=True)
    e = s.exp()
    p = (e / e.sum(dim=-1, keepdim=True)).to(v.dtype).float()
    z = torch.einsum("bnqk,bknh->bqnh", p, v.reshape(B, T, n_heads, H).float())
    return z.to(q.dtype).reshape(B, T, NH)


def _launch(q, k, v, n_heads: int, causal: bool):
    """Run the CUDA kernel on PyTorch's current stream."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("attention_mix_tnh: q, k and v must be on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError("attention_mix_tnh: q, k and v must all be float32 or "
                        f"all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("attention_mix_tnh: q, k and v must be contiguous")
    B, T, NH = q.shape
    if B > 65535:
        raise ValueError(f"attention_mix_tnh: batch {B} exceeds the grid "
                         "limit of 65535")
    lib = _build.load_library()
    z = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device)
    rc = lib.attention_mix_tnh_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), z.data_ptr(), B, T, n_heads,
        NH // n_heads, int(causal), _DTYPE_CODES[q.dtype], q.device.index,
        stream.cuda_stream)
    _build.check(lib, rc, "attention_mix_tnh")
    attention_mix_tnh.launches += 1
    return z


class _MixTNH(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, n_heads, causal):
        return _launch(q, k, v, n_heads, causal)

    @staticmethod
    def backward(ctx, dz):
        raise NotImplementedError(
            "the attention-mix backward kernel is not ported yet (ROADMAP "
            "queue B, B2)")


def attention_mix_tnh(q, k, v, n_heads: int, causal: bool = False):
    """Fused attention mix over token-major ``[B, T, N·H]`` tensors
    (pre-scaled q) -> z ``[B, T, N·H]`` in q's dtype.

    CUDA tensors launch the hand-written kernel and add one to
    ``attention_mix_tnh.launches``; CPU tensors run the plain version.  A T
    whose keys and values do not fit the kernel's shared memory raises
    ``NotImplementedError`` on either device: long token axes need the tiled
    flash kernel (B13)."""
    if q.ndim != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError("attention_mix_tnh: q, k and v must share one "
                         f"[B, T, N*H] shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, T, NH = q.shape
    if NH % n_heads:
        raise ValueError(f"attention_mix_tnh: N*H={NH} is not a multiple of "
                         f"n_heads={n_heads}")
    H = NH // n_heads
    if not mix_tnh_fits_smem(T, H):
        raise NotImplementedError(
            f"attention_mix_tnh: T={T}, H={H} does not fit the kernel's "
            "shared memory; long token axes need the tiled flash kernel, "
            "which is not ported yet (ROADMAP queue B, B13)")
    if q.device.type == "cpu":
        return attention_mix_tnh_reference(q, k, v, n_heads, causal)
    return _MixTNH.apply(q, k, v, n_heads, causal)


attention_mix_tnh.launches = 0


def flash_attention_padded(q, k, v, segment_ids, causal: bool = False):
    """Tiled flash attention for long token axes; not ported yet."""
    raise NotImplementedError(
        "flash_attention_padded is not ported yet (ROADMAP queue B, B13)")


def attention_mix(q, k, v):
    """Head-major mix with head-group packing; not ported yet."""
    raise NotImplementedError(
        "attention_mix is not ported yet (ROADMAP queue B, at its end)")


def fused_attention_block(*args, **kwargs):
    """QKV GEMM, mix and O GEMM in one kernel; not ported yet."""
    raise NotImplementedError(
        "fused_attention_block is not ported yet (ROADMAP queue B, at its "
        "end)")
