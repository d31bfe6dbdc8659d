"""LayerNorm -> GEMM (PyTorch port of ``vit_prisma_tpu/ops/ln_matmul.py``).

:func:`ln_matmul` is kernel B14: ``normalize(x) @ W[s] + b[s]`` for a stack
of S projections (S = 3 for Q, K and V, 1 for the MLP's W_in) sharing one
weightless LayerNorm: a float32 island (center, then divide by the root mean
square with eps inside the sqrt) whose result is rounded to x's dtype before
the float32-accumulated GEMM; the bias is added in float32.  x ``[R, D]``, W
``[S, D, C]``, b ``[S, C]`` -> ``[S, R, C]``, so that each projection is a
contiguous slice.  An affine LayerNorm folds into W and b first
(:func:`fold_ln_affine`).

It is a ``torch.autograd.Function``: on CUDA tensors the forward launches
``csrc/ln_matmul.cu``, which normalizes each x tile as the GEMM stages it,
so the LayerNorm's output never reaches device memory (TMA, mbarriers and
wgmma through ``csrc/hopper_gemm.cuh``: bfloat16 ``ln_gemm_tc_kernel``;
float32 ``ln_gemm_tf32_kernel``, each float32 product as three TF32
products on the tensor cores, W split into TF32 hi and lo parts K-major
by a pre-pass into the wrapper's scratch: :func:`ln_matmul_route`); on
CPU tensors it runs the plain version :func:`ln_matmul_reference`.  The backward,
on either device, is the plain version's VJP (:func:`ln_matmul_vjp`: one
LayerNorm recomputed, then ``torch.matmul``), as the JAX package takes its
reference's VJP.
"""

from __future__ import annotations

import torch

from vit_prisma_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Must match the checks of ln_matmul_fwd in csrc/ln_matmul.cu: 128-row tiles,
# columns in tiles of 128 (bf16: 256 where C allows), K in steps of 32 (bf16
# stages of 64 zero-fill a last half step).
_ROW_TILE, _COL_TILE, _DEPTH_TILE = 128, 128, 32
# Must match tc::Layout and tf::kBytes in csrc/ln_matmul.cu: four stages of
# a [128 x 64] bf16 x tile and a [64 x BN] W tile (bf16), or of a [128 x
# 32] float x tile and [128 x 32] W hi and lo tiles (float32); 8 mbarriers
# and 1024 bytes to align the 128-byte swizzle.
_STAGES, _BARRIERS, _ALIGN = 4, 8, 1024


def ln_matmul_route(dtype) -> str:
    """The kernel a dtype takes: ``"wgmma"`` (bfloat16, ``ln_gemm_tc_kernel``)
    or ``"tf32x3"`` (float32, ``ln_gemm_tf32_kernel``: 3xTF32 on tf32
    wgmma)."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"ln_matmul: no route for {dtype}")
    return "tf32x3" if dtype == torch.float32 else "wgmma"


def ln_matmul_smem_bytes(dtype, C: int) -> int:
    """Shared memory of the GEMM's block for a dtype and output width C."""
    if ln_matmul_route(dtype) == "tf32x3":
        stage = 128 * 32 * 4 + 2 * 128 * 32 * 4
    else:
        stage = 128 * 64 * 2 + (256 if C % 256 == 0 else 128) * 64 * 2
    return _STAGES * stage + _BARRIERS * 8 + _ALIGN


def _scratch_floats(R: int, S: int, D: int, C: int, dtype) -> int:
    """Floats of the kernel's scratch: each row's mean and scale and, float32,
    W's split K-major copy [2, S, C, D] from a 128-byte aligned offset
    (tf::wt_offset in csrc/ln_matmul.cu)."""
    if ln_matmul_route(dtype) != "tf32x3":
        return 2 * R
    return -(-2 * R // 32) * 32 + 2 * S * C * D


def ln_matmul_fits(R: int, S: int, D: int, C: int) -> bool:
    """Whether the kernel takes x ``[R, D]`` and W ``[S, D, C]``: C a
    multiple of its 128-wide column tile, D of its 32-deep step; R any size
    (the kernel masks the ragged last row tile) within the grid's limits."""
    return (R > 0 and 0 < S <= 65535 and D > 0 and C > 0 and C % _COL_TILE == 0
            and D % _DEPTH_TILE == 0 and -(-R // _ROW_TILE) <= 65535)


def ln_matmul_reference(x, W, b, eps: float = 1e-5):
    """Plain PyTorch version with the kernel's rounding points: float32
    LayerNorm island, xn rounded to x's dtype, float32 accumulation, bias
    added in float32, the sum rounded to x's dtype."""
    acc = torch.einsum("rd,sdc->src", _normalize(x, eps).float(), W.float())
    return (acc + b[:, None, :].float()).to(x.dtype)


def fold_ln_affine(W, b, ln_w=None, ln_b=None):
    """Fold an affine LayerNorm's weight and bias into the projections that
    follow it: ``(xn * ln_w + ln_b) @ W[s] + b[s] == xn @ (ln_w[:, None] *
    W[s]) + (ln_b @ W[s] + b[s])``.  W ``[S, D, C]``, b ``[S, C]``; returns
    ``(W', b')`` for :func:`ln_matmul`.  The bias term is a float32-summed
    product through the unscaled W, rounded to b's dtype, as in the JAX
    package."""
    if ln_b is not None:
        b = torch.einsum("d,sdc->sc", ln_b.to(W.dtype).float(), W.float()).to(b.dtype) + b
    if ln_w is not None:
        W = ln_w.to(W.dtype)[None, :, None] * W
    return W, b


def _launch(x, W, b, eps: float):
    """Run the CUDA kernel on PyTorch's current stream."""
    R, D = x.shape
    S, _, C = W.shape
    for name, t in (("x", x), ("W", W), ("b", b)):
        if not t.is_cuda or t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"ln_matmul: {name} is {t.dtype} on {t.device}; x is "
                             f"{x.dtype} on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"ln_matmul: {name} must be contiguous and 16-byte aligned")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"ln_matmul: x must be float32 or bfloat16, got {x.dtype}")
    lib = _build.load_library()
    out = torch.empty(S, R, C, dtype=x.dtype, device=x.device)
    # each row's mean and scale; float32: W's split copy
    scratch = torch.empty(_scratch_floats(R, S, D, C, x.dtype), dtype=torch.float32,
                          device=x.device)
    rc = lib.ln_matmul_fwd(x.data_ptr(), W.data_ptr(), b.data_ptr(), out.data_ptr(),
                           scratch.data_ptr(), R, S, D, C, float(eps), _DTYPE_CODES[x.dtype],
                           x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "ln_matmul")
    ln_matmul.launches += 1
    return out


def _normalize(x, eps: float):
    """The reference's LayerNorm island: xn rounded to x's dtype."""
    xf = x.float()
    xc = xf - xf.mean(dim=-1, keepdim=True)
    return (xc / torch.sqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)).to(x.dtype)


def ln_matmul_vjp(x, W, b, g, eps: float = 1e-5, need_x=True, need_W=True, need_b=True):
    """``(dx, dW, db)`` of :func:`ln_matmul_reference` for the cotangent g
    ``[S, R, C]``, each None where not needed: the reference's autograd
    written out.  Its GEMM gradients sum float32 products of x-dtype
    operands and are rounded to x's dtype where the reference's casts round
    them, so they run as matmuls in x's dtype (float32 accumulation, one
    rounding); the LayerNorm's gradient is autograd through the island,
    recomputed."""
    S, R, C = g.shape
    dx = dW = db = None
    if need_x:
        with torch.enable_grad():
            xl = x.detach().requires_grad_(True)
            xn = _normalize(xl, eps)
            dxn = (g.to(W.dtype).permute(1, 0, 2).reshape(R, S * C)
                   @ W.permute(0, 2, 1).reshape(S * C, -1)).to(xn.dtype)
            dx, = torch.autograd.grad(xn, xl, dxn)
    if need_W:
        dW = torch.matmul(_normalize(x, eps).t(), g.to(W.dtype))
    if need_b:
        db = g.float().sum(dim=1).to(b.dtype)
    return dx, dW, db


class _LnMatmul(torch.autograd.Function):
    """B14 forward (the plain version on CPU tensors); the plain version's
    autograd as the backward on either device."""

    @staticmethod
    def forward(ctx, x, W, b, eps):
        ctx.save_for_backward(x, W, b)
        ctx.eps = eps
        if x.device.type == "cpu":
            return ln_matmul_reference(x, W, b, eps)
        return _launch(x, W, b, eps)

    @staticmethod
    def backward(ctx, g):
        x, W, b = ctx.saved_tensors
        need_x, need_W, need_b = ctx.needs_input_grad[:3]
        return (*ln_matmul_vjp(x, W, b, g, ctx.eps, need_x, need_W, need_b), None)


def ln_matmul(x, W, b, eps: float = 1e-5):
    """``normalize(x) @ W[s] + b[s]`` -> ``[S, R, C]`` in x's dtype,
    differentiable.  CUDA tensors launch the hand-written kernel and add one
    to ``ln_matmul.launches``; CPU tensors run the plain version.  A shape
    outside :func:`ln_matmul_fits` raises ``ValueError`` on either device."""
    if x.ndim != 2 or W.ndim != 3 or b.ndim != 2 or W.shape[1] != x.shape[1] \
            or tuple(b.shape) != (W.shape[0], W.shape[2]):
        raise ValueError(f"ln_matmul: x {tuple(x.shape)}, W {tuple(W.shape)}, b "
                         f"{tuple(b.shape)} are not [R, D], [S, D, C], [S, C]")
    R, D = x.shape
    S, _, C = W.shape
    if not ln_matmul_fits(R, S, D, C):
        raise ValueError(f"ln_matmul: R={R}, S={S}, D={D}, C={C} outside the kernel's "
                         "tiles (C a multiple of 128, D of 32)")
    return _LnMatmul.apply(x, W, b, eps)


ln_matmul.launches = 0
