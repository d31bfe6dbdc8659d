"""Fused SAE forward and backward over L stacked SAEs, standard-ReLU, TopK
and gated (PyTorch port of ``vit_prisma_tpu/ops/sae_step.py``).

For ``x`` ``[L, B, d_in]``, ``W_enc`` ``[L, d_in, d_sae]``, ``b_enc``
``[L, d_sae]``, ``W_dec`` ``[L, d_sae, d_in]`` and ``b_dec`` ``[L, d_in]``,
all in the compute dtype c::

    h      = relu((x - b_dec) W_enc + b_enc)
    y      = h W_dec + b_dec
    l1[l]  = sum(h)                          (the sparsity penalty's value)
    nact[l, j] = number of rows with hpre[.., j] > 0   (exact counters)

Three kernels, each a wrapper with a ``launches`` count, a hand-written CUDA
kernel for CUDA tensors and a plain PyTorch version with the same cast
points for CPU tensors:

* B4 :func:`sae_fused_forward` (``csrc/sae_fused_fwd.cu``), optionally
  returning the activations ``hc`` in c for the stored-acts backward;
* B5 :func:`sae_fused_backward` (``csrc/sae_fused_bwd.cu``), the remat VJP,
  which recomputes ``hpre``;
* B6 :func:`sae_fused_backward_stored` (same file), the VJP from the stored
  ``hc``, whose mask is ``float(hc) > 0``: it equals B5's ``hpre > 0``
  except where a positive float32 pre-activation rounds to +0 in bf16.

Every SAE kernel here takes one of three routes by dtype, shape and kernel
family (:func:`sae_gemm_route`): bfloat16 with d_in and d_sae multiples of
256 runs ``csrc/sae_fused_tc.cu`` (wgmma on a TMA-fed ring, on
``csrc/sae_wgmma.cuh``), other bfloat16 shapes the mma.sync tiles of
``csrc/sae_gemm.cuh`` in the files named here; float32 runs every family
(B4, B5, B6; B8, B9; B11, B12) on ``csrc/sae_fused_tf32.cu`` ("tf32x3":
each product as three TF32 products on tf32 wgmma, after pre-passes that
split the B operands into TF32 hi and lo parts laid out K-major).  Each
wrapper counts its launches by route in ``routes``.  On the Hopper route
B5 recomputes B4's encoder product with B4's own mainloop and carries its
mask ``hpre > 0`` into B6's dh launch in hc's bits: hc is B4's, with -0
(bits 0x8000, which B4 never writes) where a positive hpre rounds to +0,
and the mask is "bits != 0".  On the float32 route B5 runs B4's encoder
kernel again without its reductions (hc is B4's to the bit, and
``relu(hpre) > 0`` iff ``hpre > 0``), then B6's launches.

:func:`sae_fused_apply` wraps them in a ``torch.autograd.Function``
returning ``(y, l1, nact)``.  Its gradient for ``x`` is zero (only the train
step may use it), and the weight gradients are cast to the parameters'
dtypes.  The products run in float32 (with float32 accumulation of the
bfloat16 values) in the plain versions, as the TPU kernels accumulate.

TopK (keep each row's k largest pre-activations) has three more::

    hp     = ((x - b_dec) W_enc + b_enc) rounded to c   (round first: the
             threshold and the mask read the rounded values)
    t[l,b] = k-th largest of max(float(hp), 0) over the row
    active = (float(hp) >= t) & (float(hp) > 0)      (ties keep >= k)
    h      = active ? hp : 0;  y = h W_dec + b_dec;  l1 = sum(h);
    nact   = active rows per feature

* B8 :func:`sae_fused_forward_topk` (``csrc/sae_fused_fwd_topk.cu``)
  returns ``(y, l1, nact, t)``, plus the masked ``h`` with ``save_h``;
* B9 :func:`sae_fused_backward_topk` (``csrc/sae_fused_bwd.cu``, the TopK
  mask mode) recomputes hp, rounds it to c and masks it against the stored
  ``t``, so its active set is B8's bit for bit;
* the stored-acts backward needs no kernel of its own: B8's masked h is
  positive exactly on the active set, so B6 applies to it unchanged.

On the Hopper route and the float32 route B8 stores ``c(max(hpre, 0))``
(+0 where hpre <= 0, which equals ``max(float(hp), 0)`` entry by entry),
takes t by B10's radix select (``csrc/radix_select.cuh``, bitwise the
bitwise search's t on such rows) and masks the rows in place; B9
recomputes that encoder with the same mainloop and masks it against t, then
runs B6's launches, so B9 follows B8's route at every shape and its active
set stays B8's.

:func:`sae_fused_apply_topk` wraps them as :func:`sae_fused_apply` wraps
B4-B6.

The gated SAE (``b_gate``, ``r_mag``, ``b_mag`` in place of ``b_enc``)
shares one encoder product between its gate and magnitude paths, since
``exp(r_mag)`` scales columns of ``W_enc``; with ``e = exp(r_mag)`` and the
decoder row norms ``wdn`` (float32, plain torch, :func:`_gated_hoisted`)::

    g   = (x - b_dec) W_enc                         (float32)
    hg  = (g + b_gate) rounded to c;  hm = (g e + b_mag) rounded to c
    h   = hg > 0 ? max(hm, 0) : 0;    hga = max(hg, 0)
    y   = h W_dec + b_dec;  via = hga W_dec + b_dec;  l1 = sum(hga wdn)
    nact = rows with h > 0 per feature

* B11 :func:`sae_gated_fused_forward` (``csrc/sae_fused_fwd_gated.cu``);
* B12 :func:`sae_gated_fused_backward` (``csrc/sae_fused_bwd_gated.cu``),
  the remat VJP from the cotangents of y, via and l1.

B11 and B12 take the same routes (:func:`sae_gemm_route`): bfloat16 with
d_in and d_sae multiples of 256 runs ``csrc/sae_fused_tc.cu``, the other
bfloat16 shapes the files above, float32 ``csrc/sae_fused_tf32.cu`` (B12's
dg in two launches, dy's then dvia's, through a float32 dg tile); the route
is a function of the shape, dtype and family alone, so a backward (B5, B9,
B12) always recomputes its masks on its forward's route, to the bit.

:func:`sae_gated_fused_apply` wraps them, returning ``(y, via, l1,
nact)``.
"""

from __future__ import annotations

import torch

from vit_prisma_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The kernels' block tile (sae_gemm.cuh BM = BN = 128): partial sums come
# one per 128-row block.
_TILE = 128


def fused_step_eligible(B: int, d_in: int, d_sae: int, itemsize: int) -> bool:
    """Shape gate of the fused step: the JAX package's alignment rule, which
    also meets the kernels' own limits (every dimension a multiple of the
    128 x 128 x 32 tile, float32 or bfloat16)."""
    return (d_in % 128 == 0 and d_sae % 256 == 0 and B % 256 == 0
            and itemsize in (2, 4) and B // _TILE <= 65535
            and d_sae // _TILE <= 65535)


def fused_gated_step_eligible(B: int, d_in: int, d_sae: int, itemsize: int) -> bool:
    """Shape gate of the fused gated step: :func:`fused_step_eligible`'s
    limits (B11 and B12 run on the same tile GEMM), and B11's decoder grid
    over 2B rows (h and hga stacked).  The JAX package's VMEM block pickers
    have no counterpart here."""
    return fused_step_eligible(B, d_in, d_sae, itemsize) and 2 * B // _TILE <= 65535


# ---------------------------------------------------------------------------
# Plain versions (the cast points of the TPU kernels)
# ---------------------------------------------------------------------------

def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Float32 product of two c-typed operands: bf16 values are exact in
    float32, so this is a float32-accumulated product."""
    return torch.matmul(a.float(), b.float())


def _center(x, bd):
    return x - bd[:, None, :]


def sae_fused_forward_reference(x, We, be, Wd, bd, save_h: bool = False):
    """Plain version of B4.  Returns ``(y, l1, nact)``, plus ``hc`` with
    ``save_h``."""
    xc = _center(x, bd)
    hpre = _mm(xc, We) + be.float()[:, None, :]
    h = torch.relu(hpre)
    hc = h.to(x.dtype)
    y = (bd.float()[:, None, :] + _mm(hc, Wd)).to(x.dtype)
    l1 = h.sum(dim=(1, 2))
    nact = (hpre > 0).sum(dim=1, dtype=torch.float32)
    return (y, l1, nact, hc) if save_h else (y, l1, nact)


def _backward_from_mask(xc, hc, mask, Wd, dy, dl1):
    dh_f = _mm(dy, Wd.transpose(-1, -2))
    dh = torch.where(mask, dh_f + dl1.float()[:, None, None], 0.0)
    dhc = dh.to(xc.dtype)
    return _mm(xc.transpose(-1, -2), dhc), _mm(hc.transpose(-1, -2), dy), dh.sum(dim=1)


def sae_fused_backward_reference(x, We, be, Wd, bd, dy, dl1):
    """Plain version of B5 (recompute).  Returns float32 ``(dW_enc, dW_dec,
    db_enc)``."""
    xc = _center(x, bd)
    hpre = _mm(xc, We) + be.float()[:, None, :]
    hc = torch.relu(hpre).to(x.dtype)
    return _backward_from_mask(xc, hc, hpre > 0, Wd, dy, dl1)


def sae_fused_backward_stored_reference(x, hc, Wd, bd, dy, dl1):
    """Plain version of B6 (stored ``hc``).  Returns float32 ``(dW_enc,
    dW_dec, db_enc)``."""
    return _backward_from_mask(_center(x, bd), hc, hc.float() > 0, Wd, dy, dl1)


def _hp(x, We, be, bd):
    """TopK pre-activations rounded to the compute dtype, and the centered x."""
    xc = _center(x, bd)
    return xc, (_mm(xc, We) + be.float()[:, None, :]).to(x.dtype)


def _row_threshold(hp: torch.Tensor, k: int) -> torch.Tensor:
    """Per-row k-th largest of ``max(float(hp), 0)`` over the last axis, by
    the kernels' bitwise search (float32 ``[..., 1]``).  Non-negative float
    patterns are ordered as integers, so the sign bit is never searched:
    31 passes for float32, 15 for bfloat16 (whose low 16 bits are 0)."""
    hpf = hp.float()
    key = torch.where(hpf > 0, hpf, 0.0).view(torch.int32)
    low = 16 if hp.dtype == torch.bfloat16 else 0
    acc = torch.zeros(hp.shape[:-1] + (1,), dtype=torch.int32, device=hp.device)
    for b in range(30, low - 1, -1):
        cand = acc | (1 << b)
        acc = torch.where((key >= cand).sum(-1, keepdim=True) >= k, cand, acc)
    return acc.view(torch.float32)


def _topk_mask(hp, t):
    hpf = hp.float()
    active = (hpf >= t) & (hpf > 0)
    return active, torch.where(active, hp, torch.zeros((), dtype=hp.dtype, device=hp.device))


def sae_fused_forward_topk_reference(x, We, be, Wd, bd, k: int, save_h: bool = False):
    """Plain version of B8.  Returns ``(y, l1, nact, t)``, plus the masked
    ``h`` with ``save_h``."""
    _, hp = _hp(x, We, be, bd)
    t = _row_threshold(hp, k)
    active, h = _topk_mask(hp, t)
    y = (bd.float()[:, None, :] + _mm(h, Wd)).to(x.dtype)
    out = (y, h.float().sum(dim=(1, 2)), active.sum(dim=1, dtype=torch.float32), t)
    return out + (h,) if save_h else out


def sae_fused_backward_topk_reference(x, We, be, Wd, bd, dy, dl1, t):
    """Plain version of B9 (recompute, masked by the stored ``t``).
    Returns float32 ``(dW_enc, dW_dec, db_enc)``."""
    xc, hp = _hp(x, We, be, bd)
    active, h = _topk_mask(hp, t)
    return _backward_from_mask(xc, h, active, Wd, dy, dl1)


def sae_fused_topk_reference(x, We, be, Wd, bd, k: int):
    """Unfused equivalent of :func:`sae_fused_apply_topk` with autograd (the
    JAX package's ``sae_fused_topk_reference``): the threshold from
    ``torch.topk``'s values, the same mask semantics (ties keep >= k)."""
    xc = x - bd[:, None, :]
    hpre = (torch.einsum("lbd,lds->lbs", xc.float(), We.float())
            + be.float()[:, None, :]).to(x.dtype)
    hf = hpre.detach().float()
    t = torch.topk(hf, k, dim=-1).values[..., -1:].clamp_min(0.0)
    active = (hf >= t) & (hf > 0)
    h = torch.where(active, hpre, torch.zeros((), dtype=hpre.dtype))
    y = (torch.einsum("lbs,lsd->lbd", h.float(), Wd.float())
         + bd.float()[:, None, :]).to(x.dtype)
    return y, h.sum(dim=(1, 2), dtype=torch.float32), active.sum(dim=1, dtype=torch.float32)


def sae_fused_reference(x, We, be, Wd, bd):
    """Unfused equivalent in the input dtype (same signature and outputs as
    :func:`sae_fused_apply`), as the JAX package's ``sae_fused_reference``."""
    xc = x - bd[:, None, :]
    hpre = torch.einsum("lbd,lds->lbs", xc, We) + be[:, None, :]
    h = torch.relu(hpre)
    y = torch.einsum("lbs,lsd->lbd", h, Wd) + bd[:, None, :]
    l1 = h.sum(dim=(1, 2), dtype=torch.float32)
    nact = (hpre > 0).sum(dim=1, dtype=torch.float32)
    return y, l1, nact


def _gated_hoisted(rmag, Wd):
    """The gated kernels' per-feature invariants, float32 ``[L, d_sae]``:
    e = exp(r_mag) and the decoder row norms (the JAX package computes them
    in XLA outside its kernels)."""
    return torch.exp(rmag.float()), torch.sqrt(torch.square(Wd.float()).sum(dim=-1))


def _gated_hoisted_card(rmag, Wd):
    """:func:`_gated_hoisted` for the kernels' launches: the row norms in
    one float32 reduction over W_dec as it lies, not three passes over a
    float32 copy (the same sums of squares, in another order)."""
    return torch.exp(rmag.float()), torch.linalg.vector_norm(Wd, dim=-1, dtype=torch.float32)


def _gated_pre(x, We, bg, e, bm, bd):
    """The centered x, the float32 product g and the pre-activations hg and
    hm rounded to c (B11's and B12's cast point, so both see one mask)."""
    xc = _center(x, bd)
    g = _mm(xc, We)
    hg = (g + bg.float()[:, None, :]).to(x.dtype).float()
    hm = (g * e[:, None, :] + bm.float()[:, None, :]).to(x.dtype).float()
    return xc, g, hg, hm


def sae_gated_fused_forward_reference(x, We, bg, rmag, bm, Wd, bd, save_h: bool = False):
    """Plain version of B11.  Returns ``(y, via, l1, nact)``, plus ``hc``
    and ``hgac`` (h and hga in c) with ``save_h``."""
    e, wdn = _gated_hoisted(rmag, Wd)
    _, _, hg, hm = _gated_pre(x, We, bg, e, bm, bd)
    hc = torch.where((hg > 0) & (hm > 0), hm, 0.0).to(x.dtype)
    hga = torch.relu(hg)
    hgac = hga.to(x.dtype)
    dec = lambda f: (bd.float()[:, None, :] + _mm(f, Wd)).to(x.dtype)
    out = (dec(hc), dec(hgac), (hga * wdn[:, None, :]).sum(dim=(1, 2)),
           (hc > 0).sum(dim=1, dtype=torch.float32))
    return out + (hc, hgac) if save_h else out


def sae_gated_fused_backward_reference(x, We, bg, rmag, bm, Wd, bd, dy, dvia, dl1):
    """Plain version of B12 (recompute).  Returns float32 ``(dW_enc, dW_dec,
    db_gate, db_mag, dr_mag)``."""
    e, wdn = _gated_hoisted(rmag, Wd)
    xc, g, hg, hm = _gated_pre(x, We, bg, e, bm, bd)
    gate = hg > 0
    mag = gate & (hm > 0)
    WdT = Wd.transpose(-1, -2)
    dhm = torch.where(mag, _mm(dy, WdT), 0.0)
    dhg = torch.where(gate, _mm(dvia, WdT) + dl1.float()[:, None, None] * wdn[:, None, :], 0.0)
    dgc = (dhg + dhm * e[:, None, :]).to(x.dtype)
    hga = torch.relu(hg)
    coef = dl1.float()[:, None] * hga.sum(dim=1) / wdn.clamp_min(1e-30)
    dWd = (_mm(torch.where(mag, hm, 0.0).to(x.dtype).transpose(-1, -2), dy)
           + _mm(hga.to(x.dtype).transpose(-1, -2), dvia) + coef[..., None] * Wd.float())
    return (_mm(xc.transpose(-1, -2), dgc), dWd, dhg.sum(dim=1), dhm.sum(dim=1),
            (dhm * g).sum(dim=1) * e)


def sae_gated_fused_reference(x, We, bg, rmag, bm, Wd, bd):
    """Unfused equivalent of :func:`sae_gated_fused_apply` with autograd
    through einsums (the JAX package's ``sae_gated_fused_reference``: one
    encoder product, float32 accumulation, one rounding to c at the
    pre-activations)."""
    xc = x - bd[:, None, :]
    g = torch.einsum("lbd,lds->lbs", xc.float(), We.float())
    hg = (g + bg.float()[:, None, :]).to(x.dtype).float()
    hm = (g * torch.exp(rmag.float())[:, None, :] + bm.float()[:, None, :]).to(x.dtype).float()
    h = torch.where(hg > 0, torch.relu(hm), 0.0).to(x.dtype)
    hga = torch.relu(hg)
    dec = lambda f: (torch.einsum("lbs,lsd->lbd", f.float(), Wd.float())
                     + bd.float()[:, None, :]).to(x.dtype)
    wdn = torch.sqrt(torch.square(Wd.float()).sum(dim=-1))
    return (dec(h), dec(hga.to(x.dtype)), (hga * wdn[:, None, :]).sum(dim=(1, 2)),
            (h > 0).sum(dim=1, dtype=torch.float32))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _shapes(x, We, Wd):
    L, B, D = x.shape
    S = We.shape[-1]
    if tuple(We.shape) != (L, D, S) or tuple(Wd.shape) != (L, S, D):
        raise ValueError(f"sae kernels: x {tuple(x.shape)}, W_enc {tuple(We.shape)}, "
                         f"W_dec {tuple(Wd.shape)} do not stack as [L, B, d_in], "
                         "[L, d_in, d_sae], [L, d_sae, d_in]")
    return L, B, D, S


def _check(name, dtype, device, **tensors):
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: the compute dtype must be float32 or bfloat16, got {dtype}")
    for k, t in tensors.items():
        want = torch.float32 if k == "dl1" else dtype
        if t.dtype != want or t.device != device:
            raise ValueError(f"{name}: {k} is {t.dtype} on {t.device}, expected "
                             f"{want} on {device}")
        if device.type == "cuda" and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name}: {k} must be contiguous and 16-byte aligned")


def _kernel_shapes_ok(name, B, D, S):
    if B % _TILE or D % _TILE or S % _TILE:
        raise ValueError(f"{name}: B={B}, d_in={D} and d_sae={S} must be multiples "
                         f"of the kernels' {_TILE}-wide tile")


def _lib_and_stream(device):
    return _build.load_library(), torch.cuda.current_stream(device).cuda_stream


# The block tile's width on B4's and B6's bf16 Hopper route
# (csrc/sae_wgmma.cuh kBN; its 128 rows are _TILE's): d_in and d_sae must
# be multiples of it.
_TC_BN = 256
SAE_GEMM_ROUTES = ("wgmma", "mma_sync", "tf32x3")
# The kernel families, each wrapper's: a forward and its remat backward are
# of one family, and a family takes one route at a shape and dtype.
SAE_FAMILIES = ("relu", "topk", "gated")
SAE_KERNEL_FAMILIES = {"sae_fused_forward": "relu", "sae_fused_backward": "relu",
                       "sae_fused_backward_stored": "relu", "sae_fused_forward_topk": "topk",
                       "sae_fused_backward_topk": "topk", "sae_gated_fused_forward": "gated",
                       "sae_gated_fused_backward": "gated"}
# Dynamic shared memory of csrc/sae_fused_tf32.cu's kernel (kBytes): four
# 48 KB stages (a [128 x 32] float A tile, B's hi and lo [128 x 32] tiles),
# the column partials of 8 consumer warps x 128 columns, their l1 partials,
# 8 mbarriers and 1 KB of alignment: one block an SM.
SAE_TF32_SMEM_BYTES = 4 * 3 * 128 * 32 * 4 + 8 * 128 * 4 + 8 * 4 + 8 * 8 + 1024


def sae_gemm_route(B: int, d_in: int, d_sae: int, dtype: torch.dtype, family: str = "relu"):
    """The route a fused SAE kernel of ``family`` (``"relu"``: B4-B6;
    ``"topk"``: B8, B9; ``"gated"``: B11, B12) takes on the card:
    ``"wgmma"`` (the bf16 Hopper kernels of ``csrc/sae_fused_tc.cu``),
    ``"mma_sync"`` (the other bf16 shapes, on ``csrc/sae_gemm.cuh``'s
    tensor-core tiles), ``"tf32x3"`` (float32, every family:
    ``csrc/sae_fused_tf32.cu``, 3xTF32 on tf32 wgmma), or None where no
    kernel takes the shape (B, d_in or d_sae not a multiple of 128).  It
    reads the shape, dtype and family alone, so a forward and its remat
    backward (B4 and B5, B8 and B9, B11 and B12) always take the same route,
    and the backward's recomputed masks are the forward's."""
    if family not in SAE_FAMILIES:
        raise ValueError(f"sae_gemm_route: family {family!r} is not one of {SAE_FAMILIES}")
    if B % _TILE or d_in % _TILE or d_sae % _TILE or dtype not in _DTYPE_CODES:
        return None
    if dtype == torch.float32:
        return "tf32x3"
    return "wgmma" if d_in % _TC_BN == 0 and d_sae % _TC_BN == 0 else "mma_sync"


def sae_kernel_routes(B: int, d_in: int, d_sae: int, dtype: torch.dtype) -> dict:
    """Each routed wrapper's route at one shape and dtype, by its family."""
    return {k: sae_gemm_route(B, d_in, d_sae, dtype, fam)
            for k, fam in SAE_KERNEL_FAMILIES.items()}


def _tf32_scratch_floats(backward: bool, L: int, B: int, D: int, S: int,
                         family: str = "relu") -> int:
    """Floats of the "tf32x3" route's split copies (csrc/sae_fused_tf32.cu):
    a weight's TF32 hi and lo parts K-major, 2 S D a layer (the forwards'
    W_enc, then W_dec in the same place); the backwards W_dec's, then xc's
    and dy's transposed copies, 4 D B a layer, in the same place (the gated
    backward: xc's and [dy; dvia]'s, 6 D B)."""
    if not backward:
        return L * 2 * S * D
    return L * max(2 * S * D, (6 if family == "gated" else 4) * D * B)


def sae_fused_forward(x, We, be, Wd, bd, save_h: bool = False):
    """Kernel B4: ``(y, l1, nact)`` (plus ``hc`` with ``save_h``) for the
    stacked SAEs; y and hc in x's dtype, l1 ``[L]`` and nact ``[L, d_sae]``
    float32.  CUDA tensors launch ``csrc/sae_fused_tc.cu`` (the "wgmma"
    route of :func:`sae_gemm_route`), ``csrc/sae_fused_tf32.cu``
    ("tf32x3") or ``csrc/sae_fused_fwd.cu`` and add one to
    ``sae_fused_forward.launches`` and to the route's count in
    ``sae_fused_forward.routes``; a launch that fails raises.  CPU tensors
    run the plain version."""
    L, B, D, S = _shapes(x, We, Wd)
    _check("sae_fused_forward", x.dtype, x.device, x=x, W_enc=We, b_enc=be, W_dec=Wd, b_dec=bd)
    if x.device.type == "cpu":
        return sae_fused_forward_reference(x, We, be, Wd, bd, save_h)
    _kernel_shapes_ok("sae_fused_forward", B, D, S)
    route = sae_gemm_route(B, D, S, x.dtype)
    new = lambda *shape, dtype=x.dtype: torch.empty(shape, dtype=dtype, device=x.device)
    xc, hc, y = new(L, B, D), new(L, B, S), new(L, B, D)
    # per-tile partials: nact per 128-row block, l1 per block tile
    nact_part = new(L, B // _TILE, S, dtype=torch.float32)
    l1_part = new(L, B // _TILE, S // (_TC_BN if route == "wgmma" else _TILE),
                  dtype=torch.float32)
    lib, stream = _lib_and_stream(x.device)
    ptrs = (x.data_ptr(), We.data_ptr(), be.data_ptr(), Wd.data_ptr(), bd.data_ptr(),
            xc.data_ptr(), hc.data_ptr(), y.data_ptr(), nact_part.data_ptr(),
            l1_part.data_ptr())
    if route == "wgmma":
        rc = lib.sae_fused_fwd_tc(*ptrs, L, B, D, S, x.device.index, stream)
    elif route == "tf32x3":
        split = new(_tf32_scratch_floats(False, L, B, D, S), dtype=torch.float32)
        rc = lib.sae_fused_fwd_tf32(*ptrs, split.data_ptr(), L, B, D, S, x.device.index, stream)
    else:
        rc = lib.sae_fused_fwd(*ptrs, L, B, D, S, _DTYPE_CODES[x.dtype], x.device.index,
                               stream)
    _build.check(lib, rc, f"sae_fused_forward ({route})")
    sae_fused_forward.launches += 1
    sae_fused_forward.routes[route] += 1
    # per-row-block partials, summed as the JAX package sums its own
    out = (y, l1_part.sum(dim=(1, 2)), nact_part.sum(dim=1))
    return out + (hc,) if save_h else out


sae_fused_forward.launches = 0
sae_fused_forward.routes = dict.fromkeys(SAE_GEMM_ROUTES, 0)


# sae_fused_bwd's mask modes: B6 (stored hc), B5 (ReLU remat), B9 (TopK remat)
_STORED, _RELU_REMAT, _TOPK_REMAT = 0, 1, 2


def _backward_launch(name, mode, x, Wd, bd, dy, dl1, hc=None, We=None, be=None, t=None):
    """Launch B6 (``hc`` is the stored activation; W_enc and b_enc are not
    read), B5 or B9 (``We`` and ``be`` given, hc is written into scratch;
    B9 also reads the forward's thresholds ``t``)."""
    L, B, D = x.shape
    S = Wd.shape[1]
    _kernel_shapes_ok(name, B, D, S)
    new = lambda *shape, dtype=x.dtype: torch.empty(shape, dtype=dtype, device=x.device)
    if mode == _STORED:
        We = be = hc
    else:
        hc = new(L, B, S)
    xc, dhc = new(L, B, D), new(L, B, S)
    dWe, dWd = new(L, D, S, dtype=torch.float32), new(L, S, D, dtype=torch.float32)
    dbe_part = new(L, B // _TILE, S, dtype=torch.float32)
    lib, stream = _lib_and_stream(x.device)
    rc = lib.sae_fused_bwd(x.data_ptr(), We.data_ptr(), be.data_ptr(), Wd.data_ptr(),
                           bd.data_ptr(), dy.data_ptr(), dl1.data_ptr(),
                           0 if t is None else t.data_ptr(), hc.data_ptr(),
                           xc.data_ptr(), dhc.data_ptr(), dWe.data_ptr(), dWd.data_ptr(),
                           dbe_part.data_ptr(), L, B, D, S, _DTYPE_CODES[x.dtype],
                           mode, x.device.index, stream)
    _build.check(lib, rc, name)
    return dWe, dWd, dbe_part.sum(dim=1)


def _tc_backward(name, entry, route, x, S, ins, hc_scratch):
    """A backward's launches on the "wgmma" route (``csrc/sae_fused_tc.cu``)
    or the "tf32x3" route (``csrc/sae_fused_tf32.cu``): the library's
    ``entry`` with the pointers of ``ins``, then of xc (but in tf32x3's B6,
    which forms no xc), the recomputed hc (B5, B9: ``hc_scratch``), dhc,
    the split copies (tf32x3), dW_enc, dW_dec and the db_enc partials, all
    allocated here.  Raises if the launch fails."""
    L, B, D = x.shape
    new = lambda *shape, dtype=x.dtype: torch.empty(shape, dtype=dtype, device=x.device)
    scratch = (new(L, B, D),) if route == "wgmma" or hc_scratch else ()
    scratch += (new(L, B, S), new(L, B, S)) if hc_scratch else (new(L, B, S),)
    if route == "tf32x3":
        scratch += (new(_tf32_scratch_floats(True, L, B, D, S), dtype=torch.float32),)
    dWe, dWd = new(L, D, S, dtype=torch.float32), new(L, S, D, dtype=torch.float32)
    dbe_part = new(L, B // _TILE, S, dtype=torch.float32)
    lib, stream = _lib_and_stream(x.device)
    rc = getattr(lib, entry)(*(t.data_ptr() for t in (*ins, *scratch, dWe, dWd, dbe_part)),
                             L, B, D, S, x.device.index, stream)
    _build.check(lib, rc, f"{name} ({route})")
    return dWe, dWd, dbe_part.sum(dim=1)


def sae_fused_backward(x, We, be, Wd, bd, dy, dl1):
    """Kernel B5, the remat VJP: float32 ``(dW_enc [L, d_in, d_sae],
    dW_dec [L, d_sae, d_in], db_enc [L, d_sae])`` from ``dy`` (x's dtype)
    and ``dl1`` (float32 ``[L]``).  CUDA tensors launch
    ``csrc/sae_fused_tc.cu`` (the "wgmma" route of :func:`sae_gemm_route`,
    B4's: its mask ``hpre > 0`` carried by -0 marks in the recomputed hc),
    ``csrc/sae_fused_tf32.cu`` ("tf32x3", B4's: B4's encoder again, then
    B6's launches) or ``csrc/sae_fused_bwd.cu`` and add one to
    ``sae_fused_backward.launches`` and to the route's count in
    ``sae_fused_backward.routes``; a launch that fails raises.  CPU tensors
    run the plain version."""
    L, B, D, S = _shapes(x, We, Wd)
    _check("sae_fused_backward", x.dtype, x.device, x=x, W_enc=We, b_enc=be, W_dec=Wd,
           b_dec=bd, dy=dy, dl1=dl1)
    if x.device.type == "cpu":
        return sae_fused_backward_reference(x, We, be, Wd, bd, dy, dl1)
    _kernel_shapes_ok("sae_fused_backward", B, D, S)
    route = sae_gemm_route(B, D, S, x.dtype)
    if route in ("wgmma", "tf32x3"):
        entry = "sae_fused_bwd_remat_tc" if route == "wgmma" else "sae_fused_bwd_remat_tf32"
        out = _tc_backward("sae_fused_backward", entry, route, x, S,
                           (x, We, be, Wd, bd, dy, dl1), hc_scratch=True)
    else:
        out = _backward_launch("sae_fused_backward", _RELU_REMAT, x, Wd, bd, dy, dl1,
                               We=We, be=be)
    sae_fused_backward.launches += 1
    sae_fused_backward.routes[route] += 1
    return out


sae_fused_backward.launches = 0
sae_fused_backward.routes = dict.fromkeys(SAE_GEMM_ROUTES, 0)


def sae_fused_backward_stored(x, hc, Wd, bd, dy, dl1):
    """Kernel B6, the VJP from the forward's stored ``hc`` ``[L, B, d_sae]``:
    the same outputs as :func:`sae_fused_backward`.  CUDA tensors launch
    ``csrc/sae_fused_tc.cu`` (the "wgmma" route of :func:`sae_gemm_route`),
    ``csrc/sae_fused_tf32.cu`` ("tf32x3") or ``csrc/sae_fused_bwd.cu`` and
    add one to ``sae_fused_backward_stored.launches`` and to the route's
    count in ``sae_fused_backward_stored.routes``; a launch that fails
    raises.  CPU tensors run the plain version."""
    L, B, D = x.shape
    S = hc.shape[-1]
    if tuple(hc.shape) != (L, B, S) or tuple(Wd.shape) != (L, S, D):
        raise ValueError(f"sae_fused_backward_stored: hc {tuple(hc.shape)}, W_dec "
                         f"{tuple(Wd.shape)} do not match x {tuple(x.shape)}")
    _check("sae_fused_backward_stored", x.dtype, x.device, x=x, hc=hc, W_dec=Wd, b_dec=bd,
           dy=dy, dl1=dl1)
    if x.device.type == "cpu":
        return sae_fused_backward_stored_reference(x, hc, Wd, bd, dy, dl1)
    _kernel_shapes_ok("sae_fused_backward_stored", B, D, S)
    route = sae_gemm_route(B, D, S, x.dtype)
    if route in ("wgmma", "tf32x3"):
        entry = "sae_fused_bwd_stored_tc" if route == "wgmma" else "sae_fused_bwd_stored_tf32"
        out = _tc_backward("sae_fused_backward_stored", entry, route, x, S,
                           (x, hc, Wd, bd, dy, dl1), hc_scratch=False)
    else:
        out = _backward_launch("sae_fused_backward_stored", _STORED, x, Wd, bd, dy, dl1, hc=hc)
    sae_fused_backward_stored.launches += 1
    sae_fused_backward_stored.routes[route] += 1
    return out


sae_fused_backward_stored.launches = 0
sae_fused_backward_stored.routes = dict.fromkeys(SAE_GEMM_ROUTES, 0)


def sae_fused_forward_topk(x, We, be, Wd, bd, k: int, save_h: bool = False):
    """Kernel B8: ``(y, l1, nact, t)`` (plus the masked ``h`` with
    ``save_h``) for the stacked TopK SAEs; y and h in x's dtype, l1 ``[L]``,
    nact ``[L, d_sae]`` and the per-row thresholds t ``[L, B, 1]`` float32.
    CUDA tensors launch ``csrc/sae_fused_tc.cu`` (the "wgmma" route of
    :func:`sae_gemm_route`) or ``csrc/sae_fused_tf32.cu`` ("tf32x3"), both
    B10's radix select on the rows of ``c(max(hpre, 0))``, or
    ``csrc/sae_fused_fwd_topk.cu`` and add one to
    ``sae_fused_forward_topk.launches`` and to the route's count in
    ``sae_fused_forward_topk.routes``; a launch that fails raises.  CPU
    tensors run the plain version."""
    L, B, D, S = _shapes(x, We, Wd)
    _check("sae_fused_forward_topk", x.dtype, x.device, x=x, W_enc=We, b_enc=be, W_dec=Wd,
           b_dec=bd)
    if not 1 <= k <= S:
        raise ValueError(f"sae_fused_forward_topk: k={k} outside [1, d_sae={S}]")
    if x.device.type == "cpu":
        return sae_fused_forward_topk_reference(x, We, be, Wd, bd, k, save_h)
    _kernel_shapes_ok("sae_fused_forward_topk", B, D, S)
    route = sae_gemm_route(B, D, S, x.dtype, "topk")
    new = lambda *shape, dtype=x.dtype: torch.empty(shape, dtype=dtype, device=x.device)
    xc, h, y = new(L, B, D), new(L, B, S), new(L, B, D)
    t = new(L, B, 1, dtype=torch.float32)
    # per-tile partials of the counts pass: nact per 128-row block, l1 per
    # 128 x 128 tile (on every route)
    nact_part = new(L, B // _TILE, S, dtype=torch.float32)
    l1_part = new(L, B // _TILE, S // _TILE, dtype=torch.float32)
    lib, stream = _lib_and_stream(x.device)
    ptrs = (x.data_ptr(), We.data_ptr(), be.data_ptr(), Wd.data_ptr(), bd.data_ptr(),
            xc.data_ptr(), h.data_ptr(), y.data_ptr(), t.data_ptr(), nact_part.data_ptr(),
            l1_part.data_ptr())
    if route == "wgmma":
        rc = lib.sae_fused_fwd_topk_tc(*ptrs, L, B, D, S, k, x.device.index, stream)
    elif route == "tf32x3":
        split = new(_tf32_scratch_floats(False, L, B, D, S), dtype=torch.float32)
        rc = lib.sae_fused_fwd_topk_tf32(*ptrs, split.data_ptr(), L, B, D, S, k,
                                         x.device.index, stream)
    else:
        rc = lib.sae_fused_fwd_topk(*ptrs, L, B, D, S, k, _DTYPE_CODES[x.dtype],
                                    x.device.index, stream)
    _build.check(lib, rc, f"sae_fused_forward_topk ({route})")
    sae_fused_forward_topk.launches += 1
    sae_fused_forward_topk.routes[route] += 1
    out = (y, l1_part.sum(dim=(1, 2)), nact_part.sum(dim=1), t)
    return out + (h,) if save_h else out


sae_fused_forward_topk.launches = 0
sae_fused_forward_topk.routes = dict.fromkeys(SAE_GEMM_ROUTES, 0)


def sae_fused_backward_topk(x, We, be, Wd, bd, dy, dl1, t):
    """Kernel B9, the TopK remat VJP from B8's thresholds ``t`` ``[L, B, 1]``
    float32: the same outputs as :func:`sae_fused_backward`.  CUDA tensors
    launch ``csrc/sae_fused_tc.cu`` (the "wgmma" route of
    :func:`sae_gemm_route`) or ``csrc/sae_fused_tf32.cu`` ("tf32x3"), both
    B8's: B8's encoder mode masked against t, then B6's launches, or
    ``csrc/sae_fused_bwd.cu`` (its TopK mask mode) and add one to
    ``sae_fused_backward_topk.launches`` and to the route's count in
    ``sae_fused_backward_topk.routes``; a launch that fails raises.
    CPU tensors run the plain version."""
    L, B, D, S = _shapes(x, We, Wd)
    _check("sae_fused_backward_topk", x.dtype, x.device, x=x, W_enc=We, b_enc=be, W_dec=Wd,
           b_dec=bd, dy=dy, dl1=dl1)
    if tuple(t.shape) != (L, B, 1) or t.dtype != torch.float32 or t.device != x.device:
        raise ValueError(f"sae_fused_backward_topk: t is {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}, expected float32 {(L, B, 1)} on {x.device}")
    if x.device.type == "cpu":
        return sae_fused_backward_topk_reference(x, We, be, Wd, bd, dy, dl1, t)
    _kernel_shapes_ok("sae_fused_backward_topk", B, D, S)
    route = sae_gemm_route(B, D, S, x.dtype, "topk")
    if route in ("wgmma", "tf32x3"):
        entry = "sae_fused_bwd_topk_tc" if route == "wgmma" else "sae_fused_bwd_topk_tf32"
        out = _tc_backward("sae_fused_backward_topk", entry, route, x, S,
                           (x, We, be, Wd, bd, dy, dl1, t.contiguous()), hc_scratch=True)
    else:
        out = _backward_launch("sae_fused_backward_topk", _TOPK_REMAT, x, Wd, bd, dy, dl1,
                               We=We, be=be, t=t.contiguous())
    sae_fused_backward_topk.launches += 1
    sae_fused_backward_topk.routes[route] += 1
    return out


sae_fused_backward_topk.launches = 0
sae_fused_backward_topk.routes = dict.fromkeys(SAE_GEMM_ROUTES, 0)


def _gated_check(name, x, We, bg, rmag, bm, Wd, bd, **more):
    L, B, D, S = _shapes(x, We, Wd)
    for k, v in (("b_gate", bg), ("r_mag", rmag), ("b_mag", bm)):
        if tuple(v.shape) != (L, S):
            raise ValueError(f"{name}: {k} is {tuple(v.shape)}, expected {(L, S)}")
    _check(name, x.dtype, x.device, x=x, W_enc=We, b_gate=bg, r_mag=rmag, b_mag=bm,
           W_dec=Wd, b_dec=bd, **more)
    return L, B, D, S


def sae_gated_fused_forward(x, We, bg, rmag, bm, Wd, bd, save_h: bool = False):
    """Kernel B11: ``(y, via, l1, nact)`` for the stacked gated SAEs; y and
    via ``[L, B, d_in]`` in x's dtype, l1 ``[L]`` and nact ``[L, d_sae]``
    float32; with ``save_h`` also the activations h and hga in x's dtype
    ``[L, B, d_sae]``, which hold the kernel's masks (for checks: the
    backward recomputes them).  CUDA tensors launch ``csrc/sae_fused_tc.cu``
    (the "wgmma" route of :func:`sae_gemm_route`), ``csrc/sae_fused_tf32.cu``
    ("tf32x3") or ``csrc/sae_fused_fwd_gated.cu`` and add one to
    ``sae_gated_fused_forward.launches`` and to the route's count in
    ``sae_gated_fused_forward.routes``; a launch that fails raises.  CPU
    tensors run the plain version."""
    L, B, D, S = _gated_check("sae_gated_fused_forward", x, We, bg, rmag, bm, Wd, bd)
    if x.device.type == "cpu":
        return sae_gated_fused_forward_reference(x, We, bg, rmag, bm, Wd, bd, save_h)
    _kernel_shapes_ok("sae_gated_fused_forward", B, D, S)
    route = sae_gemm_route(B, D, S, x.dtype, "gated")
    e, wdn = _gated_hoisted_card(rmag, Wd)
    new = lambda *shape, dtype=x.dtype: torch.empty(shape, dtype=dtype, device=x.device)
    # each layer's h and hga rows stacked, so are y and via: one decoder launch
    xc, h, y = new(L, B, D), new(L, 2 * B, S), new(L, 2 * B, D)
    nact_part = new(L, B // _TILE, S, dtype=torch.float32)
    l1_part = new(L, B // _TILE, S // (_TC_BN if route == "wgmma" else _TILE),
                  dtype=torch.float32)
    lib, stream = _lib_and_stream(x.device)
    ptrs = (x.data_ptr(), We.data_ptr(), bg.data_ptr(), e.data_ptr(), bm.data_ptr(),
            Wd.data_ptr(), bd.data_ptr(), wdn.data_ptr(), xc.data_ptr(), h.data_ptr(),
            y.data_ptr(), nact_part.data_ptr(), l1_part.data_ptr())
    if route == "wgmma":
        rc = lib.sae_gated_fwd_tc(*ptrs, L, B, D, S, x.device.index, stream)
    elif route == "tf32x3":
        split = new(_tf32_scratch_floats(False, L, B, D, S, "gated"), dtype=torch.float32)
        rc = lib.sae_gated_fwd_tf32(*ptrs, split.data_ptr(), L, B, D, S, x.device.index, stream)
    else:
        rc = lib.sae_fused_fwd_gated(*ptrs, L, B, D, S, _DTYPE_CODES[x.dtype], x.device.index,
                                     stream)
    _build.check(lib, rc, f"sae_gated_fused_forward ({route})")
    sae_gated_fused_forward.launches += 1
    sae_gated_fused_forward.routes[route] += 1
    out = (y[:, :B], y[:, B:], l1_part.sum(dim=(1, 2)), nact_part.sum(dim=1))
    return out + (h[:, :B], h[:, B:]) if save_h else out


sae_gated_fused_forward.launches = 0
sae_gated_fused_forward.routes = dict.fromkeys(SAE_GEMM_ROUTES, 0)


def sae_gated_fused_backward(x, We, bg, rmag, bm, Wd, bd, dy, dvia, dl1):
    """Kernel B12, the gated remat VJP from ``dy`` and ``dvia`` (x's dtype)
    and ``dl1`` (float32 ``[L]``): float32 ``(dW_enc [L, d_in, d_sae],
    dW_dec [L, d_sae, d_in], db_gate, db_mag, dr_mag [L, d_sae])``.  CUDA
    tensors launch ``csrc/sae_fused_tc.cu`` (the "wgmma" route of
    :func:`sae_gemm_route`, B11's), ``csrc/sae_fused_tf32.cu`` ("tf32x3",
    B11's) or ``csrc/sae_fused_bwd_gated.cu`` and add one to
    ``sae_gated_fused_backward.launches`` and to the route's count in
    ``sae_gated_fused_backward.routes``; a launch that fails raises.  CPU
    tensors run the plain version."""
    L, B, D, S = _gated_check("sae_gated_fused_backward", x, We, bg, rmag, bm, Wd, bd,
                              dy=dy, dvia=dvia, dl1=dl1)
    if x.device.type == "cpu":
        return sae_gated_fused_backward_reference(x, We, bg, rmag, bm, Wd, bd, dy, dvia, dl1)
    _kernel_shapes_ok("sae_gated_fused_backward", B, D, S)
    route = sae_gemm_route(B, D, S, x.dtype, "gated")
    e, wdn = _gated_hoisted_card(rmag, Wd)
    new = lambda *shape, dtype=x.dtype: torch.empty(shape, dtype=dtype, device=x.device)
    xc, dgc = new(L, B, D), new(L, B, S)
    part = new(4, L, B // _TILE, S, dtype=torch.float32)
    sums = new(4, L, S, dtype=torch.float32)
    dWe, dWd = new(L, D, S, dtype=torch.float32), new(L, S, D, dtype=torch.float32)
    lib, stream = _lib_and_stream(x.device)
    ins = (x.data_ptr(), We.data_ptr(), bg.data_ptr(), e.data_ptr(), bm.data_ptr(),
           Wd.data_ptr(), bd.data_ptr(), wdn.data_ptr(), dy.data_ptr(), dvia.data_ptr(),
           dl1.data_ptr(), xc.data_ptr())
    outs = (dgc.data_ptr(), part.data_ptr(), sums.data_ptr(), dWe.data_ptr(), dWd.data_ptr())
    if route in ("wgmma", "tf32x3"):
        # c(h) and c(hga) stacked as B11 writes them, and the float32 g
        h, g = new(L, 2 * B, S), new(L, B, S, dtype=torch.float32)
        if route == "wgmma":
            rc = lib.sae_gated_bwd_tc(*ins, h.data_ptr(), g.data_ptr(), *outs, L, B, D, S,
                                      x.device.index, stream)
        else:
            split = new(_tf32_scratch_floats(True, L, B, D, S, "gated"), dtype=torch.float32)
            rc = lib.sae_gated_bwd_tf32(*ins, h.data_ptr(), g.data_ptr(), *outs,
                                        split.data_ptr(), L, B, D, S, x.device.index, stream)
    else:
        hc, hgac = new(L, B, S), new(L, B, S)
        rc = lib.sae_fused_bwd_gated(*ins, hc.data_ptr(), hgac.data_ptr(), *outs, L, B, D, S,
                                     _DTYPE_CODES[x.dtype], x.device.index, stream)
    _build.check(lib, rc, f"sae_gated_fused_backward ({route})")
    sae_gated_fused_backward.launches += 1
    sae_gated_fused_backward.routes[route] += 1
    # sums: colsum(max(hg, 0)) (read by the kernel), db_gate, db_mag, sum(dhm g)
    return dWe, dWd, sums[1], sums[2], sums[3] * e


sae_gated_fused_backward.launches = 0
sae_gated_fused_backward.routes = dict.fromkeys(SAE_GEMM_ROUTES, 0)


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------

class SAEFusedApply(torch.autograd.Function):
    """``(y, l1, nact)`` with the fused VJP (JAX: ``_make_relu_apply``)."""

    @staticmethod
    def forward(ctx, x, We, be, Wd, bd, save_acts: bool):
        if save_acts:
            y, l1, nact, hc = sae_fused_forward(x, We, be, Wd, bd, save_h=True)
            ctx.save_for_backward(x, We, be, Wd, bd, hc)
        else:
            y, l1, nact = sae_fused_forward(x, We, be, Wd, bd)
            ctx.save_for_backward(x, We, be, Wd, bd, None)
        ctx.save_acts = save_acts
        ctx.mark_non_differentiable(nact)
        return y, l1, nact

    @staticmethod
    def backward(ctx, dy, dl1, _):
        x, We, be, Wd, bd, saved = ctx.saved_tensors
        dy, dl1 = _cotangents(x, dy, dl1)
        if ctx.save_acts:
            dWe, dWd, dbe = sae_fused_backward_stored(x, saved, Wd, bd, dy, dl1)
        else:
            dWe, dWd, dbe = sae_fused_backward(x, We, be, Wd, bd, dy, dl1)
        return (None,) + _param_grads(We, be, Wd, bd, dy, dWe, dWd, dbe) + (None,)


def _cotangents(x, dy, dl1):
    """dy in x's dtype and dl1 float32, zeros where autograd passed None."""
    dy = (torch.zeros_like(x) if dy is None else dy.to(x.dtype)).contiguous()
    dl1 = (torch.zeros(x.shape[0], dtype=torch.float32, device=x.device) if dl1 is None
           else dl1.float().contiguous())
    return dy, dl1


def _param_grads(We, be, Wd, bd, dy, dWe, dWd, dbe):
    """The kernels' float32 grads and db_dec, cast to the params' dtypes.
    b_dec enters twice: sae_in = x - b_dec (encode) and y = h W_dec + b_dec
    (decode), so db_dec = sum_B dy - W_enc db_enc."""
    dbd = dy.sum(dim=1, dtype=torch.float32) - torch.matmul(
        We.float(), dbe.to(We.dtype).float()[..., None])[..., 0]
    return dWe.to(We.dtype), dbe.to(be.dtype), dWd.to(Wd.dtype), dbd.to(bd.dtype)


def sae_fused_apply(x, We, be, Wd, bd, *, save_acts=None):
    """Standard-ReLU SAE forward over ``L`` stacked SAEs through kernels B4
    and B5 or B6.  Returns ``(y, l1, nact)``: y ``[L, B, d_in]`` in x's
    dtype, l1 ``[L]`` float32 (differentiable; its cotangent adds to dh on
    the active set) and nact ``[L, d_sae]`` float32 (not differentiable).

    The gradient for ``x`` is zero, so ``x`` must not require grad: the
    function serves only the train step.  ``save_acts`` picks the VJP:
    ``False`` recomputes hc (B5); ``True`` and ``None`` keep hc from the
    forward (B6).

    The JAX package stores hc only under a byte cap (2 GiB, from a TPU v5e
    measurement).  This port has none: B4 writes hc to device memory
    whether it is kept or not, and B5 writes it again, so keeping it costs
    no peak memory and saves B5's encoder product.  Measured through this
    function on an NVIDIA H100 80GB HBM3 (700 W) at the sweep shape (24 x
    4096 rows, 1024 -> 8192), forward and backward: kept 35.4 ms against
    recomputed 42.4 ms in bfloat16, 220.1 against 253.1 ms in float32, with
    the same peak memory either way (5.26 and 8.89 GB above the inputs)."""
    if x.requires_grad:
        raise ValueError("sae_fused_apply returns a zero gradient for x; it serves the "
                         "train step only, and x must not require grad")
    return SAEFusedApply.apply(x.contiguous(), We.contiguous(), be.contiguous(),
                               Wd.contiguous(), bd.contiguous(), save_acts is not False)


class SAEFusedApplyTopK(torch.autograd.Function):
    """``(y, l1, nact)`` of the TopK SAEs with the fused VJP (JAX:
    ``_make_topk_apply``): B6 on B8's masked h when it is kept, else B9
    from B8's thresholds."""

    @staticmethod
    def forward(ctx, x, We, be, Wd, bd, k: int, save_acts: bool):
        if save_acts:
            y, l1, nact, _, h = sae_fused_forward_topk(x, We, be, Wd, bd, k, save_h=True)
            ctx.save_for_backward(x, We, be, Wd, bd, h)
        else:
            y, l1, nact, t = sae_fused_forward_topk(x, We, be, Wd, bd, k)
            ctx.save_for_backward(x, We, be, Wd, bd, t)
        ctx.save_acts = save_acts
        ctx.mark_non_differentiable(nact)
        return y, l1, nact

    @staticmethod
    def backward(ctx, dy, dl1, _):
        x, We, be, Wd, bd, saved = ctx.saved_tensors
        dy, dl1 = _cotangents(x, dy, dl1)
        if ctx.save_acts:
            # B8's h is positive exactly on the active set: B6's mask
            dWe, dWd, dbe = sae_fused_backward_stored(x, saved, Wd, bd, dy, dl1)
        else:
            dWe, dWd, dbe = sae_fused_backward_topk(x, We, be, Wd, bd, dy, dl1, saved)
        return (None,) + _param_grads(We, be, Wd, bd, dy, dWe, dWd, dbe) + (None, None)


def sae_fused_apply_topk(x, We, be, Wd, bd, *, k: int, save_acts=None):
    """TopK SAE forward over ``L`` stacked SAEs through kernel B8 and B6 or
    B9; the same contract as :func:`sae_fused_apply`, with ``l1`` the sum
    of the kept (non-negative) activations.  ``save_acts``: ``False``
    recomputes the masked h from the saved thresholds (B9); ``True`` and
    ``None`` keep B8's masked h (B6).  The JAX package keeps h only under a
    TPU byte cap; here B8 writes h to device memory whether it is kept or
    not, and B9 writes it again, so keeping it costs no peak memory and
    saves B9's encoder product (measured in ``PERF.md``)."""
    if x.requires_grad:
        raise ValueError("sae_fused_apply_topk returns a zero gradient for x; it serves "
                         "the train step only, and x must not require grad")
    return SAEFusedApplyTopK.apply(x.contiguous(), We.contiguous(), be.contiguous(),
                                   Wd.contiguous(), bd.contiguous(), int(k),
                                   save_acts is not False)


class SAEGatedFusedApply(torch.autograd.Function):
    """``(y, via, l1, nact)`` of the gated SAEs with the fused remat VJP
    (JAX: ``sae_gated_fused_apply``'s ``custom_vjp``): B11 forward, B12
    backward."""

    @staticmethod
    def forward(ctx, x, We, bg, rmag, bm, Wd, bd):
        y, via, l1, nact = sae_gated_fused_forward(x, We, bg, rmag, bm, Wd, bd)
        ctx.save_for_backward(x, We, bg, rmag, bm, Wd, bd)
        ctx.mark_non_differentiable(nact)
        return y, via, l1, nact

    @staticmethod
    def backward(ctx, dy, dvia, dl1, _):
        x, We, bg, rmag, bm, Wd, bd = ctx.saved_tensors
        dy, dl1 = _cotangents(x, dy, dl1)
        dvia = _cotangents(x, dvia, dl1)[0]
        dWe, dWd, dbg, dbm, drm = sae_gated_fused_backward(x, We, bg, rmag, bm, Wd, bd,
                                                           dy, dvia, dl1)
        # b_dec enters y and via additively and the encoder input x - b_dec:
        # db_dec = sum dy + sum dvia - W_enc (sum over rows of dg), with
        # sum dg = db_gate + e db_mag, cast to W_enc's dtype first
        dsum_g = (dbg + torch.exp(rmag.float()) * dbm).to(We.dtype)
        dbd = (dy.sum(dim=1, dtype=torch.float32) + dvia.sum(dim=1, dtype=torch.float32)
               - torch.matmul(We.float(), dsum_g.float()[..., None])[..., 0])
        return (None, dWe.to(We.dtype), dbg.to(bg.dtype), drm.to(rmag.dtype),
                dbm.to(bm.dtype), dWd.to(Wd.dtype), dbd.to(bd.dtype))


def sae_gated_fused_apply(x, We, bg, rmag, bm, Wd, bd):
    """Gated-SAE forward over ``L`` stacked SAEs through kernels B11 and
    B12.  Returns ``(y, via, l1, nact)``: the reconstruction and the
    gate-path reconstruction ``max(hg, 0) W_dec + b_dec`` (for the aux loss)
    ``[L, B, d_in]`` in x's dtype, the decoder-norm-weighted gate L1
    ``sum(max(hg, 0) wdn)`` ``[L]`` float32 (differentiable, its W_dec-norm
    term included) and the counts of rows with h > 0 ``[L, d_sae]`` float32
    (not differentiable).  The gradient for ``x`` is zero, so ``x`` must not
    require grad: the function serves only the train step.  The backward
    recomputes the activations (the JAX package's gated VJP keeps nothing
    either)."""
    if x.requires_grad:
        raise ValueError("sae_gated_fused_apply returns a zero gradient for x; it serves "
                         "the train step only, and x must not require grad")
    return SAEGatedFusedApply.apply(*(t.contiguous() for t in (x, We, bg, rmag, bm, Wd, bd)))
