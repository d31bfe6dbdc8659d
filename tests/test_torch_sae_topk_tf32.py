"""The float32 route of B8 and B9 (``csrc/sae_fused_tf32.cu``'s TopK encoder
and remat encoder modes of ``sae_tf32_kernel``, B10's radix select and the
counts pass between them, B6's float32 launches after B9's recompute) on the
CPU: the route map, the wrappers' dispatch to ``sae_fused_fwd_topk_tf32`` and
``sae_fused_bwd_topk_tf32`` on a stand-in library, and the arithmetic,
emulated as tests/test_torch_sae_tf32.py emulates B4-B6 (each product as three
TF32 products, each 32-deep stage in the split copy's K order summed from zero
and added to the float32 total).  The emulated B8 and B9 are held to their
plain versions within the float32 tolerance (1e-5: ``chip_smoke.py``'s SAE_REL
and SAE_GRAD_REL) up to counted mask flips (TOPK_FLIP_FRAC and
TOPK_FLIP_ROW_FRAC), the plain versions to JAX's ``_fused_forward_topk`` and
``_fused_backward_topk`` (Pallas in interpret mode); one TF32 product (the
control) misses that tolerance.  t is the bitwise search on the emulated h,
h holds +0 and never -0, and B9 from t gives B6's grads on B8's h to the
bit.  The CUDA kernels are held to the plain versions on the card by
``chip_smoke.py``'s ``topk_kernels`` phase."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_sae_tf32 import (SHAPES, TOL, _encoder, _inputs, _product, _torch,
                                       emulated_backward_stored)
from vit_prisma_tpu.ops.sae_step import _fused_backward_topk as jax_backward_topk
from vit_prisma_tpu.ops.sae_step import _fused_forward_topk as jax_forward_topk
from vit_prisma_tpu_torch.ops import sae_step
from vit_prisma_tpu_torch.ops.topk import kth_value

K = 16
FLIP_FRAC, FLIP_ROW_FRAC = 1e-4, 1e-2  # chip_smoke.py's TOPK_FLIP_FRAC, TOPK_FLIP_ROW_FRAC


# ---------------------------------------------------------------------------
# Routes and dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,D,S", [(4096, 768, 12288), (4096, 1024, 8192), (4096, 384, 6144),
                                   (256, 128, 512)])
def test_float32_topk_takes_tf32x3_and_gated_keeps_ffma(B, D, S):
    """float32 B8 and B9 take 3xTF32 at every shape the picker takes, as
    the gated family does since its FFMA tiles went, and bf16 TopK is
    unchanged."""
    r = lambda dtype, fam: sae_step.sae_gemm_route(B, D, S, dtype, fam)
    assert r(torch.float32, "topk") == "tf32x3"
    assert r(torch.float32, "gated") == "tf32x3"
    assert r(torch.bfloat16, "topk") == ("wgmma" if D % 256 == 0 and S % 256 == 0
                                         else "mma_sync")
    routes = sae_step.sae_kernel_routes(B, D, S, torch.float32)
    assert routes["sae_fused_forward_topk"] == routes["sae_fused_backward_topk"] == "tf32x3"


class _Lib:
    """Stands in for the kernel library: records each SAE entry point's call
    and returns ``rc``."""

    def __init__(self, rc=0):
        self.rc, self.calls = rc, []

    def __getattr__(self, name):
        if name.startswith("sae_fused"):
            return lambda *args: self.calls.append((name, args)) or self.rc
        raise AttributeError(name)

    @staticmethod
    def vpt_cuda_error_string(rc):
        return b"stand-in error"


def _meta(L, B, D, S):
    """float32 x, W_enc, b_enc, W_dec, b_dec, dy, dl1 and t on the meta device."""
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device="meta")
    return (new(L, B, D), new(L, D, S), new(L, S), new(L, S, D), new(L, D), new(L, B, D),
            new(L), new(L, B, 1))


def _call(which, args):
    x, We, be, Wd, bd, dy, dl1, t = args
    if which == "forward":
        return sae_step.sae_fused_forward_topk(x, We, be, Wd, bd, K, save_h=True)
    return sae_step.sae_fused_backward_topk(x, We, be, Wd, bd, dy, dl1, t)


# per wrapper: its float32 entry point and the pointers before (L, B, D, S):
# B8's eleven and the split copies'; B9's x, the weights, dy, dl1, t, then
# xc, h, dhc, the split copies', dW_enc, dW_dec and the db_enc partials
ENTRIES = {"forward": ("sae_fused_fwd_topk_tf32", 12),
           "backward": ("sae_fused_bwd_topk_tf32", 15)}


@pytest.mark.parametrize("which", list(ENTRIES))
def test_float32_dispatch_reaches_the_tf32_entries(monkeypatch, which):
    """float32 B8 and B9 each make one call, of their tf32 entry point, with
    the shape (and k), counted once on "tf32x3"; the outputs have their
    shapes."""
    L, B, D, S = 2, 256, 128, 512
    lib = _Lib()
    monkeypatch.setattr(sae_step, "_lib_and_stream", lambda device: (lib, 0))
    fn = getattr(sae_step, f"sae_fused_{which}_topk")
    launches, routes = fn.launches, dict(fn.routes)
    out = _call(which, _meta(L, B, D, S))
    (name, args), = lib.calls
    entry, n_ptrs = ENTRIES[which]
    assert name == entry and len(args) == n_ptrs + (7 if which == "forward" else 6)
    assert args[n_ptrs:n_ptrs + 4] == (L, B, D, S)
    if which == "forward":
        assert args[n_ptrs + 4] == K
        y, l1, nact, t, h = out
        assert [tuple(v.shape) for v in out] == [(L, B, D), (L,), (L, S), (L, B, 1), (L, B, S)]
    else:
        assert [tuple(g.shape) for g in out] == [(L, D, S), (L, S, D), (L, S)]
    assert fn.launches == launches + 1
    routes["tf32x3"] += 1
    assert fn.routes == routes


@pytest.mark.parametrize("which", list(ENTRIES))
def test_float32_failed_launch_raises_without_fallback(monkeypatch, which):
    """A tf32 entry that returns a CUDA error raises; no FFMA tile nor plain
    version is tried and nothing is counted."""
    lib = _Lib(rc=1)
    monkeypatch.setattr(sae_step, "_lib_and_stream", lambda device: (lib, 0))
    fn = getattr(sae_step, f"sae_fused_{which}_topk")
    launches, routes = fn.launches, dict(fn.routes)
    with pytest.raises(RuntimeError, match=r"\(tf32x3\): CUDA error 1 \(stand-in error\)"):
        _call(which, _meta(1, 256, 128, 512))
    assert [name for name, _ in lib.calls] == [ENTRIES[which][0]]
    assert fn.launches == launches and fn.routes == routes


# ---------------------------------------------------------------------------
# The arithmetic, emulated
# ---------------------------------------------------------------------------

def _select(r, k):
    """B10's plain version on each row of r [..., S]: t [..., 1]."""
    return kth_value(r.reshape(-1, r.shape[-1]), k).reshape(r.shape[:-1] + (1,))


def emulated_forward_topk(x, We, be, Wd, bd, k, x3=True):
    """B8 as the float32 route forms it: (y, l1, nact, t, h).  The TopK
    encoder stores max(hpre, 0) (+0 where hpre <= 0); the select takes each
    row's k-th largest t (B10's plain version) and masks the row in place;
    the counts and the decoder read the masked h."""
    hpre = _encoder(x, We, be, bd, x3)
    r = torch.where(hpre > 0, hpre, 0.0)
    t = _select(r, k)
    h = torch.where((r > 0) & (r >= t), r, 0.0)
    y = bd[:, None] + _product(h, Wd, "k", x3)
    return y, h.sum(dim=(1, 2)), (h > 0).sum(dim=1, dtype=torch.float32), t, h


def emulated_remat_h(x, We, be, bd, t):
    """B9's remat encoder: B8's TopK encoder on the same tiles, masked
    against the stored t."""
    hpre = _encoder(x, We, be, bd)
    return torch.where((hpre > 0) & (hpre >= t), hpre, 0.0)


def _flips(h, active):
    flip = (h > 0) != active
    return flip, flip.any(dim=-1)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_b8_b9_emulated_within_tolerance_of_plain_and_plain_of_jax(shape):
    """The plain B8 against JAX's ``_fused_forward_topk`` (y within 1e-5 of
    max(1, absmax), l1 1e-5 relative, nact, t and h's support equal) and the
    plain B9 against ``_fused_backward_topk`` from JAX's t (grads within
    1e-5 of absmax); the emulated B8 against the plain B8 (flips within the
    smoke's bounds; y on the rows without one, l1 within the flipped values,
    nact within each feature's flips) and the emulated B9 from the emulated
    t against the plain B9 from the plain t (as ``chip_smoke.py`` holds
    them: each recomputes its forward's active set), outside the features
    whose mask flipped between the forwards."""
    L, B, D, S = SHAPES[shape]
    arrays = _inputs(L, B, D, S, seed=B + D + 1)
    x, We, be, Wd, bd, dy, dl1 = _torch(arrays)
    out_tol = lambda want: TOL * max(1.0, float(want.abs().max()))
    grad_tol = lambda want: TOL * float(want.abs().max())

    y, l1, nact, t, h = sae_step.sae_fused_forward_topk_reference(x, We, be, Wd, bd, K,
                                                                  save_h=True)
    jy, jl1, jn, jt, jh = (torch.from_numpy(np.array(a, np.float32)) for a in jax_forward_topk(
        *(jnp.asarray(a) for a in arrays[:5]), K, save_h=True))
    assert (y - jy).abs().max().item() <= out_tol(jy)
    np.testing.assert_allclose(l1.numpy(), jl1.numpy(), rtol=TOL)
    assert torch.equal(nact, jn) and torch.equal(t, jt) and torch.equal(h > 0, jh > 0)
    grads9 = sae_step.sae_fused_backward_topk_reference(x, We, be, Wd, bd, dy, dl1, jt)
    jgrads = jax_backward_topk(*(jnp.asarray(a) for a in arrays[:6]), jnp.asarray(arrays[6]),
                               jnp.asarray(jt.numpy()))
    for got, want in zip(grads9, (jgrads[0], jgrads[1], jgrads[2])):
        want = torch.from_numpy(np.array(want, np.float32))
        assert (got - want).abs().max().item() <= grad_tol(want)

    ey, el1, en, et, eh = emulated_forward_topk(x, We, be, Wd, bd, K)
    flip, flip_rows = _flips(eh, h > 0)
    assert flip.float().mean().item() <= FLIP_FRAC
    assert flip_rows.float().mean().item() <= FLIP_ROW_FRAC
    assert (ey - y).abs()[~flip_rows].max().item() <= out_tol(y)
    l1_bound = flip.sum(dim=(1, 2)).float() * h.abs().amax(dim=(1, 2)) + TOL * l1.abs()
    assert bool(((el1 - l1).abs() <= l1_bound).all())
    assert bool(((en - nact).abs() <= flip.sum(dim=1)).all())

    eh9 = emulated_remat_h(x, We, be, bd, et)
    got = emulated_backward_stored(x, eh9, Wd, bd, dy, dl1)
    want = sae_step.sae_fused_backward_topk_reference(x, We, be, Wd, bd, dy, dl1, t)
    clean = ~flip.any(dim=1)  # [L, S]
    for keep, a, b in zip((clean[:, None, :], clean[:, :, None], clean), got, want):
        assert ((a - b).abs() * keep).max().item() <= grad_tol(b)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_tf32_control_misses_the_tolerance(shape):
    """One TF32 product in place of three: the emulated B8's y misses 1e-5 of
    the plain y on the rows whose mask it keeps, or its flips exceed the
    smoke's bounds."""
    L, B, D, S = SHAPES[shape]
    x, We, be, Wd, bd, _, _ = _torch(_inputs(L, B, D, S, seed=B + D + 1))
    y, _, _, _, h = sae_step.sae_fused_forward_topk_reference(x, We, be, Wd, bd, K, save_h=True)
    ey, _, _, _, eh = emulated_forward_topk(x, We, be, Wd, bd, K, x3=False)
    flip, flip_rows = _flips(eh, h > 0)
    kept = ~flip_rows
    y_ratio = ((ey - y).abs()[kept].max().item() / (TOL * max(1.0, float(y.abs().max())))
               if kept.any() else np.inf)
    assert (y_ratio > 1.0 or flip.float().mean().item() > FLIP_FRAC
            or flip_rows.float().mean().item() > FLIP_ROW_FRAC), y_ratio


@pytest.mark.parametrize("k", [1, K, 64, 512])
def test_t_is_the_bitwise_search_on_the_emulated_h(k):
    """t from the select on the TopK encoder's rows is ``_row_threshold``'s
    bitwise search on the emulated pre-activations and on the masked h, to
    the bit; h holds +0 and never -0 (max(hpre, 0) where hpre is -0 or
    negative) and keeps at least min(k, positives) entries a row."""
    L, B, D, S = SHAPES["d_in_128"]
    x, We, be, Wd, bd, _, _ = _torch(_inputs(L, B, D, S, seed=31))
    *_, t, h = emulated_forward_topk(x, We, be, Wd, bd, k)
    hpre = _encoder(x, We, be, bd)
    bits = lambda v: v.view(torch.int32)
    assert torch.equal(bits(t), bits(sae_step._row_threshold(hpre, k)))
    assert torch.equal(bits(t), bits(sae_step._row_threshold(h, k)))
    assert not torch.signbit(h).any()
    kept = (h > 0).sum(dim=-1)
    assert bool((kept >= torch.minimum((hpre > 0).sum(dim=-1), torch.tensor(k))).all())
    # a row of signed zeros, and one with fewer than k positives
    rows = torch.tensor([[0.0, -0.0] * (S // 2), [-1.0] * (S - 3) + [2.0, 0.5, -0.0]])
    r = torch.where(rows > 0, rows, 0.0)
    assert not torch.signbit(r).any()
    assert torch.equal(bits(kth_value(r, k)), bits(sae_step._row_threshold(rows, k)))


def test_b9_from_t_is_b6_on_b8_h_to_the_bit():
    """B9's remat encoder runs B8's TopK encoder on the same tiles and masks
    it against B8's t, so its h is B8's to the bit, and B6's launches on it
    give B6's grads on B8's h, to the bit."""
    x, We, be, Wd, bd, dy, dl1 = _torch(_inputs(*SHAPES["d_in_256"], seed=32))
    *_, t, h8 = emulated_forward_topk(x, We, be, Wd, bd, K)
    h9 = emulated_remat_h(x, We, be, bd, t)
    assert torch.equal(h9.view(torch.int32), h8.view(torch.int32))
    for a, b in zip(emulated_backward_stored(x, h9, Wd, bd, dy, dl1),
                    emulated_backward_stored(x, h8, Wd, bd, dy, dl1)):
        assert torch.equal(a, b)


def test_rows_do_not_depend_on_the_batch():
    """A row's encoder sum, threshold and decoder sum depend on its own data
    alone: the first 128 rows alone give the whole call's y, t and h rows to
    the bit."""
    x, We, be, Wd, bd, _, _ = _torch(_inputs(*SHAPES["d_in_128"], seed=33))
    whole = emulated_forward_topk(x, We, be, Wd, bd, K)
    rows = emulated_forward_topk(x[:, :128], We, be, Wd, bd, K)
    for i in (0, 3, 4):
        assert torch.equal(rows[i], whole[i][:, :128])
