"""The float32 route of B11 and B12 (``csrc/sae_fused_tf32.cu``'s gated
encoder, gated remat encoder, dg and gated weight-gradient modes of
``sae_tf32_kernel``, the decoder over the 2B stacked rows) on the CPU: the
route map, the wrappers' dispatch to ``sae_gated_fwd_tf32`` and
``sae_gated_bwd_tf32`` on a stand-in library, the scratch, the layout of
the transposed [dy; dvia] split copy, and the arithmetic, emulated as
tests/test_torch_sae_tf32.py emulates B4-B6 (each product as three TF32
products, each 32-deep stage in the split copy's K order summed from zero
and added to the float32 total).  The emulated B11 and B12 are held to their
plain versions within the float32 tolerance (1e-5: ``chip_smoke.py``'s
SAE_REL and SAE_GRAD_REL) up to counted gate and magnitude flips
(GATED_FLIP_FRAC and TOPK_FLIP_ROW_FRAC), the plain versions to JAX's
``_fused_forward_gated`` and ``_fused_backward_gated`` (Pallas in interpret
mode); one TF32 product (the control) misses that tolerance.  B12's
recomputed h and hga, and the masks its dg passes read from them, are B11's
to the bit.  The CUDA kernels are held to the plain versions on the card by
``chip_smoke.py``'s ``gated_kernels`` phase."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_sae_gated_wgmma import _arrays
from tests.test_torch_sae_tf32 import STAGE, TOL, _product, k_mn
from vit_prisma_tpu.ops.sae_step import _fused_backward_gated as jax_backward
from vit_prisma_tpu.ops.sae_step import _fused_forward_gated as jax_forward
from vit_prisma_tpu_torch.ops import sae_step

FLIP_FRAC, FLIP_ROW_FRAC = 1e-4, 1e-2  # chip_smoke.py's GATED_FLIP_FRAC, TOPK_FLIP_ROW_FRAC
GRADS = ("dW_enc", "dW_dec", "db_gate", "db_mag", "dr_mag")
# name: (L, B, d_in, d_sae): d_in 128 (a multiple of 128, not of 256) and 256
SHAPES = {"d_in_128": (2, 256, 128, 512), "d_in_256": (2, 256, 256, 512)}


# ---------------------------------------------------------------------------
# Routes, dispatch, scratch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,D,S", [(4096, 768, 12288), (4096, 1024, 8192), (4096, 384, 6144),
                                   (256, 128, 512)])
def test_float32_gated_takes_tf32x3_and_bf16_is_unchanged(B, D, S):
    """float32 B11 and B12 take 3xTF32 at the gated slice, the sweep's widths,
    a ViT-S width and the narrowest tile; bf16 keeps the Hopper route where
    d_in and d_sae are multiples of 256, else the mma.sync tiles; the fused
    gated step's gate admits every such float32 shape."""
    routes = sae_step.sae_kernel_routes(B, D, S, torch.float32)
    assert routes["sae_gated_fused_forward"] == routes["sae_gated_fused_backward"] == "tf32x3"
    bf16 = sae_step.sae_kernel_routes(B, D, S, torch.bfloat16)
    want = "wgmma" if D % 256 == 0 and S % 256 == 0 else "mma_sync"
    assert bf16["sae_gated_fused_forward"] == bf16["sae_gated_fused_backward"] == want
    assert sae_step.fused_gated_step_eligible(B, D, S, 4)
    assert "ffma" not in sae_step.SAE_GEMM_ROUTES


def test_pinned_scratch():
    """B11 splits W_enc, then W_dec, in one place (2 S D a layer); B12 W_enc's
    and W_dec's copies, then x - b_dec's [2L, D, B] and [dy; dvia]'s [2L, D,
    2B] transposed copies (6 D B a layer) in the same place."""
    f = sae_step._tf32_scratch_floats
    assert f(False, 1, 4096, 768, 12288, "gated") == 2 * 12288 * 768
    assert f(True, 1, 4096, 768, 12288, "gated") == 2 * 12288 * 768 == 6 * 768 * 4096
    assert f(True, 2, 4096, 1024, 8192, "gated") == 2 * 6 * 1024 * 4096 > f(True, 2, 4096,
                                                                             1024, 8192)


class _Lib:
    """Stands in for the kernel library: records each SAE entry point's call
    and returns ``rc``."""

    def __init__(self, rc=0):
        self.rc, self.calls = rc, []

    def __getattr__(self, name):
        if name.startswith("sae_"):
            return lambda *args: self.calls.append((name, args)) or self.rc
        raise AttributeError(name)

    @staticmethod
    def vpt_cuda_error_string(rc):
        return b"stand-in error"


def _meta(L, B, D, S):
    """float32 x, W_enc, b_gate, r_mag, b_mag, W_dec, b_dec, dy, dvia and dl1
    on the meta device."""
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device="meta")
    return (new(L, B, D), new(L, D, S), new(L, S), new(L, S), new(L, S), new(L, S, D),
            new(L, D), new(L, B, D), new(L, B, D), new(L))


def _call(which, args):
    if which == "forward":
        return sae_step.sae_gated_fused_forward(*args[:7], save_h=True)
    return sae_step.sae_gated_fused_backward(*args)


# per wrapper: its float32 entry point and the pointers before (L, B, D, S):
# B11's thirteen and the split copies'; B12's x .. b_dec, wdn, dy, dvia, dl1,
# xc, h, g, dg, the partials, the sums, dW_enc, dW_dec and the split copies'
ENTRIES = {"forward": ("sae_gated_fwd_tf32", 14), "backward": ("sae_gated_bwd_tf32", 20)}


@pytest.mark.parametrize("which", list(ENTRIES))
def test_float32_dispatch_reaches_the_tf32_entries(monkeypatch, which):
    """float32 B11 and B12 each make one call, of their tf32 entry point,
    with the shape, counted once on "tf32x3"; the outputs have their shapes."""
    L, B, D, S = 2, 256, 128, 512
    lib = _Lib()
    monkeypatch.setattr(sae_step, "_lib_and_stream", lambda device: (lib, 0))
    fn = getattr(sae_step, f"sae_gated_fused_{which}")
    launches, routes = fn.launches, dict(fn.routes)
    out = _call(which, _meta(L, B, D, S))
    (name, args), = lib.calls
    entry, n_ptrs = ENTRIES[which]
    assert name == entry and len(args) == n_ptrs + 6
    assert args[n_ptrs:n_ptrs + 4] == (L, B, D, S)
    if which == "forward":
        assert [tuple(v.shape) for v in out] == [(L, B, D), (L, B, D), (L,), (L, S), (L, B, S),
                                                 (L, B, S)]
    else:
        assert [tuple(g.shape) for g in out] == [(L, D, S), (L, S, D), (L, S), (L, S), (L, S)]
    assert fn.launches == launches + 1
    routes["tf32x3"] += 1
    assert fn.routes == routes


@pytest.mark.parametrize("which", list(ENTRIES))
def test_float32_failed_launch_raises_without_fallback(monkeypatch, which):
    """A tf32 entry that returns a CUDA error raises; no other entry nor the
    plain version is tried and nothing is counted."""
    lib = _Lib(rc=1)
    monkeypatch.setattr(sae_step, "_lib_and_stream", lambda device: (lib, 0))
    fn = getattr(sae_step, f"sae_gated_fused_{which}")
    launches, routes = fn.launches, dict(fn.routes)
    with pytest.raises(RuntimeError, match=r"\(tf32x3\): CUDA error 1 \(stand-in error\)"):
        _call(which, _meta(1, 256, 128, 512))
    assert [name for name, _ in lib.calls] == [ENTRIES[which][0]]
    assert fn.launches == launches and fn.routes == routes


def _split_t(src, ldk, koff, out):
    """split_t_kernel<kOrderMn>'s writes of src [Z, K, N] into out [Z, N,
    ldk] at column offset koff: position koff + k0 + j of row n holds
    src[k0 + k_mn(j), n] (hi + lo, exactly, here)."""
    Z, K, N = src.shape
    order = torch.tensor([k_mn(j) for j in range(STAGE)])
    for k0 in range(0, K, STAGE):
        out[:, :, koff + k0:koff + k0 + STAGE] = src[:, k0 + order, :].transpose(1, 2)


def test_dy_dvia_split_copy_is_the_stacked_k_order():
    """B12 writes dy's and dvia's transposed copies side by side in rows of
    2B floats (dvia's at column B), so the gated weight-gradient launch reads
    [dy; dvia] over K = 2B in the weight gradients' k_mn order, every stage
    inside one of the two (B a multiple of 128)."""
    L, B, D = 2, 256, 128
    rng = np.random.default_rng(5)
    dy, dvia = (torch.from_numpy(rng.standard_normal((L, B, D), np.float32)) for _ in range(2))
    yt = torch.full((L, D, 2 * B), float("nan"))
    _split_t(dy, 2 * B, 0, yt)
    _split_t(dvia, 2 * B, B, yt)
    order = torch.tensor([k_mn(j) for j in range(STAGE)])
    stacked = torch.cat([dy, dvia], dim=1)  # [L, 2B, D]
    for k0 in range(0, 2 * B, STAGE):
        assert torch.equal(yt[:, :, k0:k0 + STAGE], stacked[:, k0 + order, :].transpose(1, 2))


# ---------------------------------------------------------------------------
# The arithmetic, emulated
# ---------------------------------------------------------------------------

def emulated_encoder(x, We, bg, rmag, bm, Wd, bd, x3=True):
    """B11's and B12's gated encoder: (g, h, hga) from g = xc W_enc (the
    encoder product in k_phys's order), hg = g + b_gate and hm = g e + b_mag,
    each rounded once."""
    e, _ = sae_step._gated_hoisted(rmag, Wd)
    g = _product(x - bd[:, None], We, "k", x3)
    hg = g + bg[:, None]
    hm = g * e[:, None] + bm[:, None]
    return g, torch.where((hg > 0) & (hm > 0), hm, 0.0), torch.where(hg > 0, hg, 0.0)


def emulated_forward(x, We, bg, rmag, bm, Wd, bd, x3=True):
    """B11 as the float32 route forms it: (y, via, l1, nact, h, hga), the
    decoder over the 2B stacked rows [h; hga]."""
    _, wdn = sae_step._gated_hoisted(rmag, Wd)
    _, h, hga = emulated_encoder(x, We, bg, rmag, bm, Wd, bd, x3)
    B = x.shape[1]
    yv = bd[:, None] + _product(torch.cat([h, hga], dim=1), Wd, "k", x3)
    return (yv[:, :B], yv[:, B:], (hga * wdn[:, None]).sum(dim=(1, 2)),
            (h > 0).sum(dim=1, dtype=torch.float32), h, hga)


def emulated_backward(x, We, bg, rmag, bm, Wd, bd, dy, dvia, dl1, x3=True):
    """B12 as the float32 route forms it: the remat encoder; dg's dy pass
    (dhm by h's mask, dhm e stored) and dvia pass (dhg by hga's mask, dg =
    dhg + dhm e); dW_enc^T = dg^T xc (K = B) and dW_dec = [h; hga]^T [dy;
    dvia] (K = 2B) + coef W_dec.  Returns the five grads and (h, hga)."""
    e, wdn = sae_step._gated_hoisted(rmag, Wd)
    g, h, hga = emulated_encoder(x, We, bg, rmag, bm, Wd, bd, x3)
    WdT = Wd.transpose(1, 2).contiguous()
    dhm = torch.where(h > 0, _product(dy, WdT, "k", x3), 0.0)
    dhg = torch.where(hga > 0, _product(dvia, WdT, "k", x3) + dl1[:, None, None] * wdn[:, None],
                      0.0)
    dg = dhg + dhm * e[:, None]
    dWe = _product(dg.transpose(1, 2), x - bd[:, None], "mn", x3).transpose(1, 2)
    coef = dl1[:, None] * hga.sum(dim=1) / wdn.clamp_min(1e-30)
    dWd = (_product(torch.cat([h, hga], dim=1).transpose(1, 2), torch.cat([dy, dvia], dim=1),
                    "mn", x3) + coef[..., None] * Wd)
    return (dWe, dWd, dhg.sum(dim=1), dhm.sum(dim=1), (dhm * g).sum(dim=1) * e), (h, hga)


def _torch(arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _flips(shape, seed):
    """The inputs, the plain forward's h and hga, the emulated forward, and
    the gate and magnitude flips between the two."""
    L, B, D, S = SHAPES[shape]
    arrays = _arrays(L, B, D, S, seed=seed)
    t = _torch(arrays)
    plain = sae_step.sae_gated_fused_forward_reference(*t[:7], save_h=True)
    emu = emulated_forward(*t[:7])
    gflip = (emu[5] > 0) != (plain[5] > 0)
    mflip = (emu[4] > 0) != (plain[4] > 0)
    return arrays, t, plain, emu, gflip, mflip


@pytest.mark.parametrize("shape", list(SHAPES))
def test_b11_emulated_within_tolerance_of_plain_and_plain_of_jax(shape):
    """The plain B11 against JAX's ``_fused_forward_gated`` (y and via within
    1e-5 of max(1, absmax), l1 1e-5 relative, nact equal); the emulated B11
    against the plain B11: flips within the smoke's bounds, y and via on the
    rows without one within 1e-5, l1 within 1e-5 plus the flipped gate
    entries' values, nact within each feature's magnitude flips and equal to
    its own mask's count."""
    arrays, t, plain, emu, gflip, mflip = _flips(shape, seed=3)
    y, via, l1, nact, h, hga = plain
    out_tol = lambda want: TOL * max(1.0, float(want.abs().max()))
    jy, jvia, jl1, jn = (torch.from_numpy(np.array(a, np.float32))
                         for a in jax_forward(*(jnp.asarray(a) for a in arrays[:7])))
    assert (y - jy).abs().max().item() <= out_tol(jy)
    assert (via - jvia).abs().max().item() <= out_tol(jvia)
    np.testing.assert_allclose(l1.numpy(), jl1.numpy(), rtol=TOL)
    assert torch.equal(nact, jn)

    ey, evia, el1, en, eh, ehga = emu
    flip = gflip | mflip
    rows = flip.any(dim=-1)
    assert flip.float().mean().item() <= FLIP_FRAC
    assert rows.float().mean().item() <= FLIP_ROW_FRAC
    assert (ey - y).abs()[~rows].max().item() <= out_tol(y)
    assert (evia - via).abs()[~rows].max().item() <= out_tol(via)
    wdn = sae_step._gated_hoisted(t[3], t[5])[1]
    l1_bound = (TOL * l1.abs() + gflip.sum(dim=(1, 2)) * hga.abs().amax(dim=(1, 2))
                * wdn.amax(dim=1))
    assert bool(((el1 - l1).abs() <= l1_bound).all())
    assert bool(((en - nact).abs() <= mflip.sum(dim=1)).all())
    assert torch.equal(en, (eh > 0).sum(dim=1, dtype=torch.float32))


@pytest.mark.parametrize("shape", list(SHAPES))
def test_b12_emulated_within_tolerance_of_plain_and_plain_of_jax(shape):
    """The plain B12 against JAX's ``_fused_backward_gated`` (grads within
    1e-5 of absmax, rtol 2e-4 beside it as tests/test_torch_sae_gated_wgmma.py
    holds the same pair); the emulated B12 against the plain B12 within 1e-5
    of absmax outside the features whose gate or magnitude mask flipped
    between the two forwards."""
    arrays, t, _, _, gflip, mflip = _flips(shape, seed=4)
    want = sae_step.sae_gated_fused_backward_reference(*t)
    jgrads = jax_backward(*(jnp.asarray(a) for a in arrays[:9]), jnp.asarray(arrays[9]))
    for name, got, j in zip(GRADS, want, jgrads):
        j = torch.from_numpy(np.array(j, np.float32))
        assert (got - j).abs().max().item() <= TOL * j.abs().max().item(), name
    got, _ = emulated_backward(*t)
    clean = ~(gflip | mflip).any(dim=1)  # [L, S]
    keep = {"dW_enc": clean[:, None, :], "dW_dec": clean[:, :, None]}
    for name, a, b in zip(GRADS, got, want):
        k = keep.get(name, clean)
        assert ((a - b).abs() * k).max().item() <= TOL * b.abs().max().item(), name


@pytest.mark.parametrize("shape", list(SHAPES))
def test_tf32_control_misses_the_tolerance(shape):
    """One TF32 product in place of three: the emulated B11's y or via misses
    1e-5 of the plain one on the rows whose masks agree, or its flips exceed
    the smoke's bounds."""
    L, B, D, S = SHAPES[shape]
    t = _torch(_arrays(L, B, D, S, seed=3))
    y, via, _, _, h, hga = sae_step.sae_gated_fused_forward_reference(*t[:7], save_h=True)
    ey, evia, _, _, eh, ehga = emulated_forward(*t[:7], x3=False)
    flip = ((eh > 0) != (h > 0)) | ((ehga > 0) != (hga > 0))
    kept = ~flip.any(dim=-1)
    ratio = max(((a - b).abs()[kept].max().item() / (TOL * max(1.0, float(b.abs().max()))))
                for a, b in ((ey, y), (evia, via))) if kept.any() else np.inf
    assert (ratio > 1.0 or flip.float().mean().item() > FLIP_FRAC
            or flip.any(dim=-1).float().mean().item() > FLIP_ROW_FRAC), ratio


def test_b12_recomputes_b11_acts_and_masks_to_the_bit():
    """B12's remat encoder is B11's encoder on the same tiles with another
    epilogue, so its h and hga are B11's to the bit; the masks its dg passes
    read (h > 0, hga > 0) are exactly the gate hg > 0 and the magnitude hg > 0
    and hm > 0 of the pre-activations, whatever their signs of zero."""
    t = _torch(_arrays(*SHAPES["d_in_256"], seed=6))
    _, _, _, _, h11, hga11 = emulated_forward(*t[:7])
    _, (h12, hga12) = emulated_backward(*t)
    bits = lambda v: v.view(torch.int32)
    assert torch.equal(bits(h12), bits(h11)) and torch.equal(bits(hga12), bits(hga11))
    g, _, _ = emulated_encoder(*t[:7])
    e = torch.exp(t[3])
    hg, hm = g + t[2][:, None], g * e[:, None] + t[4][:, None]
    assert torch.equal(hga11 > 0, hg > 0) and torch.equal(h11 > 0, (hg > 0) & (hm > 0))
    # zeros of either sign and both masks' edges, through the epilogue's rule
    pg = torch.tensor([0.0, -0.0, 1e-30, -1e-30, 2.0, 2.0, 2.0, -1.0])
    pm = torch.tensor([1.0, 1.0, 1.0, 1.0, 0.0, -0.0, 1e-30, 5.0])
    hv = torch.where((pg > 0) & (pm > 0), pm, 0.0)
    av = torch.where(pg > 0, pg, 0.0)
    assert torch.equal(hv > 0, (pg > 0) & (pm > 0)) and torch.equal(av > 0, pg > 0)
    assert not torch.signbit(hv).any() and not torch.signbit(av).any()


def test_rows_do_not_depend_on_the_batch():
    """A row's encoder sums, masks and decoder sums (y and via, h and hga)
    and its dg row depend on its own data alone: the first 128 rows alone
    give the whole call's rows to the bit."""
    L, B, D, S = SHAPES["d_in_128"]
    t = _torch(_arrays(L, B, D, S, seed=7))
    whole = emulated_forward(*t[:7])
    rows = emulated_forward(t[0][:, :128], *t[1:7])
    for i in (0, 1, 4, 5):
        assert torch.equal(rows[i], whole[i][:, :128])
    WdT = t[5].transpose(1, 2).contiguous()
    dh = lambda d: _product(d, WdT, "k")
    assert torch.equal(dh(t[7][:, :128]), dh(t[7])[:, :128])
