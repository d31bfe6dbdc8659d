"""Kernels B5, B8 and B9 by route: the port's ``sae_fused_backward``,
``sae_fused_forward_topk`` and ``sae_fused_backward_topk`` (their plain
versions, which CPU tensors run) against the JAX package's
``_fused_backward``, ``_fused_forward_topk`` and ``_fused_backward_topk``
(Pallas in interpret mode) at one shape that the bf16 Hopper route takes and
one that only the mma.sync route takes; the two facts B5's and B8's Hopper
route rest on (B10's radix select gives B8's bitwise-search threshold on
rows of ``max(hp, 0)``; ``c(relu(hpre))`` equals ``max(c(hpre), 0)``, and
-0 marks carry B5's mask ``hpre > 0`` where a positive hpre rounds to +0);
the wrappers' dispatch to the route's C entry point, with a launch that
fails raising (no fallback), on meta tensors and a stand-in library; and
each remat backward taking its forward's route at every shape of the route
picker's cases.  The CUDA kernels themselves are held to the plain versions
on the card by ``chip_smoke.py`` (phases 7 and 8)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import assert_close, seeded
from tests.test_torch_sae_wgmma import ROUTE_CASES
from vit_prisma_tpu.ops.sae_step import _fused_backward as jax_backward
from vit_prisma_tpu.ops.sae_step import _fused_backward_topk as jax_backward_topk
from vit_prisma_tpu.ops.sae_step import _fused_forward_topk as jax_forward_topk
from vit_prisma_tpu_torch.ops import sae_step
from vit_prisma_tpu_torch.ops.topk import kth_value

# name: (L, B, d_in, d_sae, k, the bf16 route).  Both are tile-aligned for
# the JAX kernels (B and d_sae multiples of 256); d_in 128 is not a multiple
# of the Hopper route's 256-wide tile.
SHAPES = {"wgmma_route": (2, 256, 256, 512, 16, "wgmma"),
          "mma_sync_route": (2, 256, 128, 512, 16, "mma_sync")}

# As tests/test_torch_sae_topk.py's and test_torch_sae_wgmma.py's TOL:
# float32 differs from XLA by summation order only (y and grads within 1e-5
# of their scale, l1 within 1e-5 relative); bfloat16 rounds y and dhc to
# bf16 after sums in other orders, one bf16 ulp apart at most, so y within
# 2e-2 of its scale, l1 within 2e-2 relative and grads within 1e-2 of their
# scale.  The TopK masks, so nact, t and h's support, are equal: hp is
# rounded to c before the threshold in both packages.
TOL = {"float32": dict(y=1e-5, l1=1e-5, grad=1e-5),
       "bfloat16": dict(y=2e-2, l1=2e-2, grad=1e-2)}
GRADS = ("dW_enc", "dW_dec", "db_enc")


def _arrays(L, B, D, S, seed=0):
    """x ~ N(0, 1), the weights at the SAE init's scale, a small dy."""
    return (seeded(seed, (L, B, D)), seeded(seed + 1, (L, D, S), D ** -0.5),
            seeded(seed + 2, (L, S), 0.01), seeded(seed + 3, (L, S, D), D ** -0.5),
            seeded(seed + 4, (L, D), 0.1), seeded(seed + 5, (L, B, D), 1e-3),
            np.random.default_rng(seed + 6).uniform(0, 1e-3, L).astype(np.float32))


def _grads_close(want, got, dtype):
    for w, g, name in zip(want, got, GRADS):
        assert g.dtype == torch.float32 and tuple(g.shape) == tuple(w.shape), name
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=TOL[dtype]["grad"] * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_remat_backward_matches_jax_kernel(shape, dtype):
    """B5: both packages' remat VJP from the same inputs and cotangents."""
    L, B, D, S, _, route = SHAPES[shape]
    assert sae_step.sae_gemm_route(B, D, S, torch.bfloat16) == route
    x, We, be, Wd, bd, dy, dl1 = _arrays(L, B, D, S, seed=30)
    want = jax_backward(*(jnp.asarray(a, dtype) for a in (x, We, be, Wd, bd, dy)),
                        jnp.asarray(dl1))
    launches = sae_step.sae_fused_backward.launches
    got = sae_step.sae_fused_backward(
        *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, We, be, Wd, bd, dy)),
        torch.from_numpy(dl1))
    assert sae_step.sae_fused_backward.launches == launches  # CPU: the plain version
    _grads_close(want, got, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_topk_forward_matches_jax_kernel(shape, dtype):
    """B8: y, l1 within TOL; nact, t and the masked h's support equal."""
    L, B, D, S, k, route = SHAPES[shape]
    assert sae_step.sae_gemm_route(B, D, S, torch.bfloat16) == route
    tol = TOL[dtype]
    arrays = _arrays(L, B, D, S, seed=40)[:5]
    jy, jl1, jn, jt, jh = jax_forward_topk(*(jnp.asarray(a, dtype) for a in arrays), k,
                                           save_h=True)
    py, pl1, pn, pt, ph = sae_step.sae_fused_forward_topk(
        *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays), k, save_h=True)
    assert py.dtype == ph.dtype == getattr(torch, dtype)
    assert pl1.dtype == pn.dtype == pt.dtype == torch.float32
    assert_close(jy, py, tol["y"] * max(1.0, float(np.abs(np.asarray(jy, np.float32)).max())),
                 "y")
    np.testing.assert_allclose(pl1.numpy(), np.asarray(jl1), rtol=tol["l1"], err_msg="l1")
    np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ph.float().numpy() > 0, np.asarray(jh, np.float32) > 0)
    assert (pn.sum(-1) >= k * B).all()  # every row keeps at least k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_topk_backward_matches_jax_kernel(shape, dtype):
    """B9: both packages' TopK remat VJP from the JAX forward's thresholds."""
    L, B, D, S, k, route = SHAPES[shape]
    assert sae_step.sae_gemm_route(B, D, S, torch.bfloat16) == route
    x, We, be, Wd, bd, dy, dl1 = _arrays(L, B, D, S, seed=50)
    jx, jWe, jbe, jWd, jbd, jdy = (jnp.asarray(a, dtype) for a in (x, We, be, Wd, bd, dy))
    t = jax_forward_topk(jx, jWe, jbe, jWd, jbd, k)[3]
    want = jax_backward_topk(jx, jWe, jbe, jWd, jbd, jdy, jnp.asarray(dl1), t)
    to = lambda a: torch.from_numpy(a).to(getattr(torch, dtype))
    got = sae_step.sae_fused_backward_topk(to(x), to(We), to(be), to(Wd), to(bd), to(dy),
                                           torch.from_numpy(dl1),
                                           torch.from_numpy(np.array(t, np.float32)))
    _grads_close(want, got, dtype)


def _rows(dtype, k_cases):
    """Pre-activation rows [R, S] in ``dtype`` for the threshold checks: N(0,
    1) rows, rows quantized to quarters (the k-th value tied), rows with
    fewer than k positives, all-negative rows, rows of zeros of both signs
    among positives; and the k values to try."""
    S = 512
    rng = np.random.default_rng(60)
    base = rng.standard_normal((8, S)).astype(np.float32)
    base[1] = np.round(base[1] * 4) / 4                       # ties at the k-th value
    base[2] = -np.abs(base[2])
    base[2, :5] = np.abs(base[2, :5])                         # 5 positives, fewer than k
    base[3] = -np.abs(base[3]) - 0.5                          # all negative
    base[4, ::2] = 0.0
    base[4, 1::4] = -0.0                                      # signed zeros among the rest
    base[5] = np.round(base[5])                               # few values, many ties
    return torch.from_numpy(base).to(dtype), [k for k in k_cases if k <= S]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 16, 64, 512])
def test_radix_select_on_relu_rows_is_the_topk_threshold(dtype, k):
    """B8's Hopper route takes t by B10's select on the rows of max(hp, 0)
    (+0 where hp <= 0, never -0): the plain version of B10 on such rows
    gives `_row_threshold(hp, k)`, B8's bitwise search, to the bit; and the
    mask keeps the same entries."""
    hp, ks = _rows(dtype, [k])
    for k in ks:
        hpf = hp.float()
        relu = torch.where(hpf > 0, hpf, 0.0).to(dtype)
        assert not torch.signbit(relu.float()).any()
        got = kth_value(relu, k)
        want = sae_step._row_threshold(hp, k)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        active, _ = sae_step._topk_mask(hp, want)
        rf = relu.float()
        assert torch.equal((rf > 0) & (rf >= got), active)


def _hc_marked(hpre):
    """B5's Hopper encoder epilogue in plain torch: hc = bf16(hpre > 0 ?
    hpre : 0), with the bits 0x8000 (-0) where hpre > 0 rounds to +0."""
    hc = torch.where(hpre > 0, hpre, 0.0).to(torch.bfloat16).view(torch.int16)
    return torch.where((hpre > 0) & (hc == 0), torch.tensor(-32768, dtype=torch.int16), hc)


def test_relu_then_round_is_round_then_relu_and_marks_carry_the_mask():
    """bf16(relu(hpre)) == max(bf16(hpre), 0) bit for bit (+0, never -0, where
    hpre <= 0 or rounds to 0), on signed zeros and on values around 2^-134,
    below which a positive float32 rounds to +0 in bf16; B5's -0 marks make
    "bits != 0" the float32 mask hpre > 0 there, and the marked hc is B4's
    hc elsewhere."""
    tiny = 2.0 ** -134
    vals = [0.0, -0.0, tiny, -tiny, tiny * 0.5, tiny * 1.5, tiny * 2, tiny * 3, 2.0 ** -133,
            2.0 ** -149, -(2.0 ** -149), 2.0 ** -126, 1e-30, -1e-30, 1.0, -1.0, 3.0e38]
    hpre = torch.tensor(vals, dtype=torch.float32)
    a = torch.where(hpre > 0, hpre, 0.0).to(torch.bfloat16)    # the kernels' c(relu(hpre))
    hp = hpre.to(torch.bfloat16).float()
    b = torch.where(hp > 0, hp, 0.0).to(torch.bfloat16)        # max(c(hpre), 0), as plain
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert not torch.signbit(a.float()).any()
    rounds_to_zero = (hpre > 0) & (a.view(torch.int16) == 0)
    assert int(rounds_to_zero.sum()) == 3  # 2^-134 (a tie, to even), its half, 2^-149
    marked = _hc_marked(hpre)
    assert torch.equal(marked != 0, hpre > 0)
    assert torch.equal(torch.where(rounds_to_zero, torch.tensor(0, dtype=torch.int16), marked),
                       a.view(torch.int16))
    # a -0 contributes nothing to dW_dec = hc^T dy
    dy = torch.linspace(-1, 1, len(vals)).to(torch.bfloat16)
    assert torch.equal(marked.view(torch.bfloat16).float() @ dy.float(), a.float() @ dy.float())


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


def _meta(L, B, D, S, dtype):
    """x, W_enc, b_enc, W_dec, b_dec, dy, dl1 and t on the meta device."""
    new = lambda *shape, dt=dtype: torch.empty(shape, dtype=dt, device="meta")
    return (new(L, B, D), new(L, D, S), new(L, S), new(L, S, D), new(L, D), new(L, B, D),
            new(L, dt=torch.float32), new(L, B, 1, dt=torch.float32))


# (B, d_in, d_sae, dtype): the entry point each wrapper reaches, by case (a
# case is named for its shape's route when the FFMA tiles were float32's:
# B5, B8 and B9 take "tf32x3" at the float32 case now)
DISPATCH = {"wgmma": (256, 256, 512, torch.bfloat16), "mma_sync": (256, 128, 512, torch.bfloat16),
            "ffma": (256, 128, 512, torch.float32)}
_CODES = {torch.float32: 0, torch.bfloat16: 1}
K = 16


def _call(which, args):
    x, We, be, Wd, bd, dy, dl1, t = args
    if which == "backward":
        return sae_step.sae_fused_backward(x, We, be, Wd, bd, dy, dl1)
    if which == "forward_topk":
        return sae_step.sae_fused_forward_topk(x, We, be, Wd, bd, K, save_h=True)
    return sae_step.sae_fused_backward_topk(x, We, be, Wd, bd, dy, dl1, t)


# per wrapper: the Hopper route's entry point, the other routes' entry point
# and the mask mode it passes them (None: no mode argument)
ENTRIES = {"backward": ("sae_fused_bwd_remat_tc", "sae_fused_bwd", 1),
           "forward_topk": ("sae_fused_fwd_topk_tc", "sae_fused_fwd_topk", None),
           "backward_topk": ("sae_fused_bwd_topk_tc", "sae_fused_bwd", 2)}


@pytest.mark.parametrize("route", list(DISPATCH))
@pytest.mark.parametrize("which", list(ENTRIES))
def test_dispatches_by_route(monkeypatch, which, route):
    B, D, S, dtype = DISPATCH[route]
    if route == "ffma":
        route = "tf32x3"
    assert sae_step.sae_gemm_route(B, D, S, dtype, "relu" if which == "backward" else "topk") \
        == route
    lib = _Lib()
    monkeypatch.setattr(sae_step, "_lib_and_stream", lambda device: (lib, 0))
    fn = getattr(sae_step, f"sae_fused_{which}")
    launches, routes = fn.launches, dict(fn.routes)
    out = _call(which, _meta(2, B, D, S, dtype))
    tc, other, mode = ENTRIES[which]
    n_ptrs = {"backward": 13, "forward_topk": 11, "backward_topk": 14}[which]
    if route == "tf32x3":  # B5, B8, B9: their pointers, then the split copies'
        (name, args), = lib.calls
        tf32 = {"backward": ("sae_fused_bwd_remat_tf32", 14),
                "forward_topk": ("sae_fused_fwd_topk_tf32", 12),
                "backward_topk": ("sae_fused_bwd_topk_tf32", 15)}[which]
        assert name == tf32[0] and args[tf32[1]:tf32[1] + 4] == (2, B, D, S)
        if which == "forward_topk":
            assert args[tf32[1] + 4] == K
    elif route == "wgmma":
        (name, args), = lib.calls
        assert name == tc
        assert args[n_ptrs:n_ptrs + 4] == (2, B, D, S)
        if which == "forward_topk":
            assert args[n_ptrs + 4] == K
    elif which == "forward_topk":
        (name, args), = lib.calls
        assert name == other and args[11:17] == (2, B, D, S, K, _CODES[dtype])
    else:  # sae_fused_bwd's mask mode, with the dtype code
        (name, args), = lib.calls
        assert name == other and args[14:20] == (2, B, D, S, _CODES[dtype], mode)
    assert fn.launches == launches + 1
    routes[route] += 1
    assert fn.routes == routes
    if which == "forward_topk":
        y, l1, nact, t, h = out
        assert (tuple(y.shape), tuple(t.shape), tuple(h.shape)) == ((2, B, D), (2, B, 1),
                                                                     (2, B, S))
        assert tuple(l1.shape) == (2,) and tuple(nact.shape) == (2, S)
    else:
        assert [tuple(g.shape) for g in out] == [(2, D, S), (2, S, D), (2, S)]


@pytest.mark.parametrize("which", list(ENTRIES))
def test_a_failed_launch_raises_without_fallback(monkeypatch, which):
    """A launch on the Hopper route that returns a CUDA error raises; no other
    route is tried and nothing is counted."""
    lib = _Lib(rc=1)
    monkeypatch.setattr(sae_step, "_lib_and_stream", lambda device: (lib, 0))
    fn = getattr(sae_step, f"sae_fused_{which}")
    launches, routes = fn.launches, dict(fn.routes)
    with pytest.raises(RuntimeError, match=r"\(wgmma\): CUDA error 1 \(stand-in error\)"):
        _call(which, _meta(1, 256, 256, 512, torch.bfloat16))
    assert [name for name, _ in lib.calls] == [ENTRIES[which][0]]
    assert fn.launches == launches and fn.routes == routes


@pytest.mark.parametrize("case", list(ROUTE_CASES))
@pytest.mark.parametrize("pair", [("forward", "backward"), ("forward_topk", "backward_topk")])
def test_remat_backward_takes_its_forwards_route(monkeypatch, pair, case):
    """B5 counts its launch on B4's route and B9 on B8's at every shape of
    the picker's cases (the picker's own), or both refuse the shape: a remat
    backward recomputes its forward's masks with its forward's mainloop."""
    B, D, S, dtype, route = ROUTE_CASES[case]
    lib = _Lib()
    monkeypatch.setattr(sae_step, "_lib_and_stream", lambda device: (lib, 0))
    args = _meta(1, B, D, S, dtype)
    x, We, be, Wd, bd = args[:5]
    taken = []
    for which in pair:
        fn = getattr(sae_step, f"sae_fused_{which}")
        before = dict(fn.routes)
        try:
            if which == "forward":
                fn(x, We, be, Wd, bd)
            else:
                _call(which, args)
        except (TypeError, ValueError) as exc:
            taken.append(type(exc))
            continue
        taken.append([r for r, n in fn.routes.items() if n != before[r]])
    if route is None:
        assert taken[0] == taken[1] and taken[0] in (TypeError, ValueError) and not lib.calls
    else:
        assert taken == [[route], [route]]
