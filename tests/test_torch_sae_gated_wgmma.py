"""Kernels B11 and B12 by route: the port's ``sae_gated_fused_forward`` and
``sae_gated_fused_backward`` (their plain versions, which CPU tensors run)
against the JAX package's ``_fused_forward_gated`` and
``_fused_backward_gated`` (Pallas in interpret mode) at one shape that the
bf16 Hopper route takes and one that only the mma.sync route takes; the
wrappers' dispatch to the route's C entry point, with a launch that fails
raising (no fallback), on meta tensors and a stand-in library; and the
forward and the backward taking the same route at every shape of the route
picker's cases, which B12's recomputed masks rest on.  The CUDA kernels
themselves are held to the plain versions on the card by ``chip_smoke.py``
(phase 13)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import assert_close, seeded
from tests.test_torch_sae_wgmma import ROUTE_CASES
from vit_prisma_tpu.ops.sae_step import _fused_backward_gated as jax_backward
from vit_prisma_tpu.ops.sae_step import _fused_forward_gated as jax_forward
from vit_prisma_tpu_torch.ops import sae_step

# name: (L, B, d_in, d_sae, the bf16 route).  Both are tile-aligned for the
# JAX kernels (B and d_sae multiples of 256); d_in 128 is not a multiple of
# the Hopper route's 256-wide tile.
SHAPES = {"wgmma_route": (2, 256, 256, 512, "wgmma"),
          "mma_sync_route": (2, 256, 128, 512, "mma_sync")}

# As tests/test_torch_sae_gated.py's TOL (the JAX package's own bounds for
# its gated kernel, tests/test_fused_step.py:318, :338): values within 1e-5
# in float32 and 2e-2 in bfloat16 (sums in other orders; bf16 y rounds one
# ulp apart), grads within 2e-4 and 3e-2.  The masks, so nact, are equal:
# hg and hm are rounded to c before any compare in both packages.
TOL = {"float32": dict(value=1e-5, grad=2e-4), "bfloat16": dict(value=2e-2, grad=3e-2)}
GRADS = ("dW_enc", "dW_dec", "db_gate", "db_mag", "dr_mag")


def _arrays(L, B, D, S, seed=0):
    """x, W_enc, b_gate, r_mag, b_mag, W_dec, b_dec at the scales of the JAX
    package's gated kernel test (tests/test_fused_step.py:297-306), then
    dy, dvia and dl1."""
    return (seeded(seed, (L, B, D)), seeded(seed + 1, (L, D, S), 0.05),
            seeded(seed + 2, (L, S), 0.01), seeded(seed + 3, (L, S), 0.1),
            seeded(seed + 4, (L, S), 0.01), seeded(seed + 5, (L, S, D), 0.05),
            seeded(seed + 6, (L, D), 0.01), seeded(seed + 7, (L, B, D), 0.1),
            seeded(seed + 8, (L, B, D), 0.1),
            np.random.default_rng(seed + 9).uniform(1e-3, 3e-3, L).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_gated_forward_matches_jax_kernel(shape, dtype):
    L, B, D, S, route = SHAPES[shape]
    assert sae_step.sae_gemm_route(B, D, S, torch.bfloat16) == route
    tol = TOL[dtype]["value"]
    arrays = _arrays(L, B, D, S)[:7]
    jy, jvia, jl1, jn = jax_forward(*(jnp.asarray(a, dtype) for a in arrays))
    py, pvia, pl1, pn, ph, phga = sae_step.sae_gated_fused_forward(
        *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays), save_h=True)
    assert py.dtype == pvia.dtype == ph.dtype == getattr(torch, dtype)
    assert pl1.dtype == pn.dtype == torch.float32
    assert_close(jy, py, tol, "y")
    assert_close(jvia, pvia, tol, "via")
    np.testing.assert_allclose(pl1.numpy(), np.asarray(jl1), rtol=tol, err_msg="l1")
    np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))
    assert 0 < float(pn.sum()) < L * B * S  # both masks have work to do
    assert bool((phga > 0).any()) and bool((ph == 0).any())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_gated_backward_matches_jax_kernel(shape, dtype):
    """Both packages' remat VJP from the same inputs and cotangents."""
    L, B, D, S, route = SHAPES[shape]
    assert sae_step.sae_gemm_route(B, D, S, torch.bfloat16) == route
    tol = TOL[dtype]["grad"]
    *arrays, dl1 = _arrays(L, B, D, S, seed=20)
    want = jax_backward(*(jnp.asarray(a, dtype) for a in arrays), jnp.asarray(dl1))
    got = sae_step.sae_gated_fused_backward(
        *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays),
        torch.from_numpy(dl1))
    for w, g, name in zip(want, got, GRADS):
        assert g.dtype == torch.float32 and tuple(g.shape) == tuple(w.shape), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32), rtol=tol, atol=tol,
                                   err_msg=name)


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


def _meta(L, B, D, S, dtype):
    """x, W_enc, b_gate, r_mag, b_mag, W_dec, b_dec and dy, dvia, dl1 on the
    meta device."""
    new = lambda *shape, dt=dtype: torch.empty(shape, dtype=dt, device="meta")
    return ((new(L, B, D), new(L, D, S), new(L, S), new(L, S), new(L, S), new(L, S, D),
             new(L, D)), (new(L, B, D), new(L, B, D), new(L, dt=torch.float32)))


# (B, d_in, d_sae, dtype): the entry point each wrapper reaches, by case.  A
# case is named for the route its shape took when the FFMA tiles were
# float32's; float32 B11 and B12 take "tf32x3" there now (ROUTE).
DISPATCH = {"wgmma": (256, 256, 512, torch.bfloat16), "mma_sync": (256, 128, 512, torch.bfloat16),
            "ffma": (256, 128, 512, torch.float32)}
ROUTE = {"wgmma": "wgmma", "mma_sync": "mma_sync", "ffma": "tf32x3"}
ENTRY = {"forward": {"wgmma": "sae_gated_fwd_tc", "tf32x3": "sae_gated_fwd_tf32",
                     "mma_sync": "sae_fused_fwd_gated"},
         "backward": {"wgmma": "sae_gated_bwd_tc", "tf32x3": "sae_gated_bwd_tf32",
                      "mma_sync": "sae_fused_bwd_gated"}}
_CODES = {torch.float32: 0, torch.bfloat16: 1}


@pytest.mark.parametrize("route", list(DISPATCH))
def test_gated_forward_dispatches_by_route(monkeypatch, route):
    B, D, S, dtype = DISPATCH[route]
    route = ROUTE[route]
    assert sae_step.sae_gemm_route(B, D, S, dtype, "gated") == route
    lib = _Lib()
    monkeypatch.setattr(sae_step, "_lib_and_stream", lambda device: (lib, 0))
    args, _ = _meta(2, B, D, S, dtype)
    fn = sae_step.sae_gated_fused_forward
    launches, routes = fn.launches, dict(fn.routes)
    y, via, l1, nact, h, hga = fn(*args, save_h=True)
    (name, cargs), = lib.calls
    assert name == ENTRY["forward"][route]
    # tf32x3: the split copies' scratch after the thirteen pointers
    n_ptrs = 14 if route == "tf32x3" else 13
    assert cargs[n_ptrs:n_ptrs + 4] == (2, B, D, S)
    if route == "mma_sync":
        assert cargs[17] == _CODES[dtype]
    assert fn.launches == launches + 1
    routes[route] += 1
    assert fn.routes == routes
    assert tuple(y.shape) == tuple(via.shape) == (2, B, D)
    assert tuple(h.shape) == tuple(hga.shape) == (2, B, S)
    assert tuple(l1.shape) == (2,) and tuple(nact.shape) == (2, S)


@pytest.mark.parametrize("route", list(DISPATCH))
def test_gated_backward_dispatches_by_route(monkeypatch, route):
    B, D, S, dtype = DISPATCH[route]
    route = ROUTE[route]
    lib = _Lib()
    monkeypatch.setattr(sae_step, "_lib_and_stream", lambda device: (lib, 0))
    args, cot = _meta(2, B, D, S, dtype)
    fn = sae_step.sae_gated_fused_backward
    launches, routes = fn.launches, dict(fn.routes)
    grads = fn(*args, *cot)
    (name, cargs), = lib.calls
    assert name == ENTRY["backward"][route]
    # tf32x3: x .. xc, h, g, dg, the partials, sums, the grads, then the split
    n_ptrs = 20 if route == "tf32x3" else 19
    assert cargs[n_ptrs:n_ptrs + 4] == (2, B, D, S)
    if route == "mma_sync":
        assert cargs[23] == _CODES[dtype]
    assert fn.launches == launches + 1
    routes[route] += 1
    assert fn.routes == routes
    assert [tuple(g.shape) for g in grads] == [(2, D, S), (2, S, D), (2, S), (2, S), (2, S)]


@pytest.mark.parametrize("which", ["forward", "backward"])
def test_gated_failed_launch_raises_without_fallback(monkeypatch, which):
    """A launch on the Hopper route that returns a CUDA error raises; no other
    route is tried and nothing is counted."""
    lib = _Lib(rc=1)
    monkeypatch.setattr(sae_step, "_lib_and_stream", lambda device: (lib, 0))
    args, cot = _meta(1, 256, 256, 512, torch.bfloat16)
    fn = getattr(sae_step, f"sae_gated_fused_{which}")
    launches, routes = fn.launches, dict(fn.routes)
    with pytest.raises(RuntimeError, match=r"\(wgmma\): CUDA error 1 \(stand-in error\)"):
        fn(*args) if which == "forward" else fn(*args, *cot)
    assert [name for name, _ in lib.calls] == [
        "sae_gated_fwd_tc" if which == "forward" else "sae_gated_bwd_tc"]
    assert fn.launches == launches and fn.routes == routes


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_gated_forward_and_backward_take_one_route(monkeypatch, case):
    """B11 and B12 count their launch on the same route at every shape of
    the picker's cases (the picker's own: float32 takes 3xTF32 in every
    family), or both refuse the shape."""
    B, D, S, dtype, route = ROUTE_CASES[case]
    lib = _Lib()
    monkeypatch.setattr(sae_step, "_lib_and_stream", lambda device: (lib, 0))
    args, cot = _meta(1, B, D, S, dtype)
    taken = []
    for fn, more in ((sae_step.sae_gated_fused_forward, ()),
                     (sae_step.sae_gated_fused_backward, cot)):
        before = dict(fn.routes)
        try:
            fn(*args, *more)
        except (TypeError, ValueError) as exc:
            taken.append(type(exc))
            continue
        taken.append([r for r, n in fn.routes.items() if n != before[r]])
    if route is None:
        assert taken[0] == taken[1] and taken[0] in (TypeError, ValueError) and not lib.calls
    else:
        assert taken == [[route], [route]]
