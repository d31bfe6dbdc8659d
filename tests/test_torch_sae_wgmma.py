"""Kernels B4 and B6 by route: the port's ``sae_fused_forward`` and
``sae_fused_backward_stored`` (their plain versions, which CPU tensors run)
against the JAX package's ``_fused_forward`` and ``_fused_backward_stored``
(Pallas in interpret mode) at one shape that B4's and B6's bf16 Hopper route
takes and one that only the mma.sync route takes; the route picker
``sae_gemm_route``; and the wrappers' dispatch to the route's C entry point,
with a launch that fails raising (no fallback), on meta tensors and a stand-in
library.  The CUDA kernels themselves are held to the plain versions on the
card by ``chip_smoke.py`` (phases 7 and 8)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import assert_close, seeded
from vit_prisma_tpu.ops.sae_step import _fused_backward_stored as jax_backward_stored
from vit_prisma_tpu.ops.sae_step import _fused_forward as jax_forward
from vit_prisma_tpu_torch.ops import sae_step

# name: (L, B, d_in, d_sae, the bf16 route).  Both are tile-aligned for the
# JAX kernels (B and d_sae multiples of 256); d_in 128 is not a multiple of
# the Hopper route's 256-wide tile.
SHAPES = {"wgmma_route": (2, 256, 256, 512, "wgmma"),
          "mma_sync_route": (2, 256, 128, 512, "mma_sync")}

# As tests/test_torch_sae_step.py's TOL: float32 differs from XLA by
# summation order only (y, hc and grads within 1e-5 of their scale, l1
# within 1e-5 relative); bfloat16 rounds y, hc and dhc to bf16 after sums in
# other orders, one bf16 ulp apart at most, so y and hc within 2e-2 of their
# scale, l1 within 2e-2 relative and grads within 1e-2 of their scale.  nact
# counts float32 pre-activations above 0 in both packages: it must be equal.
TOL = {"float32": dict(y=1e-5, l1=1e-5, grad=1e-5),
       "bfloat16": dict(y=2e-2, l1=2e-2, grad=1e-2)}


def _arrays(L, B, D, S, seed=0):
    """x ~ N(0, 1), the weights at the SAE init's scale, a small dy."""
    return (seeded(seed, (L, B, D)), seeded(seed + 1, (L, D, S), D ** -0.5),
            seeded(seed + 2, (L, S), 0.01), seeded(seed + 3, (L, S, D), D ** -0.5),
            seeded(seed + 4, (L, D), 0.1), seeded(seed + 5, (L, B, D), 1e-3),
            np.random.default_rng(seed + 6).uniform(0, 1e-3, L).astype(np.float32))


def _scaled(want, rel):
    return rel * max(1.0, float(np.abs(np.asarray(want, np.float32)).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_forward_matches_jax_kernel(shape, dtype):
    L, B, D, S, route = SHAPES[shape]
    assert sae_step.sae_gemm_route(B, D, S, torch.bfloat16) == route
    tol = TOL[dtype]
    x, We, be, Wd, bd, _, _ = _arrays(L, B, D, S)
    jy, jl1, jn, jh = jax_forward(*(jnp.asarray(a, dtype) for a in (x, We, be, Wd, bd)),
                                  save_h=True)
    py, pl1, pn, ph = sae_step.sae_fused_forward(
        *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, We, be, Wd, bd)),
        save_h=True)
    assert py.dtype == ph.dtype == getattr(torch, dtype)
    assert pl1.dtype == pn.dtype == torch.float32
    assert_close(jy, py, _scaled(jy, tol["y"]), "y")
    assert_close(jh, ph, _scaled(jh, tol["y"]), "hc")
    np.testing.assert_allclose(pl1.numpy(), np.asarray(jl1), rtol=tol["l1"], err_msg="l1")
    np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_backward_stored_matches_jax_kernel(shape, dtype):
    """Both packages' stored-acts VJP from the same stored activations (the
    JAX forward's h), the same dy and dl1."""
    L, B, D, S, route = SHAPES[shape]
    assert sae_step.sae_gemm_route(B, D, S, torch.bfloat16) == route
    x, We, be, Wd, bd, dy, dl1 = _arrays(L, B, D, S, seed=10)
    jx, jWe, jbe, jWd, jbd, jdy = (jnp.asarray(a, dtype) for a in (x, We, be, Wd, bd, dy))
    h = jax_forward(jx, jWe, jbe, jWd, jbd, save_h=True)[3]
    assert float(jnp.mean((h > 0).astype(jnp.float32))) > 0.2  # the mask has work to do
    want = jax_backward_stored(jx, h, jWd, jbd, jdy, jnp.asarray(dl1))
    to = lambda a: torch.from_numpy(np.array(a, np.float32)).to(getattr(torch, dtype))
    got = sae_step.sae_fused_backward_stored(to(x), to(h), to(Wd), to(bd), to(dy),
                                             torch.from_numpy(dl1))
    for w, g, name in zip(want, got, ("dW_enc", "dW_dec", "db_enc")):
        assert g.dtype == torch.float32 and tuple(g.shape) == tuple(w.shape), name
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=TOL[dtype]["grad"] * np.abs(w).max(), err_msg=name)


# (B, d_in, d_sae, dtype, route): the sweep's and the TopK slice's shapes take
# the Hopper route in bf16 and, for B4-B6 (the ReLU family, the picker's
# default), 3xTF32 on tf32 wgmma in f32; shapes whose d_in or d_sae is a
# multiple of 128 but not of 256 keep the mma.sync tiles; shapes off the
# 128-wide tile take no kernel.
ROUTE_CASES = {
    "sweep_bf16": (4096, 1024, 8192, torch.bfloat16, "wgmma"),
    "topk_slice_bf16": (4096, 768, 12288, torch.bfloat16, "wgmma"),
    "odd_row_blocks_bf16": (384, 256, 512, torch.bfloat16, "wgmma"),
    "sweep_f32": (4096, 1024, 8192, torch.float32, "tf32x3"),
    "topk_slice_f32": (4096, 768, 12288, torch.float32, "tf32x3"),
    "d_in_128_bf16": (256, 128, 512, torch.bfloat16, "mma_sync"),
    "d_sae_384_bf16": (4096, 768, 384, torch.bfloat16, "mma_sync"),
    "rows_off_tile_bf16": (4097, 1024, 8192, torch.bfloat16, None),
    "float16": (4096, 1024, 8192, torch.float16, None),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_route_picker(case):
    B, D, S, dtype, route = ROUTE_CASES[case]
    assert sae_step.sae_gemm_route(B, D, S, dtype) == route


class _Lib:
    """Stands in for the kernel library: records each entry point's call and
    returns ``rc``."""

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
    new = lambda *shape: torch.empty(shape, dtype=dtype, device="meta")
    return new(L, B, D), new(L, D, S), new(L, S), new(L, S, D), new(L, D), new(L, B, S)


# (B, d_in, d_sae, dtype): the entry point each wrapper reaches, by case.
# A case is named for the route its shape took when the FFMA tiles were
# float32's; B4 and B6 (the ReLU family) take "tf32x3" at the float32 case
# now (RELU_ROUTE), as the TopK and gated families do.
DISPATCH = {"wgmma": (256, 256, 512, torch.bfloat16), "mma_sync": (256, 128, 512, torch.bfloat16),
            "ffma": (256, 128, 512, torch.float32)}
RELU_ROUTE = {"wgmma": "wgmma", "mma_sync": "mma_sync", "ffma": "tf32x3"}


@pytest.mark.parametrize("route", list(DISPATCH))
def test_forward_dispatches_by_route(monkeypatch, route):
    B, D, S, dtype = DISPATCH[route]
    route = RELU_ROUTE[route]
    assert sae_step.sae_gemm_route(B, D, S, dtype) == route
    lib = _Lib()
    monkeypatch.setattr(sae_step, "_lib_and_stream", lambda device: (lib, 0))
    x, We, be, Wd, bd, _ = _meta(2, B, D, S, dtype)
    launches, routes = sae_step.sae_fused_forward.launches, dict(sae_step.sae_fused_forward.routes)
    y, l1, nact, hc = sae_step.sae_fused_forward(x, We, be, Wd, bd, save_h=True)
    (name, args), = lib.calls
    assert name == {"wgmma": "sae_fused_fwd_tc", "tf32x3": "sae_fused_fwd_tf32",
                    "mma_sync": "sae_fused_fwd"}[route]
    if route == "mma_sync":
        assert args[14] == {torch.float32: 0, torch.bfloat16: 1}[dtype]  # the dtype code
    # tf32x3: the split copies' scratch after the ten pointers
    n_ptrs = 11 if route == "tf32x3" else 10
    assert args[n_ptrs:n_ptrs + 4] == (2, B, D, S)
    assert sae_step.sae_fused_forward.launches == launches + 1
    routes[route] += 1
    assert sae_step.sae_fused_forward.routes == routes
    assert tuple(y.shape) == (2, B, D) and tuple(hc.shape) == (2, B, S)
    assert tuple(l1.shape) == (2,) and tuple(nact.shape) == (2, S)


@pytest.mark.parametrize("route", list(DISPATCH))
def test_backward_stored_dispatches_by_route(monkeypatch, route):
    B, D, S, dtype = DISPATCH[route]
    route = RELU_ROUTE[route]
    lib = _Lib()
    monkeypatch.setattr(sae_step, "_lib_and_stream", lambda device: (lib, 0))
    x, _, _, Wd, bd, hc = _meta(2, B, D, S, dtype)
    dy, dl1 = torch.empty_like(x), torch.empty(2, device="meta")
    launches = sae_step.sae_fused_backward_stored.launches
    routes = dict(sae_step.sae_fused_backward_stored.routes)
    dWe, dWd, dbe = sae_step.sae_fused_backward_stored(x, hc, Wd, bd, dy, dl1)
    (name, args), = lib.calls
    if route == "wgmma":
        assert name == "sae_fused_bwd_stored_tc" and args[11:15] == (2, B, D, S)
    elif route == "tf32x3":  # x, hc, W_dec, b_dec, dy, dl1, dhc, split, the grads
        assert name == "sae_fused_bwd_stored_tf32" and args[11:15] == (2, B, D, S)
    else:  # B6's mask mode of sae_fused_bwd, with the dtype code
        assert name == "sae_fused_bwd" and args[14:20] == (2, B, D, S, int(route == "mma_sync"),
                                                          0)
    assert sae_step.sae_fused_backward_stored.launches == launches + 1
    routes[route] += 1
    assert sae_step.sae_fused_backward_stored.routes == routes
    assert (tuple(dWe.shape), tuple(dWd.shape), tuple(dbe.shape)) == ((2, D, S), (2, S, D),
                                                                       (2, S))


@pytest.mark.parametrize("which", ["forward", "backward_stored"])
def test_a_failed_launch_raises_without_fallback(monkeypatch, which):
    """A launch on the Hopper route that returns a CUDA error raises; no other
    route is tried and nothing is counted."""
    lib = _Lib(rc=1)
    monkeypatch.setattr(sae_step, "_lib_and_stream", lambda device: (lib, 0))
    x, We, be, Wd, bd, hc = _meta(1, 256, 256, 512, torch.bfloat16)
    fn = getattr(sae_step, f"sae_fused_{which}")
    launches, routes = fn.launches, dict(fn.routes)
    with pytest.raises(RuntimeError, match=r"\(wgmma\): CUDA error 1 \(stand-in error\)"):
        if which == "forward":
            fn(x, We, be, Wd, bd)
        else:
            fn(x, hc, Wd, bd, torch.empty_like(x), torch.empty(1, device="meta"))
    assert [name for name, _ in lib.calls] == [
        "sae_fused_fwd_tc" if which == "forward" else "sae_fused_bwd_stored_tc"]
    assert fn.launches == launches and fn.routes == routes
