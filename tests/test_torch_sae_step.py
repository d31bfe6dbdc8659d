"""Kernels B4, B5 and B6 (their plain versions, which CPU tensors run) and
the fused-step gate against the JAX package's ``sae_fused_apply`` (Pallas
in interpret mode) and ``_fused_step_ok``; and the kernel build's hashing of
shared headers.  The CUDA kernels themselves are held to the plain versions
on the card by ``chip_smoke.py``.

Shapes are the JAX package's tile-aligned test shapes
(``tests/test_fused_step.py``): d_in 128, d_sae 512, B 256, L = 2."""

import importlib.util
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_prisma_tpu.sae as jax_sae
import vit_prisma_tpu_torch.sae as port_sae
from tests._torch_parity import assert_close, seeded
from vit_prisma_tpu.ops.sae_step import sae_fused_apply as jax_apply
from vit_prisma_tpu.ops.sae_step import sae_fused_reference as jax_reference
from vit_prisma_tpu.sae.train import _fused_single_ok as jax_single_gate
from vit_prisma_tpu.sae.train import _fused_step_ok as jax_gate
from vit_prisma_tpu_torch.ops import sae_step
from vit_prisma_tpu_torch.sae.train import _fused_single_ok, _fused_step_ok

L, BS, D_IN, D_SAE = 2, 256, 128, 512
PORT_ROOT = Path(sae_step.__file__).resolve().parent.parent


def _tensors(seed=0):
    """x ~ N(0, 1) and small weights, as the JAX package's kernel test."""
    return (seeded(seed, (L, BS, D_IN)), seeded(seed + 1, (L, D_IN, D_SAE), 0.05),
            seeded(seed + 2, (L, D_SAE), 0.01), seeded(seed + 3, (L, D_SAE, D_IN), 0.05),
            seeded(seed + 4, (L, D_IN), 0.01))


def _jax_values_and_grads(fn, arrays, dtype):
    x, *params = (jnp.asarray(a, dtype) for a in arrays)

    def loss(*p):
        y, l1, _ = fn(x, *p)
        return (jnp.square(y.astype(jnp.float32) - x.astype(jnp.float32)).mean()
                + 1e-3 * l1.sum() / BS)
    return fn(x, *params), jax.grad(loss, argnums=(0, 1, 2, 3))(*params)


def _port_values_and_grads(fn, arrays, dtype):
    x, *params = (torch.from_numpy(a).to(dtype) for a in arrays)
    params = [p.requires_grad_(True) for p in params]
    y, l1, nact = fn(x, *params)
    loss = (torch.square(y.float() - x.float()).mean() + 1e-3 * l1.sum() / BS)
    grads = torch.autograd.grad(loss, params)
    return (y.detach(), l1.detach(), nact), grads


# The loss is a mean over L * B * d_in elements, so every gradient is of
# order 1e-3: each is held within ``grad`` times the largest |JAX gradient|
# of its tensor, not within a fixed atol that a zero gradient would meet.
# float32: the products are summed in another order than XLA's (128 or 512
# terms), so y within 1e-5 and l1 within 1e-5 relative, grads within 1e-5 of
# their scale (3e-7 seen).  bfloat16: y is rounded to bf16 (2^-8 relative)
# after sums in other orders, so it is held within 2e-2 (the JAX package's
# bf16 kernel bound); the grads are rounded to bf16 in both packages, one
# bf16 ulp of the largest gradient apart at most (4e-3 of it seen), so
# within 1e-2 of their scale.  nact counts pre-activations above 0, which
# are float32 in both packages: it must be equal.
TOL = {"float32": dict(y=1e-5, l1=1e-5, grad=1e-5),
       "bfloat16": dict(y=2e-2, l1=2e-2, grad=1e-2)}


@pytest.mark.parametrize("dtype,save_acts", [("float32", False), ("float32", True),
                                             ("bfloat16", False), ("bfloat16", True)])
def test_fused_apply_values_and_grads_match_jax(dtype, save_acts):
    arrays, tol = _tensors(), TOL[dtype]
    jdt, pdt = jnp.dtype(dtype), getattr(torch, dtype)
    (jy, jl1, jn), jg = _jax_values_and_grads(
        lambda *a: jax_apply(*a, save_acts=save_acts), arrays, jdt)
    before = (sae_step.sae_fused_forward.launches, sae_step.sae_fused_backward.launches,
              sae_step.sae_fused_backward_stored.launches)
    (py, pl1, pn), pg = _port_values_and_grads(
        lambda *a: sae_step.sae_fused_apply(*a, save_acts=save_acts), arrays, pdt)
    # CPU tensors run the plain versions; no kernel was launched
    assert before == (sae_step.sae_fused_forward.launches,
                      sae_step.sae_fused_backward.launches,
                      sae_step.sae_fused_backward_stored.launches)
    assert py.dtype == pdt and pl1.dtype == pn.dtype == torch.float32
    assert_close(jy, py, tol["y"], "y")
    np.testing.assert_allclose(pl1.numpy(), np.asarray(jl1), rtol=tol["l1"], err_msg="l1")
    np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))
    assert not pn.requires_grad
    for a, b, name in zip(jg, pg, ["dW_enc", "db_enc", "dW_dec", "db_dec"]):
        assert b.dtype == pdt, name
        want = np.asarray(a, np.float32)
        np.testing.assert_allclose(b.float().numpy(), want, rtol=0,
                                   atol=tol["grad"] * np.abs(want).max(), err_msg=name)


def test_fused_apply_matches_both_references_in_float32():
    """The fused function against the port's unfused ``sae_fused_reference``
    (autograd through einsums) and the JAX package's: the same values, and
    the same grads within the JAX package's bound."""
    arrays = _tensors(seed=7)
    (fy, fl1, fn), fg = _port_values_and_grads(sae_step.sae_fused_apply, arrays, torch.float32)
    (ry, rl1, rn), rg = _port_values_and_grads(sae_step.sae_fused_reference, arrays,
                                               torch.float32)
    (jy, jl1, jn), _ = _jax_values_and_grads(jax_reference, arrays, jnp.float32)
    for want in ((ry, rl1, rn), (jy, jl1, jn)):
        assert_close(want[0], fy, 1e-5, "y")
        np.testing.assert_allclose(fl1.numpy(), np.asarray(want[1]), rtol=1e-5)
        np.testing.assert_array_equal(fn.numpy(), np.asarray(want[2]))
    for a, b, name in zip(rg, fg, ["dW_enc", "db_enc", "dW_dec", "db_dec"]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                   atol=TOL["float32"]["grad"] * a.abs().max().item(),
                                   err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stored_and_remat_backward_agree(dtype):
    """B6 from the forward's hc equals B5's recompute exactly: the same
    products in the same order, and a mask that differs only where a
    positive float32 pre-activation rounds to +0 (none here)."""
    x, We, be, Wd, bd = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in _tensors(3))
    y, l1, nact, hc = sae_step.sae_fused_forward(x, We, be, Wd, bd, save_h=True)
    assert torch.equal(y, sae_step.sae_fused_forward(x, We, be, Wd, bd)[0])
    dy = torch.from_numpy(seeded(9, (L, BS, D_IN), 0.1)).to(x.dtype)
    dl1 = torch.tensor([1e-3, 2e-3])
    remat = sae_step.sae_fused_backward(x, We, be, Wd, bd, dy, dl1)
    stored = sae_step.sae_fused_backward_stored(x, hc, Wd, bd, dy, dl1)
    for a, b, name in zip(remat, stored, ["dW_enc", "dW_dec", "db_enc"]):
        assert a.dtype == b.dtype == torch.float32
        assert torch.equal(a, b), name


def test_fused_apply_refuses_a_batch_that_requires_grad():
    x, We, be, Wd, bd = (torch.from_numpy(a) for a in _tensors())
    with pytest.raises(ValueError, match="zero gradient for x"):
        sae_step.sae_fused_apply(x.requires_grad_(True), We, be, Wd, bd)
    with pytest.raises(ValueError, match="do not stack"):
        sae_step.sae_fused_forward(x.detach()[:, :, :64], We, be, Wd, bd)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        sae_step.sae_fused_forward(x.detach().half(), We.half(), be.half(), Wd.half(),
                                   bd.half())


@pytest.mark.parametrize("save_acts,backward", [
    (None, "sae_fused_backward_stored"), (True, "sae_fused_backward_stored"),
    (False, "sae_fused_backward")])
def test_save_acts_picks_the_backward(monkeypatch, save_acts, backward):
    """Only ``save_acts=False`` recomputes (B5); the default keeps hc (B6)."""
    called = []
    for name in ("sae_fused_backward", "sae_fused_backward_stored"):
        inner = getattr(sae_step, name)
        monkeypatch.setattr(sae_step, name,
                            lambda *a, name=name, inner=inner: called.append(name) or inner(*a))
    x, *params = (torch.from_numpy(a) for a in _tensors())
    params = [p.requires_grad_(True) for p in params]
    y, l1, _ = sae_step.sae_fused_apply(x, *params, save_acts=save_acts)
    torch.autograd.grad((y.sum() + l1.sum()), params)
    assert called == [backward]


# -- the gate ------------------------------------------------------------------

def _gate_cfgs(**kw):
    base = dict(d_in=D_IN, expansion_factor=D_SAE // D_IN, train_batch_size=BS, lr=1e-3,
                lr_scheduler_name="constant", b_dec_init_method="zeros",
                l1_coefficient=1e-4, context_size=1)
    base.update(kw)
    return jax_sae.SAERunnerConfig(**base), port_sae.SAERunnerConfig(**base)


# The cases of the JAX package's tests/test_fused_step.py:38-62 for the
# standard ReLU, plus bf16 compute and an Lp norm the kernel does not take.
RELU_CASES = {
    "sweep": ({}, BS, 2),
    "single_sae": ({}, BS, 1),
    "knob_off": (dict(fused_sae_step=False), BS, 2),
    "ghost_grads": (dict(use_ghost_grads=True), BS, 2),
    "layer_norm": (dict(normalize_activations="layer_norm"), BS, 2),
    "unaligned_rows": ({}, BS + 1, 2),
    "unaligned_d_in": (dict(d_in=96), BS, 2),
    "bf16_compute": (dict(compute_dtype="bfloat16"), BS, 24),
    "l2_sparsity": (dict(lp_norm=2.0), BS, 2),
}
TOPK = dict(activation_fn_str="topk", activation_fn_kwargs=(("k", 32),))


@pytest.mark.parametrize("case", list(RELU_CASES))
def test_gate_matches_jax(case):
    fields, rows, layers = RELU_CASES[case]
    jc, pc = _gate_cfgs(**fields)
    assert _fused_step_ok(pc, rows, layers) == jax_gate(jc, rows, layers)
    assert not _fused_single_ok(pc, rows)


@pytest.mark.parametrize("fields", [dict(architecture="gated"), TOPK],
                         ids=["gated", "topk"])
def test_gate_raises_for_topk_and_gated(fields):
    """TopK and gated are ported and no longer raise (the name is that of
    the test before them): the port's gate equals the JAX package's at L = 2
    and L = 1, and a 2-layer sweep step runs on their kernels."""
    jc, pc = _gate_cfgs(**fields)
    assert jax_gate(jc, BS, 2)  # the JAX package takes their kernels
    assert _fused_step_ok(pc, BS, 2) == jax_gate(jc, BS, 2)
    assert _fused_single_ok(pc, BS) == jax_single_gate(jc, BS)
    sweep = pc.replace(sweep_layers=(0, 1))
    state = port_sae.init_sweep_state(sweep, 2, device="cpu")
    x = torch.from_numpy(seeded(4, (BS, 2, D_IN)))
    _, m = port_sae.sae_sweep_train_step(state, x, sweep)
    assert torch.isfinite(m.loss).all() and (m.l0 > 0).all()
    if pc.activation_fn_str == "topk":
        assert m.l0.tolist() == [32.0, 32.0]
    else:
        assert (m.aux_reconstruction_loss > 0).all() and (m.l1_loss > 0).all()


# -- the kernel build ------------------------------------------------------------

def _build_copy(tmp_path):
    """The build module and the kernel sources in a temporary tree."""
    pkg = tmp_path / "pkg"
    (pkg / "ops").mkdir(parents=True)
    shutil.copy(PORT_ROOT / "ops" / "_build.py", pkg / "ops" / "_build.py")
    shutil.copytree(PORT_ROOT / "csrc", pkg / "csrc", ignore=shutil.ignore_patterns("build"))
    spec = importlib.util.spec_from_file_location("_build_copy", pkg / "ops" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, pkg / "csrc"


@pytest.mark.parametrize("edited", ["sae_gemm.cuh", "sae_fused_fwd.cu"])
def test_build_dir_changes_when_a_source_or_header_changes(tmp_path, edited):
    build, csrc = _build_copy(tmp_path)
    assert (csrc / "sae_gemm.cuh").exists()
    before = build.build_dir()
    assert before == build.build_dir()
    with open(csrc / edited, "a") as f:
        f.write("\n// edited\n")
    assert build.build_dir() != before


def test_build_compiles_every_source_with_csrc_on_the_include_path(tmp_path, monkeypatch):
    build, csrc = _build_copy(tmp_path)
    seen = []

    def run_all(cmds):
        seen.extend(cmds)
        for c in cmds:  # the link step leaves its library where build() expects it
            if "-shared" in c:
                Path(c[c.index("-o") + 1]).write_bytes(b"")
        return [(0, "")] * len(cmds)
    monkeypatch.setattr(build, "_run_all", run_all)
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    lib = build.build()
    assert lib.exists() and lib.parent == build.build_dir()
    compiles = [c for c in seen if "-c" in c]
    assert sorted(Path(c[-1]).name for c in compiles) == sorted(
        p.name for p in csrc.glob("*.cu"))
    for c in compiles:
        assert c[c.index("-I") + 1] == str(csrc)
