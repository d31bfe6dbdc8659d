"""Gated SAEs in the port against the JAX package: kernels B11 and B12
(their plain versions, which CPU tensors run) through
``sae_gated_fused_apply`` against the JAX package's (Pallas in interpret
mode) and both unfused references; the gated init, ``encode`` and
``sae_forward``; the fused gate; the single-SAE steps (fused through a
stack of one, and generic), the 2-layer sweep step, the module, and the
slice end to end (HookedViT -> activation store -> gated trainer across a
refill).

Shapes are the JAX package's tile-aligned test shapes (d_in 128, d_sae
512, B 256), L = 1 and 2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_prisma_tpu.sae as jax_sae
import vit_prisma_tpu_torch.sae as port_sae
from tests._torch_parity import assert_close, jax_and_port, seeded
from tests.test_torch_sae_train import _assert_states_close, _flat
from tests.test_torch_store import _jax_permutations
from tests.test_torch_sweep import HARVEST_ATOL, STORE, VIT, _metrics_close
from vit_prisma_tpu.ops.sae_step import sae_gated_fused_apply as jax_apply
from vit_prisma_tpu.ops.sae_step import sae_gated_fused_reference as jax_reference
from vit_prisma_tpu.prisma.hooks import HookRuntime as JaxHooks
from vit_prisma_tpu.sae.sae import encode as jax_encode
from vit_prisma_tpu.sae.train import _fused_single_ok as jax_single_gate
from vit_prisma_tpu.sae.train import _fused_step_ok as jax_gate
from vit_prisma_tpu.sae.train import sae_sweep_train_step as jax_sweep_step
from vit_prisma_tpu.sae.train import sae_train_step as jax_step
from vit_prisma_tpu_torch.ops import sae_step
from vit_prisma_tpu_torch.prisma.hooks import HookRuntime
from vit_prisma_tpu_torch.sae.convert import train_state_from_jax, train_state_to_numpy
from vit_prisma_tpu_torch.sae.sae import encode
from vit_prisma_tpu_torch.sae.train import _fused_single_ok, _fused_step_ok

BS, D_IN, D_SAE = 256, 128, 512
CFG = dict(d_in=D_IN, expansion_factor=D_SAE // D_IN, train_batch_size=BS, lr=1e-3,
           lr_scheduler_name="constant", b_dec_init_method="zeros", context_size=5,
           model_name="custom", hook_point_layer=2, architecture="gated",
           l1_coefficient=1e-3)
TOPK = dict(activation_fn_str="topk", activation_fn_kwargs=(("k", 32),))
GRAD_NAMES = ("dW_enc", "db_gate", "dr_mag", "db_mag", "dW_dec", "db_dec")


def _cfgs(**fields):
    fields = {**CFG, **fields}
    return jax_sae.SAERunnerConfig(**fields), port_sae.SAERunnerConfig(**fields)


def _tensors(L, seed=0):
    """x, W_enc, b_gate, r_mag, b_mag, W_dec, b_dec at the scales of the JAX
    package's gated kernel test (tests/test_fused_step.py:297-306)."""
    return (seeded(seed, (L, BS, D_IN)), seeded(seed + 1, (L, D_IN, D_SAE), 0.05),
            seeded(seed + 2, (L, D_SAE), 0.01), seeded(seed + 3, (L, D_SAE), 0.1),
            seeded(seed + 4, (L, D_SAE), 0.01), seeded(seed + 5, (L, D_SAE, D_IN), 0.05),
            seeded(seed + 6, (L, D_IN), 0.01))


# The JAX package's gated test loss (tests/test_fused_step.py:325-342):
# mse + weighted l1 + aux (via against x - b_dec), so every cotangent and
# both b_dec paths are live.
def _loss_jax(fn, arrays, dtype):
    x, *params = (jnp.asarray(a, dtype) for a in arrays)

    def loss(*p):
        y, via, l1, _ = fn(x, *p)
        sae_in = x - p[-1][:, None, :]
        return (jnp.square(y - x).mean() + 1e-3 * l1.sum() / BS
                + jnp.square(via - sae_in).sum(-1).mean())
    return fn(x, *params), jax.grad(loss, argnums=tuple(range(6)))(*params)


def _loss_port(fn, arrays, dtype):
    x, *params = (torch.from_numpy(a).to(dtype) for a in arrays)
    params = [p.requires_grad_(True) for p in params]
    y, via, l1, nact = fn(x, *params)
    sae_in = x - params[-1][:, None, :]
    loss = (torch.square(y - x).mean() + 1e-3 * l1.sum() / BS
            + torch.square(via - sae_in).sum(-1).mean())
    return (y.detach(), via.detach(), l1.detach(), nact), torch.autograd.grad(loss, params)


# The JAX package's own bounds for its gated kernel against its reference
# (tests/test_fused_step.py:318, :338): values within 1e-5 in float32 and
# 2e-2 in bfloat16 (sums in other orders; bf16 y rounds one ulp apart),
# grads within 2e-4 and 3e-2.  The masks, so nact, are equal: hg and hm are
# rounded to c before any compare in both packages.
TOL = {"float32": dict(value=1e-5, grad=2e-4), "bfloat16": dict(value=2e-2, grad=3e-2)}


@pytest.mark.parametrize("L", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gated_apply_matches_jax(dtype, L):
    """B11's plain version (values) and B12's (grads through autograd)
    against the JAX package's ``sae_gated_fused_apply`` and its values
    against ``sae_gated_fused_reference``."""
    arrays, tol = _tensors(L), TOL[dtype]
    jout, jg = _loss_jax(jax_apply, arrays, jnp.dtype(dtype))
    jref = jax_reference(*(jnp.asarray(a, jnp.dtype(dtype)) for a in arrays))
    counts = lambda: (sae_step.sae_gated_fused_forward.launches,
                      sae_step.sae_gated_fused_backward.launches)
    before = counts()
    pout, pg = _loss_port(sae_step.sae_gated_fused_apply, arrays, getattr(torch, dtype))
    assert counts() == before  # CPU tensors run the plain versions
    py, pvia, pl1, pn = pout
    assert py.dtype == pvia.dtype == getattr(torch, dtype)
    assert pl1.dtype == pn.dtype == torch.float32 and tuple(pn.shape) == (L, D_SAE)
    for want in (jout, jref):
        assert_close(want[0], py, tol["value"], "y")
        assert_close(want[1], pvia, tol["value"], "via")
        np.testing.assert_allclose(pl1.numpy(), np.asarray(want[2]), rtol=tol["value"],
                                   err_msg="l1")
        np.testing.assert_array_equal(pn.numpy(), np.asarray(want[3]))
    assert 0 < pn.sum() < L * BS * D_SAE
    for a, b, name in zip(jg, pg, GRAD_NAMES):
        assert b.dtype == getattr(torch, dtype), name
        np.testing.assert_allclose(b.float().numpy(), np.asarray(a, np.float32), rtol=tol["grad"],
                                   atol=tol["grad"], err_msg=name)


def test_gated_apply_matches_both_unfused_references():
    """Against the port's ``sae_gated_fused_reference`` (autograd through
    einsums) and the JAX package's, float32: values within 1e-5, grads
    within 1e-5 of each tensor's largest."""
    arrays = _tensors(2, seed=7)
    (fy, fvia, fl1, fn), fg = _loss_port(sae_step.sae_gated_fused_apply, arrays, torch.float32)
    (ry, rvia, rl1, rn), rg = _loss_port(sae_step.sae_gated_fused_reference, arrays,
                                         torch.float32)
    (jy, jvia, jl1, jn), _ = _loss_jax(jax_reference, arrays, jnp.float32)
    for want in ((ry, rvia, rl1, rn), (jy, jvia, jl1, jn)):
        assert_close(want[0], fy, 1e-5, "y")
        assert_close(want[1], fvia, 1e-5, "via")
        np.testing.assert_allclose(fl1.numpy(), np.asarray(want[2]), rtol=1e-5)
        np.testing.assert_array_equal(fn.numpy(), np.asarray(want[3]))
    for a, b, name in zip(rg, fg, GRAD_NAMES):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                   atol=1e-5 * a.abs().max().item(), err_msg=name)


def test_gated_plain_backward_reads_the_forward_masks():
    """B12's plain version against autograd through B11's plain version
    (the kernels' two cast points agree): dr_mag multiplies by the
    unrounded product g, db_gate and db_mag are the row sums of dhg and
    dhm, and a None cotangent counts as zero."""
    x, We, bg, rm, bm, Wd, bd = (torch.from_numpy(a) for a in _tensors(2, seed=3))
    dy = torch.from_numpy(seeded(11, (2, BS, D_IN), 0.1))
    dvia = torch.from_numpy(seeded(12, (2, BS, D_IN), 0.1))
    dl1 = torch.tensor([1e-3, 3e-3])
    got = sae_step.sae_gated_fused_backward(x, We, bg, rm, bm, Wd, bd, dy, dvia, dl1)
    leaves = [t.clone().requires_grad_(True) for t in (We, bg, rm, bm, Wd)]
    y, via, l1, _ = sae_step.sae_gated_fused_reference(x, *leaves, bd)
    want = torch.autograd.grad((y, via, l1), leaves, (dy, dvia, dl1))
    for a, b, name in zip(got, (want[0], want[4], want[1], want[3], want[2]),
                          ("dW_enc", "dW_dec", "db_gate", "db_mag", "dr_mag")):
        assert a.dtype == torch.float32, name
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-5 * b.abs().max().item(), err_msg=name)
    # only the via cotangent: the y and l1 terms vanish
    params = [t.clone().requires_grad_(True) for t in (We, bg, rm, bm, Wd, bd)]
    _, via, _, _ = sae_step.sae_gated_fused_apply(x, *params)
    g_via = torch.autograd.grad(via, params, dvia)
    zero = sae_step.sae_gated_fused_backward(x, We, bg, rm, bm, Wd, bd, torch.zeros_like(dy),
                                             dvia, torch.zeros(2))
    torch.testing.assert_close(g_via[0], zero[0])
    torch.testing.assert_close(g_via[4], zero[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gated_forward_save_h_holds_the_masks(dtype):
    """B11 with ``save_h`` also returns h and hga in c: positive exactly on
    the magnitude and gate masks, which nact counts and the decoders read."""
    x, We, bg, rm, bm, Wd, bd = (torch.from_numpy(a).to(getattr(torch, dtype))
                                 for a in _tensors(2, seed=5))
    args = (x, We, bg, rm, bm, Wd, bd)
    y, via, l1, nact, hc, hgac = sae_step.sae_gated_fused_forward(*args, save_h=True)
    assert all(torch.equal(a, b) for a, b in zip((y, via, l1, nact),
                                                 sae_step.sae_gated_fused_forward(*args)))
    assert hc.dtype == hgac.dtype == x.dtype and tuple(hc.shape) == (2, BS, D_SAE)
    assert torch.equal(nact, (hc > 0).sum(dim=1, dtype=torch.float32))
    assert not ((hc > 0) & ~(hgac > 0)).any()  # the gate closes the magnitude path
    wdn = torch.linalg.norm(Wd.float(), dim=-1)
    torch.testing.assert_close(l1, (hgac.float() * wdn[:, None]).sum(dim=(1, 2)))
    dec = lambda h: (bd.float()[:, None] + h.float() @ Wd.float()).to(x.dtype)
    assert torch.equal(y, dec(hc)) and torch.equal(via, dec(hgac))


def test_gated_reference_matches_sae_forward():
    """The port's unfused twin against the port's generic gated forward, as
    the JAX package's test_gated_reference_matches_sae_forward."""
    x, We, bg, rm, bm, Wd, bd = (torch.from_numpy(a) for a in _tensors(1))
    _, pc = _cfgs()
    params = {"W_enc": We[0], "W_dec": Wd[0], "b_gate": bg[0], "r_mag": rm[0], "b_mag": bm[0],
              "b_enc": torch.zeros(D_SAE), "b_dec": bd[0]}
    out = port_sae.sae_forward(params, pc, x[0], training=False)
    y, via, l1, nact = sae_step.sae_gated_fused_reference(x, We, bg, rm, bm, Wd, bd)
    torch.testing.assert_close(y[0], out.sae_out, rtol=1e-5, atol=1e-5)
    aux = torch.square(via[0] - (x[0] - bd[0])).sum(-1).mean()
    torch.testing.assert_close(aux, out.aux_reconstruction_loss, rtol=1e-4, atol=0)
    torch.testing.assert_close(pc.l1_coefficient * l1[0] / BS, out.l1_loss, rtol=1e-4, atol=0)
    assert torch.equal(nact[0], (out.feature_acts > 0).sum(0, dtype=torch.float32))


def test_gated_kernel_wrappers_refuse_bad_inputs():
    x, We, bg, rm, bm, Wd, bd = (torch.from_numpy(a) for a in _tensors(1))
    with pytest.raises(ValueError, match="zero gradient for x"):
        sae_step.sae_gated_fused_apply(x.requires_grad_(True), We, bg, rm, bm, Wd, bd)
    with pytest.raises(ValueError, match="b_gate"):
        sae_step.sae_gated_fused_forward(x.detach(), We, bg[0], rm, bm, Wd, bd)
    with pytest.raises(ValueError, match="expected torch.float32"):
        sae_step.sae_gated_fused_backward(x.detach(), We, bg, rm, bm, Wd, bd, x.detach(),
                                          x.detach(), torch.zeros(1, dtype=torch.float64))


# -- the SAE: init, encode, forward ------------------------------------------------

def _jax_params(jc, seed=0):
    """The JAX gated init with seeded biases (b_enc stays 0: no loss reads
    it)."""
    params = dict(jax_sae.init_sae_params(jc, jax.random.PRNGKey(seed)))
    for i, k in enumerate(("b_gate", "r_mag", "b_mag")):
        params[k] = jnp.asarray(seeded(seed + 10 + i, (jc.d_sae,), 0.05))
    params["b_dec"] = jnp.asarray(seeded(seed + 1, (jc.d_in,), 0.2))
    return params


def test_gated_init_matches_jax_layout():
    jc, pc = _cfgs()
    want = jax_sae.init_sae_params(jc, jax.random.PRNGKey(0))
    got = port_sae.init_sae_params(pc, torch.Generator().manual_seed(0), device="cpu")
    assert list(got) == list(want) == ["W_enc", "W_dec", "b_gate", "r_mag", "b_mag", "b_enc",
                                       "b_dec"]
    for k in want:
        assert tuple(got[k].shape) == want[k].shape and got[k].dtype == torch.float32, k
        if k.startswith("b_") or k == "r_mag":
            assert not got[k].any(), k
    # Kaiming-uniform without unit rows: within the bound, rows of no fixed norm
    for k, fan_in in (("W_enc", D_SAE), ("W_dec", D_IN)):
        assert float(got[k].abs().max()) <= fan_in ** -0.5
        assert float(np.abs(want[k]).max()) <= fan_in ** -0.5
    assert float(torch.linalg.norm(got["W_dec"], dim=-1).std()) > 1e-3
    sae = port_sae.SparseAutoencoder(pc, device="cpu")
    assert [n for n, _ in sae.named_parameters()] == list(want)


@pytest.mark.parametrize("fields", [{}, TOPK], ids=["relu", "topk"])
def test_gated_encode_and_forward_match_jax(fields):
    """``encode`` (its hooks: sae_in and hidden_post, no hidden_pre),
    every field of ``sae_forward`` and the loss's grads against the JAX
    package's gated SAE; TopK through the threshold mask, which equals
    ``lax.top_k`` on float32 data without ties."""
    jc, pc = _cfgs(**fields)
    jparams = _jax_params(jc, seed=2)
    pparams = port_sae.sae_params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    x = seeded(7, (64, D_IN), 2.0)
    jhooks, phooks = JaxHooks(lambda n: True), HookRuntime(lambda n: True)
    jenc = jax_encode(jparams, jc, jnp.asarray(x), jhooks)
    penc = encode(pparams, pc, torch.from_numpy(x), phooks)
    assert list(phooks.cache) == list(jhooks.cache) == ["hook_sae_in", "hook_hidden_post"]
    for name in jhooks.cache:
        assert_close(jhooks.cache[name], phooks.cache[name], 1e-5, name)
    for a, b, name in zip(jenc[:3], penc[:3], ("sae_in", "feature_acts", "gate_pre")):
        assert_close(a, b, 1e-5, name)
    if fields:
        assert ((penc[1] > 0).sum(-1) <= 32).all()
    jout = jax_sae.sae_forward(jparams, jc, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_(True) for k, v in pparams.items()}
    pout = port_sae.sae_forward(leaves, pc, torch.from_numpy(x))
    for field in jout._fields:
        want, got = getattr(jout, field), getattr(pout, field)
        scale = max(1.0, float(np.abs(np.asarray(want)).max()))
        assert_close(want, got.detach(), 1e-5 * scale, field)
    assert float(pout.aux_reconstruction_loss.detach()) > 0
    assert (float(pout.l1_loss.detach()) == 0.0) == bool(fields)
    jgrads = jax.grad(lambda p: jax_sae.sae_forward(p, jc, jnp.asarray(x)).loss)(jparams)
    pgrads = torch.autograd.grad(pout.loss, list(leaves.values()), allow_unused=True,
                                 materialize_grads=True)
    for k, g in zip(leaves, pgrads):
        assert_close(jgrads[k], g, 1e-5 * max(1.0, float(np.abs(jgrads[k]).max())), k)
    assert not pgrads[list(leaves).index("b_enc")].any()


def test_gated_sae_module_matches_jax():
    jc, pc = _cfgs()
    jparams = _jax_params(jc, seed=4)
    sae = port_sae.SparseAutoencoder(pc, params=port_sae.sae_params_from_jax(
        jax.tree.map(np.asarray, jparams), device="cpu"))
    want = jax_sae.SparseAutoencoder(jc, params=jparams)
    x = seeded(8, (32, D_IN))
    assert_close(want.encode(jnp.asarray(x)), sae.encode(torch.from_numpy(x)), 1e-5, "encode")
    assert_close(want.reconstruct(jnp.asarray(x)), sae.reconstruct(torch.from_numpy(x)),
                 1e-5, "reconstruct")
    loss = want(jnp.asarray(x)).loss
    assert_close(loss, sae(torch.from_numpy(x)).loss, 1e-5 * float(loss), "loss")


# -- the gate -------------------------------------------------------------------

# The gated cases of the JAX package's tests/test_fused_step.py:38-62, plus
# L = 1, bf16 compute, the knob and unaligned shapes.
GATE_CASES = {
    "sweep": ({}, BS, 2),
    "single_sae": ({}, BS, 1),
    "bf16_compute": (dict(compute_dtype="bfloat16"), BS, 24),
    "topk": (TOPK, BS, 2),
    "topk_single": (TOPK, BS, 1),
    "knob_off": (dict(fused_sae_step=False), BS, 1),
    "ghost_grads": (dict(use_ghost_grads=True), BS, 2),
    "unaligned_rows": ({}, BS + 1, 1),
    "unaligned_d_in": (dict(d_in=96), BS, 2),
}


@pytest.mark.parametrize("case", list(GATE_CASES))
def test_gated_gate_matches_jax(case):
    fields, rows, layers = GATE_CASES[case]
    jc, pc = _cfgs(**fields)
    assert _fused_step_ok(pc, rows, layers) == jax_gate(jc, rows, layers)
    assert _fused_single_ok(pc, rows) == jax_single_gate(jc, rows)


# -- the steps ------------------------------------------------------------------

def _jax_state(jc, seed=0):
    return jax_sae.init_train_state(jc, params=_jax_params(jc, seed))


def _port(jax_state):
    return train_state_from_jax(jax.tree.map(np.asarray, jax_state), device="cpu")


def _batches(n, seed=20, shape=(BS, D_IN)):
    return [seeded(seed + i, shape, 1.5) + 0.3 for i in range(n)]


def _assert_b_enc_untouched(flat):
    for k in ("params/b_enc", "mu/b_enc", "nu/b_enc"):
        assert not np.any(flat[k]), k


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "generic"])
def test_gated_steps_match_jax(fused):
    """Three single-SAE steps from a JAX state: fused (a stack of one through
    B11 and B12) or generic (``sae_forward`` and autograd).  float32 sums in
    other orders: state within 1e-5, metrics within 1e-5 relative, counters
    exact; b_enc and its moments stay 0 in both packages."""
    jc, pc = _cfgs(fused_sae_step=fused)
    assert _fused_single_ok(pc, BS) == fused == jax_single_gate(jc, BS)
    jstate = _jax_state(jc)
    pstate = _port(jstate)
    for b in _batches(3):
        jstate, jm = jax_step(jstate, jnp.asarray(b), jc)
        pstate, pm = port_sae.sae_train_step(pstate, torch.from_numpy(b), pc)
        for field in jm._fields:
            assert tuple(getattr(pm, field).shape) == (), field
        _metrics_close(jm, pm, atol=1e-6, rel=1e-5)
        assert float(pm.l1_loss) > 0 and float(pm.aux_reconstruction_loss) > 0
    want, got = _flat(jstate), train_state_to_numpy(pstate)
    _assert_states_close(want, got, atol=1e-5)
    _assert_b_enc_untouched(want)
    _assert_b_enc_untouched(got)


def test_gated_fused_and_generic_agree():
    """The port's fused single step against its generic step, within the
    JAX package's test_gated_fused_single_step_matches_generic bounds:
    counters equal, params rtol 1e-4 atol 2e-5, metrics rtol 2e-4."""
    jc, pc = _cfgs()
    states, metrics = {}, {}
    for fused in (True, False):
        s, ms = _port(_jax_state(jc, seed=2)), []
        for b in _batches(3, seed=30):
            s, m = port_sae.sae_train_step(s, torch.from_numpy(b),
                                           pc.replace(fused_sae_step=fused))
            ms.append(m)
        states[fused], metrics[fused] = train_state_to_numpy(s), ms
    for k in ("act_freq_scores", "n_forward_passes_since_fired"):
        np.testing.assert_array_equal(states[True][k], states[False][k], err_msg=k)
    for k in states[True]:
        if k.startswith("params/"):
            np.testing.assert_allclose(states[True][k], states[False][k], rtol=1e-4,
                                       atol=2e-5, err_msg=k)
    for mf, mg in zip(metrics[True], metrics[False]):
        for field in ("loss", "mse_loss", "l1_loss", "aux_reconstruction_loss", "l0",
                      "explained_variance"):
            np.testing.assert_allclose(float(getattr(mf, field)), float(getattr(mg, field)),
                                       rtol=2e-4, atol=1e-6, err_msg=field)


def test_gated_topk_generic_steps_match_jax():
    """Gated + TopK takes the generic step in both packages: three steps,
    state within 1e-5, the gate-path L1 reads 0."""
    jc, pc = _cfgs(**TOPK)
    assert not _fused_single_ok(pc, BS)
    jstate = _jax_state(jc, seed=6)
    pstate = _port(jstate)
    for b in _batches(3, seed=35):
        jstate, jm = jax_step(jstate, jnp.asarray(b), jc)
        pstate, pm = port_sae.sae_train_step(pstate, torch.from_numpy(b), pc)
        _metrics_close(jm, pm, atol=1e-6, rel=1e-5)
        assert float(pm.l1_loss) == 0.0
    _assert_states_close(_flat(jstate), train_state_to_numpy(pstate), atol=1e-5)


def test_gated_sweep_steps_match_jax():
    """The gated sweep at L = 2 takes B11 and B12 in both packages (the JAX
    package's test_gated_fused_sweep_step_matches_generic shape): two
    steps, state within 1e-5, counters exact."""
    jc, pc = _cfgs(sweep_layers=(0, 2))
    assert _fused_step_ok(pc, BS, 2) and jax_gate(jc, BS, 2)
    jstate = jax_sae.init_sweep_state(jc, 2, key=jax.random.PRNGKey(4))
    params = dict(jstate.params)
    for i, k in enumerate(("b_gate", "r_mag", "b_mag", "b_dec")):
        params[k] = jnp.asarray(seeded(40 + i, params[k].shape, 0.05))
    jstate = jstate._replace(params=params)
    pstate = _port(jstate)
    for b in _batches(2, seed=50, shape=(BS, 2, D_IN)):
        jstate, jm = jax_sweep_step(jstate, jnp.asarray(b), jc)
        pstate, pm = port_sae.sae_sweep_train_step(pstate, torch.from_numpy(b), pc)
        assert pm.aux_reconstruction_loss.shape == (2,)
        _metrics_close(jm, pm, atol=1e-6, rel=1e-5)
    want, got = _flat(jstate), train_state_to_numpy(pstate)
    _assert_states_close(want, got, atol=1e-5)
    _assert_b_enc_untouched(got)


def test_gated_slice_end_to_end_matches_jax():
    """HookedViT -> activation store -> gated trainer in both packages, 5
    fused single-SAE steps across one refill, with the JAX store's
    permutations replayed."""
    jc, pc = _cfgs(b_dec_init_method="mean", wandb_log_frequency=2, **STORE)
    jax_model, port_model = jax_and_port(**VIT)
    images = seeded(9, (64, 3, 16, 16))
    perms = iter(_jax_permutations(pc.seed, pc.tokens_per_buffer, 3))
    jstore = jax_sae.VisionActivationsStore(jc, jax_model, images, prefetch=False)
    pstore = port_sae.VisionActivationsStore(pc, port_model, images,
                                             permutation=lambda n: next(perms))
    jtr = jax_sae.VisionSAETrainer(jc, jax_model, jstore)
    ptr = port_sae.VisionSAETrainer(pc, port_model, pstore)
    assert list(ptr.state.params) == list(jtr.state.params)
    assert_close(jtr.state.params["b_dec"], ptr.state.params["b_dec"], HARVEST_ATOL, "b_dec")
    ptr.load_state(_port(jtr.state))
    launches = sae_step.sae_gated_fused_forward.launches
    jtr.run(max_steps=5)
    sae = ptr.run(max_steps=5)
    assert sae_step.sae_gated_fused_forward.launches == launches  # plain versions on the CPU
    assert isinstance(sae, port_sae.SparseAutoencoder) and sae.cfg.architecture == "gated"
    assert pstore.ptr == jstore.ptr == 256  # refilled at step 3, one step served
    # The rows differ by the harvest's 1e-4, so the grads by about that
    # relative amount: 5 Adam steps at lr 1e-3 stay within 1e-4 unless a
    # gradient sign flips (2 lr).
    got, want = train_state_to_numpy(ptr.state), _flat(jtr.state)
    _assert_states_close(want, got, atol=1e-4, exact_counters=False)
    for k in ("adam_count", "schedule_count", "step", "n_training_tokens",
              "n_frac_active_tokens"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    _assert_b_enc_untouched(got)
    # a count changes only where a pre-activation lies within the harvest
    # difference of 0
    assert np.abs(got["act_freq_scores"] - want["act_freq_scores"]).sum() <= 4
