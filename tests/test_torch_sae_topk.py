"""TopK SAEs in the port against the JAX package: kernels B8 and B9 (their
plain versions, which CPU tensors run) and B6 on B8's masked h against the
JAX package's ``sae_fused_apply_topk`` (Pallas in interpret mode); the
fused gate; the single-SAE step (fused through a stack of one, and generic),
the multi-step loop, the 2-layer sweep step, the trainer; the TopK
``SparseAutoencoder``; and the slice end to end (HookedViT -> activation
store -> TopK trainer across a refill).

Shapes are the JAX package's tile-aligned test shapes (d_in 128, d_sae
512, B 256), k = 32, L = 1 and 2."""

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
from vit_prisma_tpu.ops.sae_step import sae_fused_apply_topk as jax_apply
from vit_prisma_tpu.ops.sae_step import sae_fused_topk_reference as jax_reference
from vit_prisma_tpu.sae.train import _fused_single_ok as jax_single_gate
from vit_prisma_tpu.sae.train import _fused_step_ok as jax_gate
from vit_prisma_tpu.sae.train import sae_sweep_train_multistep as jax_sweep_multistep
from vit_prisma_tpu.sae.train import sae_sweep_train_step as jax_sweep_step
from vit_prisma_tpu.sae.train import sae_train_multistep as jax_multistep
from vit_prisma_tpu.sae.train import sae_train_step as jax_step
from vit_prisma_tpu_torch.ops import sae_step
from vit_prisma_tpu_torch.sae.convert import train_state_from_jax, train_state_to_numpy
from vit_prisma_tpu_torch.sae.train import _fused_single_ok, _fused_step_ok

BS, D_IN, D_SAE, K = 256, 128, 512, 32
CFG = dict(d_in=D_IN, expansion_factor=D_SAE // D_IN, train_batch_size=BS, lr=1e-3,
           lr_scheduler_name="constant", b_dec_init_method="zeros", context_size=5,
           model_name="custom", hook_point_layer=2, activation_fn_str="topk",
           activation_fn_kwargs=(("k", K),))


def _cfgs(**fields):
    fields = {**CFG, **fields}
    return jax_sae.SAERunnerConfig(**fields), port_sae.SAERunnerConfig(**fields)


def _tensors(L, seed=0):
    """x ~ N(0, 1) and small weights, as the JAX package's kernel test."""
    return (seeded(seed, (L, BS, D_IN)), seeded(seed + 1, (L, D_IN, D_SAE), 0.05),
            seeded(seed + 2, (L, D_SAE), 0.01), seeded(seed + 3, (L, D_SAE, D_IN), 0.05),
            seeded(seed + 4, (L, D_IN), 0.01))


def _loss_jax(fn, arrays, dtype):
    x, *params = (jnp.asarray(a, dtype) for a in arrays)

    def loss(*p):
        y, l1, _ = fn(x, *p)
        return (jnp.square(y.astype(jnp.float32) - x.astype(jnp.float32)).mean()
                + 1e-3 * l1.sum() / BS)
    return fn(x, *params), jax.grad(loss, argnums=(0, 1, 2, 3))(*params)


def _loss_port(fn, arrays, dtype):
    x, *params = (torch.from_numpy(a).to(dtype) for a in arrays)
    params = [p.requires_grad_(True) for p in params]
    y, l1, nact = fn(x, *params)
    loss = torch.square(y.float() - x.float()).mean() + 1e-3 * l1.sum() / BS
    return (y.detach(), l1.detach(), nact), torch.autograd.grad(loss, params)


# float32: sums in another order than XLA's, so y within 1e-5, l1 within
# 1e-5 relative, the grads within 1e-5 of each tensor's largest JAX
# gradient.  bfloat16: y rounds to bf16 after sums in other orders (2e-2,
# the JAX package's bf16 kernel bound), l1 within 2e-2 relative, grads one
# bf16 ulp of the largest apart at most (1e-2 of it).  The masks, so nact,
# are equal: hp is rounded to c before the threshold in both packages.
TOL = {"float32": dict(y=1e-5, l1=1e-5, grad=1e-5),
       "bfloat16": dict(y=2e-2, l1=2e-2, grad=1e-2)}


@pytest.mark.parametrize("L", [1, 2])
@pytest.mark.parametrize("dtype,save_acts", [("float32", False), ("float32", True),
                                             ("bfloat16", False), ("bfloat16", True)])
def test_fused_apply_topk_matches_jax(dtype, save_acts, L):
    arrays, tol = _tensors(L), TOL[dtype]
    (jy, jl1, jn), jg = _loss_jax(lambda *a: jax_apply(*a, k=K, save_acts=save_acts), arrays,
                                  jnp.dtype(dtype))
    counts = lambda: (sae_step.sae_fused_forward_topk.launches,
                      sae_step.sae_fused_backward_topk.launches,
                      sae_step.sae_fused_backward_stored.launches)
    before = counts()
    (py, pl1, pn), pg = _loss_port(
        lambda *a: sae_step.sae_fused_apply_topk(*a, k=K, save_acts=save_acts), arrays,
        getattr(torch, dtype))
    assert counts() == before  # CPU tensors run the plain versions
    assert py.dtype == getattr(torch, dtype) and pl1.dtype == pn.dtype == torch.float32
    assert_close(jy, py, tol["y"], "y")
    np.testing.assert_allclose(pl1.numpy(), np.asarray(jl1), rtol=tol["l1"], err_msg="l1")
    np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))
    assert (pn.sum(-1) >= K * BS).all()  # ties keep more than k
    for a, b, name in zip(jg, pg, ["dW_enc", "db_enc", "dW_dec", "db_dec"]):
        want = np.asarray(a, np.float32)
        np.testing.assert_allclose(b.float().numpy(), want, rtol=0,
                                   atol=tol["grad"] * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_topk_plain_outputs(dtype):
    """B8's plain version returns the thresholds and the masked h the
    backward kernels read: t is the k-th largest of relu(hp) per row, h is
    hp where hp >= t and > 0, and B9 from t equals B6 from h bit for bit."""
    x, We, be, Wd, bd = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in _tensors(2, 5))
    y, l1, nact, t, h = sae_step.sae_fused_forward_topk(x, We, be, Wd, bd, K, save_h=True)
    assert torch.equal(y, sae_step.sae_fused_forward_topk(x, We, be, Wd, bd, K)[0])
    assert t.shape == (2, BS, 1) and t.dtype == torch.float32 and h.dtype == x.dtype
    hp = ((x - bd[:, None]).float() @ We.float() + be.float()[:, None]).to(x.dtype).float()
    want_t = torch.topk(hp, K, dim=-1).values[..., -1:].clamp_min(0)
    assert torch.equal(t, want_t)
    assert torch.equal(h.float() > 0, (hp >= t) & (hp > 0))
    assert torch.equal(nact, (h.float() > 0).sum(1, dtype=torch.float32))
    torch.testing.assert_close(l1, h.float().sum(dim=(1, 2)))
    dy = torch.from_numpy(seeded(9, (2, BS, D_IN), 0.1)).to(x.dtype)
    dl1 = torch.tensor([1e-3, 2e-3])
    remat = sae_step.sae_fused_backward_topk(x, We, be, Wd, bd, dy, dl1, t)
    stored = sae_step.sae_fused_backward_stored(x, h, Wd, bd, dy, dl1)
    for a, b, name in zip(remat, stored, ["dW_enc", "dW_dec", "db_enc"]):
        assert a.dtype == torch.float32 and torch.equal(a, b), name


def test_fused_apply_topk_matches_both_unfused_references():
    """Against the port's ``sae_fused_topk_reference`` (autograd through
    einsums, threshold from torch.topk) and the JAX package's."""
    arrays = _tensors(2, seed=7)
    (fy, fl1, fn), fg = _loss_port(lambda *a: sae_step.sae_fused_apply_topk(*a, k=K),
                                   arrays, torch.float32)
    (ry, rl1, rn), rg = _loss_port(lambda *a: sae_step.sae_fused_topk_reference(*a, K),
                                   arrays, torch.float32)
    (jy, jl1, jn), _ = _loss_jax(lambda *a: jax_reference(*a, K), arrays, jnp.float32)
    for want in ((ry, rl1, rn), (jy, jl1, jn)):
        assert_close(want[0], fy, 1e-5, "y")
        np.testing.assert_allclose(fl1.numpy(), np.asarray(want[1]), rtol=1e-5)
        np.testing.assert_array_equal(fn.numpy(), np.asarray(want[2]))
    for a, b, name in zip(rg, fg, ["dW_enc", "db_enc", "dW_dec", "db_dec"]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                   atol=1e-5 * a.abs().max().item(), err_msg=name)


@pytest.mark.parametrize("save_acts,backward", [
    (None, "sae_fused_backward_stored"), (True, "sae_fused_backward_stored"),
    (False, "sae_fused_backward_topk")])
def test_save_acts_picks_the_topk_backward(monkeypatch, save_acts, backward):
    """``save_acts=False`` recomputes from the thresholds (B9); the default
    keeps B8's masked h for B6."""
    called = []
    for name in ("sae_fused_backward_topk", "sae_fused_backward_stored"):
        inner = getattr(sae_step, name)
        monkeypatch.setattr(sae_step, name,
                            lambda *a, name=name, inner=inner: called.append(name) or inner(*a))
    x, *params = (torch.from_numpy(a) for a in _tensors(1))
    params = [p.requires_grad_(True) for p in params]
    y, _, _ = sae_step.sae_fused_apply_topk(x, *params, k=K, save_acts=save_acts)
    torch.autograd.grad(y.sum(), params)
    assert called == [backward]


def test_topk_kernel_wrappers_refuse_bad_inputs():
    x, We, be, Wd, bd = (torch.from_numpy(a) for a in _tensors(1))
    with pytest.raises(ValueError, match="outside"):
        sae_step.sae_fused_forward_topk(x, We, be, Wd, bd, D_SAE + 1)
    with pytest.raises(ValueError, match="zero gradient for x"):
        sae_step.sae_fused_apply_topk(x.requires_grad_(True), We, be, Wd, bd, k=K)
    with pytest.raises(ValueError, match="expected float32"):
        sae_step.sae_fused_backward_topk(x.detach(), We, be, Wd, bd, x.detach(),
                                         torch.zeros(1), torch.zeros(1, BS))


# -- the gate ------------------------------------------------------------------

# The TopK cases of the JAX package's tests/test_fused_step.py:38-62, plus
# bf16 compute, k = d_sae and unaligned shapes.
GATE_CASES = {
    "sweep": ({}, BS, 2),
    "single_sae": ({}, BS, 1),
    "bf16_compute": (dict(compute_dtype="bfloat16"), BS, 24),
    "approx": (dict(topk_use_approx=True), BS, 2),
    "k_is_d_sae": (dict(activation_fn_kwargs=(("k", D_SAE),)), BS, 2),
    "knob_off": (dict(fused_sae_step=False), BS, 1),
    "unaligned_rows": ({}, BS + 1, 1),
    "unaligned_d_in": (dict(d_in=96), BS, 2),
}


@pytest.mark.parametrize("case", list(GATE_CASES))
def test_topk_gate_matches_jax(case):
    fields, rows, layers = GATE_CASES[case]
    jc, pc = _cfgs(**fields)
    assert _fused_step_ok(pc, rows, layers) == jax_gate(jc, rows, layers)
    assert _fused_single_ok(pc, rows) == jax_single_gate(jc, rows)


# -- the single-SAE step ----------------------------------------------------------

def _jax_state(jc, seed=0):
    params = dict(jax_sae.init_sae_params(jc, jax.random.PRNGKey(seed)))
    params["b_dec"] = jnp.asarray(seeded(seed + 1, (jc.d_in,), 0.2))
    return jax_sae.init_train_state(jc, params=params)


def _port(jax_state):
    return train_state_from_jax(jax.tree.map(np.asarray, jax_state), device="cpu")


def _batches(n, seed=20, shape=(BS, D_IN)):
    return [seeded(seed + i, shape, 1.5) + 0.3 for i in range(n)]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "generic"])
def test_topk_steps_match_jax(fused):
    """Three single-SAE steps: fused (a stack of one through B8/B6) or
    generic (the threshold mask, B10).  float32 sums in other orders:
    state within 1e-5, metrics within 1e-5 relative, counters exact (no
    threshold ties in float32 data)."""
    jc, pc = _cfgs(fused_sae_step=fused)
    assert _fused_single_ok(pc, BS) == fused
    jstate = _jax_state(jc)
    pstate = _port(jstate)
    launches = sae_step.sae_fused_forward_topk.launches
    for b in _batches(3):
        jstate, jm = jax_step(jstate, jnp.asarray(b), jc)
        pstate, pm = port_sae.sae_train_step(pstate, torch.from_numpy(b), pc)
        for field in jm._fields:
            assert tuple(getattr(pm, field).shape) == (), field
        _metrics_close(jm, pm, atol=1e-6, rel=1e-5)
        assert float(pm.l1_loss) == 0.0 and float(pm.l0) == K
    assert sae_step.sae_fused_forward_topk.launches == launches
    _assert_states_close(_flat(jstate), train_state_to_numpy(pstate), atol=1e-5)


def test_topk_fused_and_generic_agree():
    """The port's fused single step against its generic step, within the JAX
    package's test_topk_fused_single_step_matches_generic bounds: counters
    equal, params rtol 1e-4 atol 2e-5, metrics rtol 2e-4."""
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
        for field in ("loss", "mse_loss", "l0", "explained_variance"):
            np.testing.assert_allclose(float(getattr(mf, field)), float(getattr(mg, field)),
                                       rtol=2e-4, atol=1e-6, err_msg=field)


def test_topk_multistep_with_window_resets_matches_jax_and_singles():
    jc, pc = _cfgs(feature_sampling_window=2)
    xs = np.stack(_batches(3, seed=40))
    jnew, jm = jax_multistep(_jax_state(jc, seed=3), jnp.asarray(xs), jc)
    start = _port(_jax_state(jc, seed=3))
    pnew, pm = port_sae.sae_train_multistep(start, torch.from_numpy(xs), pc)
    assert pm.loss.shape == (3,)
    _assert_states_close(_flat(jnew), train_state_to_numpy(pnew), atol=1e-5)
    _metrics_close(jm, pm, atol=1e-6, rel=1e-5)
    single = start
    for j, x in enumerate(xs):
        single, _ = port_sae.sae_train_step(single, torch.from_numpy(x), pc)
        if (j + 1) % pc.feature_sampling_window == 0:
            single = port_sae.reset_sparsity_counters(single)
    got, want = train_state_to_numpy(single), train_state_to_numpy(pnew)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# -- the 2-layer sweep ------------------------------------------------------------

def test_topk_sweep_step_and_multistep_match_jax():
    """The TopK sweep at L = 2 takes the fused kernels (B8, B6) in both
    packages: two steps, then a 2-step multistep, state within 1e-5."""
    jc, pc = _cfgs(sweep_layers=(0, 2))
    assert _fused_step_ok(pc, BS, 2)
    jstate = jax_sae.init_sweep_state(jc, 2, key=jax.random.PRNGKey(4))
    pstate = _port(jstate)
    for b in _batches(2, seed=50, shape=(BS, 2, D_IN)):
        jstate, jm = jax_sweep_step(jstate, jnp.asarray(b), jc)
        pstate, pm = port_sae.sae_sweep_train_step(pstate, torch.from_numpy(b), pc)
        _metrics_close(jm, pm, atol=1e-6, rel=1e-5)
    xs = np.stack(_batches(2, seed=60, shape=(BS, 2, D_IN)))
    jstate, jm = jax_sweep_multistep(jstate, jnp.asarray(xs), jc)
    pstate, pm = port_sae.sae_sweep_train_multistep(pstate, torch.from_numpy(xs), pc)
    assert pm.loss.shape == (2, 2)
    _metrics_close(jm, pm, atol=1e-6, rel=1e-5)
    _assert_states_close(_flat(jstate), train_state_to_numpy(pstate), atol=1e-5)


# -- the trainer and the module ----------------------------------------------------

class _FixedStore:
    def __init__(self, batches, to):
        self.batches, self.i, self._to = [to(b) for b in batches], 0, to
        self.device = torch.device("cpu")

    def next_batch(self):
        self.i += 1
        return self.batches[self.i - 1]


def test_topk_trainer_run_matches_jax():
    jc, pc = _cfgs(wandb_log_frequency=1, feature_sampling_window=3)
    batches = _batches(5, seed=70)
    jtr = jax_sae.VisionSAETrainer(jc, store=_FixedStore(batches, jnp.asarray))
    ptr = port_sae.VisionSAETrainer(pc, store=_FixedStore(batches, torch.from_numpy))
    ptr.load_state(_port(jtr.state))
    logs = {"jax": [], "port": []}
    for name, tr in (("jax", jtr), ("port", ptr)):
        inner = tr.log_metrics
        tr.log_metrics = lambda m, step=None, inner=inner, log=logs[name]: \
            log.append(inner(m, step)) or log[-1]
    jtr.run(max_steps=5)
    sae = ptr.run(max_steps=5)
    assert isinstance(sae, port_sae.SparseAutoencoder) and sae.cfg.activation_fn_str == "topk"
    _assert_states_close(_flat(jtr.state), train_state_to_numpy(ptr.state), atol=1e-5)
    assert len(logs["port"]) == len(logs["jax"]) == 5
    for j, p in zip(logs["jax"], logs["port"]):
        assert set(p) == set(j) and p["l1_loss"] == 0.0
        for k in j:
            assert abs(p[k] - j[k]) <= 1e-5 * max(1.0, abs(j[k])), k


def test_topk_sae_module_and_forward_match_jax():
    """encode, reconstruct and the forward's losses (no sparsity loss) and
    grads against the JAX package's TopK SAE, which takes lax.top_k on the
    CPU: the same on float32 data without ties."""
    jc, pc = _cfgs()
    jparams = dict(jax_sae.init_sae_params(jc, jax.random.PRNGKey(5)))
    jparams["b_enc"] = jnp.asarray(seeded(6, (D_SAE,), 0.05))
    pparams = port_sae.sae_params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    x = seeded(7, (64, D_IN), 2.0)
    sae = port_sae.SparseAutoencoder(pc, params=pparams)
    want = jax_sae.SparseAutoencoder(jc, params=jparams)
    feats = sae.encode(torch.from_numpy(x))
    assert_close(want.encode(jnp.asarray(x)), feats, 1e-5, "encode")
    assert ((feats > 0).sum(-1) == K).all()
    assert_close(want.reconstruct(jnp.asarray(x)), sae.reconstruct(torch.from_numpy(x)),
                 1e-5, "reconstruct")
    jout = jax_sae.sae_forward(jparams, jc, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_(True) for k, v in pparams.items()}
    pout = port_sae.sae_forward(leaves, pc, torch.from_numpy(x))
    assert jout.l1_loss is None and pout.l1_loss is None
    for field in ("loss", "mse_loss"):
        assert_close(getattr(jout, field), getattr(pout, field).detach(), 1e-6, field)
    jgrads = jax.grad(lambda p: jax_sae.sae_forward(p, jc, jnp.asarray(x)).loss)(jparams)
    for k, g in zip(leaves, torch.autograd.grad(pout.loss, list(leaves.values()))):
        assert_close(jgrads[k], g, 1e-5 * max(1.0, float(np.abs(jgrads[k]).max())), k)
    # the exact-k activation (fused_topk=False) agrees on untied data
    exact = port_sae.SparseAutoencoder(pc.replace(fused_topk=False), params=pparams)
    assert torch.equal(exact.encode(torch.from_numpy(x)), feats)


# -- the slice end to end ------------------------------------------------------------

def test_topk_slice_end_to_end_matches_jax():
    """HookedViT -> activation store -> TopK trainer in both packages, 5
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
    assert_close(jtr.state.params["b_dec"], ptr.state.params["b_dec"], HARVEST_ATOL, "b_dec")
    ptr.load_state(_port(jtr.state))
    launches = sae_step.sae_fused_forward_topk.launches
    jtr.run(max_steps=5)
    ptr.run(max_steps=5)
    assert sae_step.sae_fused_forward_topk.launches == launches  # plain versions on the CPU
    assert pstore.ptr == jstore.ptr == 256  # refilled at step 3, one step served
    # The rows differ by the harvest's 1e-4, so the grads by about that
    # relative amount: 5 Adam steps at lr 1e-3 stay within 1e-4 unless a
    # gradient sign flips (2 lr).
    got, want = train_state_to_numpy(ptr.state), _flat(jtr.state)
    _assert_states_close(want, got, atol=1e-4, exact_counters=False)
    for k in ("adam_count", "schedule_count", "step", "n_training_tokens",
              "n_frac_active_tokens"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # a count changes only where a pre-activation lies within the harvest
    # difference of its row's k-th value
    assert np.abs(got["act_freq_scores"] - want["act_freq_scores"]).sum() <= 4
