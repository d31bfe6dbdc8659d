"""Kernel B7's plain version and the port's fused clip/projection/Adam pass
against the JAX package's: the Pallas kernel in interpret mode, its XLA twin
``_adam_update_ref``, and ``fused_clip_project_adam`` over several steps
with an optax state.  The CUDA kernel itself is held to the plain version on
the card by ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests._torch_parity import assert_close, seeded
from vit_prisma_tpu.ops.opt_step import _adam_update_kernel, _adam_update_ref
from vit_prisma_tpu.ops.opt_step import fused_clip_project_adam as jax_fused
from vit_prisma_tpu_torch.ops import opt_step as port_ops
from vit_prisma_tpu_torch.sae.convert import sae_params_from_jax

B1, B2, EPS = 0.9, 0.999, 1e-8
MDT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(L, project, seed=0, R=8, C=128):
    p = seeded(seed, (L, R, C))
    if project:
        p /= np.linalg.norm(p, axis=-1, keepdims=True)
    g = seeded(seed + 1, (L, R, C), 0.1)
    mu = seeded(seed + 2, (L, R, C), 0.01)
    nu = np.abs(seeded(seed + 3, (L, R, C), 0.01))
    scal = np.array([[0.7, 1e-3, 1.1, 1.05], [1.0, 2e-3, 1.2, 1.1]], np.float32)[:L]
    return p, g, mu, nu, scal


def _to_port(a, tdt=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(tdt)


@pytest.mark.parametrize("L", [1, 2])
@pytest.mark.parametrize("mdt", list(MDT))
@pytest.mark.parametrize("project", [True, False])
def test_adam_update_plain_version_matches_jax_kernel(project, mdt, L):
    jdt, tdt = MDT[mdt]
    p, g, mu, nu, scal = _inputs(L, project, seed=L)
    jin = (jnp.asarray(p), jnp.asarray(g), jnp.asarray(mu).astype(jdt),
           jnp.asarray(nu).astype(jdt), jnp.asarray(scal))
    kw = dict(b1=B1, b2=B2, eps=EPS, project=project)
    want_kernel = _adam_update_kernel(*jin, **kw)  # Pallas, interpret mode
    want_ref = _adam_update_ref(*jin, **kw)
    pin = (_to_port(p), _to_port(g), _to_port(jin[2], tdt), _to_port(jin[3], tdt),
           _to_port(scal))
    before = port_ops.adam_update.launches
    got = port_ops.adam_update(*pin, **kw)
    assert port_ops.adam_update.launches == before  # CPU: plain version
    for a, b in zip(got, port_ops.adam_update_reference(*pin, **kw)):
        assert torch.equal(a, b)
    # Every elementwise operation is one correctly rounded float32 op on
    # both sides; the projection's row dot is summed in another order.
    # bfloat16 moments may then round one bf16 ulp (2^-8 relative) apart.
    for want in (want_kernel, want_ref):
        for w, t, name in zip(want, got, ("p", "mu", "nu")):
            assert t.dtype == (torch.float32 if name == "p" else tdt), name
            w = np.asarray(w, np.float32)
            tol = 1e-6 if (name == "p" or mdt == "float32") else \
                2.0 ** -8 * float(np.abs(w).max())
            assert_close(w, t, tol, f"{name} ({mdt}, project={project})")


def test_adam_update_checks_its_inputs():
    p, g, mu, nu, scal = (torch.from_numpy(a) for a in _inputs(1, False))
    with pytest.raises(TypeError, match="mu and nu"):
        port_ops.adam_update(p, g, mu, nu.bfloat16(), scal, b1=B1, b2=B2, eps=EPS,
                             project=False)
    with pytest.raises(ValueError, match="scal"):
        port_ops.adam_update(p, g, mu, nu, scal[:, :3], b1=B1, b2=B2, eps=EPS,
                             project=False)
    with pytest.raises(ValueError, match="shape"):
        port_ops.adam_update(p[0], g[0], mu[0], nu[0], scal, b1=B1, b2=B2, eps=EPS,
                             project=False)


def _sae_tree(seed, L=1, d_in=32, d_sae=64, grad_scale=1.0):
    rng = np.random.default_rng(seed)
    W_dec = rng.standard_normal((L, d_sae, d_in)).astype(np.float32)
    W_dec /= np.linalg.norm(W_dec, axis=-1, keepdims=True)
    return {"W_enc": rng.standard_normal((L, d_in, d_sae)).astype(np.float32) * grad_scale,
            "W_dec": W_dec * grad_scale,
            "b_enc": rng.standard_normal((L, d_sae)).astype(np.float32) * grad_scale,
            "b_dec": rng.standard_normal((L, d_in)).astype(np.float32) * grad_scale}


@pytest.mark.parametrize("adam_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", [1, 2])
def test_fused_clip_project_adam_matches_jax_over_steps(L, adam_dtype):
    jdt, tdt = MDT[adam_dtype]
    params = _sae_tree(0, L)
    opt = optax.adam(lambda count: 1e-3, b1=B1, b2=B2)  # a schedule state, as the SAE's
    jstate = jax.vmap(opt.init)({k: jnp.asarray(v) for k, v in params.items()})
    cast = lambda t: jax.tree.map(lambda a: a.astype(jdt), t)
    jstate = (jstate[0]._replace(mu=cast(jstate[0].mu), nu=cast(jstate[0].nu)), jstate[1])
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    adam, sched = jstate
    pstate = (port_ops.ScaleByAdamState(
        count=torch.from_numpy(np.array(adam.count)),
        mu=sae_params_from_jax(jax.tree.map(np.asarray, adam.mu)),
        nu=sae_params_from_jax(jax.tree.map(np.asarray, adam.nu))),
        port_ops.ScaleByScheduleState(count=torch.from_numpy(np.array(sched.count))))
    pparams = {k: torch.from_numpy(v) for k, v in params.items()}
    lr = np.array([1e-3, 5e-4], np.float32)[:L]
    # big grads on step 0 so the clip engages; small ones after
    for step, scale in enumerate((3.0, 0.05, 0.02)):
        grads = _sae_tree(10 + step, L, grad_scale=scale)
        jparams, jstate = jax_fused(jparams, {k: jnp.asarray(v) for k, v in grads.items()},
                                    jstate, lr=jnp.asarray(lr), b1=B1, b2=B2,
                                    max_grad_norm=1.0)
        pparams, pstate = port_ops.fused_clip_project_adam(
            pparams, {k: torch.from_numpy(v) for k, v in grads.items()}, pstate,
            lr=torch.from_numpy(lr), b1=B1, b2=B2, max_grad_norm=1.0)
    # Three steps of float32 math on identical inputs; only the clip norm
    # and the projection's row dots are summed in other orders.  bfloat16
    # moments round one bf16 ulp apart where a float32 value differs.
    for k in params:
        assert_close(jparams[k], pparams[k], 1e-6, f"param {k}")
        for name, j, t in (("mu", jstate[0].mu[k], pstate[0].mu[k]),
                           ("nu", jstate[0].nu[k], pstate[0].nu[k])):
            assert t.dtype == tdt
            j = np.asarray(j, np.float32)
            tol = 1e-7 if adam_dtype == "float32" else 2.0 ** -8 * float(np.abs(j).max())
            assert_close(j, t, tol, f"{name} {k}")
    for port_st, jax_st in zip(pstate, jstate):  # [L] counts, exact
        np.testing.assert_array_equal(port_st.count.numpy(), np.asarray(jax_st.count))
        assert port_st.count.tolist() == [3] * L
