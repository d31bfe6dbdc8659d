"""The port's tiled flash attention (B13, ``flash_attention_padded``) and the
long-T attention route against the JAX package's, with the same numpy
inputs and weights.  On the CPU JAX runs its float32 einsum twin of the
library kernel, and the port's wrapper its plain versions.

Tolerances: float32 forward within 1e-5 (the JAX package's own bound,
tests/test_perf_paths.py) and gradients within 1e-5 of max(1, absmax) (the
backward takes D = rowsum(z dz), autodiff sum(dp p): the same sum in
another order, on inputs of unit scale); model activations within 1e-4 and
gradients within 1e-5 of max(1, absmax) as test_torch_grad_hooks.py.  The
bfloat16 plain versions against the float32 twin on the same bf16 inputs:
within 2^-6 of max(1, absmax) (p, ds and each output rounded to bf16 once,
2^-9 relative each, carried through sums of terms of either sign)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import assert_close, jax_and_port, port_from_jax, seeded
from vit_prisma_tpu import HookedViT as JaxViT
from vit_prisma_tpu.models.loading.registry import get_model_config as jax_get_config
from vit_prisma_tpu.ops import attention as jax_ops
import vit_prisma_tpu_torch
from vit_prisma_tpu_torch.models import layers as port_layers
from vit_prisma_tpu_torch.ops import attention as port_ops

B, N, T, H, TP = 2, 2, 200, 32, 256
F32_ATOL = 1e-5
BF16_REL = 2.0 ** -6
ACT_ATOL = 1e-4
GRAD_REL = 1e-5
L336 = "openai/clip-vit-large-patch14-336"
# image_size 232, patch 8: T = 29 * 29 + 1 = 842, H = 32, past both
# packages' whole-T gates, so both take the flash route.
LONG = dict(n_layers=2, d_model=128, d_head=32, n_heads=4, d_mlp=256, patch_size=8,
            image_size=232, n_classes=10, activation_name="quick_gelu",
            layer_norm_pre=True, return_type="logits")


def _operands(seed=0):
    """Padded q, k, v, a cotangent and the segment ids (1 real, 2 padding)."""
    pad = lambda a: np.pad(a, ((0, 0), (0, 0), (0, TP - T), (0, 0)))
    q, k, v = (pad(seeded(seed + i, (B, N, T, H))) for i in range(3))
    dz = seeded(seed + 3, (B, N, TP, H))
    seg = np.broadcast_to(np.where(np.arange(TP) < T, 1, 2).astype(np.int32), (B, TP)).copy()
    return q, k, v, dz, seg


def _jax(q, k, v, dz, seg, causal):
    f = lambda a, b, c: jax_ops.flash_attention_padded(a, b, c, jnp.asarray(seg), causal)
    z, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    return (z, *vjp(jnp.asarray(dz)))


def _port(q, k, v, dz, seg, causal, dtype=torch.float32):
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_(True) for a in (q, k, v)]
    z = port_ops.flash_attention_padded(*leaves, torch.from_numpy(seg), causal)
    return (z, *torch.autograd.grad(z, leaves, torch.from_numpy(dz).to(dtype)))


@pytest.mark.parametrize("causal", [False, True])
def test_flash_matches_jax(causal):
    ops = _operands()
    before = [f.launches for f in (port_ops.flash_attention_padded,
                                   port_ops.flash_attention_padded_bwd_dkv,
                                   port_ops.flash_attention_padded_bwd_dq)]
    want, got = _jax(*ops, causal), _port(*ops, causal)
    assert [f.launches for f in (port_ops.flash_attention_padded,
                                 port_ops.flash_attention_padded_bwd_dkv,
                                 port_ops.flash_attention_padded_bwd_dq)] == before
    for name, w, g in zip(("z", "dq", "dk", "dv"), want, got):
        assert tuple(g.shape) == (B, N, TP, H)
        scale = 1.0 if name == "z" else max(1.0, float(np.abs(np.asarray(w)).max()))
        assert_close(w, g.detach(), F32_ATOL * scale, name)
    # only the real rows' output is kept by the caller; padding stays finite
    assert torch.isfinite(got[0]).all()


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_plain_versions_within_bound(causal):
    q, k, v, dz, seg = _operands(seed=10)
    bf = lambda a: np.asarray(torch.from_numpy(a).bfloat16().float())
    want = _jax(bf(q), bf(k), bf(v), bf(dz), seg, causal)
    got = _port(q, k, v, dz, seg, causal, torch.bfloat16)
    for name, w, g in zip(("z", "dq", "dk", "dv"), want, got):
        assert g.dtype == torch.bfloat16
        assert_close(w, g.detach(), BF16_REL * max(1.0, float(np.abs(np.asarray(w)).max())),
                     name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("H,T,Tp", [(128, 77, 128), (32, 130, 192)])
def test_plain_versions_match_jax_at_other_widths(H, T, Tp, causal, dtype):
    """The widest head the bfloat16 Hopper kernels take (128, two TMA boxes)
    and one routed to the mma.sync kernels (32), each with a ragged T inside
    Tp: the forward and its VJP against JAX's (float32 twin) on the same
    inputs, rounded to bf16 first in bf16."""
    pad = lambda a: np.pad(a, ((0, 0), (0, 0), (0, Tp - T), (0, 0)))
    rnd = (lambda a: a) if dtype == torch.float32 else (
        lambda a: np.asarray(torch.from_numpy(a).bfloat16().float()))
    q = pad(seeded(H + T, (B, N, T, H), H ** -0.5))
    k, v = (pad(seeded(H + T + i, (B, N, T, H))) for i in (1, 2))
    dz = seeded(H + T + 3, (B, N, Tp, H))
    seg = np.broadcast_to(np.where(np.arange(Tp) < T, 1, 2).astype(np.int32), (B, Tp)).copy()
    want = _jax(rnd(q), rnd(k), rnd(v), rnd(dz), seg, causal)
    got = _port(q, k, v, dz, seg, causal, dtype)
    for name, w, g in zip(("z", "dq", "dk", "dv"), want, got):
        assert g.dtype == dtype and tuple(g.shape) == (B, N, Tp, H)
        f32 = dtype == torch.float32
        scale = 1.0 if f32 and name == "z" else max(1.0, float(np.abs(np.asarray(w)).max()))
        assert_close(w, g.detach(), (F32_ATOL if f32 else BF16_REL) * scale, name)
    assert torch.isfinite(got[0]).all()


def test_passes_take_the_forwards_statistics():
    q, k, v, dz, seg = (torch.from_numpy(a) for a in _operands(seed=20))
    lse = port_ops.flash_lse_reference(q, k, seg)
    z = port_ops.flash_attention_padded_reference(q, k, v, seg)
    dsum = port_ops.flash_dsum(z, dz)
    dq, dk, dv = port_ops.flash_attention_padded_bwd_reference(q, k, v, seg, dz)
    assert torch.equal(port_ops.flash_attention_padded_bwd_dq(q, k, v, seg, dz, lse, dsum), dq)
    assert all(torch.equal(a, b) for a, b in zip(
        port_ops.flash_attention_padded_bwd_dkv(q, k, v, seg, dz, lse, dsum), (dk, dv)))


def test_flash_gate_raises():
    assert port_ops.flash_fits(640, 64) and port_ops.flash_fits(64, 128)
    assert not port_ops.flash_fits(600, 64) and not port_ops.flash_fits(640, 72)
    assert not port_ops.flash_fits(640, 144)
    x = torch.zeros(1, 1, 100, 64)
    with pytest.raises(ValueError, match="multiple of 64"):
        port_ops.flash_attention_padded(x, x, x, torch.ones(1, 100, dtype=torch.int32))
    x = torch.zeros(1, 1, 128, 64)
    with pytest.raises(ValueError, match="int32"):
        port_ops.flash_attention_padded(x, x, x, torch.ones(1, 128, dtype=torch.int64))


def _spy_routes(monkeypatch):
    routes = []
    for name in ("_fused_attention", "_flash_attention_long"):
        real = getattr(port_layers, name)

        def spy(*args, _real=real, _name=name, **kwargs):
            routes.append(_name)
            return _real(*args, **kwargs)
        monkeypatch.setattr(port_layers, name, spy)
    return routes


def test_long_T_model_matches_jax_on_the_flash_route(monkeypatch):
    jax_model, port = jax_and_port(**LONG)
    cfg = port.cfg
    assert cfg.n_tokens == 842
    assert not jax_ops.mix_tnh_fits_vmem(842, cfg.n_heads * cfg.d_head, 4)
    assert not port_ops.mix_tnh_fits_smem(842, 32)
    routes = _spy_routes(monkeypatch)
    x = seeded(1, (2, 3, 232, 232))
    names = lambda n: n.endswith("hook_resid_post")
    want_out, want = jax_model.run_with_cache(jnp.asarray(x), names_filter=names,
                                              return_cache_object=False, incl_bwd=True)
    got_out, got = port.run_with_cache(torch.from_numpy(x), names_filter=names, incl_bwd=True)
    assert routes == ["_flash_attention_long"] * cfg.n_layers
    assert list(got) == list(want) and any(k.endswith("_grad") for k in got)
    for k, w in want.items():
        atol = (GRAD_REL * max(1.0, float(np.abs(np.asarray(w)).max()))
                if k.endswith("_grad") else ACT_ATOL)
        assert_close(w, got[k], atol, k)
    assert_close(want_out, got_out, ACT_ATOL, "output")


def test_l14_336_registry_matches_jax():
    port_cfg = vit_prisma_tpu_torch.get_model_config(L336)
    assert port_cfg.to_dict() == jax_get_config(L336).to_dict()
    assert (port_cfg.n_tokens, port_cfg.d_head) == (577, 64)


def test_l14_336_layer_routes_to_flash_and_matches_jax(monkeypatch):
    # One layer at full width: 336-px patchify and position embedding, and
    # T = 577 at H = 64 past B1's gate, so attention() takes B13's route.
    assert not port_ops.mix_tnh_fits_smem(577, 64)
    jax_model = JaxViT(jax_get_config(L336, n_layers=1), key=jax.random.PRNGKey(0))
    port = port_from_jax(jax_model)
    routes = _spy_routes(monkeypatch)
    x = seeded(2, (1, 3, 336, 336))
    names = lambda n: n.endswith("hook_resid_post")
    want_out, want = jax_model.run_with_cache(jnp.asarray(x), names_filter=names,
                                              return_cache_object=False)
    got_out, got = port.run_with_cache(torch.from_numpy(x), names_filter=names)
    assert routes == ["_flash_attention_long"]
    assert tuple(got["blocks.0.hook_resid_post"].shape) == (1, 577, 1024)
    assert tuple(got_out.shape) == (1, 768)
    assert_close(want["blocks.0.hook_resid_post"], got["blocks.0.hook_resid_post"], ACT_ATOL,
                 "resid_post")
    assert_close(want_out, got_out, ACT_ATOL, "output")
