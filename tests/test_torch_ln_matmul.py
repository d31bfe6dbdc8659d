"""The port's LayerNorm -> GEMM (B14, ``ops/ln_matmul.py``) and the fused
LN route (``use_fused_ln_gemm``) against the JAX package's, with the same
numpy inputs and weights.  JAX's kernel runs in interpret mode on the CPU
(R a multiple of 128, as its own tests take) or, at a ragged R, its
reference; the port's wrapper runs its plain version on CPU tensors.

Tolerances: float32 outputs within 2e-5 (JAX's own bound, tests/
test_ln_matmul.py); bfloat16 outputs within 2^-7 of max(1, absmax): both
round xn and the sum to bfloat16 after float32 sums taken in other orders,
so an entry may land one bf16 ulp apart; gradients within 1e-5 of max(1,
absmax); model activations within 1e-4 as test_torch_vit.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import assert_caches_close, assert_close, jax_and_port, seeded
from vit_prisma_tpu.models import layers as jax_layers
from vit_prisma_tpu.ops import ln_matmul as jax_ops
from vit_prisma_tpu.prisma.hooks import NULL_HOOKS as JAX_NULL_HOOKS
from vit_prisma_tpu_torch import HookedViT, HookRuntime, vit_forward
from vit_prisma_tpu_torch.models import layers as port_layers
from vit_prisma_tpu_torch.ops import attention as port_attention
from vit_prisma_tpu_torch.ops import ln_matmul as port_ops
from vit_prisma_tpu_torch.prisma.hooks import NULL_HOOKS

D, C, EPS = 128, 256, 1e-5
F32_ATOL = 2e-5
BF16_REL = 2.0 ** -7
GRAD_REL = 1e-5
ACT_ATOL = 1e-4
# _vit_cfg of the JAX package's tests/test_ln_matmul.py: at batch 128, B*T =
# 128 * 17 = 2176 rows, a multiple of 128, so JAX's kernel gate holds.
VIT = dict(n_layers=2, d_model=128, d_head=32, n_heads=4, d_mlp=256,
           patch_size=8, image_size=32, n_channels=3, n_classes=10,
           activation_name="quick_gelu", layer_norm_pre=True, return_type="logits")
BATCH = 128


def _operands(R, S, seed=0):
    return (seeded(seed, (R, D)) * 2.0 + 0.5, seeded(seed + 1, (S, D, C), 0.05),
            seeded(seed + 2, (S, C), 0.01))


def _both(arrays, dtype):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(dtype) for a in arrays])


def _atol(dtype, want):
    if dtype == torch.float32:
        return F32_ATOL
    return BF16_REL * max(1.0, float(np.abs(np.asarray(want, np.float32)).max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,S", [(256, 3), (256, 1), (200, 3)])
def test_ln_matmul_matches_jax(R, S, dtype):
    # R = 200 is ragged: the port's kernel masks it, JAX takes its reference
    (jx, jW, jb), (x, W, b) = _both(_operands(R, S), dtype)
    assert port_ops.ln_matmul_fits(R, S, D, C)
    assert jax_ops.ln_matmul_fits(R, S, D, C, 4) == (R % 128 == 0)
    want = jax_ops.ln_matmul(jx, jW, jb, EPS)
    before = port_ops.ln_matmul.launches
    got = port_ops.ln_matmul(x, W, b, EPS)
    assert port_ops.ln_matmul.launches == before  # CPU: the plain version
    assert got.dtype == dtype and tuple(got.shape) == (S, R, C)
    assert_close(want, got, _atol(dtype, want), "out")
    assert torch.equal(got, port_ops.ln_matmul_reference(x, W, b, EPS))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R", [256, 257])
def test_ln_matmul_matches_jax_at_the_narrow_column_tile(R, dtype):
    """C = 640 is a multiple of 128 but not of 256: the bf16 kernel takes
    its 128-wide column tile there.  R = 257 leaves a one-row last tile
    (JAX takes its reference); R = 256 runs JAX's kernel."""
    Cn = 640
    arrays = (seeded(3, (R, D)) * 2.0 + 0.5, seeded(4, (1, D, Cn), 0.05),
              seeded(5, (1, Cn), 0.01))
    (jx, jW, jb), (x, W, b) = _both(arrays, dtype)
    assert port_ops.ln_matmul_fits(R, 1, D, Cn)
    assert jax_ops.ln_matmul_fits(R, 1, D, Cn, 4) == (R % 128 == 0)
    want = jax_ops.ln_matmul(jx, jW, jb, EPS)
    got = port_ops.ln_matmul(x, W, b, EPS)
    assert got.dtype == dtype and tuple(got.shape) == (1, R, Cn)
    assert_close(want, got, _atol(dtype, want), "out")


@pytest.mark.parametrize("S", [3, 1])
def test_ln_matmul_grads_match_jax_vjp(S):
    R = 256
    arrays = _operands(R, S, seed=3)
    g = seeded(9, (S, R, C))
    (jx, jW, jb), (x, W, b) = _both(arrays, torch.float32)
    _, vjp = jax.vjp(lambda *a: jax_ops.ln_matmul(*a, EPS), jx, jW, jb)
    want = vjp(jnp.asarray(g))
    leaves = [t.requires_grad_(True) for t in (x, W, b)]
    got = torch.autograd.grad(port_ops.ln_matmul(*leaves, EPS), leaves, torch.from_numpy(g))
    for name, w, p in zip(("dx", "dW", "db"), want, got):
        assert_close(w, p, GRAD_REL * max(1.0, float(np.abs(np.asarray(w)).max())), name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_written_out_vjp_matches_the_references_autograd(dtype):
    # The backward's matmuls in x's dtype round where the reference's casts
    # do: float32 agrees up to summation order, bfloat16 within one ulp.
    _, (x, W, b) = _both(_operands(300, 3, seed=8), dtype)
    g = torch.from_numpy(seeded(9, (3, 300, C))).to(dtype)
    grads = []
    for fn in (port_ops.ln_matmul, port_ops.ln_matmul_reference):
        leaves = [t.clone().requires_grad_(True) for t in (x, W, b)]
        grads.append(torch.autograd.grad(fn(*leaves, EPS), leaves, g))
    for name, got, want in zip(("dx", "dW", "db"), *grads):
        assert got.dtype == want.dtype == dtype
        rel = GRAD_REL if dtype == torch.float32 else BF16_REL
        assert_close(want.float().numpy(), got, rel * max(1.0, want.float().abs().max().item()),
                     name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fold_ln_affine_matches_jax(dtype):
    _, W, b = _operands(8, 3, seed=5)
    ln_w, ln_b = 1.0 + seeded(6, (D,), 0.1), seeded(7, (D,), 0.1)
    (jW, jb, jw, jlb), (pW, pb, pw, plb) = _both((W, b, ln_w, ln_b), dtype)
    want_W, want_b = jax_ops.fold_ln_affine(jW, jb, jw, jlb)
    got_W, got_b = port_ops.fold_ln_affine(pW, pb, pw, plb)
    assert got_W.dtype == got_b.dtype == dtype
    assert_close(want_W, got_W, 0.0, "W")  # one elementwise product, rounded once
    assert_close(want_b, got_b, _atol(dtype, want_b) / 8, "b")


def test_gate_is_the_kernels_tiles():
    assert port_ops.ln_matmul_fits(36_928, 1, 1024, 4096)  # L/14-336 at batch 64
    assert port_ops.ln_matmul_fits(1, 3, 768, 768)
    assert not port_ops.ln_matmul_fits(256, 1, 768, 100)  # C off the 128 tile
    assert not port_ops.ln_matmul_fits(256, 1, 40, 128)  # D off the 32 step
    x, W, b = (torch.zeros(s) for s in ((4, 40), (1, 40, 128), (1, 128)))
    with pytest.raises(ValueError, match="tiles"):
        port_ops.ln_matmul(x, W, b)


def _count_ln_matmul(monkeypatch):
    """Count the block's ln_matmul calls (on the CPU, no launch is made)."""
    calls = []

    def spy(*args, **kwargs):
        calls.append(tuple(args[1].shape))
        return port_ops.ln_matmul(*args, **kwargs)
    monkeypatch.setattr(port_layers, "ln_matmul", spy)
    return calls


@pytest.mark.parametrize("norm", ["LN", "LNPre"])
def test_fused_ln_model_matches_jax(norm, monkeypatch):
    jax_model, port = jax_and_port(**VIT, normalization_type=norm, use_fused_ln_gemm=True)
    x = seeded(2, (BATCH, 3, 32, 32))
    T, Dm = port.cfg.n_tokens, port.cfg.d_model
    probe = jnp.zeros((BATCH, T, Dm))
    assert jax_layers._ln_gemm_fusable(jax_model.cfg, JAX_NULL_HOOKS, "blocks.0", None, probe)
    assert jax_layers._ln_mlp_fusable(jax_model.cfg, JAX_NULL_HOOKS, "blocks.0", probe)
    tprobe = torch.zeros(BATCH, T, Dm)
    assert port_layers._ln_gemm_fusable(port.cfg, NULL_HOOKS, "blocks.0", None, tprobe)
    assert port_layers._ln_mlp_fusable(port.cfg, NULL_HOOKS, "blocks.0", tprobe)

    calls = _count_ln_matmul(monkeypatch)
    names = lambda n: n.endswith("hook_resid_post")
    before = (port_ops.ln_matmul.launches, port_attention.attention_mix_tnh.launches)
    want_out, want = jax_model.run_with_cache(jnp.asarray(x), names_filter=names,
                                              return_cache_object=False, incl_bwd=True)
    got_out, got = port.run_with_cache(torch.from_numpy(x), names_filter=names,
                                       incl_bwd=True)
    assert (port_ops.ln_matmul.launches,
            port_attention.attention_mix_tnh.launches) == before  # CPU: no launch
    # each block: ln1 -> QKV (S = 3) and ln2 -> W_in (S = 1)
    assert calls == [(3, Dm, Dm), (1, Dm, port.cfg.d_mlp)] * port.cfg.n_layers
    assert list(got) == list(want) and any(k.endswith("_grad") for k in got)
    for k, w in want.items():
        atol = (GRAD_REL * max(1.0, float(np.abs(np.asarray(w)).max()))
                if k.endswith("_grad") else ACT_ATOL)
        assert_close(w, got[k], atol, k)
    assert_close(want_out, got_out, ACT_ATOL, "output")
    assert_close(jax_model(jnp.asarray(x[:4])), port(torch.from_numpy(x[:4])), ACT_ATOL,
                 "forward")


def test_fused_ln_model_param_grads_match_unfused():
    # Every parameter's gradient, ln1's and ln2's w and b through
    # fold_ln_affine, against the unfused route with the same weights.
    _, port = jax_and_port(**VIT, use_fused_ln_gemm=True)
    unfused = HookedViT(port.cfg.replace(use_fused_ln_gemm=False), device="cpu")
    unfused.load_state_dict(port.state_dict())
    x = torch.from_numpy(seeded(4, (4, 3, 32, 32)))
    grads = []
    for model in (port, unfused):
        model.zero_grad()
        vit_forward(model, model.cfg, x).square().sum().backward()  # outside inference mode
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()})
    assert any(".ln1." in k for k in grads[1])
    for k, want in grads[1].items():
        assert_close(want.numpy(), grads[0][k], GRAD_REL * 10 * max(1.0, want.abs().max().item()), k)


def test_ln_hooks_turn_the_fusion_off():
    names = ["blocks.0.ln1.hook_scale", "blocks.1.ln2.hook_normalized",
             "blocks.0.attn.hook_pattern"]
    jax_model, port = jax_and_port(**VIT, use_fused_ln_gemm=True)
    unfused = HookedViT(port.cfg.replace(use_fused_ln_gemm=False), device="cpu")
    unfused.load_state_dict(port.state_dict())
    x = seeded(3, (4, 3, 32, 32))
    filt = lambda n: n in names
    want_out, want = jax_model.run_with_cache(jnp.asarray(x), names_filter=filt,
                                              return_cache_object=False)
    got_out, got = port.run_with_cache(torch.from_numpy(x), names_filter=filt)
    plain_out, plain = unfused.run_with_cache(torch.from_numpy(x), names_filter=filt)
    assert list(got) == list(want) and set(got) == set(names)
    assert_caches_close(want, got, ACT_ATOL)
    for n in names:  # the other LayerNorms stay fused: rounding apart (JAX's bound)
        assert_close(plain[n].numpy(), got[n], F32_ATOL, n)
    assert_close(want_out, got_out, ACT_ATOL, "output")
    hooks = HookRuntime(names_filter=filt)
    probe = torch.zeros(4, port.cfg.n_tokens, port.cfg.d_model)
    assert not port_layers._ln_gemm_fusable(port.cfg, hooks, "blocks.0", None, probe)
    assert not port_layers._ln_mlp_fusable(port.cfg, hooks, "blocks.1", probe)
