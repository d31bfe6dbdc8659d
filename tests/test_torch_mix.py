"""The port's kernels B15 (``attention_mix``, head-major mix) and B16
(``fused_attention_block``) in their plain versions against the JAX
package's entry points, whose Pallas kernels run here in interpret mode, and
their gates.  The CUDA kernels themselves are held to the plain versions on
the card by ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import assert_close, seeded
from vit_prisma_tpu.ops import attention as jax_ops
from vit_prisma_tpu_torch.ops import attention as port_ops

# JAX's own shape for B15 (tests/test_perf_paths.py) and its tolerance
MIX_SHAPE = (4, 4, 10, 8)
F32_ATOL = 1e-5


def _bf16_ulps(n, want):
    """n bfloat16 ulps at the largest |value| of ``want``."""
    top = float(np.abs(np.asarray(want, np.float32)).max())
    return n * 2.0 ** (np.floor(np.log2(top)) - 7)


def _mix_inputs(shape=MIX_SHAPE, seed=0):
    return [seeded(seed, shape), seeded(seed + 1, shape), seeded(seed + 2, shape)]


def _t(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _j(arrays, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrays]


# ---------------------------------------------------------------------------
# B15
# ---------------------------------------------------------------------------

def test_mix_plain_matches_jax_f32():
    qkv = _mix_inputs()
    want = jax.jit(jax_ops.attention_mix)(*_j(qkv))
    got = port_ops.attention_mix_reference(*_t(qkv))
    assert got.dtype == torch.float32 and tuple(got.shape) == MIX_SHAPE
    assert_close(want, got, atol=F32_ATOL)


@pytest.mark.parametrize("g", [1, 2, 4])
def test_mix_plain_matches_every_head_group(g):
    """The packing masks the cross-head blocks: every group size gives the
    port's unpacked result."""
    qkv = _mix_inputs(seed=3)
    want = jax_ops._mix_forward(*_j(qkv), head_group=g)
    assert_close(want, port_ops.attention_mix_reference(*_t(qkv)), atol=F32_ATOL)


def test_mix_plain_matches_jax_bf16():
    qkv = _mix_inputs((2, 12, 50, 64), seed=5)
    qkv[0] = qkv[0] * 64 ** -0.5  # pre-scaled q, as a model passes it
    want = jax_ops.attention_mix(*_j(qkv, jnp.bfloat16))
    got = port_ops.attention_mix_reference(*_t(qkv, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert_close(np.asarray(want, np.float32), got, atol=_bf16_ulps(2, want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H", [64, 88])
@pytest.mark.parametrize("T,batch", [(257, 2), (411, 1)])  # CLIP L/14; the gate's last T
def test_mix_plain_matches_jax_long_T(T, batch, H, dtype):
    """The token axes of CLIP L/14 and the gate's edge, at the head widths of
    the bfloat16 kernel's unpadded and padded routes."""
    qkv = _mix_inputs((batch, 2, T, H), seed=T + H)
    qkv[0] = qkv[0] * H ** -0.5
    want = jax_ops.attention_mix(*_j(qkv, getattr(jnp, dtype)))
    got = port_ops.attention_mix_reference(*_t(qkv, getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (batch, 2, T, H)
    assert_close(np.asarray(want, np.float32), got,
                 atol=F32_ATOL if dtype == "float32" else 2e-2)


def test_mix_gradients_match_jax():
    qkv = _mix_inputs(seed=7)
    loss = lambda q, k, v: jnp.sum(jnp.sin(jax_ops.attention_mix(q, k, v)))
    want = jax.grad(loss, argnums=(0, 1, 2))(*_j(qkv))
    leaves = [t.requires_grad_(True) for t in _t(qkv)]
    torch.sin(port_ops.attention_mix(*leaves)).sum().backward()
    for name, w, t in zip("qkv", want, leaves):
        assert_close(w, t.grad, atol=F32_ATOL, name=f"d{name}")


def test_mix_cpu_wrapper_takes_plain_version_without_launching():
    q, k, v = _t(_mix_inputs(seed=9))
    before = port_ops.attention_mix.launches
    assert torch.equal(port_ops.attention_mix(q, k, v),
                       port_ops.attention_mix_reference(q, k, v))
    assert port_ops.attention_mix.launches == before


@pytest.mark.parametrize("T,H,fits", [
    (10, 8, True), (50, 64, True), (257, 64, True),  # B/32 and CLIP L/14
    (411, 64, True), (412, 64, False), (577, 64, False), (50, 256, True), (50, 257, False)])
def test_mix_gate_is_b1s(T, H, fits):
    assert port_ops.mix_tnh_fits_smem(T, H) == fits
    q = torch.zeros(1, 1, T, H)
    if fits:
        assert tuple(port_ops.attention_mix(q, q, q).shape) == (1, 1, T, H)
    else:
        with pytest.raises(NotImplementedError, match="B13"):
            port_ops.attention_mix(q, q, q)


# ---------------------------------------------------------------------------
# B16
# ---------------------------------------------------------------------------

def _block_inputs(B, T, D, N, H, seed):
    NH = N * H
    return [seeded(seed, (B, T, D)), seeded(seed + 1, (D, 3 * NH), D ** -0.5),
            seeded(seed + 2, (3 * NH,), 0.1), seeded(seed + 3, (NH, D), NH ** -0.5)]


# (B, T, D, N): a small geometry and one full-width CLIP ViT-B/32 block
BLOCK_GEOMETRIES = [(2, 10, 32, 4), (2, 50, 768, 12)]


@pytest.mark.parametrize("geometry", BLOCK_GEOMETRIES, ids=["small", "b32"])
def test_block_plain_matches_jax_f32(geometry):
    B, T, D, N = geometry
    H = D // N
    args = _block_inputs(B, T, D, N, H, seed=11)
    want = jax_ops.fused_attention_block(*_j(args), N, H ** -0.5)
    got = port_ops.fused_attention_block_plain(*_t(args), N, H ** -0.5)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, T, D)
    assert_close(want, got, atol=F32_ATOL * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("geometry", BLOCK_GEOMETRIES, ids=["small", "b32"])
def test_block_plain_matches_jax_bf16(geometry):
    """In bfloat16 the rounding points agree; a float32 sum order can still
    flip a rounding of qkv or z, which moves out by a bfloat16 ulp or so."""
    B, T, D, N = geometry
    H = D // N
    args = _block_inputs(B, T, D, N, H, seed=13)
    want = jax_ops.fused_attention_block(*_j(args, jnp.bfloat16), N, H ** -0.5)
    got = port_ops.fused_attention_block_plain(*_t(args, torch.bfloat16), N, H ** -0.5)
    assert got.dtype == torch.bfloat16
    assert_close(np.asarray(want, np.float32), got, atol=_bf16_ulps(2, want))


# (B, T, D, N) at an odd batch: the bf16 kernel takes two images a block,
# so the last block holds a lone image
ODD_BATCH_GEOMETRIES = [(3, 10, 32, 4), (3, 50, 768, 12)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("geometry", ODD_BATCH_GEOMETRIES, ids=["small", "b32"])
def test_block_plain_matches_jax_at_an_odd_batch(geometry, dtype):
    """float32 as test_block_plain_matches_jax_f32, bfloat16 within 2 ulps
    as test_block_plain_matches_jax_bf16."""
    B, T, D, N = geometry
    H = D // N
    args = _block_inputs(B, T, D, N, H, seed=23)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jax_ops.fused_attention_block(*_j(args, jdt), N, H ** -0.5)
    got = port_ops.fused_attention_block_plain(*_t(args, dtype), N, H ** -0.5)
    assert got.dtype == dtype and tuple(got.shape) == (B, T, D)
    if dtype == torch.float32:
        atol = F32_ATOL * max(1.0, float(np.abs(want).max()))
    else:
        atol = _bf16_ulps(2, want)
    assert_close(np.asarray(want, np.float32), got, atol=atol)


def test_block_reference_matches_jax_f32():
    B, T, D, N = BLOCK_GEOMETRIES[0]
    args = _block_inputs(B, T, D, N, D // N, seed=15)
    want = jax_ops._attn_block_ref(*_j(args), N, 0.35)
    assert_close(want, port_ops.attn_block_reference(*_t(args), N, 0.35), atol=F32_ATOL)


def test_block_gradients_match_jax():
    """Through the wrapper at a geometry its gate takes (H 64, D 128)."""
    B, T, D, N = 2, 10, 128, 2
    args = _block_inputs(B, T, D, N, 64, seed=17)
    g = seeded(21, (B, T, D))
    _, vjp = jax.vjp(lambda *a: jax_ops.fused_attention_block(*a, N, 0.125), *_j(args))
    want = vjp(jnp.asarray(g))
    leaves = [t.requires_grad_(True) for t in _t(args)]
    out = port_ops.fused_attention_block(*leaves, N, 0.125)
    out.backward(torch.from_numpy(g))
    for name, w, t in zip(("x", "Wqkv", "bqkv", "Wo"), want, leaves):
        assert_close(w, t.grad, atol=F32_ATOL * max(1.0, float(np.abs(w).max())),
                     name=f"d{name}")


def test_block_cpu_wrapper_takes_plain_version_without_launching():
    args = _t(_block_inputs(2, 50, 768, 12, 64, seed=19))
    before = port_ops.fused_attention_block.launches
    assert torch.equal(port_ops.fused_attention_block(*args, 12, 0.125),
                       port_ops.fused_attention_block_plain(*args, 12, 0.125))
    assert port_ops.fused_attention_block.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_gate_takes_b32_and_raises_past_it(dtype):
    assert port_ops.attn_block_fits_smem(50, 768, 768, dtype)  # CLIP ViT-B/32
    assert port_ops.attn_block_fits_smem(64, 768, 768, dtype)
    assert port_ops.attn_block_smem_bytes(dtype) <= port_ops._MAX_SMEM_BYTES
    past = [(65, 768, 768, 12),    # one token past the block's rows
            (257, 1024, 1024, 16),  # CLIP L/14
            (50, 768, 768, 24),    # H = 32
            (50, 960, 768, 12)]    # D not a multiple of 128
    for T, D, NH, N in past:
        assert not port_ops.attn_block_fits_smem(T, D, NH, dtype, NH // N)
        x = torch.zeros(1, T, D, dtype=dtype)
        w = torch.zeros(D, 3 * NH, dtype=dtype)
        b = torch.zeros(3 * NH, dtype=dtype)
        wo = torch.zeros(NH, D, dtype=dtype)
        with pytest.raises(NotImplementedError, match="gate"):
            port_ops.fused_attention_block(x, w, b, wo, N, 0.125)
