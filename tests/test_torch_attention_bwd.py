"""The port's attention-mix backward (kernel B2's plain version and the
autograd wiring of ``attention_mix_tnh``) against the JAX package's
``_mix_tnh_backward``, whose Pallas kernel runs here in interpret mode, and
against ``jax.vjp`` of the JAX mix.  The CUDA kernel itself is held to the
plain version on the card by ``chip_smoke.py``.

Tolerances: each gradient within ``atol * max(1, its absmax)``, atol 1e-5
in float32 (summation order only) and 2e-2 in bfloat16 (ds and the outputs
may round one bfloat16 ulp apart, 2^-8 relative)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import seeded
from vit_prisma_tpu.ops.attention import _mix_tnh_backward
from vit_prisma_tpu.ops.attention import attention_mix_tnh as jax_mix
from vit_prisma_tpu_torch.ops import attention as port_ops

B, N = 2, 3
ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(T, H, seed):
    shape = (B, T, N * H)
    # q pre-scaled by 1/sqrt(H), as the model passes it
    return (seeded(seed, shape, H ** -0.5), seeded(seed + 1, shape),
            seeded(seed + 2, shape), seeded(seed + 3, shape))


def _assert_grads_close(want, got, dtype):
    for name, w, g in zip(("dq", "dk", "dv"), want, got):
        w = np.asarray(w, np.float32)
        assert g.dtype == dtype and tuple(g.shape) == w.shape, name
        atol = ATOL[dtype] * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", [8, 64])
@pytest.mark.parametrize("T", [12, 50, 77])
@pytest.mark.parametrize("causal", [False, True])
def test_bwd_reference_matches_jax_kernel(causal, T, H, dtype):
    arrays = _inputs(T, H, seed=T + H)
    want = _mix_tnh_backward(*(jnp.asarray(a, JAX_DTYPE[dtype]) for a in arrays),
                             N, causal)
    got = port_ops.attention_mix_tnh_bwd_reference(
        *(torch.from_numpy(a).to(dtype) for a in arrays), N, causal)
    _assert_grads_close(want, got, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("H", [64, 88])
@pytest.mark.parametrize("T,batch", [(17, 2), (257, 2), (411, 1)])
def test_bwd_reference_matches_jax_kernel_at_ragged_tiles(T, batch, H, causal, dtype):
    """Token counts that leave the bfloat16 kernel's 16-row tiles ragged
    (17, CLIP L/14's 257 and the gate's last T at H = 64), at head widths it
    takes unpadded (64) and padded (88 to 96)."""
    n = 2
    shape = (batch, T, n * H)
    arrays = (seeded(T + H, shape, H ** -0.5), seeded(T + H + 1, shape),
              seeded(T + H + 2, shape), seeded(T + H + 3, shape))
    want = _mix_tnh_backward(*(jnp.asarray(a, JAX_DTYPE[dtype]) for a in arrays),
                             n, causal)
    got = port_ops.attention_mix_tnh_bwd_reference(
        *(torch.from_numpy(a).to(dtype) for a in arrays), n, causal)
    _assert_grads_close(want, got, dtype)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_matches_jax_vjp(dtype, causal):
    q, k, v, dz = _inputs(50, 64, seed=11)
    jargs = [jnp.asarray(a, JAX_DTYPE[dtype]) for a in (q, k, v)]
    z_jax, vjp = jax.vjp(lambda *a: jax_mix(*a, N, causal), *jargs)
    want = vjp(jnp.asarray(dz, JAX_DTYPE[dtype]))
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_(True) for a in (q, k, v)]
    z = port_ops.attention_mix_tnh(*leaves, N, causal)
    got = torch.autograd.grad(z, leaves, torch.from_numpy(dz).to(dtype))
    np.testing.assert_allclose(z.detach().float().numpy(), np.asarray(z_jax, np.float32),
                               rtol=0, atol=ATOL[dtype])
    _assert_grads_close(want, got, dtype)


def test_cpu_autograd_takes_plain_versions_without_launching():
    q, k, v, dz = (torch.from_numpy(a) for a in _inputs(50, 64, seed=3))
    leaves = [a.clone().requires_grad_(True) for a in (q, k, v)]
    before = (port_ops.attention_mix_tnh.launches, port_ops.attention_mix_tnh_bwd.launches)
    z = port_ops.attention_mix_tnh(*leaves, N, True)
    got = torch.autograd.grad(z, leaves, dz)
    want = port_ops.attention_mix_tnh_bwd_reference(q, k, v, dz, N, True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(z, port_ops.attention_mix_tnh_reference(q, k, v, N, True))
    assert port_ops.attention_mix_tnh_bwd(q, k, v, dz, N, True)[0].equal(want[0])
    assert (port_ops.attention_mix_tnh.launches,
            port_ops.attention_mix_tnh_bwd.launches) == before


def test_bwd_gate_equals_forward_gate():
    # A forward that ran B1 must always find B2, at every head width.
    for H in range(1, port_ops.MAX_HEAD_DIM + 2):
        for T in range(1, 3000, 7):
            assert port_ops.mix_tnh_bwd_fits_smem(T, H) == port_ops.mix_tnh_fits_smem(T, H), (T, H)
    assert port_ops.mix_tnh_bwd_fits_smem(411, 64) and not port_ops.mix_tnh_bwd_fits_smem(412, 64)
    # at 4 warps B2's rows pass takes exactly B1's bytes (H a multiple of 4)
    for T, H in ((411, 64), (257, 64), (106, 256), (50, 8)):
        assert port_ops.mix_tnh_bwd_smem_bytes(T, H, 4)[0] == port_ops.mix_tnh_smem_bytes(T, H)


@pytest.mark.parametrize("H_first", [1, 65, 129, 193])
def test_bwd_gate_equals_forward_gate_everywhere(H_first):
    """B2's gate equals B1's at every T <= 1024 and H <= 256, so no route
    moves."""
    for H in range(H_first, H_first + 64):
        for T in range(1, 1025):
            assert port_ops.mix_tnh_bwd_fits_smem(T, H) == port_ops.mix_tnh_fits_smem(T, H), (T, H)


@pytest.mark.parametrize("H_first", [1, 33, 65, 97])
def test_tensor_core_backward_fits_wherever_the_gate_admits(H_first):
    """Each pass of the bfloat16 tensor-core route fits the H100's 227 KB
    at every (T, H <= 128) the gate admits, so no bfloat16 backward that
    ran before can be refused."""
    for H in range(H_first, H_first + 32):
        T = 1
        while port_ops.mix_tnh_bwd_fits_smem(T, H):
            assert port_ops.mix_tnh_bwd_tc_smem_bytes(T, H) <= 232448, (T, H)
            T += 1
        assert T > 16, H
    # CLIP L/14: one head's K and V (or Q and dZ) in 78 KB, two blocks an SM
    assert port_ops.mix_tnh_bwd_tc_smem_bytes(257, 64) == 78336
    assert port_ops.mix_tnh_bwd_tc_smem_bytes(257, 88) == 272 * 104 * 4  # 88 pads to 96


def test_oversized_T_raises_naming_flash_kernel():
    q = torch.zeros(1, 1024, N * 64)
    with pytest.raises(NotImplementedError, match="B13"):
        port_ops.attention_mix_tnh_bwd(q, q, q, q, N)
