"""The port's attention mix (kernel B1's plain version) against the JAX
package's ``attention_mix_tnh``, whose Pallas kernel runs here in interpret
mode.  The CUDA kernel itself is held to the plain version on the card by
``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import assert_close, seeded
from vit_prisma_tpu.ops.attention import attention_mix_tnh as jax_mix
from vit_prisma_tpu_torch.ops import attention as port_ops

B, N = 2, 3


def _qkv(T, H, seed):
    shape = (B, T, N * H)
    # q pre-scaled by 1/sqrt(H), as the model passes it
    return (seeded(seed, shape, H ** -0.5), seeded(seed + 1, shape),
            seeded(seed + 2, shape))


@pytest.mark.parametrize("H", [8, 64])
@pytest.mark.parametrize("T", [12, 50, 77])
@pytest.mark.parametrize("causal", [False, True])
def test_mix_matches_jax_f32(causal, T, H):
    q, k, v = _qkv(T, H, seed=T + H)
    want = jax_mix(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), N, causal)
    got = port_ops.attention_mix_tnh_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), N, causal)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, T, N * H)
    assert_close(want, got, atol=1e-5)


def test_mix_matches_jax_bf16():
    q, k, v = _qkv(50, 64, seed=7)
    want = jax_mix(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), N, False)
    got = port_ops.attention_mix_tnh_reference(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)), N, False)
    assert got.dtype == torch.bfloat16
    assert_close(np.asarray(want, np.float32), got, atol=2e-2)


def test_cpu_wrapper_takes_plain_version_without_launching():
    q, k, v = (torch.from_numpy(a) for a in _qkv(50, 64, seed=3))
    before = port_ops.attention_mix_tnh.launches
    got = port_ops.attention_mix_tnh(q, k, v, N, True)
    want = port_ops.attention_mix_tnh_reference(q, k, v, N, True)
    assert torch.equal(got, want)
    assert port_ops.attention_mix_tnh.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("H", [64, 88])
@pytest.mark.parametrize("T,batch", [(257, 2), (411, 1)])  # CLIP L/14; the gate's last T
def test_mix_matches_jax_long_T(T, batch, H, causal, dtype):
    """The token axes of CLIP L/14 and the gate's edge, at the head widths of
    the bfloat16 kernel's unpadded and padded routes (88 pads to 96)."""
    n = 2
    shape = (batch, T, n * H)
    q, k, v = (seeded(T + H, shape, H ** -0.5), seeded(T + H + 1, shape),
               seeded(T + H + 2, shape))
    want = jax_mix(*(jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)), n, causal)
    got = port_ops.attention_mix_tnh_reference(
        *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)), n, causal)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == shape
    assert_close(np.asarray(want, np.float32), got, atol=1e-5 if dtype == "float32" else 2e-2)


def _gate_before_tensor_cores(T, H):
    """The route gate as it stood before the bfloat16 tensor-core kernel:
    the float32 kernel's shared memory at one row a warp."""
    h4 = -(-H // 4) * 4
    return H <= 256 and 4 * (T * (h4 + 4) + 8 * h4 + T * H + 8 * T) <= 232448


@pytest.mark.parametrize("H_first", [1, 65, 129, 193])
def test_route_gate_is_frozen(H_first):
    """B1 against B13 decides on the same (T, H) as before, in either dtype."""
    for H in range(H_first, H_first + 64):
        for T in range(1, 1025):
            assert port_ops.mix_tnh_fits_smem(T, H) == _gate_before_tensor_cores(T, H), (T, H)
    assert port_ops.mix_tnh_fits_smem(411, 64) and not port_ops.mix_tnh_fits_smem(412, 64)


@pytest.mark.parametrize("H_first", [1, 33, 65, 97])
def test_tensor_core_kernel_fits_wherever_the_gate_admits(H_first):
    """Every (T, H <= 128) the gate admits fits the bfloat16 kernel's shared
    memory, so no bfloat16 route that ran before can be refused."""
    for H in range(H_first, H_first + 32):
        T = 1
        while port_ops.mix_tnh_fits_smem(T, H):
            assert port_ops.mix_tc_smem_bytes(T, H) <= 232448, (T, H)
            T += 1
        assert T > 16, H
    assert port_ops.MIX_TC_MAX_HEAD_DIM == 128
    # CLIP L/14: K and V in 78 KB, two blocks an SM; the gate's edge, 120 KB
    assert port_ops.mix_tc_smem_bytes(257, 64) == 78336
    assert port_ops.mix_tc_smem_bytes(411, 64) == 119808
    assert port_ops.mix_tc_smem_bytes(257, 88) == 272 * 104 * 4  # 88 pads to 96


def test_oversized_T_raises_naming_flash_kernel():
    T, H = 1024, 64
    assert not port_ops.mix_tnh_fits_smem(T, H)
    assert port_ops.mix_tnh_fits_smem(257, 64)  # CLIP L/14
    q = torch.zeros(1, T, N * H)
    with pytest.raises(NotImplementedError, match="B13"):
        port_ops.attention_mix_tnh(q, q, q, N)
