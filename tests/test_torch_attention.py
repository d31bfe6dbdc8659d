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


def test_oversized_T_raises_naming_flash_kernel():
    T, H = 1024, 64
    assert not port_ops.mix_tnh_fits_smem(T, H)
    assert port_ops.mix_tnh_fits_smem(257, 64)  # CLIP L/14
    q = torch.zeros(1, T, N * H)
    with pytest.raises(NotImplementedError, match="B13"):
        port_ops.attention_mix_tnh(q, q, q, N)
