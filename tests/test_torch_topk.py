"""Kernel B10 (its plain version, which CPU tensors run) and the TopK mask
activation against the JAX package's ``ops/topk.py`` (the Pallas kernel in
interpret mode); and a JAX-free import of the port's ``ops.topk``.  The
CUDA kernel itself is held to the plain version on the card by
``chip_smoke.py``."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import seeded
from vit_prisma_tpu.ops import topk as jax_topk
from vit_prisma_tpu_torch.ops import topk

ROWS, D = 64, 512


def _rows(seed=0):
    """Rows of N(0, 1); every fourth shifted negative (a negative k-th
    value), every other one quantized to quarters (tied k-th values)."""
    x = seeded(seed, (ROWS, D))
    x[::4] -= 10.0
    x[1::2] = np.round(x[1::2] * 4) / 4
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 32, D])
def test_kth_value_plain_matches_jax_bitwise(dtype, k):
    x = _rows()
    want = np.asarray(jax_topk.kth_value(jnp.asarray(x, jnp.dtype(dtype)), k, interpret=True))
    before = topk.kth_value.launches
    got = topk.kth_value(torch.from_numpy(x).to(getattr(torch, dtype)), k)
    assert topk.kth_value.launches == before  # CPU tensors run the plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == (ROWS, 1)
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kth_value_keeps_ties_and_is_the_k_th_value(dtype):
    """x >= t keeps the top k and every entry tied with the k-th; t is the
    k-th value itself except for bfloat16 rows with a negative k-th value,
    where it is a separator just below it."""
    x = torch.from_numpy(_rows(seed=1)).to(getattr(torch, dtype))
    k = 32
    t = topk.kth_value(x, k)
    values = torch.kthvalue(x.float(), D - k + 1, dim=1).values
    kept = (x >= t).sum(dim=1)
    assert torch.equal(kept, (x.float() >= values[:, None]).sum(dim=1))
    assert (kept >= k).all() and (kept[1::2] > k).any()  # quantized rows tie
    exact = values >= 0 if dtype == "bfloat16" else torch.ones(ROWS, dtype=torch.bool)
    assert torch.equal(t[exact, 0], values[exact])
    if dtype == "bfloat16":
        assert (t[~exact, 0] < values[~exact]).all()


def test_kth_value_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="outside"):
        topk.kth_value(x, 9)
    with pytest.raises(ValueError, match="outside"):
        topk.kth_value(x, 0)
    with pytest.raises(ValueError, match=r"\[rows, D\]"):
        topk.kth_value(x[None], 2)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        topk.kth_value(x.half(), 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_topk_mask_activation_matches_jax(dtype):
    """Outputs bitwise; grads (through the kept entries only) within 1e-6."""
    x = seeded(2, (3, 40, 256), 2.0)  # [..., d] inputs reshape to rows
    x[1] = np.round(x[1] * 2) / 2
    g = seeded(3, x.shape)
    jdt, pdt = jnp.dtype(dtype), getattr(torch, dtype)
    jx = jnp.asarray(x, jdt)
    want, vjp = jax.vjp(lambda a: jax_topk.topk_mask_activation(a, 16), jx)
    (want_grad,) = vjp(jnp.asarray(g, jdt))
    px = torch.from_numpy(x).to(pdt).requires_grad_(True)
    got = topk.topk_mask_activation(px, 16)
    (got_grad,) = torch.autograd.grad(got, px, torch.from_numpy(g).to(pdt))
    assert got.dtype == pdt and got.shape == px.shape
    np.testing.assert_array_equal(got.detach().float().numpy(), np.asarray(want, np.float32))
    np.testing.assert_allclose(got_grad.float().numpy(), np.asarray(want_grad, np.float32),
                               rtol=0, atol=1e-6)


def test_topk_ops_import_loads_no_jax():
    code = ("import sys, vit_prisma_tpu_torch.ops.topk, vit_prisma_tpu_torch.sae; "
            "bad = sorted(m for m in sys.modules "
            "if m.startswith('jax') or m.startswith('vit_prisma_tpu.') "
            "or m == 'vit_prisma_tpu'); "
            "assert not bad, bad")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=root)
