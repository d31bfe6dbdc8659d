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


def _wide_rows(D, seed):
    """Six rows of width D: N(0, 1), shifted negative, quantized to quarters
    (tied), one repeated value, +0.0 and -0.0 mixed, and -0.0 with a few
    positives."""
    x = seeded(seed, (6, D))
    x[1] -= 10.0
    x[2] = np.round(x[2] * 4) / 4
    x[3] = 0.75
    x[4] = np.where(x[4] > 0, 0.0, -0.0)
    x[5] = -0.0
    x[5, ::97] = 1.5
    return x


# Past the parent kernel's 96 KB of staging (float32 rows of 24,576,
# bfloat16 rows of 49,152), where the port's kernel takes a thread-block
# cluster: the plain version it is held to on the card against JAX.
@pytest.mark.parametrize("dtype,D", [("float32", 24_577), ("bfloat16", 49_153)])
@pytest.mark.parametrize("k", ["1", "64", "D"])
def test_kth_value_plain_matches_jax_bitwise_past_one_block(dtype, D, k):
    k = D if k == "D" else int(k)
    x = _wide_rows(D, seed=4)
    want = np.asarray(jax_topk.kth_value(jnp.asarray(x, jnp.dtype(dtype)), k, interpret=True))
    got = topk.kth_value(torch.from_numpy(x).to(getattr(torch, dtype)), k)
    assert got.dtype == torch.float32 and tuple(got.shape) == (6, 1)
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))


# The kernel's static shared memory: four pass histograms of 256 counts and,
# in its per-warp variant, eight warp histograms; an SM offers a block 227 KB.
KTH_STATIC_SMEM = 4 * 256 * 4 + 8 * 256 * 4
SMEM_PER_BLOCK = 232_448


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kth_value_route_covers_every_width(dtype):
    """kth_value_route (the Python mirror of the kernel's plan) for every D
    from 1 to 2^20: one block while the row fits its staging, a cluster of
    3-8 blocks (a part of at least KTH_CLUSTER_PART bytes each, where 8
    allow it) that together cover the row while it fits theirs, streamed
    past that; no block stages more than 227 KB less the histograms."""
    dt = getattr(torch, dtype)
    elem = 2 if dtype == "bfloat16" else 4
    vec = 16 // elem
    block_max = topk.KTH_STAGE_CAP // elem
    cluster_max = topk.KTH_MAX_CLUSTER * block_max
    seen = set()
    for D in range(1, 2 ** 20 + 1):
        r = topk.kth_value_route(D, dt)
        cluster, part, stage = r["cluster"], r["part"], r["stage_bytes"]
        want = "block" if D <= block_max else "cluster" if D <= cluster_max else "streamed"
        assert r["route"] == want, (D, r)
        assert 1 <= cluster <= topk.KTH_MAX_CLUSTER and (cluster == 1) == (want == "block")
        assert part % vec == 0 and cluster * part >= D and (cluster - 1) * part < D, (D, r)
        assert stage == (0 if want == "streamed" else part * elem + 16), (D, r)
        assert stage + KTH_STATIC_SMEM <= SMEM_PER_BLOCK, (D, r)
        if want == "cluster" and cluster < topk.KTH_MAX_CLUSTER:
            assert (cluster - 1) * topk.KTH_CLUSTER_PART < D * elem, (D, r)
        seen.add((r["route"], cluster))
    assert seen == ({("block", 1), ("streamed", 8)}
                    | {("cluster", c) for c in range(3, topk.KTH_MAX_CLUSTER + 1)})


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
