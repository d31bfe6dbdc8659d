"""The float32 tensor-core route of B13, the tiled flash attention
(``csrc/flash_tf32.cuh``; namespace ``f32tc`` of
``csrc/flash_attention_{fwd,bwd}.cu``), on the CPU: its route map, its
shared memory, and its arithmetic, emulated with bit operations on the
same pieces and in the same order of chunks: 3xTF32 products (the scores'
small products summed apart), the forward's chunks of keys with the online
softmax (m and l carried, the accumulator rescaled by 2^((m_old - m)
log2(e)), each chunk's P V summed from zero and then added), and the
backward's chunks of 32 (or 16) queries (dk/dv) or keys (dq), each chunk's
gradient product summed from zero and then added.  The emulation is held to the plain versions within the kernels'
float32 tolerance (1e-5 of max(1, absmax): ``chip_smoke.py``'s FLASH_REL),
and the plain versions to JAX's ``flash_attention_padded`` on the CPU; plain
TF32 (one product) must miss that tolerance on every output.  The CUDA
kernels themselves are held to the plain versions on the card by
``chip_smoke.py``."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import seeded
from vit_prisma_tpu.ops import attention as jax_ops
from vit_prisma_tpu_torch.ops import attention as port_ops

MAX_SMEM = 232448  # a block's
SM_SMEM = 233472  # an SM's
TOL = 1e-5  # each output: relative to max(1, its absmax)
LOG2E = 1.4426950408889634
WIDTHS = range(16, 129, 16)  # every head width flash_fits takes


def test_route_map_is_frozen():
    """float32 takes 3xTF32 at every width; bfloat16 keeps wgmma at 64 and
    128 and mma.sync at the other widths."""
    for H in WIDTHS:
        assert port_ops.flash_fits(640, H)
        assert port_ops.flash_route(H, torch.float32) == "tf32x3", H
        assert port_ops.flash_route(H, torch.bfloat16) == (
            "wgmma" if H in (64, 128) else "mma_sync"), H
    assert not any(port_ops.flash_fits(640, H) for H in range(1, 129) if H not in WIDTHS)


def test_layout_fits_one_block_at_every_width():
    """Each pass fits one block's shared memory at every width, and its
    rows of H + 4 floats are 4 mod 8 (ldmatrix's 8 rows and the permuted
    scalar reads in distinct banks)."""
    for H in WIDTHS:
        for pass_ in ("fwd", "dkv", "dq"):
            stride, nbytes = port_ops.flash_tf32_layout(H, pass_)
            assert stride == H + 4 and stride % 8 == 4, (H, pass_)
            assert nbytes <= MAX_SMEM, (H, pass_, nbytes)


def test_pinned_footprints():
    layout = port_ops.flash_tf32_layout
    # forward: two (K, V) pairs of 32 rows of 68 floats, two stages of 32
    # segment ids: three blocks an SM
    assert layout(64, "fwd") == (68, 4 * (4 * 32 * 68 + 2 * 32)) == (68, 35072)
    # dk/dv: the block's 64 K and V rows, two (Q, dZ) pairs, and per stage
    # 32 segment ids, -lse log2(e) and D; dq: 64 Q and dZ rows, two (K, V)
    # pairs, segment ids: three blocks an SM
    assert layout(64, "dkv") == (68, 70400) and layout(64, "dq") == (68, 69888)
    # an SM's 228 KB hold three blocks of each (1 KB reserved a block)
    assert all(3 * (layout(64, p)[1] + 1024) <= SM_SMEM for p in ("fwd", "dkv", "dq"))
    assert layout(128, "fwd") == (132, 67840)
    assert layout(128, "dkv") == (132, 4 * (2 * 64 * 132 + 4 * 32 * 132 + 6 * 32)) == (132, 135936)
    assert layout(128, "dq") == (132, 135424)


def _tf32(x):
    """x rounded to TF32 (10 explicit mantissa bits), ties away from zero,
    as the kernels' integer split rounds (cvt.rna.tf32.f32's rounding)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _mm(eq, a, b, x3, apart=False):
    """A product as the kernels form it: 3xTF32 (a_lo b_hi + a_hi b_lo +
    a_hi b_hi, hi = tf32(x), lo = tf32(x - hi); ``apart``: the two small
    products summed apart from the large one and added last, as the
    scores are), or plain TF32 (``x3=False``), the control."""
    ah, bh = _tf32(a), _tf32(b)
    if not x3:
        return torch.einsum(eq, ah, bh)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    small = torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
    big = torch.einsum(eq, ah, bh)
    return big + small if apart else small + big


def _fma(a, b, c):
    """a b + c rounded once to float32, as fmaf."""
    return (a.double() * b + c.double()).float()


def _keep(seg, causal, rows, cols):
    """[B, rows, cols] visibility of query rows ``rows`` and keys ``cols``."""
    keep = seg[:, rows, None] == seg[:, None, cols]
    if causal:
        keep = keep & (rows[:, None] >= cols[None, :])
    return keep[:, None]  # heads


def _forward(q, k, v, seg, causal, x3):
    """z and lse as the forward kernel forms them: chunks of 32 keys (16
    past H 96), the online softmax with ex2 and log2(e) folded in."""
    B, N, Tp, H = q.shape
    C = 32 if H <= 96 else 16
    rows = torch.arange(Tp)
    m = torch.full((B, N, Tp), -math.inf)
    l = torch.zeros(B, N, Tp)
    acc = torch.zeros(B, N, Tp, H)
    for c0 in range(0, Tp, C):
        cols = torch.arange(c0, c0 + C)
        s = _mm("bnqh,bnkh->bnqk", q, k[:, :, cols], x3, apart=True)
        s = s.masked_fill(~_keep(seg, causal, rows, cols), -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        base = torch.where(m_new == -math.inf, 0.0, m_new)
        nb = -base * LOG2E
        alpha = torch.exp2((m - base) * LOG2E)  # exactly 1 while m holds
        p = torch.exp2(_fma(s, LOG2E, nb[..., None]))
        l = _fma(l, alpha, p.sum(-1))
        acc = acc * alpha[..., None] + _mm("bnqk,bnkh->bnqh", p, v[:, :, cols], x3)
        m = m_new
    inv = torch.where(l > 0, 1 / l, 0.0)
    return acc * inv[..., None], torch.where(l > 0, m + torch.log(l), math.inf)


def _p_ds(s, dp, nl, D, keep):
    """p = exp2(s log2(e) - lse log2(e)) where the key is visible, and ds =
    p (dp - D)."""
    p = torch.where(keep, torch.exp2(_fma(s, LOG2E, nl)), 0.0)
    return p, p * (dp - D)


def _backward(q, k, v, seg, dz, lse, dsum, causal, x3):
    """dq, dk, dv as the two passes form them: the dk/dv pass in chunks of
    32 queries (16 past H 96), the dq pass in chunks of 32 keys."""
    B, N, Tp, H = q.shape
    nl = -lse * LOG2E
    every = torch.arange(Tp)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    C = 32 if H <= 96 else 16
    for c0 in range(0, Tp, C):  # dk/dv: query chunks against every key
        qs = torch.arange(c0, c0 + C)
        sT = _mm("bnkh,bnqh->bnkq", k, q[:, :, qs], x3, apart=True)
        dpT = _mm("bnkh,bnqh->bnkq", v, dz[:, :, qs], x3, apart=True)
        keep = _keep(seg, causal, qs, every).transpose(-1, -2)
        p, ds = _p_ds(sT, dpT, nl[:, :, None, qs], dsum[:, :, None, qs], keep)
        dv = dv + _mm("bnkq,bnqh->bnkh", p, dz[:, :, qs], x3)
        dk = dk + _mm("bnkq,bnqh->bnkh", ds, q[:, :, qs], x3)
    dq = torch.zeros_like(q)
    for c0 in range(0, Tp, 32):  # dq: key chunks against every row
        ks = torch.arange(c0, c0 + 32)
        s = _mm("bnqh,bnkh->bnqk", q, k[:, :, ks], x3, apart=True)
        dp = _mm("bnqh,bnkh->bnqk", dz, v[:, :, ks], x3, apart=True)
        _, ds = _p_ds(s, dp, nl[..., None], dsum[..., None], _keep(seg, causal, every, ks))
        dq = dq + _mm("bnqk,bnkh->bnqh", ds, k[:, :, ks], x3)
    return dq, dk, dv


def _operands(T, Tp, H, B=1, N=2):
    seed = T + H
    pad = lambda a: np.pad(a, ((0, 0), (0, 0), (0, Tp - T), (0, 0)))
    q = pad(seeded(seed, (B, N, T, H), H ** -0.5))
    k, v = (pad(seeded(seed + i, (B, N, T, H))) for i in (1, 2))
    dz = seeded(seed + 3, (B, N, Tp, H))
    seg = np.broadcast_to(np.where(np.arange(Tp) < T, 1, 2).astype(np.int32), (B, Tp)).copy()
    return q, k, v, dz, seg


_JAX = {}


def _jax(T, Tp, H, causal, B=1, N=2):
    """JAX's forward and VJP on the CPU (z, dq, dk, dv), once per case."""
    key = (T, Tp, H, causal, B, N)
    if key not in _JAX:
        q, k, v, dz, seg = _operands(T, Tp, H, B, N)
        f = lambda a, b, c: jax_ops.flash_attention_padded(a, b, c, jnp.asarray(seg), causal)
        z, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
        _JAX[key] = tuple(torch.from_numpy(np.asarray(x)) for x in (z, *vjp(jnp.asarray(dz))))
    return _JAX[key]


def _errors(T, Tp, H, causal, x3, B=1, N=2):
    """Each output's error against the plain versions, over its limit; the
    plain versions against JAX's first (within the same limit)."""
    q, k, v, dz, seg = (torch.from_numpy(a) for a in _operands(T, Tp, H, B, N))
    want = {"z": port_ops.flash_attention_padded_reference(q, k, v, seg, causal),
            "lse": port_ops.flash_lse_reference(q, k, seg, causal)}
    want.update(zip(("dq", "dk", "dv"),
                    port_ops.flash_attention_padded_bwd_reference(q, k, v, seg, dz, causal)))
    limit = {n: TOL * max(1.0, w.abs().max().item()) for n, w in want.items()}
    for n, j in zip(("z", "dq", "dk", "dv"), _jax(T, Tp, H, causal, B, N)):
        assert (want[n] - j).abs().max().item() <= limit[n], ("plain against JAX", n)
    z, lse = _forward(q, k, v, seg, causal, x3)
    dsum = port_ops.flash_dsum(z, dz)
    got = dict(z=z, lse=lse)
    got.update(zip(("dq", "dk", "dv"), _backward(q, k, v, seg, dz, lse, dsum, causal, x3)))
    return {n: (got[n] - w).abs().max().item() / limit[n] for n, w in want.items()}


# CLIP L/14-336's token count (577 -> Tp 640) at its head width, at
# V-JEPA's (80) and at the widest the route takes (128); causal or not.
SHAPES = [(577, 640, 64), (577, 640, 80), (577, 640, 128)]


@pytest.mark.parametrize("x3", [True, False], ids=["3xtf32", "tf32_control"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T,Tp,H", SHAPES)
def test_tiled_3xtf32_within_the_float32_tolerance(T, Tp, H, causal, x3):
    """3xTF32 in the kernels' chunks keeps the forward, lse and the three
    gradients within 1e-5 of the plain versions; one TF32 product (the
    control) misses that on every output."""
    ratio = _errors(T, Tp, H, causal, x3)
    if x3:
        assert all(r <= 1.0 for r in ratio.values()), ratio
    else:
        assert all(r > 1.0 for r in ratio.values()), ratio


@pytest.mark.parametrize("x3", [True, False], ids=["3xtf32", "tf32_control"])
def test_long_axis_accumulation(x3):
    """ViViT-B's token count (3137 -> Tp 3200): 100 chunks of 32 in the
    forward and in each backward pass, each summed from zero and then
    added, stay within the tolerance; the control does not."""
    ratio = _errors(3137, 3200, 64, False, x3, N=1)
    if x3:
        assert all(r <= 1.0 for r in ratio.values()), ratio
    else:
        assert all(r > 1.0 for r in ratio.values()), ratio
