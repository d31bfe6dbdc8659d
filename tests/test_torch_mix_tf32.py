"""The float32 tensor-core route of the attention mix (B1 and B15 forward,
B2 backward: ``csrc/mix_tf32.cuh``, ``csrc/attention_mix_tnh_bwd.cu``) on
the CPU: its route map, its shared memory against the route gate, and its
arithmetic, 3xTF32, emulated with bit operations on the same products and
held to the plain versions within the kernels' float32 tolerance (1e-5:
``chip_smoke.py``'s KERNEL_TOL and GRAD_KERNEL_REL), which plain TF32 (one
product) must miss.  The CUDA kernels themselves are held to the plain
versions on the card by ``chip_smoke.py``."""

import math

import pytest
import torch

from tests._torch_parity import seeded
from vit_prisma_tpu_torch.ops import attention as port_ops

MAX_SMEM = 232448
TOL = 1e-5  # forward: absolute; each gradient: relative to max(1, its absmax)
LOG2E = 1.4426950408889634


def test_route_map_is_frozen():
    """float32 heads up to 128 wide take 3xTF32, wider heads the FFMA code;
    bfloat16 keeps its routes."""
    for H in range(1, 257):
        assert port_ops.mix_route(H, torch.float32) == ("tf32x3" if H <= 128 else "ffma"), H
        assert port_ops.mix_route(H, torch.bfloat16) == ("mma_sync" if H <= 128 else "ffma"), H


@pytest.mark.parametrize("H_first", [1, 33, 65, 97])
def test_tf32_route_fits_wherever_the_gate_admits(H_first):
    """The forward and both of B2's passes fit one block's shared memory at
    every (T, H <= 128) the unchanged gate admits, so no float32 call that
    ran on the FFMA route can be refused."""
    for H in range(H_first, H_first + 32):
        T = 1
        while port_ops.mix_tnh_fits_smem(T, H):
            for pass_ in ("fwd", "rows", "cols"):
                stride, nbytes = port_ops.mix_tf32_layout(T, H, pass_)
                assert nbytes <= MAX_SMEM and stride >= H, (T, H, pass_)
            T += 1
        assert T > 16, H


def test_tf32_footprints():
    layout = port_ops.mix_tf32_layout
    # CLIP L/14 (T 257 -> 264 rows) and the gate's last T at H 64 (411 ->
    # 416 rows): rows of 68 floats (64 padded to 4 mod 8), 16 floats of slack
    assert layout(257, 64) == (68, 4 * (2 * 264 * 68 + 16)) == (68, 143680)
    assert layout(257, 64, "cols") == (68, 4 * (2 * 264 * 68 + 3 * 264 + 16))
    assert layout(411, 64) == layout(411, 64, "rows") == (68, 226368)
    assert layout(411, 64, "cols") == (68, 231360)
    # H 88 pads to 92 floats; at the gate's last T (305) the columns pass
    # drops the padding to fit
    assert layout(257, 88, "cols")[0] == 92 and layout(305, 88)[0] == 92
    assert layout(305, 88, "cols")[0] == 88


def _tf32(x):
    """x rounded to TF32 (10 explicit mantissa bits), ties away from zero,
    as cvt.rna.tf32.f32 rounds: add half of the 13 dropped bits to the
    magnitude, then clear them."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _mm(eq, a, b, x3):
    """The product as the kernels form it: 3xTF32, a_lo b_hi + a_hi b_lo +
    a_hi b_hi with hi = tf32(x), lo = tf32(x - hi); or plain TF32
    (``x3=False``), the control."""
    ah, bh = _tf32(a), _tf32(b)
    if not x3:
        return torch.einsum(eq, ah, bh)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl) + torch.einsum(eq, ah, bh)


def _emulated(q, k, v, dz, n_heads, causal, x3):
    """z, dq, dk, dv with the route's rounding points: every product in TF32
    pieces (``_mm``), p = exp2(s log2(e) - m log2(e)) times 1 / l, D = the
    row sum of dp p, ds = p (dp - D)."""
    B, T, NH = q.shape
    H = NH // n_heads
    qf, kf, vf, dzf = (x.reshape(B, T, n_heads, H) for x in (q, k, v, dz))
    s = _mm("bqnh,bknh->bnqk", qf, kf, x3)
    if causal:
        s = s.masked_fill(~torch.ones(T, T, dtype=torch.bool).tril(), -math.inf)
    e = torch.exp2(s * LOG2E - s.amax(-1, keepdim=True) * LOG2E)
    p = e * (1 / e.sum(-1, keepdim=True))
    dp = _mm("bqnh,bknh->bnqk", dzf, vf, x3)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    flat = lambda x: x.reshape(B, T, NH)
    return (flat(_mm("bnqk,bknh->bqnh", p, vf, x3)), flat(_mm("bnqk,bknh->bqnh", ds, kf, x3)),
            flat(_mm("bnqk,bqnh->bknh", ds, qf, x3)), flat(_mm("bnqk,bqnh->bknh", p, dzf, x3)))


def _errors(T, H, causal, x3):
    """Each output's error against the plain versions, over its limit."""
    n = 2
    shape = (1, T, n * H)
    q, k, v, dz = (torch.from_numpy(seeded(T + H + i, shape, H ** -0.5 if i == 0 else 1.0))
                   for i in range(4))
    want = (port_ops.attention_mix_tnh_reference(q, k, v, n, causal),
            *port_ops.attention_mix_tnh_bwd_reference(q, k, v, dz, n, causal))
    got = _emulated(q, k, v, dz, n, causal, x3)
    return {name: (g - w).abs().max().item() / (TOL * (1.0 if name == "z" else
                                                       max(1.0, w.abs().max().item())))
            for name, g, w in zip(("z", "dq", "dk", "dv"), got, want)}


# The B/32 and CLIP L/14 token counts and the gate's last T at H 64, and a
# head width the route pads (88, whose gate ends at T 305).
SHAPES = [(50, 64), (257, 64), (411, 64), (50, 88), (257, 88)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T,H", SHAPES)
def test_3xtf32_is_within_the_float32_tolerance(T, H, causal):
    """3xTF32 keeps the forward and the three gradients within 1e-5 of the
    plain float32 versions (about 1e-6 here): the card's float32 tolerance
    needs no change for the route."""
    ratio = _errors(T, H, causal, x3=True)
    assert all(r <= 1.0 for r in ratio.values()), ratio


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T,H", SHAPES)
def test_plain_tf32_misses_the_float32_tolerance(T, H, causal):
    """The control: one TF32 product rounds float32 inputs to 2^-11, some
    3e-4 to 1e-3 off on every output, past the limit the route holds."""
    ratio = _errors(T, H, causal, x3=False)
    assert all(r > 1.0 for r in ratio.values()), ratio
