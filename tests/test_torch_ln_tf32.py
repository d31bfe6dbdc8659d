"""The float32 tensor-core route of B14, the LayerNorm -> GEMM
(``csrc/ln_matmul.cu``'s ``ln_gemm_tf32_kernel`` on the float32 pieces of
``csrc/hopper_gemm.cuh``), on the CPU: its route map, its shared memory,
its scratch, the K order its W pre-pass writes, and its arithmetic,
emulated with bit operations on the same pieces and in the same order: the
normalize as the kernel forms it (a reciprocal and one Newton correction),
each float32 product as three TF32 products (hi = x rounded to TF32, lo =
(x - hi) rounded, ties away from zero, as the split rounds), each 32-deep
stage summed from zero (x_lo W_hi, then x_hi W_lo, then x_hi W_hi, each
over the stage's four k8 steps in the pre-pass's K order) and added to the
running total, then the bias.  The emulation is held to the plain version
within the kernel's float32 tolerance (1e-5 of max(1, absmax):
``chip_smoke.py``'s LN_REL), the plain version to JAX's ``ln_matmul`` on
the CPU; plain TF32 (one product) must miss that tolerance.  The CUDA
kernel itself is held to the plain version on the card by
``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import seeded
from vit_prisma_tpu.ops import ln_matmul as jax_ops
from vit_prisma_tpu_torch.ops import ln_matmul as port_ops

MAX_SMEM = 232448  # a block's
TOL = 1e-5  # relative to max(1, absmax)
EPS = 1e-5
STAGE = 32  # K a stage: one 128-byte swizzled row of floats


def k_phys(k):
    """The activation column that position k of a stage of the split copy
    holds (hopper_gemm.cuh's k_phys): k8 step kk = k // 8, position j = k %
    8 -> 8 (j % 4) + 2 kk + j // 4."""
    kk, j = divmod(k, 8)
    return 8 * (j % 4) + 2 * kk + j // 4


K_ORDER = torch.tensor([k_phys(k) for k in range(STAGE)])


def test_route_map_is_frozen():
    """float32 takes 3xTF32 on tf32 wgmma, bfloat16 keeps its wgmma kernel;
    nothing else has a route."""
    assert port_ops.ln_matmul_route(torch.float32) == "tf32x3"
    assert port_ops.ln_matmul_route(torch.bfloat16) == "wgmma"
    with pytest.raises(TypeError):
        port_ops.ln_matmul_route(torch.float16)


def test_gate_is_unchanged():
    """C a multiple of 128 and D of 32, any R: the gate the FFMA route had."""
    assert port_ops.ln_matmul_fits(36_928, 1, 1024, 4096)
    assert port_ops.ln_matmul_fits(18_464, 1, 1024, 4096)
    assert port_ops.ln_matmul_fits(12_801, 1, 768, 640)
    assert port_ops.ln_matmul_fits(1, 3, 768, 768)
    assert not port_ops.ln_matmul_fits(256, 1, 768, 100)
    assert not port_ops.ln_matmul_fits(256, 1, 40, 128)
    assert not port_ops.ln_matmul_fits(128 * 65_536, 1, 32, 128)


def test_pinned_footprints():
    """Four 48 KB stages (a [128 x 32] float x tile, W's hi and lo [128 x
    32] tiles), 8 mbarriers and 1 KB of alignment, at every C: one block an
    SM; bfloat16 as before."""
    for C in (640, 768, 3072, 4096):
        assert port_ops.ln_matmul_smem_bytes(torch.float32, C) == 4 * 3 * 16384 + 64 + 1024
        assert port_ops.ln_matmul_smem_bytes(torch.float32, C) == 197_696 <= MAX_SMEM
    assert port_ops.ln_matmul_smem_bytes(torch.bfloat16, 768) == 197_696
    assert port_ops.ln_matmul_smem_bytes(torch.bfloat16, 640) == 132_160


def test_pinned_scratch():
    """The rows' mean and scale, then (float32) W's split copy [2, S, C, D]
    from a 128-byte aligned offset."""
    f = port_ops._scratch_floats
    assert f(18_464, 1, 1024, 4096, torch.float32) == 36_928 + 2 * 4096 * 1024
    assert f(12_801, 3, 768, 768, torch.float32) == 25_632 + 2 * 3 * 768 * 768
    assert f(12_801, 3, 768, 768, torch.bfloat16) == 25_602
    assert all(-(-2 * R // 32) * 32 % 32 == 0 for R in (1, 7, 129))


def test_k_order_gives_each_thread_two_chunks():
    """The pre-pass's K order is a permutation of each stage, and thread t
    of a warp (lane % 4) reads, for rows g and g + 8, exactly the 16-byte
    chunks 2t and 2t + 1: fragment element e of k8 step kk (the mma.sync
    tf32 A layout: column t, t + 4 for e // 2 = 0, 1) sits at the column
    load_frags puts it."""
    assert sorted(K_ORDER.tolist()) == list(range(STAGE))
    for t in range(4):
        cols = set()
        for kk in range(4):
            for e in range(4):
                pos = 8 * kk + t + 4 * (e // 2)
                col = k_phys(pos)
                chunk, word = divmod(col, 4)
                # load_frags: chunk 2t + c, word w -> x[2c + w // 2][h + 2 (w % 2)]
                c, w = chunk - 2 * t, word
                assert c in (0, 1) and (2 * c + w // 2, 2 * (w % 2)) == (kk, 2 * (e // 2))
                cols.add(col)
        assert cols == set(range(8 * t, 8 * t + 8))


def _tf32(x):
    """x rounded to TF32 (10 explicit mantissa bits), ties away from zero,
    as the split rounds (cvt.rna.tf32.f32's rounding)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _fma(a, b, c):
    """a b + c rounded once to float32, as fmaf."""
    return (a.double() * b + c.double()).float()


def _normalize(x):
    """The kernel's island: float32 mean and scale, then (x - mean) / scale
    from the reciprocal and one Newton correction (norm1)."""
    mean = x.mean(-1, keepdim=True)
    xc = x - mean
    scale = torch.sqrt((xc * xc).mean(-1, keepdim=True) + EPS)
    inv = 1 / scale
    q = xc * inv
    return _fma(_fma(-q, scale, xc), inv, q)


def _emulated(x, W, b, x3=True):
    """out [S, R, C] as ln_gemm_tf32_kernel forms it: stage by stage, the
    stage's sum from zero, small products first, added to the total."""
    xn = _normalize(x)
    S, D, C = W.shape
    out = torch.zeros(S, x.shape[0], C)
    for k0 in range(0, D, STAGE):
        cols = k0 + K_ORDER  # the stage's columns in the pre-pass's K order
        a, w = xn[:, cols], W[:, cols, :]
        ah, wh = _tf32(a), _tf32(w)
        al, wl = _tf32(a - ah), _tf32(w - wh)
        products = ((al, wh), (ah, wl), (ah, wh)) if x3 else ((ah, wh),)
        c = torch.zeros_like(out)
        for pa, pw in products:
            for kk in range(4):
                s = slice(8 * kk, 8 * kk + 8)
                c = c + torch.einsum("rk,skc->src", pa[:, s], pw[:, s, :])
        out = out + c
    return out + b[:, None, :]


# B/32's QKV and MLP-in widths and an L/14-336-width block (D 1024 -> C
# 4096) with R cut to a few hundred rows, and the edge (C 640, one row past
# a 128-row tile).
SHAPES = [("b32_qkv", 300, 3, 768, 768), ("b32_mlp_in", 300, 1, 768, 3072),
          ("l14_336_mlp_in", 160, 1, 1024, 4096), ("edge", 129, 1, 768, 640)]


def _operands(R, S, D, C, seed):
    """chip_smoke.py's operands: x 2 N(0, 1) + 0.5, W scaled by D^-0.5, b by
    0.02."""
    return (seeded(seed, (R, D)) * 2.0 + 0.5, seeded(seed + 1, (S, D, C), D ** -0.5),
            seeded(seed + 2, (S, C), 0.02))


@pytest.mark.parametrize("x3", [True, False], ids=["3xtf32", "tf32_control"])
@pytest.mark.parametrize("name,R,S,D,C", SHAPES, ids=[s[0] for s in SHAPES])
def test_stagewise_3xtf32_within_the_float32_tolerance(name, R, S, D, C, x3):
    """The emulation within 1e-5 of max(1, absmax) of the plain version
    (about 1e-6 here), which is itself within that of JAX's ``ln_matmul``;
    one TF32 product (the control) misses it."""
    arrays = _operands(R, S, D, C, seed=R + C)
    x, W, b = (torch.from_numpy(a) for a in arrays)
    want = port_ops.ln_matmul_reference(x, W, b, EPS)
    limit = TOL * max(1.0, want.abs().max().item())
    jax_out = torch.from_numpy(np.array(jax_ops.ln_matmul(*(jnp.asarray(a) for a in arrays),
                                                            EPS)))
    assert (want - jax_out).abs().max().item() <= limit, "plain against JAX"
    ratio = (_emulated(x, W, b, x3) - want).abs().max().item() / limit
    assert (ratio <= 1.0) if x3 else (ratio > 1.0), ratio


def test_rows_do_not_depend_on_R():
    """A row's output is summed in one fixed order whatever R: the
    emulation of the first rows alone equals the same rows of the whole."""
    x, W, b = (torch.from_numpy(a) for a in _operands(300, 1, 768, 768, seed=5))
    assert torch.equal(_emulated(x[:128], W, b), _emulated(x, W, b)[:, :128])
