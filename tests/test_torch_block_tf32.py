"""The float32 tensor-core route of B16, the fused attention block
(``csrc/attention_block.cu``'s ``block_tf32_kernel``), on the CPU: its
route map, its shared memory, its scratch, the order its Wqkv pre-pass
writes each head's columns in, and its arithmetic, emulated with bit
operations on the same pieces and in the same order: the QKV and output
products as three TF32 products each (hi = x rounded to TF32, lo = (x -
hi) rounded, ties away from zero), each 32-deep stage of K summed from
zero (the two small products first, each over the stage's four k8 steps
in the pre-pass's K order) and added to the running total; the bias in
float32 and q's scale; the mix as B1's float32 device code forms it
(scores with the small products summed apart, p = 2^(s log2(e) - m
log2(e)) / l, p V in chunks of 32, 16 and 8 keys, each summed from zero
and then added).  The emulation is held to the plain version and to the
JAX reference's twin within the kernel's float32 tolerance (1e-5 of
max(1, absmax): ``chip_smoke.py``'s BLOCK_F32_REL), the plain version to
JAX's ``fused_attention_block`` on the CPU; plain TF32 (one product) must
miss that tolerance.  The CUDA kernel itself is held to both on the card
by ``chip_smoke.py``."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import seeded
from vit_prisma_tpu.ops import attention as jax_ops
from vit_prisma_tpu_torch.ops import attention as port_ops

MAX_SMEM = 232448  # a block's
TOL = 1e-5  # relative to max(1, absmax)
LOG2E = 1.4426950408889634
STAGE = 32
H = 64
SCALE = 0.125
# CLIP ViT-B/32's block (T 50, D 768, 12 heads) with 3 images: a full block
# of two and a lone third
B, T, D, N = 3, 50, 768, 12
NH = N * H


def k_phys(k):
    """hopper_gemm.cuh's K order inside a stage (see test_torch_ln_tf32)."""
    kk, j = divmod(k, 8)
    return 8 * (j % 4) + 2 * kk + j // 4


K_ORDER = torch.tensor([k_phys(k) for k in range(STAGE)])


def qkv_col(r, nh=NH):
    """attention_block.cu's QkvCols: row r of Wqkv^T's split copy holds
    Wqkv's column qkv_col(r): head n's k, then v, then q columns."""
    n, i = divmod(r, 3 * H)
    return (1 + i // H) * nh + n * H + i % H if i < 2 * H else n * H + i - 2 * H


def test_route_map_is_frozen():
    assert port_ops.attn_block_route(torch.float32) == "tf32x3"
    assert port_ops.attn_block_route(torch.bfloat16) == "wgmma"
    with pytest.raises(TypeError):
        port_ops.attn_block_route(torch.float16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_gate_is_unchanged(dtype):
    """T <= 64, H = 64, D a multiple of 128, in both dtypes."""
    fits = port_ops.attn_block_fits_smem
    assert fits(50, 768, 768, dtype) and fits(64, 640, 128, dtype) and fits(1, 128, 64, dtype)
    assert not fits(65, 768, 768, dtype) and not fits(257, 1024, 1024, dtype)
    assert not fits(50, 704, 768, dtype) and not fits(50, 768, 768, dtype, H=32)


def test_pinned_footprints():
    """float32: three 48 KB stages (both images' [64 x 32] x or z tiles and
    room for a [128 x 32] weight tile's hi and lo), both images' k and v
    tiles of 64 rows of 68 floats, 7 mbarriers, 1 KB of alignment;
    bfloat16 as before.  Both one block an SM."""
    f32 = port_ops.attn_block_smem_bytes(torch.float32)
    assert f32 == 3 * (2 * 8192 + 2 * 16384) + 2 * 2 * 64 * 68 * 4 + 56 + 1024 == 218_168
    assert port_ops.attn_block_smem_bytes(torch.bfloat16) == 220_232
    assert max(f32, port_ops.attn_block_smem_bytes(torch.bfloat16)) <= MAX_SMEM


def test_pinned_scratch():
    """z [B, 64, NH], then (float32) Wqkv^T's and Wo^T's split copies."""
    f = port_ops._attn_block_scratch
    assert f(256, 768, 768, torch.float32) == 256 * 64 * 768 + 2 * 3 * 768 * 768 + 2 * 768 * 768
    assert f(256, 768, 768, torch.bfloat16) == 256 * 64 * 768


def test_head_order_of_the_qkv_copy():
    """Each head's 192 rows are its k, v and q columns: pass 0 (rows 0-95)
    k and v's first 32 columns, pass 1 v's last 32 and q; a permutation."""
    cols = [qkv_col(r) for r in range(3 * NH)]
    assert sorted(cols) == list(range(3 * NH))
    n = 5
    rows = range(n * 3 * H, (n + 1) * 3 * H)
    got = [cols[r] for r in rows]
    assert got[:H] == [NH + n * H + h for h in range(H)]
    assert got[H:2 * H] == [2 * NH + n * H + h for h in range(H)]
    assert got[2 * H:] == [n * H + h for h in range(H)]


def _tf32(x):
    """x rounded to TF32, ties away from zero, as the split rounds."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _gemm(a, w, x3):
    """a [M, K] w [K, N] as the kernel's wgmma passes form it: stage by
    stage in the pre-pass's K order, the stage's sum from zero (a_lo w_hi,
    a_hi w_lo, a_hi w_hi, each over four k8 steps), added to the total."""
    out = torch.zeros(a.shape[0], w.shape[1])
    for k0 in range(0, a.shape[1], STAGE):
        cols = k0 + K_ORDER
        (ah, al), (wh, wl) = _split(a[:, cols]), _split(w[cols])
        c = torch.zeros_like(out)
        for pa, pw in (((al, wh), (ah, wl), (ah, wh)) if x3 else ((ah, wh),)):
            for kk in range(4):
                s = slice(8 * kk, 8 * kk + 8)
                c = c + pa[:, s] @ pw[s]
        out = out + c
    return out


def _mm_steps(a, b, x3, apart):
    """a [.., M, K] b [.., K, N] over k8 steps as mix_tf32's mma3 forms it:
    ``apart`` (scores) the small products summed apart and added last, else
    (a chunk of p V) all three in one sum, step by step."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    big = small = 0
    for k0 in range(0, a.shape[-1], 8):
        s = slice(k0, k0 + 8)
        if not x3:
            big = big + ah[..., s] @ bh[..., s, :]
        elif apart:
            small = small + al[..., s] @ bh[..., s, :] + ah[..., s] @ bl[..., s, :]
            big = big + ah[..., s] @ bh[..., s, :]
        else:
            big = (big + al[..., s] @ bh[..., s, :] + ah[..., s] @ bl[..., s, :]
                   + ah[..., s] @ bh[..., s, :])
    return big + small


def _emulated(x, Wqkv, bqkv, Wo, x3=True):
    """out [B, T, D] as block_tf32_kernel forms it."""
    Bx = x.shape[0]
    qkv = _gemm(x.reshape(Bx * T, D), Wqkv, x3) + bqkv
    q, k, v = (t.reshape(Bx, T, N, H).transpose(1, 2) for t in qkv.split(NH, dim=1))
    q = q * SCALE
    s = _mm_steps(q, k.transpose(-1, -2), x3, apart=True)
    m = s.amax(-1, keepdim=True)
    e = torch.exp2(s * LOG2E - m * LOG2E)
    p = e * (1 / e.sum(-1, keepdim=True))
    z = 0
    for k0, k1 in ((0, 32), (32, 48), (48, 56)):  # T 50 -> 56 keys: chunks of 4, 2, 1 steps
        z = z + _mm_steps(p[..., k0:min(k1, T)], v[..., k0:min(k1, T), :], x3, apart=False)
    z = z.transpose(1, 2).reshape(Bx * T, NH)
    return _gemm(z, Wo, x3).reshape(Bx, T, D)


def _inputs(seed):
    """chip_smoke.py's _block_inputs: x unit normal, the weights scaled by
    1/sqrt(fan-in), the bias by 0.1."""
    return [seeded(seed, (B, T, D)), seeded(seed + 1, (D, 3 * NH), D ** -0.5),
            seeded(seed + 2, (3 * NH,), 0.1), seeded(seed + 3, (NH, D), NH ** -0.5)]


@pytest.mark.parametrize("x3", [True, False], ids=["3xtf32", "tf32_control"])
def test_3xtf32_within_the_float32_tolerance(x3):
    """The emulation within 1e-5 of max(1, absmax) of the plain version and
    of the JAX reference's twin (about 1e-6 here); the plain version within
    that of JAX's ``fused_attention_block``; one TF32 product (the control)
    misses it against both."""
    arrays = _inputs(seed=31)
    args = [torch.from_numpy(a) for a in arrays]
    plain = port_ops.fused_attention_block_plain(*args, N, SCALE)
    ref = port_ops.attn_block_reference(*args, N, SCALE)
    limit = lambda w: TOL * max(1.0, w.abs().max().item())
    jax_out = torch.from_numpy(np.array(jax_ops.fused_attention_block(
        *(jnp.asarray(a) for a in arrays), N, SCALE)))
    assert (plain - jax_out).abs().max().item() <= limit(jax_out), "plain against JAX"
    got = _emulated(*args, x3=x3)
    ratios = [(got - w).abs().max().item() / limit(w) for w in (plain, ref)]
    assert all(r <= 1.0 for r in ratios) if x3 else all(r > 1.0 for r in ratios), ratios


def test_images_do_not_depend_on_the_batch():
    """An image's output is summed in one fixed order whatever its batch or
    slot: the emulation of the lone third image equals its rows of the
    whole batch."""
    args = [torch.from_numpy(a) for a in _inputs(seed=37)]
    whole = _emulated(*args)
    alone = _emulated(args[0][2:], *args[1:])
    assert torch.equal(alone, whole[2:]) and math.isfinite(whole.abs().max().item())
