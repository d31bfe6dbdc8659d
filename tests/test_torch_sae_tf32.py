"""The float32 route of B4, B5 and B6 (``csrc/sae_fused_tf32.cu``'s
``sae_tf32_kernel`` on the float32 pieces of ``csrc/hopper_gemm.cuh``) and
B9's launches after its recompute, on the CPU (B8's and B9's TopK encoder
modes are tests/test_torch_sae_topk_tf32.py's): the route map per kernel
family and dtype, the fused step's gate, the kernel's shared memory and
scratch, the K orders its pre-passes write and the banks its weight-gradient
loader reads, and its arithmetic, emulated with bit operations on the same
pieces and in the same order: each float32 product as three TF32 products
(hi = x rounded to TF32, lo = (x - hi) rounded, ties away from zero, as the
split rounds), each 32-deep stage summed from zero (a_lo b_hi, then a_hi
b_lo, then a_hi b_hi, over the stage's k8 steps in the pre-pass's K order)
and added to the running total, for all five products: the encoder, the
decoder, dh and the two weight gradients.  The emulation is held to the
plain versions within the kernels' float32 tolerance (1e-5: ``chip_smoke.py``'s
SAE_REL and SAE_GRAD_REL), the plain versions to JAX's ``sae_fused_apply``
(Pallas in interpret mode); one TF32 product (the control) must miss that
tolerance.  The CUDA kernel itself is held to the plain versions on the card
by ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import seeded
from vit_prisma_tpu.ops import sae_step as jax_ops
from vit_prisma_tpu_torch.ops import sae_step

MAX_SMEM = 232448  # a block's
TOL = 1e-5         # SAE_REL (of max(1, absmax)) and SAE_GRAD_REL (of absmax), float32
SWITCHED_TOL = 0.25  # TOPK_SWITCHED_GRAD_REL (of absmax): grads of a feature whose mask flipped
STAGE = 32         # K a stage: one 128-byte swizzled row of floats


def k_phys(k):
    """Position k of a stage of the encoder's, decoder's and dh's split
    copies holds source row k_phys(k) (hopper_gemm.cuh's): k8 step kk = k //
    8, position j = k % 8 -> 8 (j % 4) + 2 kk + j // 4."""
    kk, j = divmod(k, 8)
    return 8 * (j % 4) + 2 * kk + j // 4


def k_mn(k):
    """The weight gradients' order (sae_fused_tf32.cu's k_mn): inside each
    k8 step, position j -> 2 (j % 4) + j // 4."""
    return 8 * (k // 8) + 2 * (k % 4) + k % 8 // 4


ORDERS = {"k": torch.tensor([k_phys(k) for k in range(STAGE)]),
          "mn": torch.tensor([k_mn(k) for k in range(STAGE)])}


# ---------------------------------------------------------------------------
# Routes, gate, footprints
# ---------------------------------------------------------------------------

def test_route_map_per_family_and_dtype():
    """float32: every family, ReLU (B4, B5, B6), TopK (B8, B9) and gated
    (B11, B12), on 3xTF32; bfloat16 as before, one route for every family;
    nothing else has a route."""
    for B, D, S in ((4096, 1024, 8192), (4096, 768, 12288), (4096, 384, 6144), (256, 128, 512)):
        r = lambda dtype, fam: sae_step.sae_gemm_route(B, D, S, dtype, fam)
        assert r(torch.float32, "relu") == "tf32x3"
        assert r(torch.float32, "topk") == "tf32x3" and r(torch.float32, "gated") == "tf32x3"
        bf16 = "wgmma" if D % 256 == 0 and S % 256 == 0 else "mma_sync"
        assert {r(torch.bfloat16, f) for f in sae_step.SAE_FAMILIES} == {bf16}
        assert sae_step.sae_gemm_route(B, D, S, torch.float32) == "tf32x3"  # the default: ReLU
        assert r(torch.float16, "relu") is None
    assert sae_step.sae_gemm_route(4097, 1024, 8192, torch.float32) is None
    with pytest.raises(ValueError):
        sae_step.sae_gemm_route(4096, 1024, 8192, torch.float32, "standard")
    assert sae_step.SAE_GEMM_ROUTES == ("wgmma", "mma_sync", "tf32x3")


def test_kernel_routes_by_wrapper():
    """Each routed wrapper's route at the sweep's shape: in float32 all on
    tf32x3 (B4, B5, B6, B8, B9, B11 and B12); in bf16 all on wgmma."""
    f32 = sae_step.sae_kernel_routes(4096, 1024, 8192, torch.float32)
    assert f32 == {"sae_fused_forward": "tf32x3", "sae_fused_backward": "tf32x3",
                   "sae_fused_backward_stored": "tf32x3", "sae_fused_forward_topk": "tf32x3",
                   "sae_fused_backward_topk": "tf32x3", "sae_gated_fused_forward": "tf32x3",
                   "sae_gated_fused_backward": "tf32x3"}
    assert set(sae_step.sae_kernel_routes(4096, 1024, 8192, torch.bfloat16).values()) == {"wgmma"}
    assert set(sae_step.SAE_KERNEL_FAMILIES) == {
        k for k, f in vars(sae_step).items() if callable(f) and hasattr(f, "routes")}


@pytest.mark.parametrize("B,D,S", [(4096, 1024, 8192), (4096, 768, 12288), (4096, 384, 6144),
                                   (256, 128, 512), (768, 640, 1280)])
def test_gate_is_unchanged_and_takes_the_new_route(B, D, S):
    """The fused step's gate admits B and d_sae multiples of 256, d_in of
    128, as before; every float32 shape it admits takes 3xTF32, none stays
    on FFMA."""
    assert sae_step.fused_step_eligible(B, D, S, 4) and sae_step.fused_step_eligible(B, D, S, 2)
    assert sae_step.sae_gemm_route(B, D, S, torch.float32) == "tf32x3"
    assert not sae_step.fused_step_eligible(B + 128, D, S, 4)
    assert not sae_step.fused_step_eligible(B, D + 64, S, 4)
    assert not sae_step.fused_step_eligible(B, D, S + 128, 4)
    assert not sae_step.fused_step_eligible(B, D, S, 8)


def test_pinned_shared_memory():
    """Four 48 KB stages (a [128 x 32] float A tile, B's hi and lo [128 x
    32] tiles), 8 warps' column partials of 128 floats, their l1 partials,
    8 mbarriers and 1 KB of alignment: one block an SM."""
    assert sae_step.SAE_TF32_SMEM_BYTES == 4 * 49152 + 4096 + 32 + 64 + 1024 == 201_824
    assert sae_step.SAE_TF32_SMEM_BYTES <= MAX_SMEM < 2 * sae_step.SAE_TF32_SMEM_BYTES


def test_pinned_scratch():
    """The split copies: the forward a weight's hi and lo, 2 S D floats a
    layer (W_enc's, then W_dec's in the same place); the backwards W_dec's,
    then xc's and dy's transposed copies (4 D B a layer), in the same place.
    1.6 GB at the sweep's shape, where both need the same."""
    f = sae_step._tf32_scratch_floats
    assert f(False, 24, 4096, 1024, 8192) == f(True, 24, 4096, 1024, 8192) == 24 * 2 * 8192 * 1024
    assert 4 * f(True, 24, 4096, 1024, 8192) == 1_610_612_736
    assert f(False, 1, 4096, 768, 12288) == f(True, 1, 4096, 768, 12288) == 2 * 12288 * 768
    assert f(True, 2, 8192, 128, 512) == 2 * 4 * 128 * 8192 > f(False, 2, 8192, 128, 512)


def test_k_orders_give_each_thread_its_elements():
    """Both orders permute each stage (k_mn each k8 step).  K-major A: thread
    t (lane % 4) reads, for rows g and g + 8, exactly the 16-byte chunks 2t
    and 2t + 1 of the stage, the fragment element e of k8 step kk (the tf32
    A layout: column t, t + 4 for e // 2 = 0, 1) where load_frags puts it.
    M-contiguous A (the weight gradients): element e of step kk of thread t
    is A's K row 8 kk + 2 t + e // 2, as load_frags_mn reads it."""
    for order in ORDERS.values():
        assert sorted(order.tolist()) == list(range(STAGE))
    assert all(k_mn(k) // 8 == k // 8 for k in range(STAGE))
    for t in range(4):
        cols = set()
        for kk in range(4):
            for e in range(4):
                pos = 8 * kk + t + 4 * (e // 2)
                chunk, word = divmod(k_phys(pos), 4)
                c = chunk - 2 * t
                assert c in (0, 1) and (2 * c + word // 2, 2 * (word % 2)) == (kk, 2 * (e // 2))
                cols.add(k_phys(pos))
                assert k_mn(pos) == 8 * kk + 2 * t + e // 2
        assert cols == set(range(8 * t, 8 * t + 8))


def _sw128(row, chunk):
    return row * 128 + ((chunk ^ (row & 7)) << 4)


def test_weight_gradient_loader_hits_every_bank():
    """load_frags_mn: for each fragment element (e, kk), a warp's 32 scalar
    reads of an M-contiguous tile (four [32 K x 32 M] boxes, 128-byte
    swizzled) fall in 32 distinct banks, for every warp of both consumer
    warpgroups, and read the element the fragment wants."""
    for row0 in (64 * wg + 16 * w for wg in range(2) for w in range(4)):
        for kk in range(4):
            for e in range(4):
                banks = set()
                for lane in range(32):
                    g, t = divmod(lane, 4)
                    m, k = row0 + g + 8 * (e & 1), 8 * kk + 2 * t + (e >> 1)
                    off = (m >> 5) * 4096 + _sw128(k, (m & 31) >> 2) + (m & 3) * 4
                    # the box, row and column that offset holds
                    box, r = divmod(off, 4096)
                    r, within = divmod(r, 128)
                    col = ((within >> 4) ^ (r & 7)) * 4 + (within & 15) // 4
                    assert (32 * box + col, r) == (m, k)
                    banks.add(off // 4 % 32)
                assert len(banks) == 32


# ---------------------------------------------------------------------------
# The arithmetic, emulated
# ---------------------------------------------------------------------------

def _tf32(x):
    """x rounded to TF32 (10 explicit mantissa bits), ties away from zero,
    as the split rounds."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _product(a, b, order, x3=True):
    """C [L, M, N] = a [L, M, K] b [L, K, N] as sae_tf32_kernel forms it:
    stage by stage in the split copy's K order, the stage's sum from zero
    (the small products first, each over the stage's 32 positions in turn),
    added to the float32 total.  x3=False: one TF32 product (the control)."""
    L, M, K = a.shape
    total = torch.zeros(L, M, b.shape[-1])
    for k0 in range(0, K, STAGE):
        ks = k0 + ORDERS[order]
        pa, pb = a[:, :, ks], b[:, ks, :]
        ah, bh = _tf32(pa), _tf32(pb)
        al, bl = _tf32(pa - ah), _tf32(pb - bh)
        c = torch.zeros_like(total)
        for fa, fb in (((al, bh), (ah, bl), (ah, bh)) if x3 else ((ah, bh),)):
            for k in range(STAGE):
                c = c + fa[:, :, k:k + 1] * fb[:, k:k + 1, :]
        total = total + c
    return total


def _encoder(x, We, be, bd, x3=True):
    """hpre = (x - b_dec) W_enc + b_enc, as the encoder launch forms it."""
    return _product(x - bd[:, None], We, "k", x3) + be[:, None]


def emulated_forward(x, We, be, Wd, bd, x3=True):
    """B4: (y, l1, nact, hc) as the float32 route forms them."""
    hpre = _encoder(x, We, be, bd, x3)
    hc = torch.where(hpre > 0, hpre, 0.0)
    y = bd[:, None] + _product(hc, Wd, "k", x3)
    return y, hc.sum(dim=(1, 2)), (hpre > 0).sum(dim=1, dtype=torch.float32), hc


def emulated_backward_stored(x, hc, Wd, bd, dy, dl1, x3=True):
    """B6: dh from dy W_dec^T (W_dec K-major as it lies), then dW_enc^T =
    dh^T xc and dW_dec = hc^T dy (K = B, the weight gradients' order)."""
    dh = torch.where(hc > 0, _product(dy, Wd.transpose(1, 2), "k", x3) + dl1[:, None, None], 0.0)
    xc = x - bd[:, None]
    dWe = _product(dh.transpose(1, 2), xc, "mn", x3).transpose(1, 2)
    dWd = _product(hc.transpose(1, 2), dy, "mn", x3)
    return dWe, dWd, dh.sum(dim=1)


def emulated_backward_remat(x, We, be, Wd, bd, dy, dl1):
    """B5: B4's encoder again (no reductions), then B6's launches on it."""
    hpre = _encoder(x, We, be, bd)
    return emulated_backward_stored(x, torch.where(hpre > 0, hpre, 0.0), Wd, bd, dy, dl1)


def _inputs(L, B, D, S, seed):
    """chip_smoke.py's _sae_inputs in numpy: x ~ N(0, 1), the weights at the
    SAE init's scale, a small dy and dl1."""
    return (seeded(seed, (L, B, D)), seeded(seed + 1, (L, D, S), D ** -0.5),
            seeded(seed + 2, (L, S), 0.01), seeded(seed + 3, (L, S, D), D ** -0.5),
            seeded(seed + 4, (L, D), 0.1), seeded(seed + 5, (L, B, D), 1e-3),
            np.random.default_rng(seed + 6).uniform(0, 1e-3, L).astype(np.float32))


def _torch(arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


# name: (L, B, d_in, d_sae), narrow: both JAX-tile-aligned, d_in 128 as the
# ViT-S width's (a multiple of 128, not of 256) and 256
SHAPES = {"d_in_128": (2, 256, 128, 512), "d_in_256": (2, 256, 256, 512)}


def _operands(name, seed):
    """The five products' operands: (a, b, order, the tolerance's scale:
    "out" for max(1, absmax) as SAE_REL, "grad" for absmax as SAE_GRAD_REL)."""
    L, B, D, S = SHAPES["d_in_256"]
    x, We, be, Wd, bd, dy, dl1 = _torch(_inputs(L, B, D, S, seed))
    xc = x - bd[:, None]
    hc = torch.relu(sae_step._mm(xc, We) + be[:, None])
    dh = torch.where(hc > 0, sae_step._mm(dy, Wd.transpose(1, 2)) + dl1[:, None, None], 0.0)
    return {"encoder": (xc, We, "k", "out"), "decoder": (hc, Wd, "k", "out"),
            "dh": (dy, Wd.transpose(1, 2).contiguous(), "k", "grad"),
            "dW_enc": (dh.transpose(1, 2).contiguous(), xc, "mn", "grad"),
            "dW_dec": (hc.transpose(1, 2).contiguous(), dy, "mn", "grad")}[name]


@pytest.mark.parametrize("x3", [True, False], ids=["3xtf32", "tf32_control"])
@pytest.mark.parametrize("name", ["encoder", "decoder", "dh", "dW_enc", "dW_dec"])
def test_each_product_within_the_float32_tolerance(name, x3):
    """Each of the five products, emulated, within 1e-5 of the plain float32
    product's scale; one TF32 product misses it."""
    a, b, order, scale = _operands(name, seed=3)
    want = torch.matmul(a, b)
    absmax = want.abs().max().item()
    limit = TOL * (max(1.0, absmax) if scale == "out" else absmax)
    ratio = (_product(a, b, order, x3) - want).abs().max().item() / limit
    assert (ratio <= 1.0) if x3 else (ratio > 1.0), ratio


def _jax_apply(arrays):
    """JAX's sae_fused_apply (save_acts: the stored-acts VJP) forward and
    its VJP at the cotangents (dy, dl1): (y, l1, nact), (dW_enc, db_enc,
    dW_dec)."""
    x, We, be, Wd, bd, dy, dl1 = (jnp.asarray(a) for a in arrays)
    f = lambda *p: jax_ops.sae_fused_apply(x, *p, save_acts=True)
    out, vjp = jax.vjp(f, We, be, Wd, bd)
    grads = vjp((dy, dl1, jnp.zeros_like(out[2])))
    return [np.asarray(o) for o in out], [np.asarray(g) for g in grads[:3]]


@pytest.mark.parametrize("shape", list(SHAPES))
def test_b4_b5_b6_emulated_within_tolerance_of_plain_and_plain_of_jax(shape):
    """The plain versions against JAX's sae_fused_apply (y, hc within 1e-5
    of max(1, absmax), l1 1e-5 relative, nact equal, the stored-acts grads
    within 1e-5 of absmax); the emulated B4 against the plain B4 (nact
    within each feature's ReLU switches), the emulated B6 on the plain hc
    and the emulated B5 against theirs, outside the switched features."""
    L, B, D, S = SHAPES[shape]
    arrays = _inputs(L, B, D, S, seed=B + D)
    x, We, be, Wd, bd, dy, dl1 = _torch(arrays)
    y, l1, nact, hc = sae_step.sae_fused_forward_reference(x, We, be, Wd, bd, save_h=True)
    grads6 = sae_step.sae_fused_backward_stored_reference(x, hc, Wd, bd, dy, dl1)
    (jy, jl1, jn), (jdWe, jdbe, jdWd) = _jax_apply(arrays)
    jy = np.array(jy)
    out_tol = lambda want: TOL * max(1.0, float(np.abs(np.asarray(want)).max()))
    grad_tol = lambda want: TOL * float(np.abs(np.asarray(want)).max())
    assert (y - torch.from_numpy(jy)).abs().max().item() <= out_tol(jy)
    np.testing.assert_allclose(l1.numpy(), jl1, rtol=TOL)
    np.testing.assert_array_equal(nact.numpy(), jn)
    for got, want in zip(grads6, (jdWe, jdWd, jdbe)):
        assert (got - torch.from_numpy(want)).abs().max().item() <= grad_tol(want)

    ey, el1, en, ehc = emulated_forward(x, We, be, Wd, bd)
    hpre = sae_step._mm(x - bd[:, None], We) + be[:, None]
    switched = ((ehc > 0) != (hpre > 0)).sum(dim=1)  # [L, S]
    assert (ey - y).abs().max().item() <= out_tol(y)
    assert (ehc - hc).abs().max().item() <= out_tol(hc)
    assert ((el1 - l1).abs() / l1.abs()).max().item() <= TOL
    assert bool(((en - nact).abs() <= switched).all())
    for got, want in zip(emulated_backward_stored(x, hc, Wd, bd, dy, dl1), grads6):
        assert (got - want).abs().max().item() <= grad_tol(want)
    clean = ~(switched > 0)
    grads5 = sae_step.sae_fused_backward_reference(x, We, be, Wd, bd, dy, dl1)
    for k, got, want in zip(("dW_enc", "dW_dec", "db_enc"),
                            emulated_backward_remat(x, We, be, Wd, bd, dy, dl1), grads5):
        keep = {"dW_enc": clean[:, None, :], "dW_dec": clean[:, :, None], "db_enc": clean}[k]
        assert ((got - want).abs() * keep).max().item() <= grad_tol(want), k


def test_b5_equals_b6_on_b4_hc_to_the_bit():
    """B5 recomputes B4's encoder on the same tiles, so its hc is B4's and
    its grads are B6's on B4's hc, to the bit."""
    x, We, be, Wd, bd, dy, dl1 = _torch(_inputs(*SHAPES["d_in_128"], seed=21))
    hc4 = emulated_forward(x, We, be, Wd, bd)[3]
    for a, b in zip(emulated_backward_remat(x, We, be, Wd, bd, dy, dl1),
                    emulated_backward_stored(x, hc4, Wd, bd, dy, dl1)):
        assert torch.equal(a, b)


def test_b9_equals_b6_on_b8_h_to_the_bit():
    """float32 B9 recomputes B8's h (B8's TopK encoder, emulated, on the same
    tiles) masked against B8's t, then runs B6's launches: its grads are
    B6's on B8's h, to the bit, and within tolerance of B9's plain version
    from the plain forward's t: TOL outside the features whose mask flipped
    between the two forwards, SWITCHED_TOL in them."""
    L, B, D, S = SHAPES["d_in_128"]
    x, We, be, Wd, bd, dy, dl1 = _torch(_inputs(L, B, D, S, seed=22))
    hp = _encoder(x, We, be, bd)
    t = sae_step._row_threshold(hp, 16)
    h8 = sae_step._topk_mask(hp, t)[1]  # the select's mask on B8's rows
    h9 = torch.where((hp > 0) & (hp >= t), hp, 0.0)  # the remat encoder's
    got = emulated_backward_stored(x, h9, Wd, bd, dy, dl1)
    assert all(torch.equal(a, b) for a, b in
               zip(got, emulated_backward_stored(x, h8, Wd, bd, dy, dl1)))
    *_, t_plain, h_plain = sae_step.sae_fused_forward_topk_reference(x, We, be, Wd, bd, 16,
                                                                     save_h=True)
    want = sae_step.sae_fused_backward_topk_reference(x, We, be, Wd, bd, dy, dl1, t_plain)
    flipped = ((h_plain > 0) != (h8 > 0)).any(dim=1)  # [L, S]
    for sw, a, b in zip((flipped[:, None, :], flipped[:, :, None], flipped), got, want):
        d, scale = (a - b).abs(), b.abs().max().item()
        sw = sw.expand_as(d)
        assert d[~sw].max().item() <= TOL * scale
        assert not sw.any() or d[sw].max().item() <= SWITCHED_TOL * scale


def test_rows_and_layers_do_not_depend_on_the_batch():
    """A row's B4 outputs and dh are summed in one fixed order whatever the
    batch, and a layer's everything whatever L: the first 128 rows alone and
    layer 0 alone give the same bits (y, hc, nact and the grads; l1 is the
    wrapper's torch sum of the kernel's tile partials, whose order torch
    picks by shape)."""
    x, We, be, Wd, bd, dy, dl1 = _torch(_inputs(*SHAPES["d_in_128"], seed=23))
    whole = emulated_forward(x, We, be, Wd, bd)
    rows = emulated_forward(x[:, :128], We, be, Wd, bd)
    assert torch.equal(rows[0], whole[0][:, :128]) and torch.equal(rows[3], whole[3][:, :128])
    dh = lambda d: _product(d, Wd.transpose(1, 2), "k")
    assert torch.equal(dh(dy[:, :128]), dh(dy)[:, :128])
    layer0 = emulated_forward(x[:1], We[:1], be[:1], Wd[:1], bd[:1])
    assert all(torch.equal(layer0[i], whole[i][:1]) for i in (0, 2, 3))
    g0 = emulated_backward_stored(x[:1], whole[3][:1], Wd[:1], bd[:1], dy[:1], dl1[:1])
    g = emulated_backward_stored(x, whole[3], Wd, bd, dy, dl1)
    assert all(torch.equal(a, b[:1]) for a, b in zip(g0, g))
