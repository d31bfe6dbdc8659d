"""Attention-mix kernels (PyTorch port of ``vit_prisma_tpu/ops/attention.py``).

:func:`attention_mix_tnh` is kernel B1 with kernel B2 as its backward: per
head ``softmax(q kᵀ) v`` over token-major ``[B, T, N·H]`` tensors with a
pre-scaled q, float32 scores and softmax, p rounded to the input dtype before
the PV product, and an optional causal mask.  It is a
``torch.autograd.Function``: on CUDA tensors the forward launches
``csrc/attention_mix_tnh.cu`` and the backward ``csrc/attention_mix_tnh_bwd.cu``
(:func:`attention_mix_tnh_bwd`); on CPU tensors they run the plain versions
:func:`attention_mix_tnh_reference` and
:func:`attention_mix_tnh_bwd_reference`, so CPU gradients take the kernel's
rounding points too.  The device code of both (``csrc/attention_mix_core.cuh``,
shared with B15, and ``csrc/attention_mix_tnh_bwd.cu``) has three routes,
chosen by dtype and head width (:func:`mix_route`): bfloat16 heads up to 128
wide run every product on the tensor cores (mma.sync in bfloat16); float32
heads up to 128 wide too, each float32 product as three TF32 products
(``csrc/mix_tf32.cuh``); wider heads run FFMA on float32 copies.

:func:`flash_attention_padded` is kernel B13, forward and backward: tiled
flash attention over head-major ``[B, N, Tp, H]`` tensors for token axes too
long for B1's shared memory, with segment ids masking the padding.  On CUDA
tensors it launches ``csrc/flash_attention_fwd.cu`` and, for the gradient,
the two passes of ``csrc/flash_attention_bwd.cu``
(:func:`flash_attention_padded_bwd_dkv`, :func:`flash_attention_padded_bwd_dq`);
on CPU tensors the plain versions.  Its routes (:func:`flash_route`):
bfloat16 on wgmma (H 64, 128) or mma.sync, float32 on 3xTF32 mma.sync
(``csrc/flash_tf32.cuh``).

The JAX package's two kernels without a caller on any path, ported as
op-level entry points: :func:`attention_mix` is kernel B15, the mix over
head-major ``[B, N, T, H]`` tensors (B1's device code with head-major
strides; the plain VJP as its backward), and :func:`fused_attention_block`
is kernel B16, the QKV projection, the mix and the output projection of one
attention layer in one kernel (``csrc/attention_block.cu``; the VJP of
:func:`attn_block_reference` as its backward).
"""

from __future__ import annotations

import torch

from vit_prisma_tpu_torch.ops import _build

# Must match smem_bytes() and kMaxHead in csrc/attention_mix_core.cuh.
_WARPS = 8
_MAX_SMEM_BYTES = 232448  # 227 KB: what one block may use on an H100
MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def mix_tnh_smem_bytes(T: int, H: int) -> int:
    """Shared memory of the float32 mix kernel for one (batch, head) at T
    tokens: float32 K (rows padded for float4 reads) and V, plus one q row
    and one p row per warp."""
    h4 = -(-H // 4) * 4
    return 4 * (T * (h4 + 4) + _WARPS * h4 + T * H + _WARPS * T)


def mix_tnh_fits_smem(T: int, H: int) -> bool:
    """The route gate shared by B1, B2 and B15: whether the whole-T mix
    takes a head of width H at T tokens.  It is the float32 kernel's
    footprint (:func:`mix_tnh_smem_bytes`) in either dtype, so that a route
    never depends on the dtype; the bfloat16 kernel fits wherever it does
    (:func:`mix_tc_smem_bytes`).  Past it, models take the flash kernel
    (B13)."""
    return H <= MAX_HEAD_DIM and mix_tnh_smem_bytes(T, H) <= _MAX_SMEM_BYTES


# Must match kTcMaxHead, tc_keys(), tc_head_pad(), tc_stride() and
# tc_smem_bytes() in csrc/attention_mix_core.cuh.
MIX_TC_MAX_HEAD_DIM = 128


def mix_tc_smem_bytes(T: int, H: int) -> int:
    """Shared memory of the bfloat16 tensor-core mix kernel (bfloat16 heads
    up to :data:`MIX_TC_MAX_HEAD_DIM` wide) for one (batch, head) at T
    tokens: bfloat16 K and V, rows zero-padded to a multiple of 16 keys,
    columns to H rounded up to 16 plus 8 elements of padding (none at 16)."""
    hp = -(-H // 16) * 16
    stride = hp if hp == 16 else hp + 8
    return 2 * 2 * (-(-T // 16) * 16) * stride


def mix_route(H: int, dtype: torch.dtype) -> str:
    """The device code B1, B2 and B15 run for a head width and dtype:
    ``"mma_sync"`` (bfloat16 up to :data:`MIX_TC_MAX_HEAD_DIM`: bfloat16
    products on the tensor cores), ``"tf32x3"`` (float32 up to the same
    width: each float32 product as three TF32 products on the tensor cores)
    or ``"ffma"`` (wider heads, either dtype: float32 FMAs on the CUDA
    cores)."""
    if H > MIX_TC_MAX_HEAD_DIM:
        return "ffma"
    return "tf32x3" if dtype == torch.float32 else "mma_sync"


# Must match round8(), smem_floats(), row_stride() and kSlack in
# csrc/mix_tf32.cuh.
_TF32_SLACK = 16


def _tf32_floats(T: int, stride: int, stats: bool) -> int:
    rows = -(-T // 8) * 8
    return 2 * rows * stride + (3 * rows if stats else 0) + _TF32_SLACK


def mix_tf32_layout(T: int, H: int, pass_: str = "fwd"):
    """``(stride, bytes)`` of one block of the float32 tensor-core route
    (heads up to :data:`MIX_TC_MAX_HEAD_DIM` wide) at T tokens, for ``pass_``
    ``"fwd"`` or ``"rows"`` (B1 and B15, B2's rows pass: K and V) or
    ``"cols"`` (B2's columns pass: Q, dZ and each row's nb, inv and D): two
    operands staged as float32 rows of ``stride`` floats (H rounded up to 4
    mod 8 where that fits, else to 4) in T rounded up to 8 rows, and 16
    floats of slack.  Fits wherever :func:`mix_tnh_fits_smem` admits."""
    stats = pass_ == "cols"
    stride = -(-(H + 4) // 8) * 8 - 4
    if 4 * _tf32_floats(T, stride, stats) > _MAX_SMEM_BYTES:
        stride = -(-H // 4) * 4
    return stride, 4 * _tf32_floats(T, stride, stats)


# Must match rows_smem_bytes(), cols_smem_bytes() and kShapes in
# csrc/attention_mix_tnh_bwd.cu.
_BWD_SHAPES = ((8, 4), (4, 4), (8, 1), (4, 1), (2, 1), (1, 1))


def mix_tnh_bwd_smem_bytes(T: int, H: int, warps: int, rows: int = 1):
    """Shared memory of B2's two passes for one (batch, head) at T tokens,
    ``warps`` warps a block and ``rows`` rows (or keys) a warp: the rows
    pass holds float32 K (rows padded as in B1) and V transposed, plus per
    warp ``rows`` q, dz, p and dp rows; the columns pass holds Q and dZ
    (padded where H is a multiple of 4), every row's m, l and D, and per
    warp ``rows`` k and v rows and 64 ``rows`` floats."""
    h4 = -(-H // 4) * 4
    rows_pass = 4 * (T * (h4 + 4) + T * H + warps * rows * (2 * h4 + 2 * T))
    stride = h4 + (4 if H % 4 == 0 else 0)
    cols_pass = 4 * (2 * T * stride + 3 * T + warps * rows * (2 * h4 + 64))
    return rows_pass, cols_pass


def mix_tnh_bwd_tc_smem_bytes(T: int, H: int) -> int:
    """Shared memory of each pass of B2's bfloat16 tensor-core route (heads
    up to :data:`MIX_TC_MAX_HEAD_DIM` wide) for one (batch, head) at T
    tokens: the rows pass stages K and V, the columns pass Q and dZ, each as
    B1's bfloat16 kernel stages K and V (:func:`mix_tc_smem_bytes`); each
    row's statistics sit in the padding of its Q row (H <= 16 rows have
    none: there they are read from device memory).  Must match
    mix::tc_smem_bytes() as csrc/attention_mix_tnh_bwd.cu launches it."""
    return mix_tc_smem_bytes(T, H)


def mix_tnh_bwd_fits_smem(T: int, H: int) -> bool:
    """Whether B2 takes a head of width H at T tokens: where B1 does, since
    each pass then fits at one of its shapes (at 4 warps of one row the
    rows pass takes B1's bytes exactly), so a forward that ran B1 always
    has a backward; the tests hold the two gates equal at every H.  It
    describes the FFMA route in either dtype, as B1's gate does; heads up
    to 128 wide take the tensor-core passes of their dtype, whose shared
    memory (:func:`mix_tnh_bwd_tc_smem_bytes`, :func:`mix_tf32_layout`)
    fits wherever it admits."""
    if not mix_tnh_fits_smem(T, H):
        return False
    sizes = [mix_tnh_bwd_smem_bytes(T, H, w, r) for w, r in _BWD_SHAPES]
    return (any(r <= _MAX_SMEM_BYTES for r, _ in sizes)
            and any(c <= _MAX_SMEM_BYTES for _, c in sizes))


def attention_mix_tnh_reference(q, k, v, n_heads: int, causal: bool = False):
    """Plain PyTorch version of the mix, with the kernel's float32 and cast
    points: the tests use it as the oracle, and the wrapper runs it for CPU
    tensors."""
    B, T, NH = q.shape
    H = NH // n_heads
    qf = q.reshape(B, T, n_heads, H).float()
    kf = k.reshape(B, T, n_heads, H).float()
    s = torch.einsum("bqnh,bknh->bnqk", qf, kf)
    if causal:
        keep = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    s = s - s.amax(dim=-1, keepdim=True)
    e = s.exp()
    p = (e / e.sum(dim=-1, keepdim=True)).to(v.dtype).float()
    z = torch.einsum("bnqk,bknh->bqnh", p, v.reshape(B, T, n_heads, H).float())
    return z.to(q.dtype).reshape(B, T, NH)


def attention_mix_tnh_bwd_reference(q, k, v, dz, n_heads: int,
                                    causal: bool = False):
    """Plain PyTorch version of B2, the mix's VJP, with the Pallas kernel's
    float32 and cast points (not those of the JAX einsum twin, float32
    throughout): p recomputed in float32, ``ds = p (dp - rowsum(dp p))``
    rounded to q's dtype, ``dv = pcᵀ dz`` with p rounded to v's dtype, each
    gradient in its input's dtype.  Returns ``(dq, dk, dv)``."""
    B, T, NH = q.shape
    H = NH // n_heads
    heads = lambda x: x.reshape(B, T, n_heads, H).float()
    qf, kf, vf, dzf = heads(q), heads(k), heads(v), heads(dz)
    s = torch.einsum("bqnh,bknh->bnqk", qf, kf)
    if causal:
        keep = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    s = s - s.amax(dim=-1, keepdim=True)
    e = s.exp()
    p = e / e.sum(dim=-1, keepdim=True)
    dp = torch.einsum("bqnh,bknh->bnqk", dzf, vf)
    ds = (p * (dp - (dp * p).sum(dim=-1, keepdim=True))).to(q.dtype).float()
    pc = p.to(v.dtype).float()
    dq = torch.einsum("bnqk,bknh->bqnh", ds, kf)
    dk = torch.einsum("bnqk,bqnh->bknh", ds, qf)
    dv = torch.einsum("bnqk,bqnh->bknh", pc, dzf)
    flat = lambda x, ref: x.reshape(B, T, NH).to(ref.dtype)
    return flat(dq, q), flat(dk, k), flat(dv, v)


def _check_cuda(what, *xs):
    """The kernels take contiguous float32 or bfloat16 tensors, all of one
    dtype, on one CUDA device."""
    q = xs[0]
    if not (q.is_cuda and all(x.device == q.device for x in xs)):
        raise ValueError(f"{what}: inputs must be on one CUDA device, got "
                         f"{[str(x.device) for x in xs]}")
    if any(x.dtype != q.dtype for x in xs) or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what}: inputs must all be float32 or all "
                        f"bfloat16, got {[x.dtype for x in xs]}")
    if not all(x.is_contiguous() for x in xs):
        raise ValueError(f"{what}: inputs must be contiguous")
    if q.shape[0] > 65535:
        raise ValueError(f"{what}: batch {q.shape[0]} exceeds the grid limit "
                         "of 65535")


def _launch(q, k, v, n_heads: int, causal: bool):
    """Run the CUDA kernel on PyTorch's current stream."""
    _check_cuda("attention_mix_tnh", q, k, v)
    B, T, NH = q.shape
    lib = _build.load_library()
    z = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device)
    rc = lib.attention_mix_tnh_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), z.data_ptr(), B, T, n_heads,
        NH // n_heads, int(causal), _DTYPE_CODES[q.dtype], q.device.index,
        stream.cuda_stream)
    _build.check(lib, rc, "attention_mix_tnh")
    attention_mix_tnh.launches += 1
    return z


def _launch_bwd(q, k, v, dz, n_heads: int, causal: bool):
    """Run B2's two passes on PyTorch's current stream."""
    _check_cuda("attention_mix_tnh_bwd", q, k, v, dz)
    B, T, NH = q.shape
    lib = _build.load_library()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # each row's m, l and D, from the rows pass to the columns pass
    stats = torch.empty(B, n_heads, 3, T, dtype=torch.float32, device=q.device)
    rc = lib.attention_mix_tnh_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dz.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), stats.data_ptr(), B, T, n_heads,
        NH // n_heads, int(causal), _DTYPE_CODES[q.dtype], q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, "attention_mix_tnh_bwd")
    attention_mix_tnh_bwd.launches += 1
    return dq, dk, dv


def _check_shapes(what, q, *others, n_heads: int):
    if q.ndim != 3 or any(x.shape != q.shape for x in others):
        raise ValueError(f"{what}: inputs must share one [B, T, N*H] shape, "
                         f"got {[tuple(x.shape) for x in (q, *others)]}")
    B, T, NH = q.shape
    if NH % n_heads:
        raise ValueError(f"{what}: N*H={NH} is not a multiple of "
                         f"n_heads={n_heads}")
    return T, NH // n_heads


def attention_mix_tnh_bwd(q, k, v, dz, n_heads: int, causal: bool = False):
    """Kernel B2, the mix's VJP: ``(dq, dk, dv)`` for the cotangent ``dz``
    of ``attention_mix_tnh(q, k, v)``.  CUDA tensors launch the hand-written
    kernel and add one to ``attention_mix_tnh_bwd.launches``: heads up to
    128 wide run its products on the tensor cores (float32 as 3xTF32), wider
    heads on the CUDA cores (:func:`mix_route`); CPU tensors run the plain
    version.  It takes every T and H that B1 takes; past them it raises
    ``NotImplementedError``, naming the flash kernel (B13),
    :func:`flash_attention_padded`."""
    T, H = _check_shapes("attention_mix_tnh_bwd", q, k, v, dz, n_heads=n_heads)
    if not mix_tnh_bwd_fits_smem(T, H):
        raise NotImplementedError(
            f"attention_mix_tnh_bwd: T={T}, H={H} does not fit the kernel's "
            "shared memory; long token axes take the tiled flash kernel "
            "(B13), flash_attention_padded")
    if q.device.type == "cpu":
        return attention_mix_tnh_bwd_reference(q, k, v, dz, n_heads, causal)
    return _launch_bwd(q, k, v, dz, n_heads, causal)


attention_mix_tnh_bwd.launches = 0


class _MixTNH(torch.autograd.Function):
    """B1 forward, B2 backward (the plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, n_heads, causal):
        ctx.save_for_backward(q, k, v)
        ctx.n_heads, ctx.causal = n_heads, causal
        if q.device.type == "cpu":
            return attention_mix_tnh_reference(q, k, v, n_heads, causal)
        return _launch(q, k, v, n_heads, causal)

    @staticmethod
    def backward(ctx, dz):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = attention_mix_tnh_bwd(q, k, v, dz.contiguous(), ctx.n_heads,
                                           ctx.causal)
        return dq, dk, dv, None, None


def attention_mix_tnh(q, k, v, n_heads: int, causal: bool = False):
    """Fused attention mix over token-major ``[B, T, N·H]`` tensors
    (pre-scaled q) -> z ``[B, T, N·H]`` in q's dtype, differentiable.

    CUDA tensors launch the hand-written kernel and add one to
    ``attention_mix_tnh.launches`` (the backward launches B2); CPU tensors
    run the plain versions.  A T whose keys and values do not fit the
    kernel's shared memory raises ``NotImplementedError`` on either device:
    long token axes take :func:`flash_attention_padded` (B13)."""
    T, H = _check_shapes("attention_mix_tnh", q, k, v, n_heads=n_heads)
    if not mix_tnh_fits_smem(T, H):
        raise NotImplementedError(
            f"attention_mix_tnh: T={T}, H={H} does not fit the kernel's "
            "shared memory; long token axes take the tiled flash kernel "
            "(B13), flash_attention_padded")
    return _MixTNH.apply(q, k, v, n_heads, causal)


attention_mix_tnh.launches = 0


# ---------------------------------------------------------------------------
# B13: tiled flash attention over head-major [B, N, Tp, H]
# ---------------------------------------------------------------------------

# Must match kTile in csrc/flash_tile.cuh and the head widths that
# csrc/flash_attention_{fwd,bwd}.cu instantiate.
FLASH_TILE = 64
FLASH_MAX_HEAD_DIM = 128


def flash_fits(Tp: int, H: int) -> bool:
    """Whether the flash kernels take a padded token count Tp and head width
    H: Tp a multiple of their 64-row tile, H a multiple of 16 up to 128.
    bfloat16 heads 64 and 128 wide (whole 128-byte TMA boxes) run the
    Hopper kernels (wgmma, TMA); the other bfloat16 widths are routed to
    the mma.sync kernels, and float32 at every width to the 3xTF32 ones, so
    no width is padded."""
    return Tp > 0 and Tp % FLASH_TILE == 0 and 0 < H <= FLASH_MAX_HEAD_DIM and H % 16 == 0


def flash_route(H: int, dtype: torch.dtype) -> str:
    """The kernels ``csrc/flash_attention_{fwd,bwd}.cu`` run for a head
    width and dtype: ``"wgmma"`` (bfloat16 at H 64 and 128: the Hopper
    kernels), ``"mma_sync"`` (the other bfloat16 widths) or ``"tf32x3"``
    (float32: each float32 product as three TF32 products on the tensor
    cores)."""
    if dtype == torch.float32:
        return "tf32x3"
    return "wgmma" if H in (64, 128) else "mma_sync"


# Must match kBwdWarps (16 rows a warp), kStream, stride() and the
# *_smem_bytes() of csrc/flash_tf32.cuh.
_FLASH_TF32_BLOCK = 64
_FLASH_TF32_STREAM = 32


def flash_tf32_layout(H: int, pass_: str = "fwd"):
    """``(stride, bytes)`` of one block of B13's float32 route at head
    width H for ``pass_`` ``"fwd"``, ``"dkv"`` or ``"dq"``: streamed tiles
    of 32 rows staged as float32 rows of ``stride`` = H + 4 floats, two
    (K, V) or (Q, dZ) pairs in the ring; the backward passes also hold
    their block's resident rows (16 a warp) of two operands; and per ring
    stage 32 segment ids (the dk/dv pass: also -lse log2(e) and D)."""
    stride, rows = H + 4, _FLASH_TF32_STREAM
    ring = 4 * rows * stride + 2 * rows * (3 if pass_ == "dkv" else 1)
    resident = 0 if pass_ == "fwd" else 2 * _FLASH_TF32_BLOCK * stride
    return stride, 4 * (ring + resident)


def _flash_scores(q, k, seg, causal: bool):
    """float32 scores with -inf where the segment ids (or the causal mask)
    hide a key."""
    s = torch.einsum("bnqh,bnkh->bnqk", q.float(), k.float())
    keep = seg[:, None, :, None] == seg[:, None, None, :]
    if causal:
        Tp = q.shape[2]
        keep = keep & torch.ones(Tp, Tp, dtype=torch.bool, device=q.device).tril()
    return s.masked_fill(~keep, float("-inf"))


def flash_attention_padded_reference(q, k, v, seg, causal: bool = False):
    """Plain PyTorch version of B13's forward, with its float32 and cast
    points (p rounded to v's dtype before PV, z in q's dtype); in float32 it
    is the JAX package's CPU twin of the library kernel."""
    p = torch.softmax(_flash_scores(q, k, seg, causal), dim=-1)
    z = torch.einsum("bnqk,bnkh->bnqh", p.to(v.dtype).float(), v.float())
    return z.to(q.dtype)


def _flash_p(q, k, seg, lse, causal: bool):
    """p = exp(s - lse) from the forward's log-sum-exp, 0 where masked."""
    return torch.exp(_flash_scores(q, k, seg, causal) - lse[..., None])


def flash_attention_padded_bwd_dkv_reference(q, k, v, seg, dz, lse, dsum,
                                             causal: bool = False):
    """Plain version of B13's dk/dv pass, with the library kernel's rounding
    points: ``dv = pᵀ dz`` and ``dk = dsᵀ q`` with pᵀ and dsᵀ rounded to
    dz's dtype, ``ds = (dz vᵀ - dsum) p``.  Returns ``(dk, dv)``."""
    p = _flash_p(q, k, seg, lse, causal)
    dzf = dz.float()
    ds = (torch.einsum("bnqh,bnkh->bnqk", dzf, v.float()) - dsum[..., None]) * p
    dv = torch.einsum("bnqk,bnqh->bnkh", p.to(dz.dtype).float(), dzf)
    dk = torch.einsum("bnqk,bnqh->bnkh", ds.to(dz.dtype).float(), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_padded_bwd_dq_reference(q, k, v, seg, dz, lse, dsum,
                                            causal: bool = False):
    """Plain version of B13's dq pass: ``dq = ds k`` with ds rounded to k's
    dtype."""
    p = _flash_p(q, k, seg, lse, causal)
    ds = (torch.einsum("bnqh,bnkh->bnqk", dz.float(), v.float()) - dsum[..., None]) * p
    dq = torch.einsum("bnqk,bnkh->bnqh", ds.to(k.dtype).float(), k.float())
    return dq.to(q.dtype)


def flash_lse_reference(q, k, seg, causal: bool = False):
    """Each row's float32 log-sum-exp of its masked scores ``[B, N, Tp]``,
    as B13's forward saves it for the backward."""
    return torch.logsumexp(_flash_scores(q, k, seg, causal), dim=-1)


def flash_dsum(z, dz):
    """``rowsum(z dz)`` in float32 ``[B, N, Tp]``: the D of both backward
    passes, from the forward's output (a plain op, as in the library)."""
    return (z.float() * dz.float()).sum(dim=-1)


def flash_attention_padded_bwd_reference(q, k, v, seg, dz, causal: bool = False):
    """Plain version of B13's whole backward: ``(dq, dk, dv)`` for the
    cotangent ``dz`` of ``flash_attention_padded(q, k, v, seg)``."""
    lse = flash_lse_reference(q, k, seg, causal)
    dsum = flash_dsum(flash_attention_padded_reference(q, k, v, seg, causal), dz)
    dk, dv = flash_attention_padded_bwd_dkv_reference(q, k, v, seg, dz, lse, dsum, causal)
    dq = flash_attention_padded_bwd_dq_reference(q, k, v, seg, dz, lse, dsum, causal)
    return dq, dk, dv


def _check_flash(what, q, k, v, seg, *others):
    if q.ndim != 4 or any(x.shape != q.shape for x in (k, v, *others)):
        raise ValueError(f"{what}: q, k, v must share one [B, N, Tp, H] shape, got "
                         f"{[tuple(x.shape) for x in (q, k, v, *others)]}")
    B, N, Tp, H = q.shape
    if tuple(seg.shape) != (B, Tp) or seg.dtype != torch.int32:
        raise ValueError(f"{what}: seg must be int32 [B, Tp] = [{B}, {Tp}], got "
                         f"{seg.dtype} {tuple(seg.shape)}")
    if not flash_fits(Tp, H):
        raise ValueError(f"{what}: Tp={Tp}, H={H}: Tp must be a multiple of "
                         f"{FLASH_TILE} and H a multiple of 16 up to {FLASH_MAX_HEAD_DIM}")
    return B, N, Tp, H


def _check_flash_cuda(what, tensors, stats):
    _check_cuda(what, *tensors)
    if any(x.data_ptr() % 16 for x in (*tensors, *stats)):
        raise ValueError(f"{what}: q, k, v (and dz), seg (and lse, D) must be "
                         "16-byte aligned")
    for x in stats:
        if x.device != tensors[0].device or not x.is_contiguous():
            raise ValueError(f"{what}: seg, lse and D must be contiguous on "
                             f"{tensors[0].device}")


def _launch_flash(q, k, v, seg, causal: bool):
    """Run B13's forward on PyTorch's current stream: ``(z, lse)``."""
    B, N, Tp, H = _check_flash("flash_attention_padded", q, k, v, seg)
    _check_flash_cuda("flash_attention_padded", (q, k, v), (seg,))
    lib = _build.load_library()
    z = torch.empty_like(q)
    lse = torch.empty(B, N, Tp, dtype=torch.float32, device=q.device)
    rc = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), z.data_ptr(),
        lse.data_ptr(), B, N, Tp, H, int(causal), _DTYPE_CODES[q.dtype], q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, "flash_attention_padded")
    flash_attention_padded.launches += 1
    return z, lse


def _launch_flash_bwd(which, q, k, v, seg, dz, lse, dsum, causal: bool):
    """Run one of B13's backward passes (0: dk and dv, 1: dq)."""
    what = ("flash_attention_padded_bwd_dkv", "flash_attention_padded_bwd_dq")[which]
    B, N, Tp, H = _check_flash(what, q, k, v, seg, dz)
    _check_flash_cuda(what, (q, k, v, dz), (seg, lse, dsum))
    if lse.shape != (B, N, Tp) or dsum.shape != (B, N, Tp) \
            or lse.dtype != torch.float32 or dsum.dtype != torch.float32:
        raise ValueError(f"{what}: lse and D must be float32 [B, N, Tp]")
    lib = _build.load_library()
    dq = torch.empty_like(q) if which else None
    dk, dv = (None, None) if which else (torch.empty_like(k), torch.empty_like(v))
    ptr = lambda t: 0 if t is None else t.data_ptr()
    rc = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dz.data_ptr(), seg.data_ptr(),
        lse.data_ptr(), dsum.data_ptr(), ptr(dq), ptr(dk), ptr(dv), B, N, Tp, H,
        int(causal), which, _DTYPE_CODES[q.dtype], q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, what)
    return dq if which else (dk, dv)


def flash_attention_padded_bwd_dkv(q, k, v, seg, dz, lse, dsum, causal: bool = False):
    """B13's dk/dv pass: ``(dk, dv)`` from the forward's ``lse`` and
    ``dsum`` = :func:`flash_dsum`.  CUDA tensors launch the kernel and add
    one to ``flash_attention_padded_bwd_dkv.launches``; CPU tensors run the
    plain version."""
    if q.device.type == "cpu":
        _check_flash("flash_attention_padded_bwd_dkv", q, k, v, seg, dz)
        return flash_attention_padded_bwd_dkv_reference(q, k, v, seg, dz, lse, dsum, causal)
    out = _launch_flash_bwd(0, q, k, v, seg, dz, lse, dsum, causal)
    flash_attention_padded_bwd_dkv.launches += 1
    return out


flash_attention_padded_bwd_dkv.launches = 0


def flash_attention_padded_bwd_dq(q, k, v, seg, dz, lse, dsum, causal: bool = False):
    """B13's dq pass; as :func:`flash_attention_padded_bwd_dkv`, counted in
    ``flash_attention_padded_bwd_dq.launches``."""
    if q.device.type == "cpu":
        _check_flash("flash_attention_padded_bwd_dq", q, k, v, seg, dz)
        return flash_attention_padded_bwd_dq_reference(q, k, v, seg, dz, lse, dsum, causal)
    out = _launch_flash_bwd(1, q, k, v, seg, dz, lse, dsum, causal)
    flash_attention_padded_bwd_dq.launches += 1
    return out


flash_attention_padded_bwd_dq.launches = 0


class _FlashPadded(torch.autograd.Function):
    """B13 forward and its two backward passes (the plain versions on CPU
    tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, seg, causal):
        if q.device.type == "cpu":
            z = flash_attention_padded_reference(q, k, v, seg, causal)
            lse = flash_lse_reference(q, k, seg, causal)
        else:
            z, lse = _launch_flash(q, k, v, seg, causal)
        ctx.save_for_backward(q, k, v, seg, z, lse)
        ctx.causal = causal
        return z

    @staticmethod
    def backward(ctx, dz):
        q, k, v, seg, z, lse = ctx.saved_tensors
        dz = dz.contiguous()
        dsum = flash_dsum(z, dz)
        dk, dv = flash_attention_padded_bwd_dkv(q, k, v, seg, dz, lse, dsum, ctx.causal)
        dq = flash_attention_padded_bwd_dq(q, k, v, seg, dz, lse, dsum, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention_padded(q, k, v, seg, causal: bool = False):
    """Tiled flash attention over head-major ``[B, N, Tp, H]`` tensors
    (pre-scaled q) -> z ``[B, N, Tp, H]`` in q's dtype, differentiable.
    ``seg`` is the ``[B, Tp]`` int32 segment-id vector: a query row sees a
    key only where their ids are equal (and, when causal, the key is not
    after it), so the caller marks padding rows with their own id.

    CUDA tensors launch the hand-written kernel and add one to
    ``flash_attention_padded.launches`` (the backward launches its two
    passes); CPU tensors run the plain versions.  Tp must be a multiple of
    64 and H a multiple of 16 up to 128 (:func:`flash_fits`); otherwise it
    raises ``ValueError`` on either device."""
    _check_flash("flash_attention_padded", q, k, v, seg)
    return _FlashPadded.apply(q, k, v, seg, causal)


flash_attention_padded.launches = 0


# ---------------------------------------------------------------------------
# B15: the mix over head-major [B, N, T, H]
# ---------------------------------------------------------------------------

def attention_mix_reference(q, k, v):
    """Plain PyTorch version of B15's forward, with the Pallas kernel's
    float32 and cast points: float32 scores and softmax with a division, p
    rounded to v's dtype, float32 PV accumulation, z in q's dtype.  The
    tests use it as the oracle, and the wrapper runs it for CPU tensors."""
    s = torch.einsum("bnqh,bnkh->bnqk", q.float(), k.float())
    s = s - s.amax(dim=-1, keepdim=True)
    e = s.exp()
    p = (e / e.sum(dim=-1, keepdim=True)).to(v.dtype).float()
    return torch.einsum("bnqk,bnkh->bnqh", p, v.float()).to(q.dtype)


def attention_mix_bwd_reference(q, k, v, dz):
    """B15's VJP, the plain version of the JAX package's ``_mix_bwd`` (it
    has no backward kernel): p recomputed in float32, ``ds = p (dp -
    rowsum(dp p))``, float32 einsums, each gradient cast to its input's
    dtype.  Returns ``(dq, dk, dv)``."""
    s = torch.einsum("bnqh,bnkh->bnqk", q.float(), k.float())
    s = s - s.amax(dim=-1, keepdim=True)
    e = s.exp()
    p = e / e.sum(dim=-1, keepdim=True)
    dzf = dz.float()
    dp = torch.einsum("bnqh,bnkh->bnqk", dzf, v.float())
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bnqk,bnkh->bnqh", ds, k.float())
    dk = torch.einsum("bnqk,bnqh->bnkh", ds, q.float())
    dv = torch.einsum("bnqk,bnqh->bnkh", p, dzf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _launch_mix(q, k, v):
    """Run B15's kernel on PyTorch's current stream."""
    _check_cuda("attention_mix", q, k, v)
    B, N, T, H = q.shape
    lib = _build.load_library()
    z = torch.empty_like(q)
    rc = lib.attention_mix_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), z.data_ptr(), B, N, T, H,
        _DTYPE_CODES[q.dtype], q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, "attention_mix")
    attention_mix.launches += 1
    return z


class _Mix(torch.autograd.Function):
    """B15 forward (the plain version on CPU tensors); the plain VJP as the
    backward on either device."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        if q.device.type == "cpu":
            return attention_mix_reference(q, k, v)
        return _launch_mix(q, k, v)

    @staticmethod
    def backward(ctx, dz):
        return attention_mix_bwd_reference(*ctx.saved_tensors, dz)


def attention_mix(q, k, v):
    """Fused softmax attention over head-major ``[B, N, T, H]`` tensors
    (pre-scaled q, no mask) -> z ``[B, N, T, H]`` in q's dtype,
    differentiable: kernel B15.

    CUDA tensors launch the hand-written kernel, B1's device code with the
    head-major strides, and add one to ``attention_mix.launches``; CPU
    tensors run :func:`attention_mix_reference`.  The backward is the plain
    :func:`attention_mix_bwd_reference` on either device, as in the JAX
    package.  The JAX kernel's head-group packing (``_pick_head_group``) and
    batch blocks (``_pick_batch_block``) choose tiles for the TPU's matrix
    unit and on-chip memory and change no result; the port has neither.  It
    takes what B1 takes (:func:`mix_tnh_fits_smem`); past that it raises
    ``NotImplementedError`` on either device."""
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("attention_mix: q, k, v must share one [B, N, T, H] shape, got "
                         f"{[tuple(x.shape) for x in (q, k, v)]}")
    B, N, T, H = q.shape
    if not mix_tnh_fits_smem(T, H):
        raise NotImplementedError(
            f"attention_mix: T={T}, H={H} does not fit the kernel's shared memory "
            "(the gate of attention_mix_tnh); long token axes take the tiled flash "
            "kernel (B13), flash_attention_padded")
    if N > 65535:
        raise ValueError(f"attention_mix: {N} heads exceed the grid limit of 65535")
    return _Mix.apply(q, k, v)


attention_mix.launches = 0


# ---------------------------------------------------------------------------
# B16: QKV projection, mix and output projection in one kernel
# ---------------------------------------------------------------------------

# Must match kHead, kRows and tc::kBytes (bfloat16) and tf::kBytes (float32)
# in csrc/attention_block.cu.
ATTN_BLOCK_HEAD = 64
ATTN_BLOCK_MAX_T = 64
_ATTN_BLOCK_COL_TILE = 128


def attn_block_route(dtype) -> str:
    """The kernel a dtype takes: ``"wgmma"`` (bfloat16, ``block_tc_kernel``)
    or ``"tf32x3"`` (float32, ``block_tf32_kernel``: 3xTF32 on tf32 wgmma,
    the mix on B1's float32 device code)."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_attention_block: no route for {dtype}")
    return "tf32x3" if dtype == torch.float32 else "wgmma"


def attn_block_smem_bytes(dtype) -> int:
    """Shared memory of B16's block; it depends on the dtype alone.  Both
    routes take two images a block.  bfloat16 (``block_tc_kernel``): a
    4-stage TMA ring of 40 KB stages (both images' [64 x 64] x or z tiles
    and one [64 x 192] weight tile), both images' q, k, v [64 x 64] tiles
    with rows padded by 16 bytes, nine mbarriers and 1024 bytes to align
    the 128-byte swizzle.  float32 (``block_tf32_kernel``): a 3-stage ring
    of 48 KB stages (both images' [64 x 32] x or z tiles and room for a
    [128 x 32] weight tile's hi and lo), both images' k and v tiles of 64
    rows of 68 floats, seven mbarriers and the alignment."""
    if attn_block_route(dtype) == "wgmma":
        tiles = 3 * 64 * (ATTN_BLOCK_HEAD + 8) * 2
        ring = 4 * (2 * 64 * 64 + 64 * 192) * 2
        return ring + 2 * tiles + 9 * 8 + 1024
    ring = 3 * (2 * 64 * 32 + 2 * 128 * 32) * 4
    tiles = 2 * 64 * (ATTN_BLOCK_HEAD + 4) * 4
    return ring + 2 * tiles + 7 * 8 + 1024


def _attn_block_scratch(B: int, D: int, NH: int, dtype) -> int:
    """Elements of B16's scratch: z [B, 64, NH] and, float32, the weights'
    split K-major copies, Wqkv^T [2, 3 NH, D] and Wo^T [2, D, NH]."""
    z = B * ATTN_BLOCK_MAX_T * NH
    return z + (8 * NH * D if attn_block_route(dtype) == "tf32x3" else 0)


def attn_block_fits_smem(T: int, D: int, NH: int, dtype, H: int = ATTN_BLOCK_HEAD) -> bool:
    """Whether B16 takes an image of T tokens, model width D and N*H = NH
    attention columns in ``dtype``: its block holds T <= 64 rows and one
    head of width 64 at a time, writes out in 128-column tiles (D a
    multiple of 128), and needs :func:`attn_block_smem_bytes` of shared
    memory.  CLIP ViT-B/32 (T 50, D 768, N 12) fits in both dtypes; CLIP
    L/14 (T 257) does not."""
    return (0 < T <= ATTN_BLOCK_MAX_T and H == ATTN_BLOCK_HEAD and NH > 0
            and NH % H == 0 and D > 0 and D % _ATTN_BLOCK_COL_TILE == 0
            and dtype in _DTYPE_CODES and attn_block_smem_bytes(dtype) <= _MAX_SMEM_BYTES)


def _scale_in(dtype, inv_scale: float) -> float:
    """The scale as the kernel applies it: a Python float multiplying a JAX
    array takes the array's dtype first."""
    return torch.tensor(inv_scale, dtype=dtype).item()


def _split_heads(qkv, B, T, n_heads, H):
    q, k, v = qkv.reshape(B, T, 3, n_heads, H).unbind(2)
    return q, k, v


def fused_attention_block_plain(x, Wqkv, bqkv, Wo, n_heads: int, inv_scale: float):
    """Plain PyTorch version of B16 at the Pallas kernel's rounding points
    (the oracle for the kernel; the wrapper runs it for CPU tensors): qkv
    accumulated in float32 with the float32 bias, rounded once to x's dtype;
    q times the scale rounded again; float32 scores and softmax, p rounded
    to v's dtype; each head's z rounded to x's dtype; out accumulated in
    float32 over all N*H columns, rounded once."""
    B, T, D = x.shape
    NH = Wo.shape[0]
    H = NH // n_heads
    dt = x.dtype
    qkv = (torch.matmul(x.reshape(B * T, D).float(), Wqkv.float()) + bqkv.float()).to(dt)
    q, k, v = _split_heads(qkv, B, T, n_heads, H)
    q = (q.float() * _scale_in(dt, inv_scale)).to(dt)
    s = torch.einsum("bqnh,bknh->bnqk", q.float(), k.float())
    s = s - s.amax(dim=-1, keepdim=True)
    e = s.exp()
    p = (e / e.sum(dim=-1, keepdim=True)).to(v.dtype).float()
    z = torch.einsum("bnqk,bknh->bqnh", p, v.float()).to(dt)
    out = torch.matmul(z.reshape(B * T, NH).float(), Wo.float()).to(dt)
    return out.reshape(B, T, D)


def attn_block_reference(x, Wqkv, bqkv, Wo, n_heads: int, inv_scale: float):
    """The twin of the JAX package's ``_attn_block_ref``: every product in
    x's dtype (float32 accumulation, one rounding each), the bias added in
    x's dtype, softmax in float32, p rounded to x's dtype.  Its autograd is
    B16's backward."""
    B, T, D = x.shape
    NH = Wo.shape[0]
    H = NH // n_heads
    qkv = x.reshape(B * T, D) @ Wqkv + bqkv
    q, k, v = _split_heads(qkv, B, T, n_heads, H)
    q = q * _scale_in(x.dtype, inv_scale)
    s = torch.einsum("bqnh,bknh->bnqk", q.float(), k.float())
    p = torch.softmax(s, dim=-1).to(x.dtype)
    z = torch.einsum("bnqk,bknh->bqnh", p, v)
    return (z.reshape(B * T, NH) @ Wo).reshape(B, T, D)


def _launch_attn_block(x, Wqkv, bqkv, Wo, n_heads: int, inv_scale: float):
    """Run B16's kernel on PyTorch's current stream."""
    tensors = (x, Wqkv, bqkv, Wo)
    _check_cuda("fused_attention_block", *tensors)
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("fused_attention_block: x, Wqkv, bqkv and Wo must be 16-byte aligned")
    B, T, D = x.shape
    NH = Wo.shape[0]
    lib = _build.load_library()
    out = torch.empty_like(x)
    # each image's z rows, from the mix to the output projection; float32:
    # the weights' split copies after them
    zbuf = torch.empty(_attn_block_scratch(B, D, NH, x.dtype), dtype=x.dtype, device=x.device)
    rc = lib.attention_block_fwd(
        x.data_ptr(), Wqkv.data_ptr(), bqkv.data_ptr(), Wo.data_ptr(), zbuf.data_ptr(),
        out.data_ptr(), B, T, D, n_heads, _scale_in(x.dtype, inv_scale),
        _DTYPE_CODES[x.dtype], x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "fused_attention_block")
    fused_attention_block.launches += 1
    return out


class _AttnBlock(torch.autograd.Function):
    """B16 forward (the plain version on CPU tensors); the VJP of
    :func:`attn_block_reference` as the backward on either device, as the
    JAX package's ``_fab_bwd``."""

    @staticmethod
    def forward(ctx, x, Wqkv, bqkv, Wo, n_heads, inv_scale):
        ctx.save_for_backward(x, Wqkv, bqkv, Wo)
        ctx.n_heads, ctx.inv_scale = n_heads, inv_scale
        if x.device.type == "cpu":
            return fused_attention_block_plain(x, Wqkv, bqkv, Wo, n_heads, inv_scale)
        return _launch_attn_block(x, Wqkv, bqkv, Wo, n_heads, inv_scale)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            out = attn_block_reference(*leaves, ctx.n_heads, ctx.inv_scale)
            grads = torch.autograd.grad(out, leaves, g)
        return (*grads, None, None)


def fused_attention_block(x, Wqkv, bqkv, Wo, n_heads: int, inv_scale: float):
    """QKV projection, per-head softmax mix and output projection over
    ``[B, T, D]`` (LayerNorm'd) input as one kernel, B16: ``Wqkv`` ``[D,
    3*N*H]`` (q|k|v packed along the columns), ``bqkv`` ``[3*N*H]``, ``Wo``
    ``[N*H, D]``; no output bias (the caller adds it with the residual).
    Differentiable.

    CUDA tensors launch the hand-written kernel (all three products by hand,
    no library GEMM; TMA and wgmma, two images a block: bfloat16, or float32
    as three TF32 products each, :func:`attn_block_route`) and add one to ``fused_attention_block.launches``; CPU
    tensors run :func:`fused_attention_block_plain`.  The backward is the VJP
    of :func:`attn_block_reference` on either device.  Past
    :func:`attn_block_fits_smem` it raises ``NotImplementedError`` on either
    device."""
    if x.ndim != 3 or Wqkv.ndim != 2 or bqkv.ndim != 1 or Wo.ndim != 2:
        raise ValueError("fused_attention_block: x, Wqkv, bqkv, Wo must be [B, T, D], "
                         "[D, 3*N*H], [3*N*H], [N*H, D]")
    B, T, D = x.shape
    NH = Wo.shape[0]
    if (tuple(Wqkv.shape) != (D, 3 * NH) or tuple(bqkv.shape) != (3 * NH,)
            or tuple(Wo.shape) != (NH, D) or NH % n_heads):
        raise ValueError(
            f"fused_attention_block: x {tuple(x.shape)}, Wqkv {tuple(Wqkv.shape)}, bqkv "
            f"{tuple(bqkv.shape)}, Wo {tuple(Wo.shape)}, n_heads {n_heads} do not agree")
    if not attn_block_fits_smem(T, D, NH, x.dtype, NH // n_heads):
        raise NotImplementedError(
            f"fused_attention_block: T={T}, D={D}, N*H={NH} (H={NH // n_heads}), {x.dtype} "
            f"is past the kernel's gate (T <= {ATTN_BLOCK_MAX_T}, H = {ATTN_BLOCK_HEAD}, D a "
            "multiple of 128, float32 or bfloat16)")
    return _AttnBlock.apply(x, Wqkv, bqkv, Wo, n_heads, inv_scale)


fused_attention_block.launches = 0
