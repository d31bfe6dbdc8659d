"""Fused clip + decoder-row projection + Adam (PyTorch port of
``vit_prisma_tpu/ops/opt_step.py``).

The SAE train step's optimizer side is pure memory traffic.  Kernel B7
(:func:`adam_update`, ``csrc/adam_update.cu``) does it in one read and one
write of every tensor, per layer ``l`` of a ``[L, R, C]`` stack:

    g'   = g * clip_scale[l]
    g''  = g' - <g', p_row> p_row          (W_dec rows only, ``project``)
    mu   = b1 mu + (1-b1) g''
    nu   = b2 nu + (1-b2) g''^2
    p   += -lr[l] * (mu / bc1) / (sqrt(nu) / sqrt(bc2) + eps)

which is ``optax.adam`` (scale_by_adam + scale_by_learning_rate) after the
clip and the projection.  The moments may be stored in bfloat16; the update
math is float32.  :func:`fused_clip_project_adam` keeps optax's state layout
(:class:`ScaleByAdamState`, :class:`ScaleByScheduleState`) and count and
bias corrections, so a JAX train state maps onto the port's one to one
(``sae/convert.py``).  The global-norm clip scale is plain torch outside the
kernel, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from vit_prisma_tpu_torch.ops import _build

_MOMENT_CODES = {torch.float32: 0, torch.bfloat16: 1}


class ScaleByAdamState(NamedTuple):
    """optax's Adam state: the step count and the two moments, by name."""
    count: torch.Tensor
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class ScaleByScheduleState(NamedTuple):
    """optax's schedule state: the count the learning rate is read at."""
    count: torch.Tensor


def adam_update_reference(p, g, mu, nu, scal, *, b1, b2, eps, project):
    """Plain PyTorch version of the kernel, with its cast points, over
    ``[L, ...]`` tensors and the ``[L, 4]`` table ``scal`` = (clip_scale,
    lr, 1/bc1, 1/sqrt(bc2)).  Returns (p, mu, nu) in their dtypes."""
    bshape = (slice(None),) + (None,) * (p.ndim - 1)
    sc, lr, rbc1, sbc2 = (scal[:, i][bshape] for i in range(4))
    pf = p.float()
    gf = g.float() * sc
    if project:
        gf = gf - torch.sum(gf * pf, dim=-1, keepdim=True) * pf
    mu_n = b1 * mu.float() + (1.0 - b1) * gf
    nu_n = b2 * nu.float() + (1.0 - b2) * (gf * gf)
    upd = (-lr) * (mu_n * rbc1) / (torch.sqrt(nu_n) * sbc2 + eps)
    return (pf + upd).to(p.dtype), mu_n.to(mu.dtype), nu_n.to(nu.dtype)


def _launch(p, g, mu, nu, scal, b1, b2, eps, project):
    for name, t in (("p", p), ("g", g), ("mu", mu), ("nu", nu), ("scal", scal)):
        if t.device != p.device:
            raise ValueError(f"adam_update: {name} is on {t.device}, p on {p.device}")
        if not t.is_contiguous():
            raise ValueError(f"adam_update: {name} must be contiguous")
        # the kernel moves four elements per access
        if t is not scal and t.data_ptr() % (4 * t.element_size()):
            raise ValueError(f"adam_update: {name} is not {4 * t.element_size()}"
                             "-byte aligned")
    L, R, C = p.shape
    if C % 4:
        raise ValueError(f"adam_update: the row width C={C} must be a multiple of 4")
    lib = _build.load_library()
    p_out, mu_out, nu_out = (torch.empty_like(t) for t in (p, mu, nu))
    stream = torch.cuda.current_stream(p.device)
    rc = lib.adam_update(
        p.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(), scal.data_ptr(),
        p_out.data_ptr(), mu_out.data_ptr(), nu_out.data_ptr(), L, R, C,
        b1, 1.0 - b1, b2, 1.0 - b2, eps, int(project), _MOMENT_CODES[mu.dtype],
        p.device.index, stream.cuda_stream)
    _build.check(lib, rc, "adam_update")
    adam_update.launches += 1
    return p_out, mu_out, nu_out


def adam_update(p, g, mu, nu, scal, *, b1: float, b2: float, eps: float,
                project: bool):
    """One fused clip/projection/Adam pass over a ``[L, R, C]`` tensor
    (kernel B7).  ``p`` and ``g`` are float32; ``mu`` and ``nu`` share one
    dtype, float32 or bfloat16; ``scal`` is the float32 ``[L, 4]`` table.
    Returns new (p, mu, nu); the inputs are not changed.

    CUDA tensors launch the hand-written kernel and add one to
    ``adam_update.launches``; CPU tensors run :func:`adam_update_reference`."""
    if p.ndim != 3 or g.shape != p.shape or mu.shape != p.shape or nu.shape != p.shape:
        raise ValueError("adam_update: p, g, mu and nu must share one [L, R, C] "
                         f"shape, got {tuple(p.shape)}, {tuple(g.shape)}, "
                         f"{tuple(mu.shape)}, {tuple(nu.shape)}")
    if p.dtype != torch.float32 or g.dtype != torch.float32:
        raise TypeError(f"adam_update: p and g must be float32, got {p.dtype}, {g.dtype}")
    if mu.dtype != nu.dtype or mu.dtype not in _MOMENT_CODES:
        raise TypeError("adam_update: mu and nu must both be float32 or both "
                        f"bfloat16, got {mu.dtype}, {nu.dtype}")
    if tuple(scal.shape) != (p.shape[0], 4) or scal.dtype != torch.float32:
        raise ValueError(f"adam_update: scal must be float32 [L, 4], got "
                         f"{scal.dtype} {tuple(scal.shape)}")
    if p.device.type == "cpu":
        return adam_update_reference(p, g, mu, nu, scal, b1=b1, b2=b2, eps=eps,
                                     project=project)
    return _launch(p, g, mu, nu, scal, b1, b2, eps, project)


adam_update.launches = 0


def fused_clip_project_adam(params, grads, opt_state, *, lr, b1, b2,
                            eps=1e-8, max_grad_norm=None, model_axis=None,
                            sharded_keys=()):
    """Clip -> W_dec projection -> Adam, one :func:`adam_update` pass per
    tensor.

    ``params``/``grads``: dicts of ``[L, ...]``-stacked tensors (a single
    SAE passes L = 1).  ``opt_state``: ``(ScaleByAdamState,
    ScaleByScheduleState)`` with ``[L]``-stacked leaves.  ``lr``: the
    scheduled learning rate, a float or a ``[L]`` (or scalar) tensor on the
    params' device; it is read by the kernel, never by the host.  Returns
    ``(new_params, new_opt_state)``.

    Under a feature-parallel SAE (``parallel/mesh.py``) each rank holds a
    shard of the tensors named in ``sharded_keys``: their sums of squares
    are summed over ``model_axis`` (a ``parallel.collectives.Axis``) before
    the global norm, so every rank takes the same clip scale into B7."""
    adam_st, sched_st = opt_state
    first = next(iter(params.values()))
    L, device = first.shape[0], first.device
    count1 = adam_st.count + 1
    cnt = count1.float()
    rbc1 = (1.0 / (1.0 - torch.pow(b1, cnt))).expand(L)
    sbc2 = (1.0 / torch.sqrt(1.0 - torch.pow(b2, cnt))).expand(L)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=device).expand(L)

    if max_grad_norm:
        # summed in sorted key order, as JAX flattens a dict
        per_key = {k: torch.square(grads[k]).sum(dim=tuple(range(1, grads[k].ndim)))
                   for k in sorted(grads)}
        shards = [k for k in sorted(grads) if k in sharded_keys]
        if shards and model_axis is not None and model_axis.size > 1:
            summed = model_axis.sum(torch.stack([per_key[k] for k in shards]))
            per_key.update(zip(shards, summed))
        sumsq = sum(per_key[k] for k in sorted(grads))
        gnorm = torch.sqrt(sumsq)
        scale = torch.clamp(max_grad_norm / (gnorm + 1e-6), max=1.0)
    else:
        scale = torch.ones(L, dtype=torch.float32, device=device)
    scal = torch.stack([scale, lr, rbc1, sbc2], dim=1).contiguous()  # [L, 4]

    new_params, new_mu, new_nu = {}, {}, {}
    for k, p in params.items():
        shape3 = p.shape if p.ndim == 3 else (L, 1, -1)
        p3 = p.reshape(shape3)
        out = adam_update(p3, grads[k].reshape(p3.shape),
                          adam_st.mu[k].reshape(p3.shape),
                          adam_st.nu[k].reshape(p3.shape), scal,
                          b1=b1, b2=b2, eps=eps, project=(k == "W_dec"))
        new_params[k], new_mu[k], new_nu[k] = (o.reshape(p.shape) for o in out)

    new_opt_state = (ScaleByAdamState(count=count1, mu=new_mu, nu=new_nu),
                     ScaleByScheduleState(count=sched_st.count + 1))
    return new_params, new_opt_state
