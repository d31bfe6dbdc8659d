"""SAE training (PyTorch port of ``vit_prisma_tpu/sae/train.py``): the
train step and the trainer that feeds it from an activation store.

One step (:func:`sae_train_step`), as ``_sae_train_step_impl`` in the JAX
package: unit-norm decoder rows -> ghost mask -> loss and gradients by
autograd (in ``cfg.compute_dtype`` when set) -> the fused clip, W_dec
projection and Adam pass (kernel B7, ``ops/opt_step.py``) -> the fired and
act-freq counters -> the L0 and explained-variance metrics.  The state keeps
optax's layout (``opt_state = (ScaleByAdamState, ScaleByScheduleState)``),
and nothing in the step reads a device value on the host: the scheduled
learning rate goes to the kernel as a device tensor.

The standard-ReLU single SAE takes this step in the JAX package too: its
fused ReLU kernels serve only the all-layer sweep.  A TopK SAE takes the
fused step at any layer count, as in the JAX package: a single SAE is lifted
to a stack of one (:func:`_fused_single_ok`), and its forward runs through
kernel B8 and its backward through B6 or B9.  The generic TopK step, for
configs the fused gate refuses, masks through kernel B10.  A gated SAE
with the ReLU takes the fused step at any layer count too, through kernels
B11 and B12 (gated + TopK takes the generic step).  The sweep
(:func:`sae_sweep_train_step`, :class:`SAESweepTrainer`) trains L SAEs at
once from ``[B, L, d_in]`` batches.  Where :func:`_fused_step_ok` admits it
(standard ReLU at L >= 2, TopK or gated ReLU, tile-aligned shapes) the step
runs the stacked forward through kernel B4 (TopK: B8; gated: B11) and its
backward through B6 or B5 (TopK: B6 or B9; gated: B12)
(``ops/sae_step.py``), then B7 over the ``[L, ...]`` stacks; else it runs
the generic step layer by layer.  :func:`make_fused_cycle` (``train_cycles``)
is, in eager PyTorch, a refill from the cycle's image indices followed by K
steps, serving the same rows as ``train_steps(store.next_batches(K))``.

Both trainers validate in training, as the JAX package's: ``validate()``
runs one eval step (``sae/evals.py``: clean, SAE-substituted and
zero-ablated forwards) over a fixed labelled batch from ``eval_dataset``,
``cfg.n_validation_runs`` times a run at even token thresholds and once at
its end, and ``run`` aborts when the CE recovered falls below
``cfg.min_ce_recovered``; the sweep's ``evaluate()`` runs the all-layer eval
over a dataset.  With ``cfg.log_to_wandb`` the metrics go to wandb when it
imports and starts; otherwise nothing is logged there.

Datasets: :meth:`VisionSAETrainer.load_dataset` gives the (train, eval)
pair a config names, as the JAX trainer's (ImageNet folders, through the
native JPEG loader with ``use_native_loader``; CIFAR-10; any image folder).

Checkpoints: with ``cfg.n_checkpoints`` both trainers save at even token
thresholds and once at the end (``"final"``), as the JAX trainers do: the
single trainer one SAE ``.npz`` and its log feature sparsity
(:meth:`VisionSAETrainer.save_checkpoint`), the sweep one ``.npz`` a layer
(:meth:`SAESweepTrainer.save_checkpoints`).  :func:`save_train_state` and
:func:`load_train_state` keep the whole train state (params, Adam moments in
their dtype, counters) for a resume equal to the uninterrupted run.

The variants that the fused kernels do not take run the generic step, as in
the JAX package (``_fused_step_ok``): ghost grads (the resurrection loss of
the features unfired for over ``cfg.dead_feature_window`` steps),
``normalize_activations``, ``topk_use_approx`` (the exact
:func:`~vit_prisma_tpu_torch.sae.sae.topk_activation`, JAX's route off the
TPU) and the transcoder, whose step takes the output hook's rows as its
``target`` (the store's ``[..., 1, :]`` slot): the MSE, the explained
variance and the ghost loss's residual are taken as the JAX step takes
them.

Sharding (``parallel/mesh.py``): with ``mesh`` (or a store built with one)
both trainers train this rank's shard of the state on its rows of each
batch: the single SAE feature-parallel over ``model`` and data-parallel
over ``data`` (:func:`~vit_prisma_tpu_torch.parallel.mesh.shard_sae_train_step`),
the sweep layer-parallel over ``model`` and data-parallel over ``data``
(:func:`~vit_prisma_tpu_torch.parallel.mesh.shard_sae_sweep_step`).  The
metrics are the global ones on every rank; ``whole_state`` gathers the
state.  :func:`save_train_state_sharded` and :func:`load_train_state_sharded`
keep a sharded state with ``torch.distributed.checkpoint``: each rank
writes its own shards, and a load restores into any mesh's plan, or whole.
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from vit_prisma_tpu_torch.configs.vit_config import DTYPE_MAP
from vit_prisma_tpu_torch.ops.opt_step import (
    ScaleByAdamState,
    ScaleByScheduleState,
    fused_clip_project_adam,
)
from vit_prisma_tpu_torch.ops.sae_step import (
    fused_gated_step_eligible,
    fused_step_eligible,
    sae_fused_apply,
    sae_fused_apply_topk,
    sae_gated_fused_apply,
)
from vit_prisma_tpu_torch.parallel.collectives import NO_SHARDING, SINGLE, Axis, ShardAxes
from vit_prisma_tpu_torch.sae.config import SAERunnerConfig
from vit_prisma_tpu_torch.sae.geometric_median import compute_geometric_median
from vit_prisma_tpu_torch.sae.sae import (
    SAEOutput,
    SparseAutoencoder,
    init_sae_params,
    sae_forward,
    set_decoder_norm_to_unit_norm,
)
from vit_prisma_tpu_torch.sae.schedulers import get_schedule
from vit_prisma_tpu_torch.utils.device import resolve_device

Params = Dict[str, torch.Tensor]


class SAETrainState(NamedTuple):
    params: Params
    opt_state: Tuple[ScaleByAdamState, ScaleByScheduleState]
    act_freq_scores: torch.Tensor              # [d_sae] float32
    n_forward_passes_since_fired: torch.Tensor  # [d_sae] float32
    n_frac_active_tokens: torch.Tensor         # scalar float32
    step: torch.Tensor                         # scalar int32
    n_training_tokens: torch.Tensor            # scalar int64


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    mse_loss: torch.Tensor
    l1_loss: torch.Tensor
    ghost_grad_loss: torch.Tensor
    aux_reconstruction_loss: torch.Tensor
    l0: torch.Tensor
    explained_variance: torch.Tensor
    n_dead_features: torch.Tensor
    lr_multiplier: torch.Tensor


def make_schedule(cfg: SAERunnerConfig):
    """The LR multiplier as a function of the step (``lr = cfg.lr *
    schedule(count)``); the JAX package's ``make_optimizer`` without optax."""
    return get_schedule(cfg.lr_scheduler_name, warm_up_steps=cfg.lr_warm_up_steps,
                        training_steps=cfg.total_training_steps)


def init_train_state(cfg: SAERunnerConfig, params: Optional[Params] = None,
                     generator: Optional[torch.Generator] = None,
                     device=None) -> SAETrainState:
    """Zero moments in ``cfg.adam_dtype``, zero counters, on the params'
    device (``device`` when the params are drawn here, the CUDA card when
    None)."""
    if cfg.adam_dtype != "float32" and not cfg.fused_optimizer:
        raise ValueError("adam_dtype='bfloat16' requires fused_optimizer")
    if params is None:
        params = init_sae_params(cfg, generator, device)
    first = next(iter(params.values()))
    dev, mdt = first.device, DTYPE_MAP[cfg.adam_dtype]
    zeros = lambda *shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype, device=dev)
    adam = ScaleByAdamState(
        count=zeros(dtype=torch.int32),
        mu={k: torch.zeros_like(v, dtype=mdt) for k, v in params.items()},
        nu={k: torch.zeros_like(v, dtype=mdt) for k, v in params.items()})
    return SAETrainState(
        params=dict(params),
        opt_state=(adam, ScaleByScheduleState(count=zeros(dtype=torch.int32))),
        act_freq_scores=zeros(cfg.d_sae),
        n_forward_passes_since_fired=zeros(cfg.d_sae),
        n_frac_active_tokens=zeros(),
        step=zeros(dtype=torch.int32),
        n_training_tokens=zeros(dtype=torch.int64))


def _lift(d: Params) -> Params:
    return {k: v[None] for k, v in d.items()}


def _drop(d: Params) -> Params:
    return {k: v[0] for k, v in d.items()}


def _grads(loss: torch.Tensor, leaves: Params) -> Params:
    """d loss / d leaves, zero for a leaf the loss does not read (the gated
    SAE's ``b_enc``), as ``jax.grad`` returns it; B7 then keeps such a
    leaf and its moments at 0."""
    return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()),
                                                allow_unused=True, materialize_grads=True)))


def loss_and_grads(params: Params, batch: torch.Tensor, cfg: SAERunnerConfig,
                   dead_neuron_mask: Optional[torch.Tensor] = None,
                   target: Optional[torch.Tensor] = None,
                   axes: ShardAxes = NO_SHARDING) -> Tuple[Params, SAEOutput]:
    """The step's forward and backward: gradients of ``sae_forward``'s loss
    (against ``target``, a transcoder's) with respect to ``params``,
    optionally computed in ``cfg.compute_dtype`` (the cast sits inside the
    graph, so float32 params get float32 grads).  Returns (grads, detached
    output)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    compute_dt = cfg.compute_torch_dtype
    with torch.enable_grad():
        p, b, t = leaves, batch, target
        if compute_dt is not None:
            p = {k: v.to(compute_dt) for k, v in leaves.items()}
            b = batch.to(compute_dt)
            t = None if target is None else target.to(compute_dt)
        out = sae_forward(p, cfg, b, y=t, dead_neuron_mask=dead_neuron_mask, training=True,
                          axes=axes)
        grads = _grads(out.loss, leaves)
    return grads, SAEOutput(*(
        None if t is None else t.detach() for t in out))


# the parameters a feature-parallel SAE splits over the model axis
FEATURE_KEYS = ("W_enc", "W_dec", "b_enc", "b_gate", "r_mag", "b_mag")


@torch.no_grad()
def _sae_train_step_impl(state: SAETrainState, batch: torch.Tensor,
                         cfg: SAERunnerConfig,
                         target: Optional[torch.Tensor] = None,
                         axes: ShardAxes = NO_SHARDING
                         ) -> Tuple[SAETrainState, StepMetrics]:
    """The generic step.  ``axes`` shards it (``parallel/mesh.py``): the
    batch is this rank's rows of the global batch (``axes.data``) and the
    state its shard of the features (``axes.model``); the gradients are
    averaged over the rows' axis, every sum over features and rows is
    summed over its axis, and the metrics are the global ones."""
    schedule = make_schedule(cfg)
    data, model = axes.data, axes.model

    # 1. decoder unit-norm projection before the forward
    params = set_decoder_norm_to_unit_norm(state.params)

    # 2. ghost mask from the fired counters
    ghost_mask = state.n_forward_passes_since_fired > cfg.dead_feature_window

    # 3. forward/backward; the mean of the shards' gradients is the global one
    grads, out = loss_and_grads(params, batch, cfg, ghost_mask, target, axes)
    grads = {k: data.mean(g) for k, g in grads.items()}
    feature_acts, sae_out = out.feature_acts, out.sae_out

    # 4+5. clip -> W_dec projection -> Adam, one kernel-B7 pass per tensor
    adam_st, sched_st = state.opt_state
    lr = cfg.lr * schedule(sched_st.count)
    new_p, (new_adam, new_sched) = fused_clip_project_adam(
        _lift(params), _lift(grads),
        (adam_st._replace(mu=_lift(adam_st.mu), nu=_lift(adam_st.nu)), sched_st),
        lr=lr, b1=cfg.adam_b1, b2=cfg.adam_b2, max_grad_norm=cfg.max_grad_norm,
        model_axis=model, sharded_keys=FEATURE_KEYS)
    new_adam = new_adam._replace(mu=_drop(new_adam.mu), nu=_drop(new_adam.nu))

    # 6. fired/act-freq counters.  The activations are >= 0 (ReLU,
    # tanh-ReLU or TopK), so the JAX package's |h| > 0 and h > 0 are one mask.
    active = feature_acts > 0
    n_active = data.sum(active.sum(dim=0, dtype=torch.float32))
    fired_counter = torch.where(n_active > 0, 0.0, state.n_forward_passes_since_fired + 1.0)
    act_freq = state.act_freq_scores + n_active
    n_rows = batch.shape[0] * data.size

    # metrics
    l0 = data.mean(model.sum(active.sum(dim=-1, dtype=torch.float32)).mean())
    tgt = (target if cfg.is_transcoder and target is not None else batch).to(cfg.torch_dtype)
    resid_var = torch.square(tgt - sae_out).sum(-1)
    total_var = torch.square(tgt - data.mean(tgt.mean(0))).sum(-1)
    explained_variance = data.mean((1 - resid_var / total_var).mean())
    # TopK has no sparsity loss: the metric reads 0
    l1_val = out.l1_loss if out.l1_loss is not None else torch.zeros(
        (), dtype=torch.float32, device=batch.device)

    new_state = SAETrainState(
        params=_drop(new_p),
        opt_state=(new_adam, new_sched),
        act_freq_scores=act_freq,
        n_forward_passes_since_fired=fired_counter,
        n_frac_active_tokens=state.n_frac_active_tokens + n_rows,
        step=state.step + 1,
        n_training_tokens=state.n_training_tokens + n_rows)
    metrics = StepMetrics(
        loss=data.mean(out.loss), mse_loss=data.mean(out.mse_loss),
        l1_loss=data.mean(l1_val), ghost_grad_loss=data.mean(out.ghost_grad_loss),
        aux_reconstruction_loss=data.mean(out.aux_reconstruction_loss),
        l0=l0, explained_variance=explained_variance,
        n_dead_features=model.sum(ghost_mask.sum()), lr_multiplier=schedule(state.step))
    return new_state, metrics


def sae_train_step(state: SAETrainState, batch: torch.Tensor,
                   cfg: SAERunnerConfig,
                   target: Optional[torch.Tensor] = None
                   ) -> Tuple[SAETrainState, StepMetrics]:
    """One training step on ``batch`` [train_batch_size, d_in] (``target``:
    a transcoder's output-hook rows).  Returns a new state; ``state`` is
    left as it was.  Configs that :func:`_fused_single_ok` admits (TopK,
    gated) run the fused step on a stack of one, as the JAX package does."""
    if target is None and _fused_single_ok(cfg, batch.shape[0]):
        new1, m1 = _sae_train_step_fused(_map_state(lambda a: a[None], state),
                                         batch[None], cfg)
        return _map_state(lambda a: a[0], new1), StepMetrics(*(f[0] for f in m1))
    return _sae_train_step_impl(state, batch, cfg, target)


def _apply_window_reset(state: SAETrainState,
                        cfg: SAERunnerConfig) -> SAETrainState:
    """Zero the act-freq counters when the post-step count hits a
    ``feature_sampling_window`` multiple, on the device (the multi-step
    path's form of :func:`reset_sparsity_counters`).  ``state.step`` may be
    a scalar or, for the sweep, ``[L]``."""
    w = cfg.feature_sampling_window
    if not w:
        return state
    keep = 1.0 - ((state.step % w) == 0).float()
    af_keep = keep.reshape(keep.shape + (1,) * (state.act_freq_scores.ndim - keep.ndim))
    return state._replace(act_freq_scores=state.act_freq_scores * af_keep,
                          n_frac_active_tokens=state.n_frac_active_tokens * keep)


def sae_train_multistep(state: SAETrainState, batches: torch.Tensor,
                        cfg: SAERunnerConfig,
                        targets: Optional[torch.Tensor] = None
                        ) -> Tuple[SAETrainState, StepMetrics]:
    """K steps over ``batches`` [K, B, d_in] (and ``targets``, a
    transcoder's, likewise) with the window resets applied after each, as
    the JAX package's ``lax.scan``; metrics stacked [K]."""
    per_step = []
    for i, b in enumerate(batches):
        state, m = sae_train_step(state, b, cfg, None if targets is None else targets[i])
        state = _apply_window_reset(state, cfg)
        per_step.append(m)
    return state, StepMetrics(*(torch.stack(f) for f in zip(*per_step)))


def reset_sparsity_counters(state: SAETrainState) -> SAETrainState:
    """Feature-sparsity window reset."""
    return state._replace(
        act_freq_scores=torch.zeros_like(state.act_freq_scores),
        n_frac_active_tokens=torch.zeros_like(state.n_frac_active_tokens))


def initialize_b_dec(cfg: SAERunnerConfig, params: Params,
                     activations: torch.Tensor) -> Params:
    """b_dec from stored activations: their geometric median (100 Weiszfeld
    iterations), their mean, or left at zero."""
    out = dict(params)
    if cfg.b_dec_init_method == "geometric_median":
        out["b_dec"] = compute_geometric_median(
            activations, maxiter=100).median.to(cfg.torch_dtype)
    elif cfg.b_dec_init_method == "mean":
        out["b_dec"] = activations.mean(0).to(cfg.torch_dtype)
    return out


# ---------------------------------------------------------------------------
# The all-layer sweep: L SAEs trained at once, state leaves stacked [L, ...]
# ---------------------------------------------------------------------------

_COUNTERS = ("act_freq_scores", "n_forward_passes_since_fired",
             "n_frac_active_tokens", "step", "n_training_tokens")


def _map_state(fn: Callable, *states: SAETrainState) -> SAETrainState:
    """``fn`` applied leaf by leaf across train states of one structure."""
    first = states[0]
    leaf = lambda get: fn(*(get(s) for s in states))
    tree = lambda get: {k: fn(*(get(s)[k] for s in states)) for k in get(first)}
    return SAETrainState(
        params=tree(lambda s: s.params),
        opt_state=(ScaleByAdamState(count=leaf(lambda s: s.opt_state[0].count),
                                    mu=tree(lambda s: s.opt_state[0].mu),
                                    nu=tree(lambda s: s.opt_state[0].nu)),
                   ScaleByScheduleState(count=leaf(lambda s: s.opt_state[1].count))),
        **{f: leaf(lambda s, f=f: getattr(s, f)) for f in _COUNTERS})


def _stack_metrics(per_step) -> StepMetrics:
    return StepMetrics(*(torch.stack(f) for f in zip(*per_step)))


def init_sweep_state(cfg: SAERunnerConfig, n_layers: int,
                     generator: Optional[torch.Generator] = None,
                     device=None) -> SAETrainState:
    """Stacked train state for ``n_layers`` independent SAEs, drawn one
    after another from ``generator`` (seeded with ``cfg.seed`` when None)."""
    g = generator if generator is not None else torch.Generator().manual_seed(cfg.seed)
    states = [init_train_state(cfg, generator=g, device=device) for _ in range(n_layers)]
    return _map_state(lambda *xs: torch.stack(xs), *states)


def _fused_step_ok(cfg: SAERunnerConfig, n_rows: int, n_layers: int = 1,
                   allow_single_layer: bool = False) -> bool:
    """Config and shape gate of the fused step, as the JAX package's: the
    standard ReLU with the L1 penalty (kernels B4-B6) at L >= 2 (the JAX
    package measured the generic step faster at L = 1), or TopK with an
    exact k below d_sae (B8, B9, B6; at L = 1 through
    :func:`_fused_single_ok`), or the gated SAE with the ReLU (B11, B12; at
    L = 1 too), on tile-aligned shapes."""
    if n_layers < 2 and not allow_single_layer:
        return False
    if not (cfg.fused_sae_step
            and cfg.architecture in ("standard", "gated")
            and cfg.activation_fn_str in ("relu", "topk")
            and cfg.normalize_activations == "none"
            and not cfg.use_ghost_grads
            and not cfg.is_transcoder):
        return False
    itemsize = (cfg.compute_torch_dtype or cfg.torch_dtype).itemsize
    if cfg.architecture == "gated":
        # the gated kernels are ReLU only; gated + TopK takes the generic step
        return (cfg.activation_fn_str == "relu"
                and fused_gated_step_eligible(n_rows, cfg.d_in, cfg.d_sae, itemsize))
    if cfg.activation_fn_str == "topk":
        # the fused kernels are exact; an approx opt-in stays off them
        if cfg.topk_use_approx or not cfg.topk_k or cfg.topk_k >= cfg.d_sae:
            return False
    elif cfg.lp_norm != 1.0:
        return False
    return fused_step_eligible(n_rows, cfg.d_in, cfg.d_sae, itemsize)


def _fused_single_ok(cfg: SAERunnerConfig, n_rows: int) -> bool:
    """The single-SAE (L = 1) fused gate: TopK and gated take it, as in the
    JAX package (the unfused TopK step pays a full threshold pass over the
    [B, d_sae] pre-activations; the unfused gated step a second encoder
    product)."""
    if cfg.activation_fn_str == "topk" or cfg.architecture == "gated":
        return _fused_step_ok(cfg, n_rows, 1, allow_single_layer=True)
    return False


@torch.no_grad()
def _sae_train_step_fused(state: SAETrainState, x: torch.Tensor,
                          cfg: SAERunnerConfig,
                          data: Axis = SINGLE) -> Tuple[SAETrainState, StepMetrics]:
    """Stacked step on the fused kernels, for a layer-major batch ``x``
    ``[L, B, d_in]``; the JAX package's ``_sae_train_step_fused``.  With
    ``data`` (the JAX ``data_axis``), ``x`` is this rank's rows of the
    global batch, and the step inserts the JAX step's collectives: the
    global batch mean in the normalized-MSE denominator, the mean of the
    gradients, the sum of ``nact``, the means of the metrics and the global
    B in the token counters.  The per-layer losses are summed for one backward
    (the layers' params are disjoint, so each layer gets its own grads).
    TopK has no sparsity penalty: its l1 metric is 0.  Gated adds the
    decoder-norm-weighted gate L1 and the aux reconstruction of the gate
    path against ``x - b_dec`` (b_dec's gradient flows through both)."""
    schedule = make_schedule(cfg)
    B = x.shape[1]
    B_global = B * data.size
    params = set_decoder_norm_to_unit_norm(state.params)
    ghost_mask = state.n_forward_passes_since_fired > cfg.dead_feature_window
    compute_dt = cfg.compute_torch_dtype
    is_topk = cfg.activation_fn_str == "topk"
    is_gated = cfg.architecture == "gated"
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        p = leaves if compute_dt is None else {k: v.to(compute_dt) for k, v in leaves.items()}
        xt = x.to(p["W_enc"].dtype)
        weights = (xt, p["W_enc"], p["b_enc"], p["W_dec"], p["b_dec"])
        if is_gated:
            y, via, l1_sums, nact = sae_gated_fused_apply(
                xt, p["W_enc"], p["b_gate"], p["r_mag"], p["b_mag"], p["W_dec"], p["b_dec"])
        elif is_topk:
            y, l1_sums, nact = sae_fused_apply_topk(*weights, k=cfg.topk_k,
                                                    save_acts=cfg.fused_store_acts)
        else:
            y, l1_sums, nact = sae_fused_apply(*weights, save_acts=cfg.fused_store_acts)
        cent = xt - data.mean(xt.mean(dim=1, keepdim=True))
        norm = torch.sqrt(torch.square(cent).sum(
            dim=-1, keepdim=True, dtype=torch.float32)).to(xt.dtype)
        mse_l = (torch.square(y - xt) / norm).mean(dim=(1, 2), dtype=torch.float32)
        l1_l = torch.zeros_like(mse_l) if is_topk else cfg.l1_coefficient * l1_sums / B
        aux_l = torch.zeros_like(mse_l)
        if is_gated:
            sae_in = xt - p["b_dec"][:, None, :]
            aux_l = torch.square(via - sae_in).sum(dim=-1, dtype=torch.float32).mean(dim=-1)
        loss_l = mse_l + l1_l + aux_l
        grads = _grads(loss_l.sum(), leaves)
    # the mean of the shards' gradients is the global batch's gradient
    grads = {k: data.mean(g) for k, g in grads.items()}
    nact = data.sum(nact)
    mse_l, l1_l, aux_l, loss_l = (data.mean(v.detach()) for v in (mse_l, l1_l, aux_l, loss_l))

    # clip -> W_dec projection -> Adam per layer, kernel B7 over the stacks
    adam_st, sched_st = state.opt_state
    new_params, new_opt = fused_clip_project_adam(
        params, grads, state.opt_state, lr=cfg.lr * schedule(sched_st.count),
        b1=cfg.adam_b1, b2=cfg.adam_b2, max_grad_norm=cfg.max_grad_norm)

    # nact is the per-feature count of active rows: the counters and L0
    fired_counter = torch.where(nact > 0, 0.0, state.n_forward_passes_since_fired + 1.0)
    act_freq = state.act_freq_scores + nact
    l0 = nact.sum(dim=-1) / B_global
    x32 = x.to(cfg.torch_dtype)
    y = y.detach()
    resid_var = torch.square(x32 - y.to(x32.dtype)).sum(-1)
    total_var = torch.square(x32 - data.mean(x32.mean(dim=1, keepdim=True))).sum(-1)
    explained_variance = data.mean((1 - resid_var / total_var).mean(dim=-1))

    zeros_l = torch.zeros_like(mse_l)
    new_state = SAETrainState(
        params=new_params, opt_state=new_opt,
        act_freq_scores=act_freq, n_forward_passes_since_fired=fired_counter,
        n_frac_active_tokens=state.n_frac_active_tokens + B_global,
        step=state.step + 1, n_training_tokens=state.n_training_tokens + B_global)
    metrics = StepMetrics(
        loss=loss_l, mse_loss=mse_l, l1_loss=l1_l,
        ghost_grad_loss=zeros_l, aux_reconstruction_loss=aux_l,
        l0=l0, explained_variance=explained_variance,
        n_dead_features=ghost_mask.sum(dim=-1).float(), lr_multiplier=schedule(state.step))
    return new_state, metrics


def _sweep_generic_step(state: SAETrainState, x: torch.Tensor,
                        cfg: SAERunnerConfig) -> Tuple[SAETrainState, StepMetrics]:
    """The generic step once per layer of a layer-major batch ``[L, B, d]``
    (the JAX package vmaps it), results stacked on the layer axis."""
    outs = [_sae_train_step_impl(_map_state(lambda a, l=l: a[l], state), x[l], cfg)
            for l in range(x.shape[0])]
    return (_map_state(lambda *xs: torch.stack(xs), *(s for s, _ in outs)),
            _stack_metrics(m for _, m in outs))


def sae_sweep_train_step(state: SAETrainState, batch: torch.Tensor,
                         cfg: SAERunnerConfig) -> Tuple[SAETrainState, StepMetrics]:
    """All-layer sweep step: ``state`` leaves are ``[L, ...]``, ``batch`` is
    ``[B, L, d_in]`` (one row per layer from one harvest).  The fused
    kernels when :func:`_fused_step_ok` admits the config, else the generic
    step per layer.  Metrics are ``[L]``."""
    x = batch.transpose(0, 1)
    if _fused_step_ok(cfg, batch.shape[0], batch.shape[1]):
        return _sae_train_step_fused(state, x.contiguous(), cfg)
    return _sweep_generic_step(state, x, cfg)


def sae_sweep_train_multistep(state: SAETrainState, batches: torch.Tensor,
                              cfg: SAERunnerConfig) -> Tuple[SAETrainState, StepMetrics]:
    """K sweep steps over ``batches`` ``[K, B, L, d_in]`` with the window
    resets after each; metrics stacked ``[K, L]``.  On the fused path the
    ``[K, B, L, d] -> [K, L, B, d]`` transpose is made once for the K
    steps, as the JAX package hoists it out of its scan."""
    fused = _fused_step_ok(cfg, batches.shape[1], batches.shape[2])
    xs = batches.transpose(1, 2)
    if fused:
        xs = xs.contiguous()
    per_step = []
    for x in xs:
        state, m = (_sae_train_step_fused if fused else _sweep_generic_step)(state, x, cfg)
        state = _apply_window_reset(state, cfg)
        per_step.append(m)
    return state, _stack_metrics(per_step)


# ---------------------------------------------------------------------------
# The fused cycle: refill + the half-buffer's K steps
# ---------------------------------------------------------------------------

def _warn_unserved_half(ptr: int, half: int) -> None:
    """``train_cycles`` expects the buffer's first half to be served; rows
    left unserved are dropped by the first cycle's mix."""
    if ptr != half:
        warnings.warn(
            f"train_cycles entered with store.ptr={ptr} != half={half}: "
            f"{half - ptr} already-harvested rows will be dropped unserved "
            "by the first cycle's mix. Serve them first (next_batches / "
            "train_steps) to keep the documented stream equivalence.",
            stacklevel=3)


def make_fused_cycle(cfg: SAERunnerConfig, store, multistep=None):
    """The steady-state cycle: images from the cycle's indices -> harvest of
    the fresh (floor) half -> the B3 mix -> K train steps.  The JAX package
    makes this one XLA program; PyTorch runs it eagerly, in the same order,
    so it serves the same rows as ``train_steps(store.next_batches(K))``
    with K batches spanning the half-buffer.

    Needs ``store.fused_cycle_available`` (a device-resident dataset) and
    ``K * train_batch_size`` equal to half the buffer.  Returns
    ``cycle(state, idx) -> (state, metrics)``, where ``idx`` is
    ``store.next_cycle_indices()``.  ``multistep(state, batches, cfg)``
    runs the K steps (a sharded trainer's; the unsharded one when None)."""
    if not store.fused_cycle_available:
        raise ValueError("the fused cycle needs a device-resident dataset (a tensor, a "
                         "small ndarray, or device_dataset=True)")
    bs = cfg.train_batch_size
    half = store.buffer_tokens // 2
    K = half // bs
    if K * bs != half:
        raise ValueError(f"train_batch_size({bs}) must divide the half-buffer ({half})")
    if multistep is None:
        multistep = sae_sweep_train_multistep if cfg.sweep_layers else sae_train_multistep

    def cycle(state: SAETrainState, idx) -> Tuple[SAETrainState, StepMetrics]:
        store._refill_half(indices=idx)
        n = store.local_batch_size  # this rank's rows of a batch under a mesh
        batches = store.buffer[:K * n].reshape((K, n) + tuple(store.buffer.shape[1:]))
        return multistep(state, batches, cfg)

    return cycle


# ---------------------------------------------------------------------------
# Trainers
# ---------------------------------------------------------------------------

def _token_thresholds(cfg: SAERunnerConfig, n: int):
    """Evenly spaced token thresholds of a run."""
    if not n:
        return []
    total = cfg.total_training_tokens
    return list(range(0, total, total // n))[1:]


def _build_val_batch(eval_dataset, n: int):
    """One fixed labelled eval batch (images, labels) from a dataset of
    (image, label) items or bare images (labels 0), as tensors where the
    items lie."""
    items = [eval_dataset[i] for i in range(n)]
    if isinstance(items[0], (tuple, list)):
        images = torch.stack([torch.as_tensor(it[0]) for it in items])
        labels = torch.tensor([int(it[1]) for it in items], dtype=torch.int64)
    else:
        images = torch.stack([torch.as_tensor(it) for it in items])
        labels = torch.zeros((n,), dtype=torch.int64)
    return images, labels


def _class_emb_or_identity(model, images, class_embeddings):
    """Class directions for the substitution CE: the given zero-shot or
    probe matrix, else an identity readout over the model's own output."""
    device = next(model.parameters()).device
    if class_embeddings is not None:
        return torch.as_tensor(class_embeddings).to(device)
    probe = model(images[:1].to(device))
    return torch.eye(probe.shape[-1], dtype=probe.dtype, device=device)


def _start_wandb(cfg: SAERunnerConfig):
    """The wandb module after ``wandb.init``, or None when it does not
    import or start (the run goes on without it)."""
    if not cfg.log_to_wandb:
        return None
    try:
        import wandb
        wandb.init(project=cfg.wandb_project, entity=cfg.wandb_entity, config=cfg.to_dict())
        return wandb
    except Exception:
        return None


def _substitution_score(clean: float, recons: float, zero: float) -> float:
    denom = zero - clean
    return (zero - recons) / denom if abs(denom) > 1e-9 else float("nan")


class VisionSAETrainer:
    """Streams token rows from an activation store into the train step,
    with the JAX trainer's log cadence, sparsity-window resets, bad-run
    abort, in-training validation (``eval_dataset``: (image, label) items
    or bare images; ``class_embeddings``: the class directions, else an
    identity readout of the model's output) and optional wandb logging.
    Parameters are drawn from ``generator`` (seeded with ``cfg.seed`` when
    None) and live on ``device`` (when None: the store's, or the CUDA card
    without a store).

    ``mesh`` (default: the store's): a ``(data, model)`` mesh; the state is
    this rank's shard (``whole_state()`` gathers it; ``load_state`` takes a
    shard), steps take this rank's rows, and one rank writes the
    checkpoints.  Every rank runs the same calls."""

    _step = staticmethod(sae_train_step)
    _multistep = staticmethod(sae_train_multistep)
    _shard_builders = ("shard_sae_train_step", "shard_sae_train_multistep",
                       "sae_state_shardings")

    def __init__(self, cfg: SAERunnerConfig, model=None, store=None,
                 generator: Optional[torch.Generator] = None, device=None,
                 eval_dataset=None, class_embeddings=None, mesh=None):
        self.cfg = cfg
        self.model = model
        self.store = store
        self.mesh = mesh if mesh is not None else getattr(store, "mesh", None)
        self._cycle = None
        if device is None:
            device = store.device if store is not None else resolve_device()
        self.state = self._init_state(generator, device)
        self._plan = None
        if self.mesh is not None:
            self._setup_mesh()
        # Host mirror of the device step counter: the cadence checks read it
        # instead of the device value, so the loop never waits for the
        # device except to log.  load_state() keeps it in sync.
        self._host_step = 0
        self.checkpoint_thresholds = _token_thresholds(cfg, cfg.n_checkpoints)
        self.validation_thresholds = _token_thresholds(cfg, cfg.n_validation_runs)
        self.eval_dataset = eval_dataset if eval_dataset is not None else \
            getattr(store, "eval_dataset", None)
        self.class_embeddings = class_embeddings
        self._val_step = None
        self._val_batch = None
        self._wandb = _start_wandb(cfg)

    def _init_state(self, generator, device) -> SAETrainState:
        cfg, store = self.cfg, self.store
        params = init_sae_params(cfg, generator, device)
        if store is not None and cfg.b_dec_init_method != "zeros":
            # of a transcoder's [tokens, 2, d] buffer, the input slot
            sample = store.peek_tokens(min(4096 * 8, cfg.tokens_per_buffer))
            params = initialize_b_dec(cfg, params, sample.to(device))
        return init_train_state(cfg, params=params)

    def _setup_mesh(self):
        """Place the whole state on the mesh (this rank's shard) and take
        the sharded step and multistep."""
        from vit_prisma_tpu_torch.parallel import mesh as M
        step_b, multi_b, plan_b = (getattr(M, n) for n in self._shard_builders)
        place, step = step_b(self.cfg, self.mesh, self.state)
        multi = multi_b(self.cfg, self.mesh, self.state)
        self._plan = plan_b(self.mesh, self.state)
        self.state = place(self.state)
        self._step = lambda state, batch, cfg, *target: step(state, batch, *target)
        self._multistep = lambda state, batches, cfg, *targets: multi(state, batches, *targets)

    @property
    def _is_writer(self) -> bool:
        """The rank that writes files: rank 0 under a mesh."""
        return self.mesh is None or torch.distributed.get_rank() == 0

    def whole_state(self) -> SAETrainState:
        """The whole train state: the state itself, or under a mesh the
        shards gathered (a collective: every rank calls it)."""
        if self.mesh is None:
            return self.state
        from vit_prisma_tpu_torch.parallel.mesh import gather_tree
        return gather_tree(self.state, self._plan)

    @staticmethod
    def load_dataset(cfg: SAERunnerConfig):
        """(train, eval) datasets from cfg: ``imagenet1k`` (folder-per-class
        train/val paths; with ``use_native_loader`` and only JPEGs, the train
        feed is a ``NativeBatchLoader`` at ``cfg.image_size`` with the
        model's statistics, on the uint8 wire when ``store_wire_dtype`` is
        'uint8'), ``cifar10`` (pickle batches under dataset_path), or any
        image folder with an 80/20 split.  Items are (image[C,H,W] float32,
        label)."""
        from vit_prisma_tpu_torch.dataloaders.imagenet import ImageFolderDataset
        from vit_prisma_tpu_torch.dataloaders.transforms import (
            get_model_transform_params, get_model_transforms)
        transform = get_model_transforms(cfg.model_name)

        if cfg.dataset_name == "imagenet1k":
            train = ImageFolderDataset(cfg.dataset_train_path or cfg.dataset_path,
                                       transform=transform)
            all_jpeg = all(p.lower().endswith((".jpg", ".jpeg")) for p, _ in train.samples)
            if cfg.use_native_loader and not all_jpeg:
                warnings.warn("use_native_loader: dataset contains non-JPEG images the "
                              "C++ decoder cannot read; keeping the indexed PIL pipeline")
            if cfg.use_native_loader and all_jpeg:
                from vit_prisma_tpu_torch.dataloaders.native import NativeBatchLoader
                _, mean, std = get_model_transform_params(cfg.model_name)
                train = NativeBatchLoader(
                    [p for p, _ in train.samples], batch_size=cfg.store_batch_size,
                    out_size=cfg.image_size, mean=mean, std=std, seed=cfg.seed,
                    uint8_wire=(cfg.store_wire_dtype == "uint8"))
            val = ImageFolderDataset(cfg.dataset_val_path or cfg.dataset_path,
                                     transform=transform)
            return train, val
        if cfg.dataset_name == "cifar10":
            from vit_prisma_tpu_torch.dataloaders.cifar import load_cifar_10
            train, val, _ = load_cifar_10(cfg.dataset_path, image_size=cfg.image_size)
            return train, val
        ds = ImageFolderDataset(cfg.dataset_path, transform=transform)
        order = np.random.default_rng(cfg.seed).permutation(len(ds))
        n_train = int(0.8 * len(ds))
        train = [ds[int(i)] for i in order[:n_train]]
        val = [ds[int(i)] for i in order[n_train:]]
        return train, val

    @property
    def sae(self) -> SparseAutoencoder:
        return SparseAutoencoder(self.cfg, params=self.whole_state().params)

    def train_step(self, batch, target=None) -> StepMetrics:
        if target is not None:
            self.state, metrics = self._step(self.state, batch, self.cfg, target)
        else:
            self.state, metrics = self._step(self.state, batch, self.cfg)
        self._host_step += 1
        w = self.cfg.feature_sampling_window
        if w and (self._host_step % w) == 0:
            self.state = reset_sparsity_counters(self.state)
        return metrics

    def train_steps(self, batches, targets=None) -> StepMetrics:
        """K steps over ``batches`` (pair with ``store.next_batches(K)``);
        metrics stacked on the leading axis."""
        if targets is not None:
            self.state, metrics = self._multistep(self.state, batches, self.cfg, targets)
        else:
            self.state, metrics = self._multistep(self.state, batches, self.cfg)
        self._host_step += batches.shape[0]
        return metrics

    def train_cycles(self, n_cycles: int) -> StepMetrics:
        """``n_cycles`` steady-state cycles (:func:`make_fused_cycle`): each
        refills the buffer's half and trains on it, serving the same rows
        as ``train_steps(store.next_batches(K))``.  Returns the last cycle's
        stacked per-step metrics."""
        if n_cycles < 1:
            raise ValueError(f"train_cycles requires n_cycles >= 1 (got {n_cycles})")
        store = self.store
        if self._cycle is None:
            self._cycle = make_fused_cycle(self.cfg, store, self._multistep)
        half = store.buffer_tokens // 2
        _warn_unserved_half(store.ptr, half)
        K = half // self.cfg.train_batch_size
        metrics = None
        for _ in range(n_cycles):
            self.state, metrics = self._cycle(self.state, store.next_cycle_indices())
            self._host_step += K
        store.ptr = half  # the cycle served exactly the refilled half
        return metrics

    def load_state(self, state: SAETrainState) -> "VisionSAETrainer":
        """Swap in a (resumed) train state, this rank's shard under a mesh
        (``load_train_state_sharded(path, mesh)``), and re-sync the host
        step mirror."""
        self.state = state
        self._host_step = int(state.step.reshape(-1)[0])
        return self

    def log_metrics(self, metrics: StepMetrics, step: Optional[int] = None):
        """The metrics as floats, fetched in one transfer (and logged to
        wandb when it runs)."""
        host = torch.stack([getattr(metrics, k).float() for k in metrics._fields])
        vals = dict(zip(metrics._fields, host.tolist()))
        self._wandb_log(vals, step)
        return vals

    def _wandb_log(self, vals, step: Optional[int] = None):
        if self._wandb is not None:
            self._wandb.log(vals, step=self._host_step if step is None else step)

    def check_run_tolerance(self, metrics: StepMetrics) -> bool:
        """Bad-run abort conditions.  True if the run should be aborted."""
        if self.cfg.min_l0 is not None and float(metrics.l0) < self.cfg.min_l0:
            return True
        if (self.cfg.min_explained_variance is not None and
                float(metrics.explained_variance) < self.cfg.min_explained_variance):
            return True
        return False

    def _abort_message(self, metrics: StepMetrics, vals) -> Optional[str]:
        if self.check_run_tolerance(metrics):
            return f"SAE training below quality tolerance (metrics={vals}); aborting run"
        return None

    # -- in-training validation ------------------------------------------
    def _get_val_inputs(self):
        """One fixed labelled eval batch (images, labels) on the model's
        device, built at the first call: ``min(cfg.store_batch_size,
        len(eval_dataset))`` items."""
        if self._val_batch is None and self.eval_dataset is not None:
            images, labels = _build_val_batch(
                self.eval_dataset, min(self.cfg.store_batch_size, len(self.eval_dataset)))
            device = next(self.model.parameters()).device
            self._val_batch = images.to(device), labels.to(device)
        return self._val_batch

    def validate(self) -> Optional[Dict[str, float]]:
        """One validation pass over the fixed eval batch: the substitution
        CE (clean, SAE-substituted and zero-ablated losses and the CE
        recovered), L0 per image and the cosine similarity, from one eval
        step (``sae/evals.py``).  Returns the metrics (also logged to wandb
        under ``validation_metrics/``), or None without eval data or a
        model."""
        if self.model is None or self.eval_dataset is None:
            return None
        images, labels = self._get_val_inputs()
        class_emb = _class_emb_or_identity(self.model, images, self.class_embeddings)
        if self._val_step is None:
            from vit_prisma_tpu_torch.sae.evals import make_eval_step
            self._val_step = make_eval_step(self.model, self.sae)
        s = self._val_step(self.model, self.whole_state().params, images, labels, class_emb)
        host = torch.stack([s.loss.float(), s.recons_loss.float(), s.zero_abl_loss.float(),
                            s.l0_image.float().mean(), s.cos_sim.float()]).tolist()
        clean, recons, zero, l0, cos = host
        score = _substitution_score(clean, recons, zero)
        step = int(self.state.step)
        vals = {
            "validation_metrics/substitution_loss": recons,
            "validation_metrics/zero_ablation_loss": zero,
            "validation_metrics/model_loss": clean,
            "validation_metrics/substitution_score": score,
            "validation_metrics/L0": l0,
            "validation_metrics/cos_sim": cos,
        }
        self._wandb_log(vals, step)
        if self.cfg.verbose:
            print(f"val @ step {step}: CE-recovered {score:.3f} "
                  f"(clean {clean:.4f} recon {recons:.4f} zero {zero:.4f})")
        return vals

    def check_validation_tolerance(self, vals: Dict[str, float]) -> bool:
        """True if the run should abort on a CE-recovered regression."""
        if self.cfg.min_ce_recovered is None:
            return False
        score = vals.get("validation_metrics/substitution_score")
        return score is not None and score == score and score < self.cfg.min_ce_recovered

    def _validation_abort_message(self, vals) -> Optional[str]:
        if self.check_validation_tolerance(vals):
            return ("SAE validation CE-recovered below tolerance "
                    f"({vals['validation_metrics/substitution_score']:.3f} < "
                    f"{self.cfg.min_ce_recovered}); aborting run")
        return None

    # -- checkpoints -------------------------------------------------------
    def save_checkpoint(self, tag: Optional[str] = None) -> str:
        """Save the SAE (``save_model``'s ``.npz``) under
        ``cfg.checkpoint_path`` as ``{name}_{tag}`` (default tag
        ``n_tokens_{n}``), with its log10 feature sparsity beside it as
        ``{name}_{tag}_log_feature_sparsity.npy``, and upload both as wandb
        artifacts when ``cfg.wandb_checkpoint_artifacts`` and wandb runs.
        Returns the path without its suffix."""
        whole = self.whole_state()
        sae = SparseAutoencoder(self.cfg, params=whole.params)
        n = tag if tag is not None else f"n_tokens_{int(whole.n_training_tokens)}"
        path = os.path.join(self.cfg.checkpoint_path, f"{sae.get_name()}_{n}")
        if not self._is_writer:
            return path
        sae.save_model(path)
        sparsity = (whole.act_freq_scores
                    / torch.clamp(whole.n_frac_active_tokens, min=1.0)).cpu().numpy()
        np.save(path + "_log_feature_sparsity.npy", np.log10(sparsity + 1e-10))
        if self._wandb is not None and self.cfg.wandb_checkpoint_artifacts:
            self._upload_checkpoint_artifact(path)
        return path

    def _upload_checkpoint_artifact(self, path: str):
        """The SAE and its sparsity as wandb artifacts; a failed upload
        never stops training."""
        try:
            wandb = self._wandb
            run_id = wandb.run.id if wandb.run else "run"
            name = os.path.basename(path)
            model_art = wandb.Artifact(f"{name}_{run_id}", type="model",
                                       metadata=dict(self.cfg.to_dict()))
            model_art.add_file(path if os.path.exists(path) else path + ".npz")
            wandb.log_artifact(model_art, aliases=["latest", f"step_{int(self.state.step)}"])
            sparsity_art = wandb.Artifact(f"{name}_log_feature_sparsity_{run_id}",
                                          type="log_feature_sparsity",
                                          metadata=dict(self.cfg.to_dict()))
            sparsity_art.add_file(path + "_log_feature_sparsity.npy")
            wandb.log_artifact(sparsity_art)
        except Exception as e:
            if self.cfg.verbose:
                print(f"wandb artifact upload failed: {e}")

    def _save_at_threshold(self, n_tokens: int):
        self.save_checkpoint()

    def _save_final(self):
        self.save_checkpoint(tag="final")

    def _progress(self, step: int, n_tokens: int, vals, seconds: float) -> str:
        return (f"step {step} tokens {n_tokens} loss {vals['loss']:.4f} "
                f"L0 {vals['l0']:.1f} ev {vals['explained_variance']:.3f} "
                f"({n_tokens / seconds:.0f} tok/s)")

    def _result(self):
        return self.sae

    def run(self, max_steps: Optional[int] = None):
        """Train until ``cfg.total_training_tokens`` (or ``max_steps``),
        reading the metrics every ``cfg.wandb_log_frequency`` steps and
        validating at ``cfg.n_validation_runs`` even token thresholds and at
        the end, with the CE-recovered abort."""
        if self.store is None:
            raise ValueError("run() requires an activation store")
        total = self.cfg.total_training_tokens
        k = max(1, int(self.cfg.steps_per_dispatch))
        bs = self.cfg.train_batch_size
        freq = self.cfg.wandb_log_frequency
        thresholds = list(self.checkpoint_thresholds)
        val_thresholds = list(self.validation_thresholds)
        step = 0
        # one sync here, then host accounting only
        self._host_step = int(self.state.step.reshape(-1)[0])
        start_step = self._host_step
        n_tokens = int(self.state.n_training_tokens.reshape(-1)[0])
        t0 = time.time()
        while n_tokens < total:
            if max_steps is not None and step >= max_steps:
                break
            chunk = k if max_steps is None else min(k, max_steps - step)
            rows = self.store.next_batch() if chunk == 1 else self.store.next_batches(chunk)
            # a transcoder's rows carry the input and the target slots
            split = (rows[..., 0, :], rows[..., 1, :]) if self.cfg.is_transcoder else (rows,)
            metrics = (self.train_step if chunk == 1 else self.train_steps)(*split)
            for j in range(chunk):
                step += 1
                n_tokens += bs
                if step % freq:
                    continue
                m = metrics if chunk == 1 else StepMetrics(*(f[j] for f in metrics))
                vals = self.log_metrics(m, step=start_step + step)
                if self.cfg.verbose:
                    print(self._progress(start_step + step, n_tokens, vals, time.time() - t0))
                msg = self._abort_message(m, vals)
                if msg is not None:
                    raise RuntimeError(msg)
            # the JAX sweep saves before it validates, the single trainer after
            if self._checkpoint_first:
                self._checkpoints_due(thresholds, n_tokens)
            while val_thresholds and n_tokens >= val_thresholds[0]:
                val_thresholds.pop(0)
                vvals = self.validate()
                msg = None if vvals is None else self._validation_abort_message(vvals)
                if msg is not None:
                    raise RuntimeError(msg)
            if not self._checkpoint_first:
                self._checkpoints_due(thresholds, n_tokens)
        if self.cfg.n_validation_runs:
            self.validate()
        if self.cfg.n_checkpoints:
            self._save_final()
        return self._result()

    _checkpoint_first = False

    def _checkpoints_due(self, thresholds, n_tokens: int):
        while thresholds and n_tokens >= thresholds[0]:
            thresholds.pop(0)
            self._save_at_threshold(n_tokens)


class SAESweepTrainer(VisionSAETrainer):
    """The all-layer sweep: one shared harvest feeds L SAEs trained at once
    (``cfg.sweep_layers``), with the single trainer's cadence, window resets
    and per-layer bad-run abort.  ``run`` returns one SAE per layer."""

    _step = staticmethod(sae_sweep_train_step)
    _multistep = staticmethod(sae_sweep_train_multistep)
    _shard_builders = ("shard_sae_sweep_step", "shard_sae_sweep_multistep",
                       "sweep_state_shardings")

    def __init__(self, cfg: SAERunnerConfig, model=None, store=None,
                 generator: Optional[torch.Generator] = None, device=None,
                 mesh=None, eval_dataset=None, class_embeddings=None):
        if not cfg.sweep_layers:
            raise ValueError("cfg.sweep_layers must list the layers")
        self.layers = list(cfg.sweep_layers)
        super().__init__(cfg, model, store, generator, device, eval_dataset,
                         class_embeddings, mesh)
        self._host_step = int(self.state.step[0])

    def _init_state(self, generator, device) -> SAETrainState:
        cfg, store = self.cfg, self.store
        state = init_sweep_state(cfg, len(self.layers), generator, device)
        if store is not None and cfg.b_dec_init_method != "zeros":
            n = min(4096 * 8, cfg.tokens_per_buffer)
            b_decs = [initialize_b_dec(cfg, {}, store.peek_tokens(n, layer_slot=slot)
                                       .to(device))["b_dec"]
                      for slot in range(len(self.layers))]
            state = state._replace(params={**state.params, "b_dec": torch.stack(b_decs)})
        return state

    def train_step(self, batch) -> StepMetrics:
        """``batch``: ``[B, L, d_in]`` from a sweep store.  A sweep takes no
        target, as the JAX sweep trainer."""
        return super().train_step(batch)

    def train_steps(self, batches) -> StepMetrics:
        """K sweep steps over ``batches`` ``[K, B, L, d_in]``; metrics
        ``[K, L]``."""
        return super().train_steps(batches)

    @property
    def sae(self):
        raise AttributeError("a sweep trains one SAE per layer: use sae_for_layer(i)")

    def sae_for_layer(self, i: int, state: Optional[SAETrainState] = None) -> SparseAutoencoder:
        """Layer ``i``'s SAE, from ``state`` (a whole state; the trainer's,
        gathered under a mesh, when None)."""
        state = self.whole_state() if state is None else state
        layer_cfg = self.cfg.replace(sweep_layers=None, hook_point_layer=self.layers[i])
        return SparseAutoencoder(layer_cfg,
                                 params={k: v[i] for k, v in state.params.items()})

    def log_metrics(self, metrics: StepMetrics, step: Optional[int] = None) -> Dict[str, Any]:
        """Per-layer (``layer_{l}/{name}``) and mean metrics, fetched in one
        transfer (and logged to wandb when it runs)."""
        host = torch.stack([getattr(metrics, k).float() for k in metrics._fields]).cpu()
        vals: Dict[str, Any] = {}
        for k, row in zip(metrics._fields, host):
            vals[k] = float(row.mean())
            for layer, v in zip(self.layers, row.tolist()):
                vals[f"layer_{layer}/{k}"] = v
        self._wandb_log(vals, step)
        return vals

    def check_run_tolerance(self, metrics: StepMetrics) -> Optional[int]:
        """Index of the first layer below the bad-run tolerances, or None."""
        l0 = metrics.l0.tolist()
        ev = metrics.explained_variance.tolist()
        for i in range(len(self.layers)):
            if self.cfg.min_l0 is not None and l0[i] < self.cfg.min_l0:
                return i
            if (self.cfg.min_explained_variance is not None
                    and ev[i] < self.cfg.min_explained_variance):
                return i
        return None

    def _abort_message(self, metrics: StepMetrics, vals) -> Optional[str]:
        bad = self.check_run_tolerance(metrics)
        if bad is None:
            return None
        return (f"SAE sweep layer {self.layers[bad]} below quality tolerance "
                f"(metrics={vals}); aborting run")

    def _progress(self, step: int, n_tokens: int, vals, seconds: float) -> str:
        return (f"sweep step {step} tokens/layer {n_tokens} mean loss {vals['loss']:.4f} "
                f"mean L0 {vals['l0']:.1f} mean ev {vals['explained_variance']:.3f} "
                f"({n_tokens * len(self.layers) / seconds:.0f} SAE-tok/s)")

    def _result(self) -> List[SparseAutoencoder]:
        whole = self.whole_state()
        return [self.sae_for_layer(i, whole) for i in range(len(self.layers))]

    def save_checkpoints(self, out_dir: str) -> List[str]:
        """One ``.npz`` a layer (``save_model``) in ``out_dir``, each named
        by its SAE (``get_name``, which holds the layer).  Returns the
        paths without their suffix."""
        paths = []
        whole = self.whole_state()
        for i in range(len(self.layers)):
            sae = self.sae_for_layer(i, whole)
            path = os.path.join(out_dir, sae.get_name())
            if self._is_writer:
                sae.save_model(path)
            paths.append(path)
        return paths

    _checkpoint_first = True

    def _save_at_threshold(self, n_tokens: int):
        self.save_checkpoints(os.path.join(self.cfg.checkpoint_path,
                                           f"sweep_n_tokens_{n_tokens}"))

    def _save_final(self):
        self.save_checkpoints(os.path.join(self.cfg.checkpoint_path, "sweep_final"))

    def validate(self) -> Optional[Dict[str, float]]:
        """One validation pass over all sweep layers in one sweep eval step
        (``make_sweep_eval_step``: one clean forward, the layers' SAE
        forwards and their prefix-shared substituted and zero-ablated
        suffixes).  Returns per-layer (``layer_{l}/validation_metrics/...``)
        and mean CE-recovered metrics (also logged to wandb), or None
        without eval data or a model."""
        if self.model is None or self.eval_dataset is None:
            return None
        images, labels = self._get_val_inputs()
        class_emb = _class_emb_or_identity(self.model, images, self.class_embeddings)
        if self._val_step is None:
            from vit_prisma_tpu_torch.sae.evals import make_sweep_eval_step
            self._val_step = make_sweep_eval_step(self.model, self.cfg, self.layers)
        s = self._val_step(self.model, self.whole_state().params, images, labels, class_emb)
        host = torch.stack([s.loss.float(), s.recons_loss.float(), s.zero_abl_loss.float(),
                            s.l0_image.float().mean(-1), s.cos_sim.float()]).tolist()
        vals: Dict[str, float] = {}
        scores = []
        for i, layer in enumerate(self.layers):
            clean, recons, zero, l0, cos = (row[i] for row in host)
            score = _substitution_score(clean, recons, zero)
            scores.append(score)
            p = f"layer_{layer}/validation_metrics/"
            vals[p + "substitution_loss"] = recons
            vals[p + "zero_ablation_loss"] = zero
            vals[p + "model_loss"] = clean
            vals[p + "substitution_score"] = score
            vals[p + "L0"] = l0
            vals[p + "cos_sim"] = cos
        vals["validation_metrics/substitution_score"] = \
            float(np.nanmean(scores)) if scores else float("nan")
        self._wandb_log(vals)
        if self.cfg.verbose:
            print(f"sweep val @ step {self._host_step}: CE-recovered "
                  + " ".join(f"L{l}={sc:.3f}" for l, sc in zip(self.layers, scores)))
        return vals

    def check_validation_tolerance(self, vals: Dict[str, float]) -> Optional[int]:
        """Index of the first layer whose CE recovered is below
        ``cfg.min_ce_recovered``, or None."""
        if self.cfg.min_ce_recovered is None:
            return None
        for i, layer in enumerate(self.layers):
            score = vals.get(f"layer_{layer}/validation_metrics/substitution_score")
            if score is not None and score == score and score < self.cfg.min_ce_recovered:
                return i
        return None

    def _validation_abort_message(self, vals) -> Optional[str]:
        bad = self.check_validation_tolerance(vals)
        if bad is None:
            return None
        layer = self.layers[bad]
        return (f"SAE sweep layer {layer} CE-recovered "
                f"{vals[f'layer_{layer}/validation_metrics/substitution_score']:.3f} "
                f"below min_ce_recovered={self.cfg.min_ce_recovered}; aborting run")

    def evaluate(self, data_iter, class_embeddings=None, eval_cfg=None) -> List[Dict[str, Any]]:
        """The all-layer eval over a labelled dataset (``data_iter`` yields
        (images, labels) batches), one sweep eval step per batch
        (``sweep_process_dataset``).  Returns one metric dict per layer."""
        if self.model is None:
            raise ValueError("evaluate() requires a model")
        from vit_prisma_tpu_torch.sae.evals import EvalConfig, sweep_process_dataset
        if class_embeddings is None:
            batch = self._get_val_inputs()
            if batch is None:
                raise ValueError("evaluate() needs class_embeddings or an eval_dataset")
            class_embeddings = _class_emb_or_identity(self.model, batch[0],
                                                      self.class_embeddings)
        return sweep_process_dataset(self.model, self.cfg, self.layers,
                                     self.whole_state().params, data_iter, class_embeddings,
                                     eval_cfg or EvalConfig())


# ---------------------------------------------------------------------------
# The whole train state, for a resume equal to the uninterrupted run
# ---------------------------------------------------------------------------

_STATE_TYPES = (SAETrainState, ScaleByAdamState, ScaleByScheduleState)


def save_train_state(path: str, state: SAETrainState, cfg: SAERunnerConfig) -> str:
    """Save the whole train state (params, Adam moments in their dtype,
    counters) and the config, as ``torch.save`` of ``{"cfg": cfg.to_dict(),
    "state": state}`` with every tensor on the CPU, to ``path`` (``.pt``
    added when missing).  The format is the port's own: the JAX package
    pickles numpy leaves with optax's classes (``sae/convert.py`` maps such a
    state).  Returns the path."""
    if not path.endswith(".pt"):
        path = path + ".pt"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    host = _map_state(lambda t: t.detach().cpu(), state)
    torch.save({"cfg": cfg.to_dict(), "state": host}, path)
    return path


def load_train_state(path: str, device=None) -> Tuple[SAETrainState, SAERunnerConfig]:
    """Load :func:`save_train_state`'s file onto ``device`` (the CUDA card
    when None): ``(state, cfg)``.  It unpickles with ``weights_only=True``,
    the state's NamedTuples allowed by name."""
    if not path.endswith(".pt") and os.path.exists(path + ".pt"):
        path = path + ".pt"
    with torch.serialization.safe_globals(list(_STATE_TYPES)):
        blob = torch.load(path, map_location="cpu", weights_only=True)
    dev = resolve_device(device)
    state = _map_state(lambda t: t.to(dev), blob["state"])
    return state, SAERunnerConfig.from_dict(blob["cfg"])


def _flatten_state(state: SAETrainState) -> Dict[str, Any]:
    """The train state's leaves by dotted name (``params.W_enc``,
    ``opt_state.0.mu.W_enc``, ``opt_state.1.count``, ``step``, ...)."""
    adam, sched = state.opt_state
    flat = {f"params.{k}": v for k, v in state.params.items()}
    flat["opt_state.0.count"] = adam.count
    flat.update({f"opt_state.0.mu.{k}": v for k, v in adam.mu.items()})
    flat.update({f"opt_state.0.nu.{k}": v for k, v in adam.nu.items()})
    flat["opt_state.1.count"] = sched.count
    flat.update({f: getattr(state, f) for f in _COUNTERS})
    return flat


def _unflatten_state(flat: Dict[str, Any]) -> SAETrainState:
    pick = lambda prefix: {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}
    return SAETrainState(
        params=pick("params."),
        opt_state=(ScaleByAdamState(count=flat["opt_state.0.count"],
                                    mu=pick("opt_state.0.mu."), nu=pick("opt_state.0.nu.")),
                   ScaleByScheduleState(count=flat["opt_state.1.count"])),
        **{f: flat[f] for f in _COUNTERS})


def _state_plan(mesh, cfg: SAERunnerConfig, state: SAETrainState):
    from vit_prisma_tpu_torch.parallel.mesh import sae_state_shardings, sweep_state_shardings
    return (sweep_state_shardings if cfg.sweep_layers else sae_state_shardings)(mesh, state)


def _dtensor_placements(placement):
    from vit_prisma_tpu_torch.parallel.mesh import MESH_DIMS
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate() for _ in MESH_DIMS]
    for dim, name in enumerate(placement.spec):
        if name is not None:
            out[MESH_DIMS.index(name)] = Shard(dim)
    return out


def _as_dtensor(local: torch.Tensor, placement, shape) -> Any:
    from torch.distributed.tensor import DTensor
    shape = torch.Size(shape)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, placement.mesh, _dtensor_placements(placement),
                              run_check=False, shape=shape, stride=stride)


def _whole_shape(local: torch.Tensor, placement) -> Tuple[int, ...]:
    from vit_prisma_tpu_torch.parallel.mesh import axis
    shape = list(local.shape)
    for dim, name in enumerate(placement.spec):
        if name is not None:
            shape[dim] *= axis(placement.mesh, name).size
    return tuple(shape)


def save_train_state_sharded(path: str, state: SAETrainState, cfg: SAERunnerConfig,
                             mesh=None) -> str:
    """Save a train state with ``torch.distributed.checkpoint`` under
    ``{path}/state``, ``config.json`` beside it, as the JAX package lays out
    its Orbax checkpoint.  With ``mesh`` (a sharded trainer's), ``state`` is
    this rank's shard and each rank writes its own shards, with no gather
    (every rank calls this); without it ``state`` is whole.  The format is
    the port's own: the JAX package's Orbax directories are not read here
    (a JAX state crosses through ``sae/convert.py``).  Returns the path."""
    import json

    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp
    path = os.path.abspath(path)
    flat = _flatten_state(state)
    if mesh is not None:
        plan = _flatten_state(_state_plan(mesh, cfg, state))
        flat = {k: _as_dtensor(v.contiguous(), plan[k], _whole_shape(v, plan[k]))
                for k, v in flat.items()}
    elif dist.is_initialized() and dist.get_world_size() > 1:
        raise ValueError("a whole state saved from a multi-rank world needs mesh=")
    os.makedirs(path, exist_ok=True)
    dcp.save(flat, checkpoint_id=os.path.join(path, "state"),
             no_dist=not dist.is_initialized())
    if not dist.is_initialized() or dist.get_rank() == 0:
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(cfg.to_dict(), f)
    if dist.is_initialized():
        dist.barrier()
    return path


def load_train_state_sharded(path: str, mesh=None, device=None
                             ) -> Tuple[SAETrainState, SAERunnerConfig]:
    """Restore :func:`save_train_state_sharded`'s checkpoint: with ``mesh``
    straight into this rank's shard of that mesh's plan (any mesh: each
    rank reads only the pieces of its shards; every rank calls this),
    without it whole, on ``device`` (the CUDA card when None).  Returns
    ``(state, cfg)``."""
    import json

    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint import FileSystemReader
    path = os.path.abspath(path)
    with open(os.path.join(path, "config.json")) as f:
        cfg = SAERunnerConfig.from_dict(json.load(f))
    ckpt = os.path.join(path, "state")
    meta = FileSystemReader(ckpt).read_metadata().state_dict_metadata
    shapes = {k: (tuple(m.size), m.properties.dtype) for k, m in meta.items()}
    if mesh is None:
        dev = resolve_device(device)
        flat = {k: torch.empty(shape, dtype=dt) for k, (shape, dt) in shapes.items()}
        dcp.load(flat, checkpoint_id=ckpt, no_dist=not dist.is_initialized())
        return _unflatten_state({k: v.to(dev) for k, v in flat.items()}), cfg
    from vit_prisma_tpu_torch.parallel.mesh import shard_tensor
    dev = torch.device(mesh.device_type) if mesh.device_type == "cpu" else resolve_device(device)
    whole = _unflatten_state({k: torch.empty(shape, dtype=dt, device="meta")
                              for k, (shape, dt) in shapes.items()})
    plan = _flatten_state(_state_plan(mesh, cfg, whole))
    flat = {}
    for k, (shape, dt) in shapes.items():
        local_shape = shard_tensor(torch.empty(shape, device="meta"), plan[k]).shape
        flat[k] = _as_dtensor(torch.empty(local_shape, dtype=dt, device=dev), plan[k], shape)
    dcp.load(flat, checkpoint_id=ckpt)
    return _unflatten_state({k: v.to_local() for k, v in flat.items()}), cfg
