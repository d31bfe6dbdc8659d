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

The standard-ReLU single SAE takes this step in the JAX package too (its
fused SAE kernels B4-B6 serve only the all-layer sweep, not ported yet).

Not ported yet, and raising ``NotImplementedError``: validation and wandb
(ROADMAP queue A, item 8), checkpoints and ``mesh`` (item 15), the sweep
trainer and the fused cycle (item 9), transcoder targets (item 10).
"""

from __future__ import annotations

import time
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from vit_prisma_tpu_torch.configs.vit_config import DTYPE_MAP
from vit_prisma_tpu_torch.ops.opt_step import (
    ScaleByAdamState,
    ScaleByScheduleState,
    fused_clip_project_adam,
)
from vit_prisma_tpu_torch.sae.config import SAERunnerConfig
from vit_prisma_tpu_torch.sae.geometric_median import compute_geometric_median
from vit_prisma_tpu_torch.sae.sae import (
    SAEOutput,
    SparseAutoencoder,
    check_ported,
    init_sae_params,
    sae_forward,
    set_decoder_norm_to_unit_norm,
)
from vit_prisma_tpu_torch.sae.schedulers import get_schedule

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
    device (``device`` when the params are drawn here)."""
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


def loss_and_grads(params: Params, batch: torch.Tensor, cfg: SAERunnerConfig,
                   dead_neuron_mask: Optional[torch.Tensor] = None
                   ) -> Tuple[Params, SAEOutput]:
    """The step's forward and backward: gradients of ``sae_forward``'s loss
    with respect to ``params``, optionally computed in
    ``cfg.compute_dtype`` (the cast sits inside the graph, so float32
    params get float32 grads).  Returns (grads, detached output)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    compute_dt = cfg.compute_torch_dtype
    with torch.enable_grad():
        p, b = leaves, batch
        if compute_dt is not None:
            p = {k: v.to(compute_dt) for k, v in leaves.items()}
            b = batch.to(compute_dt)
        out = sae_forward(p, cfg, b, dead_neuron_mask=dead_neuron_mask, training=True)
        grads = torch.autograd.grad(out.loss, list(leaves.values()))
    return dict(zip(leaves, grads)), SAEOutput(*(
        None if t is None else t.detach() for t in out))


@torch.no_grad()
def _sae_train_step_impl(state: SAETrainState, batch: torch.Tensor,
                         cfg: SAERunnerConfig,
                         target: Optional[torch.Tensor] = None
                         ) -> Tuple[SAETrainState, StepMetrics]:
    if target is not None:
        raise NotImplementedError(
            "transcoder targets are not ported yet (ROADMAP queue A, item 10)")
    check_ported(cfg)
    schedule = make_schedule(cfg)

    # 1. decoder unit-norm projection before the forward
    params = set_decoder_norm_to_unit_norm(state.params)

    # 2. ghost mask from the fired counters (only the n_dead metric reads it
    # while ghost grads are not ported)
    ghost_mask = state.n_forward_passes_since_fired > cfg.dead_feature_window

    # 3. forward/backward
    grads, out = loss_and_grads(params, batch, cfg, ghost_mask)
    feature_acts, sae_out = out.feature_acts, out.sae_out

    # 4+5. clip -> W_dec projection -> Adam, one kernel-B7 pass per tensor
    adam_st, sched_st = state.opt_state
    lr = cfg.lr * schedule(sched_st.count)
    new_p, (new_adam, new_sched) = fused_clip_project_adam(
        _lift(params), _lift(grads),
        (adam_st._replace(mu=_lift(adam_st.mu), nu=_lift(adam_st.nu)), sched_st),
        lr=lr, b1=cfg.adam_b1, b2=cfg.adam_b2, max_grad_norm=cfg.max_grad_norm)
    new_adam = new_adam._replace(mu=_drop(new_adam.mu), nu=_drop(new_adam.nu))

    # 6. fired/act-freq counters.  The activations are >= 0 (ReLU or
    # tanh-ReLU), so the JAX package's |h| > 0 and h > 0 are one mask.
    active = feature_acts > 0
    did_fire = active.any(dim=-2)
    fired_counter = torch.where(did_fire, 0.0, state.n_forward_passes_since_fired + 1.0)
    act_freq = state.act_freq_scores + active.sum(dim=0, dtype=torch.float32)
    n_rows = batch.shape[0]

    # metrics
    l0 = active.sum(dim=-1, dtype=torch.float32).mean()
    tgt = batch.to(cfg.torch_dtype)
    resid_var = torch.square(tgt - sae_out).sum(-1)
    total_var = torch.square(tgt - tgt.mean(0)).sum(-1)
    explained_variance = (1 - resid_var / total_var).mean()

    new_state = SAETrainState(
        params=_drop(new_p),
        opt_state=(new_adam, new_sched),
        act_freq_scores=act_freq,
        n_forward_passes_since_fired=fired_counter,
        n_frac_active_tokens=state.n_frac_active_tokens + n_rows,
        step=state.step + 1,
        n_training_tokens=state.n_training_tokens + n_rows)
    metrics = StepMetrics(
        loss=out.loss, mse_loss=out.mse_loss,
        l1_loss=out.l1_loss, ghost_grad_loss=out.ghost_grad_loss,
        aux_reconstruction_loss=out.aux_reconstruction_loss,
        l0=l0, explained_variance=explained_variance,
        n_dead_features=ghost_mask.sum(), lr_multiplier=schedule(state.step))
    return new_state, metrics


def sae_train_step(state: SAETrainState, batch: torch.Tensor,
                   cfg: SAERunnerConfig,
                   target: Optional[torch.Tensor] = None
                   ) -> Tuple[SAETrainState, StepMetrics]:
    """One training step on ``batch`` [train_batch_size, d_in].  Returns a
    new state; ``state`` is left as it was."""
    return _sae_train_step_impl(state, batch, cfg, target)


def _apply_window_reset(state: SAETrainState,
                        cfg: SAERunnerConfig) -> SAETrainState:
    """Zero the act-freq counters when the post-step count hits a
    ``feature_sampling_window`` multiple, on the device (the multi-step
    path's form of :func:`reset_sparsity_counters`)."""
    w = cfg.feature_sampling_window
    if not w:
        return state
    keep = 1.0 - ((state.step % w) == 0).float()
    return state._replace(act_freq_scores=state.act_freq_scores * keep,
                          n_frac_active_tokens=state.n_frac_active_tokens * keep)


def sae_train_multistep(state: SAETrainState, batches: torch.Tensor,
                        cfg: SAERunnerConfig,
                        targets: Optional[torch.Tensor] = None
                        ) -> Tuple[SAETrainState, StepMetrics]:
    """K steps over ``batches`` [K, B, d_in] with the window resets applied
    after each, as the JAX package's ``lax.scan``; metrics stacked [K]."""
    if targets is not None:
        raise NotImplementedError(
            "transcoder targets are not ported yet (ROADMAP queue A, item 10)")
    per_step = []
    for b in batches:
        state, m = sae_train_step(state, b, cfg)
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


class VisionSAETrainer:
    """Streams token rows from an activation store into the train step,
    with the JAX trainer's log cadence, sparsity-window resets and bad-run
    abort.  Parameters are drawn from ``generator`` (seeded with
    ``cfg.seed`` when None) and live on ``device`` (the store's when
    None)."""

    def __init__(self, cfg: SAERunnerConfig, model=None, store=None,
                 generator: Optional[torch.Generator] = None, device=None,
                 eval_dataset=None, class_embeddings=None, mesh=None):
        check_ported(cfg)
        if mesh is not None:
            raise NotImplementedError(
                "a sharded trainer (mesh=) is not ported yet (ROADMAP queue A, item 15)")
        if cfg.n_validation_runs or eval_dataset is not None or class_embeddings is not None:
            raise NotImplementedError(
                "in-training validation is not ported yet (ROADMAP queue A, item 8)")
        if cfg.n_checkpoints:
            raise NotImplementedError(
                "checkpoints are not ported yet (ROADMAP queue A, item 15)")
        if cfg.log_to_wandb:
            raise NotImplementedError(
                "wandb logging is not ported yet (ROADMAP queue A, item 8)")
        self.cfg = cfg
        self.model = model
        self.store = store
        if device is None:
            device = store.device if store is not None else "cpu"
        params = init_sae_params(cfg, generator, device)
        if store is not None and cfg.b_dec_init_method != "zeros":
            sample = store.peek_tokens(min(4096 * 8, cfg.tokens_per_buffer))
            params = initialize_b_dec(cfg, params, sample.to(device))
        self.state = init_train_state(cfg, params=params)
        # Host mirror of the device step counter: the cadence checks read it
        # instead of the device value, so the loop never waits for the
        # device except to log.  load_state() keeps it in sync.
        self._host_step = 0

    @property
    def sae(self) -> SparseAutoencoder:
        return SparseAutoencoder(self.cfg, params=self.state.params)

    def train_step(self, batch, target=None) -> StepMetrics:
        self.state, metrics = sae_train_step(self.state, batch, self.cfg, target)
        self._host_step += 1
        w = self.cfg.feature_sampling_window
        if w and (self._host_step % w) == 0:
            self.state = reset_sparsity_counters(self.state)
        return metrics

    def train_steps(self, batches, targets=None) -> StepMetrics:
        """K steps over ``batches`` [K, B, d_in] (pair with
        ``store.next_batches(K)``); metrics stacked on the leading axis."""
        self.state, metrics = sae_train_multistep(self.state, batches, self.cfg,
                                                  targets)
        self._host_step += batches.shape[0]
        return metrics

    def load_state(self, state: SAETrainState) -> "VisionSAETrainer":
        """Swap in a (resumed) train state and re-sync the host step mirror."""
        self.state = state
        self._host_step = int(state.step)
        return self

    def log_metrics(self, metrics: StepMetrics, step: Optional[int] = None):
        """The metrics as floats, fetched in one transfer."""
        host = torch.stack([getattr(metrics, k).float() for k in metrics._fields])
        return dict(zip(metrics._fields, host.tolist()))

    def check_run_tolerance(self, metrics: StepMetrics) -> bool:
        """Bad-run abort conditions.  True if the run should be aborted."""
        if self.cfg.min_l0 is not None and float(metrics.l0) < self.cfg.min_l0:
            return True
        if (self.cfg.min_explained_variance is not None and
                float(metrics.explained_variance) < self.cfg.min_explained_variance):
            return True
        return False

    def run(self, max_steps: Optional[int] = None) -> SparseAutoencoder:
        """Train until ``cfg.total_training_tokens`` (or ``max_steps``),
        reading the metrics every ``cfg.wandb_log_frequency`` steps."""
        if self.store is None:
            raise ValueError("run() requires an activation store")
        total = self.cfg.total_training_tokens
        k = max(1, int(self.cfg.steps_per_dispatch))
        bs = self.cfg.train_batch_size
        freq = self.cfg.wandb_log_frequency
        step = 0
        # one sync here, then host accounting only
        self._host_step = int(self.state.step)
        start_step = self._host_step
        n_tokens = int(self.state.n_training_tokens)
        t0 = time.time()
        while n_tokens < total:
            if max_steps is not None and step >= max_steps:
                break
            chunk = k if max_steps is None else min(k, max_steps - step)
            if chunk == 1:
                metrics = self.train_step(self.store.next_batch())
            else:
                metrics = self.train_steps(self.store.next_batches(chunk))
            for j in range(chunk):
                step += 1
                n_tokens += bs
                if step % freq:
                    continue
                m = metrics if chunk == 1 else StepMetrics(*(f[j] for f in metrics))
                vals = self.log_metrics(m, step=start_step + step)
                if self.cfg.verbose:
                    print(f"step {start_step + step} tokens {n_tokens} "
                          f"loss {vals['loss']:.4f} L0 {vals['l0']:.1f} "
                          f"ev {vals['explained_variance']:.3f} "
                          f"({n_tokens / (time.time() - t0):.0f} tok/s)")
                if self.check_run_tolerance(m):
                    raise RuntimeError(
                        "SAE training below quality tolerance "
                        f"(metrics={vals}); aborting run")
        return self.sae


class SAESweepTrainer:
    """The all-layer sweep trainer; not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "the all-layer sweep is not ported yet (ROADMAP queue A, item 9)")


def make_fused_cycle(*args, **kwargs):
    """The fused harvest-mix-train cycle; not ported yet."""
    raise NotImplementedError(
        "make_fused_cycle is not ported yet (ROADMAP queue A, item 9)")
