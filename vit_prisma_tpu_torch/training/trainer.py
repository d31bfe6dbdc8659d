"""Supervised ViT trainer (PyTorch port of ``vit_prisma_tpu/training/trainer.py``).

AdamW or SGD on cross-entropy or MSE, the two warm-up schedules, periodic
train/val metrics, pickled checkpoints with resume, ``PrismaCallback`` hooks
and early stopping.  A train step is the hooked forward (:func:`vit_forward`,
with train-mode dropout when the config asks for it) recorded by autograd,
``loss.backward()`` through the attention kernels (B1 forward, B2 backward on
the card) and cuBLAS GEMMs, and one optimizer step.

PyTorch stands in for optax: ``torch.optim.AdamW(eps=1e-8,
weight_decay=wd)`` with a ``LambdaLR`` on the schedule applies ``p <- p -
lr(t) (m̂ / (sqrt(v̂) + eps) + wd p)`` counting t from 0, as ``optax.adamw``
does, and ``torch.optim.SGD`` stands for ``optax.sgd``.  As in the JAX
package, a step clips no gradient: its step reads ``max_grad_norm`` from
the model's config, which has no such field, so
``TrainerConfig.max_grad_norm`` is never applied.  The dropout masks are
drawn from a ``torch.Generator`` seeded from (seed, step), not from
``jax.random``.
"""

from __future__ import annotations

import math
import os
import pickle
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from vit_prisma_tpu_torch.configs.vit_config import ViTConfig
from vit_prisma_tpu_torch.models.vit import HookedViT, vit_forward


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def cross_entropy_loss(logits, labels):
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels[:, None]).mean()


def mse_loss(preds, targets):
    return torch.mean(torch.square(preds - targets))


LOSS_FUNCTIONS = {"CrossEntropy": cross_entropy_loss, "MSE": mse_loss}


# ---------------------------------------------------------------------------
# Schedulers: the learning rate's factor at step t, counting from 0
# ---------------------------------------------------------------------------

def warmup_then_step_schedule(warmup_steps: int, step_size: int, gamma: float):
    """WarmupThenStepLR: linear warmup then StepLR decay."""
    def sched(step):
        if step < warmup_steps:
            return min((step + 1) / max(warmup_steps, 1), 1.0)
        return gamma ** ((step - warmup_steps) // max(step_size, 1))
    return sched


def warmup_cosine_schedule(warmup_steps: int, total_steps: int):
    """WarmupCosineAnnealingLR."""
    def sched(step):
        if step < warmup_steps:
            return min((step + 1) / max(warmup_steps, 1), 1.0)
        progress = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        return 0.5 * (1 + math.cos(math.pi * min(max(progress, 0.0), 1.0)))
    return sched


# ---------------------------------------------------------------------------
# Callbacks & early stopping
# ---------------------------------------------------------------------------

class PrismaCallback:
    def on_step_end(self, step: int, model, metrics: Dict[str, float]):
        pass

    def on_epoch_end(self, epoch: int, model, metrics: Dict[str, float]):
        pass


class EarlyStopping:
    def __init__(self, patience: int = 2, min_delta: float = 0.0,
                 verbose: bool = False):
        self.patience = patience
        self.min_delta = min_delta
        self.verbose = verbose
        self.best = -float("inf")
        self.counter = 0
        self.early_stop = False

    def __call__(self, metric: float):
        if metric > self.best + self.min_delta:
            self.best = metric
            self.counter = 0
        else:
            self.counter += 1
            if self.counter >= self.patience:
                self.early_stop = True
        return self.early_stop


# ---------------------------------------------------------------------------
# Train state and step
# ---------------------------------------------------------------------------

@dataclass
class TrainState:
    """The JAX package's (params, opt_state, step), held the PyTorch way:
    the model, whose parameters train in place; the optimizer with its
    moments and the ``LambdaLR`` that sets its learning rate; the number of
    steps taken."""
    params: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    step: int = 0


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def make_train_step(cfg: ViTConfig, loss_name: str, seed: int = 0):
    """``train_step(state, images, labels) -> (state, loss)``: one forward
    and backward and one optimizer step, in place.  With a dropout rate in
    ``cfg``, the masks come from a generator seeded from ``seed`` and the
    step count."""
    loss_fn_inner = LOSS_FUNCTIONS[loss_name]
    use_dropout = cfg.attn_dropout_rate > 0 or cfg.mlp_dropout_rate > 0

    def train_step(state: TrainState, images, labels):
        model = state.params
        drop = None
        if use_dropout:
            drop = torch.Generator(device=_device(model)).manual_seed(
                (seed << 32) + state.step)
        with torch.inference_mode(False), torch.enable_grad():
            logits = vit_forward(model, cfg, images, dropout_key=drop)
            loss = loss_fn_inner(logits, labels)
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return state, loss.detach()

    return train_step


def make_eval_fns(cfg: ViTConfig, loss_name: str):
    """``batch_loss(params, images, labels)`` and ``batch_correct(...)``,
    eval-mode forwards in inference mode."""
    loss_fn_inner = LOSS_FUNCTIONS[loss_name]

    @torch.inference_mode()
    def batch_loss(params, images, labels):
        return loss_fn_inner(vit_forward(params, cfg, images), labels)

    @torch.inference_mode()
    def batch_correct(params, images, labels):
        return (vit_forward(params, cfg, images).argmax(-1) == labels).sum()

    return batch_loss, batch_correct


def _to_device(model, images, labels):
    dev = _device(model)
    return torch.as_tensor(images, device=dev), torch.as_tensor(labels, device=dev)


def calculate_loss(batch_loss, params, data_iter) -> float:
    tot, n = 0.0, 0
    for images, labels in data_iter:
        tot += float(batch_loss(params, *_to_device(params, images, labels))) * len(labels)
        n += len(labels)
    return tot / max(n, 1)


def calculate_accuracy(batch_correct, params, data_iter) -> float:
    correct, n = 0.0, 0
    for images, labels in data_iter:
        correct += float(batch_correct(params, *_to_device(params, images, labels)))
        n += len(labels)
    return correct / max(n, 1)


# ---------------------------------------------------------------------------
# Config knobs carried on ViTConfig in the reference; grouped here.
# ---------------------------------------------------------------------------

@dataclass
class TrainerConfig:
    optimizer_name: str = "AdamW"   # 'AdamW' | 'SGD'
    lr: float = 3e-4
    weight_decay: float = 0.01
    loss_fn_name: str = "CrossEntropy"
    batch_size: int = 512
    warmup_steps: int = 10
    scheduler_step: int = 200
    scheduler_gamma: float = 0.8
    scheduler_type: str = "WarmupThenStep"  # | 'CosineAnnealing'
    early_stopping: bool = False
    early_stopping_patience: int = 2
    num_epochs: int = 50
    max_grad_norm: Optional[float] = 1.0  # not applied, as in the JAX package
    max_steps: Optional[int] = None
    log_frequency: int = 100
    save_checkpoints: bool = False
    save_cp_frequency: int = 5
    parent_dir: str = ""
    save_dir: str = "Checkpoints"
    seed: int = 666
    use_wandb: bool = False
    wandb_project_name: Optional[str] = None


def _make_optimizer(tcfg: TrainerConfig, total_steps: int, params):
    """The optimizer over ``params`` and the ``LambdaLR`` that scales its
    learning rate by the schedule at each step."""
    if tcfg.scheduler_type == "WarmupThenStep":
        sched = warmup_then_step_schedule(tcfg.warmup_steps,
                                          tcfg.scheduler_step,
                                          tcfg.scheduler_gamma)
    elif tcfg.scheduler_type == "CosineAnnealing":
        sched = warmup_cosine_schedule(tcfg.warmup_steps, total_steps)
    else:
        raise ValueError(f"Scheduler type {tcfg.scheduler_type} not supported")
    if tcfg.optimizer_name == "AdamW":
        opt = torch.optim.AdamW(params, lr=tcfg.lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=tcfg.weight_decay)
    elif tcfg.optimizer_name == "SGD":
        opt = torch.optim.SGD(params, lr=tcfg.lr)
    else:
        raise ValueError(f"Unknown optimizer {tcfg.optimizer_name}")
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, sched)


def _batches(dataset, batch_size: int, rng: np.random.Generator,
             shuffle: bool = True):
    n = len(dataset)
    order = rng.permutation(n) if shuffle else np.arange(n)
    for i in range(0, n - batch_size + 1, batch_size):
        idx = order[i:i + batch_size]
        items = [dataset[int(j)] for j in idx]
        images = np.stack([np.asarray(it[0]) for it in items])
        labels = np.asarray([it[1] for it in items])
        yield images, labels


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save_checkpoint(path: str, state: TrainState, epoch: int):
    """Pickle ``params`` (numpy; bfloat16 as float32, exactly), ``opt_state``
    (the optimizer's and the schedule's state dicts), ``step`` and
    ``epoch``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    params = {k: (v.float() if v.dtype == torch.bfloat16 else v).detach().cpu().numpy()
              for k, v in state.params.state_dict().items()}
    opt_state = {"optimizer": _to_cpu(state.optimizer.state_dict()),
                 "scheduler": state.scheduler.state_dict()}
    with open(path, "wb") as f:
        pickle.dump({"params": params, "opt_state": opt_state,
                     "step": int(state.step), "epoch": epoch}, f)


def load_checkpoint(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def train(model_function: Callable[[ViTConfig], HookedViT], cfg: ViTConfig,
          train_dataset, val_dataset=None, tcfg: Optional[TrainerConfig] = None,
          checkpoint_path: Optional[str] = None,
          callbacks: Optional[List[PrismaCallback]] = None) -> HookedViT:
    """Supervised training loop.  ``model_function(cfg)`` builds the model
    on the device training runs on; datasets are indexable ``(image,
    label)`` items, batched in the JAX package's order."""
    tcfg = tcfg or TrainerConfig()
    callbacks = callbacks or []
    rng = np.random.default_rng(tcfg.seed)

    if val_dataset is None:
        n_val = max(1, len(train_dataset) // 5)
        idx = rng.permutation(len(train_dataset))
        val_dataset = [train_dataset[int(i)] for i in idx[:n_val]]
        train_dataset = [train_dataset[int(i)] for i in idx[n_val:]]

    model = model_function(cfg)
    batch_size = (len(train_dataset) if tcfg.batch_size == -1
                  else tcfg.batch_size)
    total_steps = max(1, tcfg.num_epochs * (len(train_dataset) // batch_size))
    optimizer, scheduler = _make_optimizer(tcfg, total_steps, model.parameters())
    state = TrainState(model, optimizer, scheduler, 0)
    start_epoch = 1
    if checkpoint_path and os.path.exists(checkpoint_path):
        ckpt = load_checkpoint(checkpoint_path)
        model.load_state_dict(ckpt["params"])
        optimizer.load_state_dict(ckpt["opt_state"]["optimizer"])
        scheduler.load_state_dict(ckpt["opt_state"]["scheduler"])
        state.step = ckpt["step"]
        start_epoch = ckpt["epoch"] + 1

    step_fn = make_train_step(cfg, tcfg.loss_fn_name, seed=tcfg.seed)
    batch_loss, batch_correct = make_eval_fns(cfg, tcfg.loss_fn_name)
    early = EarlyStopping(tcfg.early_stopping_patience) \
        if tcfg.early_stopping else None

    wandb_run = None
    if tcfg.use_wandb:
        try:
            import wandb
            wandb_run = wandb.init(project=tcfg.wandb_project_name)
        except Exception:
            wandb_run = None

    steps, num_samples = state.step, 0
    stop = False
    metrics: Dict[str, float] = {}
    for epoch in range(start_epoch, tcfg.num_epochs + 1):
        for images, labels in _batches(train_dataset, batch_size, rng):
            if steps % tcfg.log_frequency == 0:
                metrics = {
                    "train_loss": calculate_loss(
                        batch_loss, model,
                        _batches(train_dataset, batch_size, rng, shuffle=False)),
                    "test_loss": calculate_loss(
                        batch_loss, model,
                        _batches(val_dataset, batch_size, rng, shuffle=False)),
                }
                if tcfg.loss_fn_name != "MSE":
                    metrics["train_acc"] = calculate_accuracy(
                        batch_correct, model,
                        _batches(train_dataset, batch_size, rng, shuffle=False))
                    metrics["test_acc"] = calculate_accuracy(
                        batch_correct, model,
                        _batches(val_dataset, batch_size, rng, shuffle=False))
                if wandb_run is not None:
                    wandb_run.log(metrics, step=num_samples)

            state, loss = step_fn(state, *_to_device(model, images, labels))
            steps += 1
            num_samples += len(labels)

            if tcfg.save_checkpoints and steps % tcfg.save_cp_frequency == 0:
                save_checkpoint(
                    os.path.join(tcfg.parent_dir, tcfg.save_dir,
                                 f"model_{num_samples}.ckpt"), state, epoch)
            for cb in callbacks:
                cb.on_step_end(steps, model, metrics)
            if tcfg.max_steps and steps >= tcfg.max_steps:
                stop = True
                break
        for cb in callbacks:
            cb.on_epoch_end(epoch, model, metrics)
        if early is not None and "train_acc" in metrics:
            if early(metrics["train_acc"]):
                break
        if stop:
            break

    if wandb_run is not None:
        wandb_run.finish()
    return model
