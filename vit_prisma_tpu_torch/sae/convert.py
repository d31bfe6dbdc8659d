"""SAE parameters and train states from the JAX package into the port.

A JAX ``SAETrainState`` with numpy leaves
(``jax.tree.map(np.asarray, state)``) keeps optax's
``(ScaleByAdamState(count, mu, nu), ScaleByScheduleState(count))`` as its
``opt_state``; the port keeps the same layout with its own NamedTuples, so
the mapping is leaf for leaf.  :func:`train_state_to_numpy` flattens a port
state into named numpy arrays, for comparisons.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from vit_prisma_tpu_torch.models.loading.state_dict import _tensor
from vit_prisma_tpu_torch.ops.opt_step import ScaleByAdamState, ScaleByScheduleState
from vit_prisma_tpu_torch.sae.train import SAETrainState


def sae_params_from_jax(np_params, device=None) -> Dict[str, torch.Tensor]:
    """``{name: array}`` (numpy, ml_dtypes bfloat16 allowed) -> tensors."""
    return {k: _tensor(v).to(device) for k, v in np_params.items()}


def train_state_from_jax(np_state, device=None) -> SAETrainState:
    """A JAX ``SAETrainState`` with numpy leaves -> the port's state."""
    adam, sched = np_state.opt_state[0], np_state.opt_state[1]
    t = lambda a, dtype=None: _tensor(a).to(device=device, dtype=dtype)
    return SAETrainState(
        params=sae_params_from_jax(np_state.params, device),
        opt_state=(ScaleByAdamState(count=t(adam.count, torch.int32),
                                    mu=sae_params_from_jax(adam.mu, device),
                                    nu=sae_params_from_jax(adam.nu, device)),
                   ScaleByScheduleState(count=t(sched.count, torch.int32))),
        act_freq_scores=t(np_state.act_freq_scores),
        n_forward_passes_since_fired=t(np_state.n_forward_passes_since_fired),
        n_frac_active_tokens=t(np_state.n_frac_active_tokens),
        step=t(np_state.step, torch.int32),
        n_training_tokens=t(np_state.n_training_tokens, torch.int64))


def train_state_to_numpy(state: SAETrainState) -> Dict[str, np.ndarray]:
    """Flat ``{name: float32 or integer numpy array}`` view of a port state:
    ``params/<k>``, ``mu/<k>``, ``nu/<k>``, ``adam_count``,
    ``schedule_count`` and the counters by their field names."""
    np_ = lambda x: (x.detach().float() if x.dtype == torch.bfloat16
                     else x.detach()).cpu().numpy()
    adam, sched = state.opt_state
    flat = {f"params/{k}": np_(v) for k, v in state.params.items()}
    flat.update({f"mu/{k}": np_(v) for k, v in adam.mu.items()})
    flat.update({f"nu/{k}": np_(v) for k, v in adam.nu.items()})
    flat.update(adam_count=np_(adam.count), schedule_count=np_(sched.count))
    for field in ("act_freq_scores", "n_forward_passes_since_fired",
                  "n_frac_active_tokens", "step", "n_training_tokens"):
        flat[field] = np_(getattr(state, field))
    return flat
