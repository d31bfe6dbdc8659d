"""Sparse-autoencoder training (PyTorch port of ``vit_prisma_tpu.sae``):
the standard SAE, its activation store, train step and trainer, for one SAE
or the all-layer sweep."""

from vit_prisma_tpu_torch.sae.config import SAERunnerConfig
from vit_prisma_tpu_torch.sae.convert import (
    sae_params_from_jax, train_state_from_jax, train_state_to_numpy,
)
from vit_prisma_tpu_torch.sae.sae import (
    SparseAutoencoder, SAEOutput, sae_forward, init_sae_params, build_sae,
    set_decoder_norm_to_unit_norm, remove_gradient_parallel_to_decoder_directions,
)
from vit_prisma_tpu_torch.sae.store import VisionActivationsStore, CachedActivationsStore
from vit_prisma_tpu_torch.sae.train import (
    VisionSAETrainer, SAETrainState, StepMetrics, sae_train_step,
    sae_train_multistep, init_train_state, initialize_b_dec,
    reset_sparsity_counters, make_fused_cycle, SAESweepTrainer,
    sae_sweep_train_step, sae_sweep_train_multistep, init_sweep_state,
)
