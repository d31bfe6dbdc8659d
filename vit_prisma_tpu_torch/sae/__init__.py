"""Sparse-autoencoder training and evaluation (PyTorch port of
``vit_prisma_tpu.sae``): the standard, gated and TopK SAEs and transcoders,
their activation store, train step and trainer, for one SAE or the
all-layer sweep, the eval suite, and the import tools (reference and legacy
checkpoints, the pretrained registry, local hub paths)."""

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
    save_train_state, load_train_state,
)
from vit_prisma_tpu_torch.sae.evals import (
    EvalConfig, evaluate, process_dataset, find_top_activations,
    make_replacement_hook, zero_ablate_hook,
)
from vit_prisma_tpu_torch.sae.neuron_evals import (
    SparsecoderEval, eval_feature_list, find_top_neuron_activations,
)
from vit_prisma_tpu_torch.sae.checkpoint_import import (
    load_reference_sae_checkpoint, load_legacy_saelens_v2,
)
from vit_prisma_tpu_torch.sae.hub import (
    upload_to_huggingface, download_sae_from_huggingface,
    load_remote_sae_and_model,
)
from vit_prisma_tpu_torch.sae.pretrained import (
    get_pretrained_sae_info, list_pretrained_saes, load_pretrained_sae,
)
