"""SAE runner configuration (PyTorch port of ``vit_prisma_tpu/sae/config.py``).

:class:`SAERunnerConfig` has the JAX dataclass's fields, defaults and derived
properties, so one config dict describes the same run in both packages.
Fields that choose a JAX or TPU code path keep their names here:
``fused_sae_step`` and ``fused_store_acts`` (the fused SAE kernels B4-B6 run
on the all-layer sweep; ``fused_store_acts=False`` picks the remat backward
B5, ``True`` or ``None`` the stored-acts backward B6), ``fused_opt_kernel``
(the port's fused optimizer pass always runs kernel B7 on the card), and
``store_wire_dtype`` (see ``sae/store.py``).  ``dtype`` and ``compute_dtype``
are string names, mapped to torch dtypes by :attr:`torch_dtype` and
:attr:`compute_torch_dtype`.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

from vit_prisma_tpu_torch.configs.vit_config import DTYPE_MAP


@dataclass(frozen=True)
class SAERunnerConfig:
    # -- data-generating model + hook target -----------------------------
    model_class_name: str = "HookedViT"
    model_name: str = "open-clip:laion/CLIP-ViT-B-32-DataComp.XL-s13B-b90K"
    hook_point_layer: int = 9
    layer_subtype: str = "hook_resid_post"
    hook_point_head_index: Optional[int] = None
    context_size: int = 50
    use_cached_activations: bool = False
    cached_activations_path: Optional[str] = None
    use_patches_only: bool = False
    cls_token_only: bool = False
    image_size: int = 224
    sweep_layers: Optional[Tuple[int, ...]] = None

    # -- SAE architecture -------------------------------------------------
    architecture: str = "standard"  # 'standard' | 'gated' | 'transcoder'
    d_in: int = 768
    expansion_factor: int = 16
    b_dec_init_method: str = "geometric_median"
    initialization_method: str = "independent"  # | 'encoder_transpose_decoder'
    activation_fn_str: str = "relu"  # 'relu' | 'tanh-relu' | 'topk'
    activation_fn_kwargs: Tuple[Tuple[str, Any], ...] = ()
    fused_topk: bool = True
    topk_use_approx: bool = False
    normalize_activations: str = "none"  # | 'layer_norm' | 'constant_norm_rescale'

    # -- transcoder --------------------------------------------------------
    is_transcoder: bool = False
    transcoder_with_skip_connection: bool = True
    out_hook_point_layer: int = 9
    layer_out_subtype: str = "hook_mlp_out"
    d_out: int = 768

    # -- numerics ----------------------------------------------------------
    dtype: str = "float32"
    # Forward/backward compute dtype of the train step (None: ``dtype``);
    # master params, Adam moments and loss reductions stay in ``dtype``.
    compute_dtype: Optional[str] = None
    fused_sae_step: bool = True
    fused_store_acts: Optional[bool] = None
    # Clip -> W_dec projection -> Adam as one pass per tensor (kernel B7).
    fused_optimizer: bool = True
    fused_opt_kernel: bool = True
    # Storage dtype of the Adam moments ('float32' | 'bfloat16').
    adam_dtype: str = "float32"
    seed: int = 42

    # -- store -------------------------------------------------------------
    n_batches_in_buffer: int = 20
    store_batch_size: int = 32
    num_workers: int = 0
    buffer_tokens_override: Optional[int] = None
    store_wire_dtype: str = "auto"

    # -- training ----------------------------------------------------------
    num_epochs: int = 1
    total_training_images: Optional[int] = None  # default 1.3M * epochs
    l1_coefficient: float = 0.0002
    lp_norm: float = 1.0
    lr: float = 0.001
    lr_scheduler_name: str = "cosineannealingwarmup"
    lr_warm_up_steps: int = 500
    train_batch_size: int = 4096
    steps_per_dispatch: int = 1
    max_grad_norm: Optional[float] = 1.0
    adam_b1: float = 0.9
    adam_b2: float = 0.999

    # -- resampling / dead features ---------------------------------------
    use_ghost_grads: bool = False
    feature_sampling_window: int = 1000
    dead_feature_window: int = 5000
    dead_feature_threshold: float = 1e-8

    # -- run tolerance -----------------------------------------------------
    min_l0: Optional[float] = None
    min_explained_variance: Optional[float] = None
    min_ce_recovered: Optional[float] = None

    # -- dataset convenience -----------------------------------------------
    dataset_name: str = "imagenet1k"  # | 'cifar10' | <folder>
    dataset_path: str = ""
    dataset_train_path: Optional[str] = None
    dataset_val_path: Optional[str] = None
    use_native_loader: bool = False

    # -- logging / checkpointing ------------------------------------------
    verbose: bool = False
    log_to_wandb: bool = False
    wandb_project: str = "vit_prisma_tpu_sae"
    wandb_entity: Optional[str] = None
    wandb_log_frequency: int = 10
    n_validation_runs: int = 0
    n_checkpoints: int = 0
    checkpoint_path: str = "checkpoints"
    wandb_checkpoint_artifacts: bool = False

    # -- derived -----------------------------------------------------------
    @property
    def torch_dtype(self):
        return DTYPE_MAP[self.dtype]

    @property
    def compute_torch_dtype(self):
        """Forward/backward compute dtype (None = use ``torch_dtype``)."""
        return None if self.compute_dtype is None \
            else DTYPE_MAP[self.compute_dtype]

    @property
    def hook_point(self) -> str:
        return f"blocks.{self.hook_point_layer}.{self.layer_subtype}"

    @property
    def out_hook_point(self) -> str:
        return f"blocks.{self.out_hook_point_layer}.{self.layer_out_subtype}"

    @property
    def d_sae(self) -> int:
        return self.d_in * self.expansion_factor

    @property
    def tokens_per_image(self) -> int:
        if self.cls_token_only:
            return 1
        if self.use_patches_only:
            return self.context_size - 1
        return self.context_size

    @property
    def tokens_per_buffer(self) -> int:
        if self.buffer_tokens_override is not None:
            return self.buffer_tokens_override
        return self.train_batch_size * self.tokens_per_image * self.n_batches_in_buffer

    @property
    def total_training_tokens(self) -> int:
        images = self.total_training_images
        if images is None:
            images = int(1_300_000 * self.num_epochs)
        return images * self.tokens_per_image

    @property
    def total_training_steps(self) -> int:
        return self.total_training_tokens // self.train_batch_size

    @property
    def num_patch(self) -> int:
        return int(math.sqrt(self.context_size - 1))

    @property
    def activation_fn_kwargs_dict(self) -> Dict[str, Any]:
        return dict(self.activation_fn_kwargs)

    @property
    def topk_k(self) -> Optional[int]:
        if self.activation_fn_str == "topk":
            return int(self.activation_fn_kwargs_dict.get("k", 64))
        return None

    @property
    def is_training(self) -> bool:
        return os.getenv("EVAL_MODE", "false").lower() not in ("true", "1")

    def __post_init__(self):
        if self.b_dec_init_method not in ("geometric_median", "mean", "zeros"):
            raise ValueError(
                f"b_dec_init_method must be geometric_median, mean, or zeros."
                f" Got {self.b_dec_init_method}")
        if self.cls_token_only and self.use_patches_only:
            raise ValueError("cls_token_only and use_patches_only are exclusive.")
        if isinstance(self.activation_fn_kwargs, dict):
            object.__setattr__(self, "activation_fn_kwargs",
                               tuple(sorted(self.activation_fn_kwargs.items())))

    # -- (de)serialization -------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["activation_fn_kwargs"] = dict(self.activation_fn_kwargs)
        return d

    def save_config(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SAERunnerConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        d = {k: v for k, v in d.items() if k in known}
        if isinstance(d.get("activation_fn_kwargs"), dict):
            d["activation_fn_kwargs"] = tuple(sorted(d["activation_fn_kwargs"].items()))
        return cls(**d)

    @classmethod
    def load_config(cls, path: str) -> "SAERunnerConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def replace(self, **kw) -> "SAERunnerConfig":
        return dataclasses.replace(self, **kw)
