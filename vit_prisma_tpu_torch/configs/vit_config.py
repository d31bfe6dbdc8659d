"""Model configuration dataclasses (PyTorch port of
``vit_prisma_tpu/configs/vit_config.py``).

The fields and defaults are those of the JAX package, so one config dict
describes the same model in both.  The config stays frozen and hashable;
``dtype`` is a string name, mapped to a torch dtype by :attr:`torch_dtype`.

Fields that select a JAX compilation strategy keep their names and change
nothing here: ``scan_blocks`` (the port always runs a Python loop over the
blocks, with the same numbers) and ``remat_blocks`` (the JAX package's
per-block rematerialization in the backward; here every block keeps its
activations, and ``torch.utils.checkpoint`` in its place is ROADMAP queue A,
item 16).
``matmul_precision`` only gates the fused attention path, as in JAX: a
float32 matmul in PyTorch runs in full float32 unless TF32 is switched on,
which this package never does.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

# String names for dtypes keep the dataclass hashable and JSON-serializable.
DTYPE_MAP = {
    "float32": torch.float32,
    "fp32": torch.float32,
    "float16": torch.float16,
    "fp16": torch.float16,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "float64": torch.float64,
}


def resolve_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, str):
        return DTYPE_MAP[dtype]
    return dtype


@dataclass(frozen=True)
class ViTConfig:
    """Architecture config for ``HookedViT``; field for field the JAX
    package's ``ViTConfig``."""

    n_layers: int = 2
    d_model: int = 128
    d_head: int = 32
    d_mlp: int = 512
    n_heads: int = 4
    model_name: str = "custom"
    activation_name: str = "gelu"
    eps: float = 1e-6

    # Hook gating flags
    use_attn_result: bool = False
    use_split_qkv_input: bool = False
    use_hook_mlp_in: bool = False
    use_attn_in: bool = False

    use_attn_scale: bool = True
    use_cls_token: bool = True
    attn_only: bool = False
    # One stacked QKV einsum on the hooked path when the inputs are shared.
    fused_qkv: bool = False

    # "LN" | "LNPre" | None
    normalization_type: Optional[str] = "LN"
    # CLIP-style LayerNorm before the first block
    layer_norm_pre: bool = False
    # Post-LN (CLIP "BertBlock") variant
    use_bert_block: bool = False

    attention_dir: str = "bidirectional"

    # Image params
    n_channels: int = 3
    patch_size: int = 32
    image_size: int = 224

    # Classification
    classification_type: str = "cls"  # 'cls' | 'gaap'
    n_classes: int = 10
    return_type: str = "pre_logits"  # 'pre_logits' | 'class_logits' | 'logits'
    normalize_output: bool = False

    # Video: [B, C, frames, H, W] input cut into tubelets of
    # video_tubelet_depth frames (models/layers.py tubelet_embedding)
    is_video_transformer: bool = False
    video_tubelet_depth: Optional[int] = None
    video_num_frames: Optional[int] = None

    # Initialization
    weight_type: str = "he"
    cls_std: float = 1e-6
    pos_std: float = 0.02

    # Numerics.  ``dtype`` is the compute/storage dtype of the main pass;
    # LayerNorm computes in float32 when it is a lower precision.
    dtype: str = "float32"
    # 'default' | 'float32' | 'high' | 'highest'.  Anything but 'default'
    # keeps attention on the hooked einsum path, as in the JAX package.
    matmul_precision: str = "default"

    # Train-mode dropout rates, applied when the forward gets a dropout
    # generator (the trainer's steps).
    attn_dropout_rate: float = 0.0
    mlp_dropout_rate: float = 0.0

    # Run the attention mix through the hand-written kernel when no
    # attention-internal hook is requested (models/layers.py).
    use_fused_attention: bool = True

    # Fuse ln1 -> QKV and ln2 -> W_in into the LayerNorm-prologue GEMM
    # (kernel B14) where no LayerNorm hook is requested (models/layers.py).
    use_fused_ln_gemm: bool = False

    scan_blocks: str = "auto"
    remat_blocks: bool = False

    def __post_init__(self):
        if self.d_head is None and self.d_model is not None:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if self.d_mlp is None and self.d_model is not None:
            object.__setattr__(self, "d_mlp", self.d_model * 4)

    # -- derived ---------------------------------------------------------
    @property
    def n_patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def n_image_patches(self) -> int:
        n = self.n_patches_per_side ** 2
        if self.is_video_transformer:
            n *= self.video_num_frames // self.video_tubelet_depth
        return n

    @property
    def n_tokens(self) -> int:
        return self.n_image_patches + (1 if self.use_cls_token else 0)

    @property
    def torch_dtype(self) -> torch.dtype:
        return resolve_dtype(self.dtype)

    @property
    def compute_in_fp32(self) -> bool:
        return self.torch_dtype not in (torch.float32, torch.float64)

    # -- (de)serialization ----------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ViTConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def replace(self, **kw) -> "ViTConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class TextTransformerConfig(ViTConfig):
    """The CLIP text tower's config (``HookedTextTransformer``); field for
    field the JAX package's ``TextTransformerConfig``."""

    context_length: int = 77
    vocab_size: int = 10_000
    # a causal mask over the tokens, on by default for text
    causal_attention: bool = True
    # a learned embedding appended after the last token (CoCa-style towers)
    use_cls_emb: bool = False

    @property
    def n_tokens(self) -> int:  # type: ignore[override]
        return self.context_length + (1 if self.use_cls_emb else 0)
