"""Model registry (PyTorch port of
``vit_prisma_tpu/models/loading/registry.py``).

Only the port's slices' models are registered so far, their values copied
from the configs the JAX registry resolves: OpenAI CLIP ViT-B/32's vision
tower, the DataComp.XL ViT-B/32 that ``SAERunnerConfig`` trains on by
default, and OpenAI CLIP ViT-L/14's vision tower, which the all-layer sweep
trains on.  The other entries, and loading real weights, wait for ROADMAP
queue A, item 4.
"""

from __future__ import annotations

from typing import Any, Dict

from vit_prisma_tpu_torch.configs.vit_config import ViTConfig

MODEL_CONFIGS: Dict[str, Dict[str, Any]] = {
    # eps 1e-6 matches the reference registry entry, which overrides the HF
    # default.
    "openai/clip-vit-base-patch32": dict(
        d_model=768, n_layers=12, n_heads=12, d_head=64, d_mlp=3072,
        patch_size=32, image_size=224, n_classes=512,
        activation_name="quick_gelu", layer_norm_pre=True,
        normalization_type="LN", eps=1e-6, return_type="class_logits",
        normalize_output=False),
    # open_clip's ViT-B-32 vision tower: exact GELU, LN eps 1e-5, and a
    # unit-normalized image embedding.
    "open-clip:laion/CLIP-ViT-B-32-DataComp.XL-s13B-b90K": dict(
        d_model=768, n_layers=12, n_heads=12, d_head=64, d_mlp=3072,
        patch_size=32, image_size=224, n_classes=512,
        activation_name="gelu", layer_norm_pre=True,
        normalization_type="LN", eps=1e-5, return_type="class_logits",
        normalize_output=True),
    # 24 layers, 1024 wide, 16 heads of 64, MLP 4096, patch 14 (T = 257).
    "openai/clip-vit-large-patch14": dict(
        d_model=1024, n_layers=24, n_heads=16, d_head=64, d_mlp=4096,
        patch_size=14, image_size=224, n_classes=768,
        activation_name="quick_gelu", layer_norm_pre=True,
        normalization_type="LN", eps=1e-5, return_type="class_logits",
        normalize_output=True),
}


def get_model_config(model_name: str, model_type: str = "vision",
                     **overrides) -> ViTConfig:
    """Resolve a config for ``model_name``, offline."""
    if model_type == "text":
        raise NotImplementedError(
            "text-tower configs are not ported yet (ROADMAP queue A, item 12)")
    if model_name not in MODEL_CONFIGS:
        raise NotImplementedError(
            f"{model_name!r} is not in the port's registry yet (ROADMAP queue "
            "A, item 4)")
    base = dict(MODEL_CONFIGS[model_name])
    base.setdefault("model_name", model_name)
    base.update(overrides)
    return ViTConfig(**base)
