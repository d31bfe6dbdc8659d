"""Model registry: name -> (category, config) (PyTorch port of
``vit_prisma_tpu/models/loading/registry.py``, whose entries are copied
here and held equal to it by ``tests/test_torch_loading.py``).

Offline: the architecture of every supported family is written here (public
constants: width, depth and heads per ViT size class), and OpenCLIP-style
names are parsed structurally (``ViT-B-32`` -> size class B, patch 32).
Text towers resolve through ``get_model_config(name, model_type="text")``:
the explicit ``TEXT_MODEL_CONFIGS`` entries, or OpenCLIP names parsed as
for the vision towers (:func:`open_clip_text_config`).
"""

from __future__ import annotations

import re
from enum import Enum
from typing import Any, Dict

from vit_prisma_tpu_torch.configs.vit_config import TextTransformerConfig, ViTConfig


class ModelCategory(Enum):
    TIMM = "timm"
    CLIP = "clip"
    OPEN_CLIP = "open_clip"
    DINO = "dino"
    VIVIT = "vivit"
    VJEPA = "vjepa"
    HF_VIT = "hf_vit"


# ViT size classes: (d_model, n_layers, n_heads, d_mlp).  Public constants.
VIT_SIZES = {
    "Ti": (192, 12, 3, 768),
    "S": (384, 12, 6, 1536),
    "M": (512, 12, 8, 2048),
    "B": (768, 12, 12, 3072),
    "L": (1024, 24, 16, 4096),
    "H": (1280, 32, 16, 5120),
    "g": (1408, 40, 16, 6144),
    "G": (1664, 48, 16, 8192),
}

# CLIP text towers paired with each vision size (d_model, n_layers, n_heads,
# embed_dim) — OpenAI/LAION conventions.
CLIP_TEXT_SIZES = {
    "B": (512, 12, 8, 512),
    "L": (768, 12, 12, 768),
    "H": (1024, 24, 16, 1024),
    "g": (1024, 24, 16, 1024),
    "G": (1280, 32, 20, 1280),
}

# CLIP embed dims per vision size class.
CLIP_EMBED_DIMS = {"B": 512, "L": 768, "H": 1024, "g": 1024, "G": 1280}


_TIMM_SIZE_WORDS = {
    "tiny": "Ti", "small": "S", "xsmall": "S", "medium": "M", "betwixt": "M",
    "base": "B", "large": "L", "huge": "H", "giant": "g", "gigantic": "G",
}


# Name tokens that CHANGE the geometry in ways the structural parser cannot
# derive from the size class alone.  A name containing one of these must have
# an explicit MODEL_CONFIGS entry; silently falling back to the base size
# class would produce a wrong-shaped model that fails only at weight-load
# time (or, with fill_missing_keys, not at all).
_GEOMETRY_MODIFIERS = ("plus", "-pplus", "swiglu", "rope", "eva")


def parse_open_clip_name(model_name: str):
    """Structural parse of OpenCLIP checkpoint names ->
    (size_class, patch, image_size).

    Handles both naming families in the reference's PASSING_MODELS
    (model_loader.py:82-126): 'open-clip:laion/CLIP-ViT-B-32-…' /
    'ViT-bigG-14-…' and 'open-clip:timm/vit_base_patch16_clip_224.…'.

    Raises ``ValueError`` when the name carries a geometry modifier the
    parser does not understand ('plus' widths, EVA variants, …) — those
    checkpoints need an explicit registry entry."""
    lowered = model_name.lower()
    for tok in _GEOMETRY_MODIFIERS:
        if tok in lowered:
            raise ValueError(
                f"{model_name!r} contains the geometry modifier {tok!r}, "
                f"which the structural name parser cannot size; this "
                f"checkpoint needs an explicit MODEL_CONFIGS entry "
                f"(none found under this exact spelling).")
    m = re.search(r"ViT-(?:big)?(Ti|S|M|B|L|H|g|G)[-/](\d+)", model_name)
    if m:
        size, patch = m.group(1), int(m.group(2))
        if "bigG" in model_name:
            size = "G"
        rest = model_name.split(str(patch), 1)[-1]
        image_size = 336 if "336" in rest else (256 if "256x256" in rest else 224)
        return size, patch, image_size
    m = re.search(r"vit_([a-z]+)_patch(\d+)_clip_(\d+)", model_name)
    if m:
        if m.group(1) not in _TIMM_SIZE_WORDS:
            raise ValueError(
                f"{model_name!r}: unknown timm ViT size word {m.group(1)!r} "
                f"— add an explicit MODEL_CONFIGS entry for this geometry.")
        return _TIMM_SIZE_WORDS[m.group(1)], int(m.group(2)), int(m.group(3))
    return None


def open_clip_vision_config(model_name: str) -> ViTConfig:
    parsed = parse_open_clip_name(model_name)
    if parsed is None:
        raise ValueError(f"Cannot parse OpenCLIP model name: {model_name}")
    size, patch, image_size = parsed
    d_model, n_layers, n_heads, d_mlp = VIT_SIZES[size]
    # OpenAI and MetaCLIP checkpoints use QuickGELU (open_clip pairs the
    # metaclip_* pretrained tags with its '-quickgelu' model configs).
    quick = ("openai" in model_name or "quickgelu" in model_name
             or "metaclip" in model_name)
    return ViTConfig(
        model_name=model_name,
        d_model=d_model, n_layers=n_layers, n_heads=n_heads,
        d_head=d_model // n_heads, d_mlp=d_mlp,
        patch_size=patch, image_size=image_size,
        n_classes=CLIP_EMBED_DIMS.get(size, d_model),
        activation_name="quick_gelu" if quick else "gelu",
        layer_norm_pre=True, normalization_type="LN", eps=1e-5,
        return_type="class_logits", normalize_output=True,
        use_cls_token=True,
    )


def open_clip_text_config(model_name: str) -> TextTransformerConfig:
    """The text tower paired with an OpenCLIP vision size class."""
    parsed = parse_open_clip_name(model_name)
    if parsed is None:
        raise ValueError(f"Cannot parse OpenCLIP model name: {model_name}")
    size = parsed[0]
    d_model, n_layers, n_heads, embed = CLIP_TEXT_SIZES[size]
    quick = "openai" in model_name
    return TextTransformerConfig(
        model_name=model_name,
        d_model=d_model, n_layers=n_layers, n_heads=n_heads,
        d_head=d_model // n_heads, d_mlp=d_model * 4,
        n_classes=embed, vocab_size=49408, context_length=77,
        activation_name="quick_gelu" if quick else "gelu",
        normalization_type="LN", eps=1e-5,
        return_type="class_logits", normalize_output=True,
        use_cls_token=False, causal_attention=True,
    )


# Explicit per-checkpoint configs (reference model_config_registry.py:81-113
# overrides merged with public architecture facts).
def _clip(p, size, image=224, eps=1e-5, act="quick_gelu"):
    d, l, h, m = VIT_SIZES[size]
    return dict(d_model=d, n_layers=l, n_heads=h, d_head=d // h, d_mlp=m,
                patch_size=p, image_size=image,
                n_classes=CLIP_EMBED_DIMS[size], activation_name=act,
                layer_norm_pre=True, normalization_type="LN", eps=eps,
                return_type="class_logits", normalize_output=True)


MODEL_CONFIGS: Dict[str, Dict[str, Any]] = {
    # OpenAI CLIP via HF transformers (reference CLIP_CONFIGS :81-113).
    # eps 1e-6 matches the reference registry entry (:84), which overrides
    # the HF default.
    "openai/clip-vit-base-patch32": {**_clip(32, "B", eps=1e-6),
                                     "normalize_output": False},
    "openai/clip-vit-base-patch16": _clip(16, "B"),
    "openai/clip-vit-large-patch14": _clip(14, "L"),
    "openai/clip-vit-large-patch14-336": _clip(14, "L", image=336),
    "wkcn/TinyCLIP-ViT-8M-16-Text-3M-YFCC15M": dict(
        d_model=256, n_layers=10, n_heads=4, d_head=64, d_mlp=1024,
        patch_size=16, image_size=224, n_classes=512,
        activation_name="quick_gelu", layer_norm_pre=True,
        normalization_type="LN", eps=1e-5, return_type="class_logits",
        normalize_output=True),
    "wkcn/TinyCLIP-ViT-40M-32-Text-19M-LAION400M": dict(
        d_model=512, n_layers=12, n_heads=8, d_head=64, d_mlp=2048,
        patch_size=32, image_size=224, n_classes=512,
        activation_name="quick_gelu", layer_norm_pre=True,
        normalization_type="LN", eps=1e-5, return_type="class_logits",
        normalize_output=True),
    # OpenCLIP checkpoints whose geometry the structural parser cannot
    # derive (reference model_config_registry.py:114-441 overrides)
    "open-clip:timm/vit_medium_patch32_clip_224.tinyclip_laion400m": dict(
        d_model=640, n_layers=16, n_heads=10, d_head=64, d_mlp=2560,
        patch_size=32, image_size=224, n_classes=640,
        activation_name="gelu", layer_norm_pre=True,
        normalization_type="LN", eps=1e-6, return_type="class_logits",
        normalize_output=True),
    "open-clip:timm/vit_xsmall_patch16_clip_224.tinyclip_yfcc15m": dict(
        d_model=384, n_layers=8, n_heads=6, d_head=64, d_mlp=1536,
        patch_size=16, image_size=224, n_classes=384,
        activation_name="gelu", layer_norm_pre=True,
        normalization_type="LN", eps=1e-6, return_type="class_logits",
        normalize_output=True),
    "open-clip:timm/vit_betwixt_patch32_clip_224.tinyclip_laion400m": dict(
        d_model=512, n_layers=12, n_heads=8, d_head=64, d_mlp=2048,
        patch_size=32, image_size=224, n_classes=512,
        activation_name="gelu", layer_norm_pre=True,
        normalization_type="LN", eps=1e-6, return_type="class_logits",
        normalize_output=True),
    "open-clip:timm/vit_gigantic_patch14_clip_224.metaclip_2pt5b": dict(
        d_model=1920, n_layers=48, n_heads=24, d_head=80, d_mlp=7680,
        patch_size=14, image_size=224, n_classes=1024,
        activation_name="gelu", layer_norm_pre=True,
        normalization_type="LN", eps=1e-6, return_type="class_logits",
        normalize_output=True),
    # ViT-B-16-plus-240 (OpenCLIP 'plus' geometry: width 896, 14 heads).
    # The reference's e32 entry claims n_heads=12 (d_head would be a
    # non-integer 896/12 — the reason the checkpoint sits on its failing
    # list); the true OpenCLIP geometry is encoded here instead.
    "open-clip:timm/vit_base_patch16_plus_clip_240.laion400m_e31": dict(
        d_model=896, n_layers=12, n_heads=14, d_head=64, d_mlp=3584,
        patch_size=16, image_size=240, n_classes=640,
        activation_name="gelu", layer_norm_pre=True,
        normalization_type="LN", eps=1e-5, return_type="class_logits",
        normalize_output=True),
    "open-clip:timm/vit_base_patch16_plus_clip_240.laion400m_e32": dict(
        d_model=896, n_layers=12, n_heads=14, d_head=64, d_mlp=3584,
        patch_size=16, image_size=240, n_classes=640,
        activation_name="gelu", layer_norm_pre=True,
        normalization_type="LN", eps=1e-5, return_type="class_logits",
        normalize_output=True),
    # timm ViTs (reference TIMM_CONFIGS :29-39)
    "vit_base_patch16_224": dict(
        d_model=768, n_layers=12, n_heads=12, d_head=64, d_mlp=3072,
        patch_size=16, image_size=224, n_classes=1000,
        activation_name="gelu", normalization_type="LN", eps=1e-6,
        return_type="class_logits"),
    "vit_base_patch32_224": dict(
        d_model=768, n_layers=12, n_heads=12, d_head=64, d_mlp=3072,
        patch_size=32, image_size=224, n_classes=1000,
        activation_name="gelu", normalization_type="LN", eps=1e-6,
        return_type="class_logits"),
    "vit_large_patch16_224": dict(
        d_model=1024, n_layers=24, n_heads=16, d_head=64, d_mlp=4096,
        patch_size=16, image_size=224, n_classes=1000,
        activation_name="gelu", normalization_type="LN", eps=1e-6,
        return_type="class_logits"),
    # DINO (reference DINO_CONFIGS :544-572)
    "facebook/dino-vitb16": dict(
        d_model=768, n_layers=12, n_heads=12, d_head=64, d_mlp=3072,
        patch_size=16, image_size=224, n_classes=768,
        activation_name="gelu", normalization_type="LN", eps=1e-12,
        return_type="pre_logits", model_name="dino-vitb16"),
    "facebook/dino-vitb8": dict(
        d_model=768, n_layers=12, n_heads=12, d_head=64, d_mlp=3072,
        patch_size=8, image_size=224, n_classes=768,
        activation_name="gelu", normalization_type="LN", eps=1e-12,
        return_type="pre_logits", model_name="dino-vitb8"),
    "facebook/dino-vits16": dict(
        d_model=384, n_layers=12, n_heads=6, d_head=64, d_mlp=1536,
        patch_size=16, image_size=224, n_classes=384,
        activation_name="gelu", normalization_type="LN", eps=1e-12,
        return_type="pre_logits", model_name="dino-vits16"),
    "facebook/dino-vits8": dict(
        d_model=384, n_layers=12, n_heads=6, d_head=64, d_mlp=1536,
        patch_size=8, image_size=224, n_classes=384,
        # eps 1e-6 per the reference registry (its one DINO entry that
        # deviates from the 1e-12 HF default)
        activation_name="gelu", normalization_type="LN", eps=1e-6,
        return_type="pre_logits", model_name="dino-vits8"),
    # HF ViT classifier
    "google/vit-base-patch16-224": dict(
        d_model=768, n_layers=12, n_heads=12, d_head=64, d_mlp=3072,
        patch_size=16, image_size=224, n_classes=1000,
        activation_name="gelu", normalization_type="LN", eps=1e-12,
        return_type="class_logits"),
    # ViViT video (reference VIVIT :573-590)
    "google/vivit-b-16x2-kinetics400": dict(
        d_model=768, n_layers=12, n_heads=12, d_head=64, d_mlp=3072,
        patch_size=16, image_size=224, n_classes=400,
        activation_name="gelu_fast", normalization_type="LN", eps=1e-6,
        return_type="class_logits", is_video_transformer=True,
        video_tubelet_depth=2, video_num_frames=32),
    "google/vivit-l-16x2-kinetics400": dict(
        d_model=1024, n_layers=24, n_heads=16, d_head=64, d_mlp=4096,
        patch_size=16, image_size=224, n_classes=400,
        activation_name="gelu_fast", normalization_type="LN", eps=1e-6,
        return_type="class_logits", is_video_transformer=True,
        video_tubelet_depth=2, video_num_frames=16),
    # EVA02 / EVA-giant CLIP towers (reference EVA02_CONFIGS :442-541).
    # Config-level parity: these encode the reference registry's geometry;
    # loading real EVA02 weights additionally needs its SwiGLU/rope
    # architecture, which (like the reference) is not modeled.
    "open-clip:timm/eva02_enormous_patch14_clip_224.laion2b_s4b_b115k": dict(
        d_model=1792, n_layers=40, n_heads=16, d_head=112, d_mlp=7168,
        patch_size=14, image_size=224, n_classes=1000,
        activation_name="gelu", layer_norm_pre=True,
        normalization_type="LN", eps=1e-6, return_type="class_logits"),
    "open-clip:timm/eva02_enormous_patch14_plus_clip_224.laion2b_s9b_b144": dict(
        d_model=1792, n_layers=40, n_heads=16, d_head=112, d_mlp=7168,
        patch_size=14, image_size=224, n_classes=1000,
        activation_name="gelu", layer_norm_pre=True,
        normalization_type="LN", eps=1e-6, return_type="class_logits"),
    "open-clip:timm/eva02_large_patch14_clip_224.merged2b_s4b_b131k": dict(
        d_model=1024, n_layers=40, n_heads=16, d_head=64, d_mlp=4096,
        patch_size=14, image_size=224, n_classes=1024,
        activation_name="gelu", layer_norm_pre=True,
        normalization_type="LN", eps=1e-6, return_type="class_logits"),
    "open-clip:timm/eva02_large_patch14_clip_336.merged2b_s6b_b61k": dict(
        d_model=1024, n_layers=40, n_heads=16, d_head=64, d_mlp=4096,
        patch_size=14, image_size=336, n_classes=1024,
        activation_name="gelu", layer_norm_pre=True,
        normalization_type="LN", eps=1e-6, return_type="class_logits"),
    "open-clip:timm/eva02_base_patch16_clip_224.merged2b_s8b_b131k": dict(
        d_model=768, n_layers=12, n_heads=12, d_head=64, d_mlp=3072,
        patch_size=16, image_size=224, n_classes=512,
        activation_name="gelu", layer_norm_pre=True,
        normalization_type="LN", eps=1e-6, return_type="class_logits"),
    "open-clip:timm/eva_giant_patch14_clip_224.laion400m_s11b_b41k": dict(
        d_model=1408, n_layers=40, n_heads=16, d_head=88, d_mlp=5632,
        patch_size=14, image_size=224, n_classes=1024,
        activation_name="gelu", layer_norm_pre=True,
        normalization_type="LN", eps=1e-6, return_type="class_logits"),
    "open-clip:timm/eva_giant_patch14_plus_clip_224.merged2b_s11b_b114k": dict(
        d_model=1408, n_layers=40, n_heads=16, d_head=88, d_mlp=5632,
        patch_size=14, image_size=224, n_classes=1024,
        activation_name="gelu", layer_norm_pre=True,
        normalization_type="LN", eps=1e-6, return_type="class_logits"),
    # V-JEPA (reference VJEPA :591-605)
    "vjepa_v1_vit_huge": dict(
        d_model=1280, n_layers=32, n_heads=16, d_head=80, d_mlp=5120,
        patch_size=16, image_size=224, n_classes=1280,
        activation_name="gelu", normalization_type="LN", eps=1e-6,
        return_type="pre_logits", use_cls_token=False,
        is_video_transformer=True, video_tubelet_depth=2,
        video_num_frames=16),
}


def _oc(size, patch, image=224, act="gelu", eps=1e-5, n_classes=None, **extra):
    """Full OpenCLIP checkpoint geometry from the public size-class facts
    (the reference registry stores only *overrides* and fetches the rest
    from the hub at load time — model_loader.py:164-208; offline we encode
    the whole thing)."""
    d, l, h, m = VIT_SIZES[size]
    cfg = dict(d_model=d, n_layers=l, n_heads=h, d_head=d // h, d_mlp=m,
               patch_size=patch, image_size=image,
               n_classes=(CLIP_EMBED_DIMS[size] if n_classes is None
                          else n_classes),
               activation_name=act, layer_norm_pre=True,
               normalization_type="LN", eps=eps,
               return_type="class_logits", normalize_output=True,
               use_cls_token=True)
    cfg.update(extra)
    return cfg


# Every explicit OpenCLIP checkpoint-id key of the reference registry
# (model_config_registry.py:114-441: OPEN_CLIP_BASE_CONFIGS +
# OPEN_CLIP_EXTENDED_CONFIGS), as full offline geometry.  The structural
# parser could derive most of these, but per-checkpoint entries make the
# supported surface explicit and diff-testable against the reference table
# (tests/test_registry_diff.py).  Value = (size_class, patch, extras).
_Q = {"act": "quick_gelu"}  # OpenAI / MetaCLIP towers ship QuickGELU
_OPEN_CLIP_EXPLICIT = {
    # ViT-B-16 CommonPool.L ladder + DataComp + laion2B
    "open-clip:laion/CLIP-ViT-B-16-CommonPool.L-s1B-b8K": ("B", 16, {}),
    "open-clip:laion/CLIP-ViT-B-16-CommonPool.L.basic-s1B-b8K": ("B", 16, {}),
    "open-clip:laion/CLIP-ViT-B-16-CommonPool.L.clip-s1B-b8K": ("B", 16, {}),
    "open-clip:laion/CLIP-ViT-B-16-CommonPool.L.image-s1B-b8K": ("B", 16, {}),
    "open-clip:laion/CLIP-ViT-B-16-CommonPool.L.laion-s1B-b8K": ("B", 16, {}),
    "open-clip:laion/CLIP-ViT-B-16-CommonPool.L.text-s1B-b8K": ("B", 16, {}),
    "open-clip:laion/CLIP-ViT-B-16-DataComp.L-s1B-b8K": ("B", 16, {}),
    "open-clip:laion/CLIP-ViT-B-16-DataComp.XL-s13B-b90K": ("B", 16, {}),
    "open-clip:laion/CLIP-ViT-B-16-laion2B-s34B-b88K": ("B", 16, {}),
    # ViT-B-32 CommonPool.M / .S ladders
    "open-clip:laion/CLIP-ViT-B-32-CommonPool.M-s128M-b4K": ("B", 32, {}),
    "open-clip:laion/CLIP-ViT-B-32-CommonPool.M.basic-s128M-b4K": ("B", 32, {}),
    "open-clip:laion/CLIP-ViT-B-32-CommonPool.M.clip-s128M-b4K": ("B", 32, {}),
    "open-clip:laion/CLIP-ViT-B-32-CommonPool.M.image-s128M-b4K": ("B", 32, {}),
    "open-clip:laion/CLIP-ViT-B-32-CommonPool.M.laion-s128M-b4K": ("B", 32, {}),
    "open-clip:laion/CLIP-ViT-B-32-CommonPool.M.text-s128M-b4K": ("B", 32, {}),
    "open-clip:laion/CLIP-ViT-B-32-CommonPool.S-s13M-b4K": ("B", 32, {}),
    "open-clip:laion/CLIP-ViT-B-32-CommonPool.S.basic-s13M-b4K": ("B", 32, {}),
    "open-clip:laion/CLIP-ViT-B-32-CommonPool.S.clip-s13M-b4K": ("B", 32, {}),
    "open-clip:laion/CLIP-ViT-B-32-CommonPool.S.image-s13M-b4K": ("B", 32, {}),
    "open-clip:laion/CLIP-ViT-B-32-CommonPool.S.laion-s13M-b4K": ("B", 32, {}),
    "open-clip:laion/CLIP-ViT-B-32-CommonPool.S.text-s13M-b4K": ("B", 32, {}),
    # DataComp / laion B-32 + L-14
    "open-clip:laion/CLIP-ViT-B-32-DataComp.M-s128M-b4K": ("B", 32, {}),
    "open-clip:laion/CLIP-ViT-B-32-DataComp.S-s13M-b4K": ("B", 32, {}),
    "open-clip:laion/CLIP-ViT-B-32-DataComp.XL-s13B-b90K": ("B", 32, {}),
    "open-clip:laion/CLIP-ViT-B-32-laion2B-s34B-b79K": ("B", 32, {}),
    "open-clip:laion/CLIP-ViT-L-14-CommonPool.XL-s13B-b90K": ("L", 14, {}),
    "open-clip:laion/CLIP-ViT-L-14-CommonPool.XL.clip-s13B-b90K": ("L", 14, {}),
    "open-clip:laion/CLIP-ViT-L-14-CommonPool.XL.laion-s13B-b90K": ("L", 14, {}),
    "open-clip:laion/CLIP-ViT-L-14-DataComp.XL-s13B-b90K": ("L", 14, {}),
    "open-clip:laion/CLIP-ViT-L-14-laion2B-s32B-b82K": ("L", 14, {}),
    # timm-hub laion checkpoints
    "open-clip:timm/vit_base_patch16_clip_224.laion400m_e31": ("B", 16, {}),
    "open-clip:timm/vit_base_patch16_clip_224.laion400m_e32": ("B", 16, {}),
    "open-clip:timm/vit_base_patch32_clip_224.laion2b_e16": ("B", 32, {}),
    "open-clip:timm/vit_large_patch14_clip_224.laion400m_e31": ("L", 14, {}),
    "open-clip:timm/vit_large_patch14_clip_224.laion400m_e32": ("L", 14, {}),
    # g / bigG towers
    "open-clip:laion/CLIP-ViT-g-14-laion2B-s34B-b88K": ("g", 14, {}),
    "open-clip:laion/CLIP-ViT-bigG-14-laion2B-39B-b160k": ("G", 14, {}),
    # Extended tier (reference's known-failing list — geometry still exact)
    "open-clip:timm/vit_base_patch16_clip_224.metaclip_2pt5b": ("B", 16, _Q),
    "open-clip:timm/vit_base_patch16_clip_224.metaclip_400m": ("B", 16, _Q),
    "open-clip:timm/vit_base_patch16_clip_224.openai": ("B", 16, _Q),
    "open-clip:timm/vit_base_patch32_clip_224.laion400m_e31": ("B", 32, {}),
    "open-clip:timm/vit_base_patch32_clip_224.laion400m_e32": ("B", 32, {}),
    "open-clip:timm/vit_base_patch32_clip_224.metaclip_2pt5b": ("B", 32, _Q),
    "open-clip:timm/vit_base_patch32_clip_224.metaclip_400m": ("B", 32, _Q),
    "open-clip:timm/vit_base_patch32_clip_224.openai": ("B", 32, _Q),
    "open-clip:laion/CLIP-ViT-B-32-256x256-DataComp-s34B-b86K":
        ("B", 32, {"image": 256}),
    # Multilingual towers: the VISION side is a standard B-32 / H-14; the
    # roberta text towers are encoded in TEXT_MODEL_CONFIGS below.
    "open-clip:laion/CLIP-ViT-B-32-xlm-roberta-base-laion5B-s13B-b90k":
        ("B", 32, {}),
    "open-clip:laion/CLIP-ViT-B-32-roberta-base-laion2B-s12B-b32k":
        ("B", 32, {}),
    "open-clip:laion/CLIP-ViT-H-14-frozen-xlm-roberta-large-laion5B-s13B-b90k":
        ("H", 14, {}),
    "open-clip:laion/CLIP-ViT-H-14-laion2B-s32B-b79K": ("H", 14, {}),
    "open-clip:timm/vit_large_patch14_clip_224.metaclip_2pt5b": ("L", 14, _Q),
    "open-clip:timm/vit_large_patch14_clip_224.metaclip_400m": ("L", 14, _Q),
    "open-clip:timm/vit_large_patch14_clip_224.openai": ("L", 14, _Q),
    "open-clip:timm/vit_large_patch14_clip_336.openai":
        ("L", 14, {"image": 336, **_Q}),
    "open-clip:timm/vit_huge_patch14_clip_224.metaclip_2pt5b": ("H", 14, _Q),
    # CoCa vision towers (standard B-32 / L-14 geometry; the CoCa text
    # decoder is out of scope, like the reference's).
    "open-clip:laion/CoCa-ViT-B-32-laion2B-s13B-b90k": ("B", 32, {}),
    "open-clip:laion/CoCa-ViT-L-14-laion2B-s13B-b90k": ("L", 14, {}),
}

for _name, (_size, _patch, _extra) in _OPEN_CLIP_EXPLICIT.items():
    MODEL_CONFIGS.setdefault(_name, _oc(_size, _patch, **dict(_extra)))
del _name, _size, _patch, _extra

# tinyclip_yfcc15m medium: a 640-wide 16-layer TinyCLIP geometry the size
# classes don't cover.  The reference registry entry for it is EMPTY (its
# true geometry sits commented out at model_config_registry.py:239-252);
# encoded here from those public facts.
MODEL_CONFIGS["open-clip:timm/vit_medium_patch16_clip_224.tinyclip_yfcc15m"] \
    = dict(
        d_model=640, n_layers=16, n_heads=10, d_head=64, d_mlp=2560,
        patch_size=16, image_size=224, n_classes=640,
        activation_name="gelu", layer_norm_pre=True,
        normalization_type="LN", eps=1e-6, return_type="class_logits",
        normalize_output=True, use_cls_token=True)


def categorize(model_name: str) -> ModelCategory:
    """Reference: model_loader.py:82-156 name lists + prefixes."""
    if model_name.startswith("open-clip:") or model_name.startswith("hf-hub:"):
        return ModelCategory.OPEN_CLIP
    if "dino" in model_name:
        return ModelCategory.DINO
    if "vivit" in model_name:
        return ModelCategory.VIVIT
    if "vjepa" in model_name:
        return ModelCategory.VJEPA
    if "TinyCLIP" in model_name or "clip" in model_name.lower():
        return ModelCategory.CLIP
    if model_name.startswith("vit_"):
        return ModelCategory.TIMM
    if model_name.startswith("google/vit"):
        return ModelCategory.HF_VIT
    raise ValueError(f"Unknown model family for {model_name!r}")


def get_model_config(model_name: str, model_type: str = "vision",
                     **overrides) -> ViTConfig:
    """Resolve a config for ``model_name``, offline, with ``overrides``
    (``dtype="bfloat16"``, any other field) applied."""
    if model_type == "text":
        if model_name in TEXT_MODEL_CONFIGS:
            base = dict(TEXT_MODEL_CONFIGS[model_name])
            base.setdefault("model_name", model_name)
            base.update(overrides)
            return TextTransformerConfig(**base)
        cfg = open_clip_text_config(model_name)
        return cfg.replace(**overrides) if overrides else cfg
    if model_name in MODEL_CONFIGS:
        base = dict(MODEL_CONFIGS[model_name])
        base.setdefault("model_name", model_name)
        base.update(overrides)
        return ViTConfig(**base)
    if categorize(model_name) == ModelCategory.OPEN_CLIP:
        cfg = open_clip_vision_config(model_name)
        return cfg.replace(**overrides) if overrides else cfg
    raise ValueError(f"No registry entry (and no name-pattern rule) for "
                     f"{model_name!r}")


# Text-side configs (reference model_config_registry.py:606-673).
TEXT_MODEL_CONFIGS: Dict[str, Dict[str, Any]] = {
    "openai/clip-vit-base-patch32": dict(
        d_model=512, n_layers=12, n_heads=8, d_head=64, d_mlp=2048,
        n_classes=512, vocab_size=49408, context_length=77,
        activation_name="quick_gelu", normalization_type="LN", eps=1e-5,
        return_type="class_logits", normalize_output=True,
        use_cls_token=False, causal_attention=True),
    "openai/clip-vit-large-patch14": dict(
        d_model=768, n_layers=12, n_heads=12, d_head=64, d_mlp=3072,
        n_classes=768, vocab_size=49408, context_length=77,
        activation_name="quick_gelu", normalization_type="LN", eps=1e-5,
        return_type="class_logits", normalize_output=True,
        use_cls_token=False, causal_attention=True),
    # Multilingual towers (reference model_config_registry.py:627-650):
    # roberta-family text encoders paired with standard CLIP vision towers.
    # Geometry and vocab sizes follow the reference's explicit entries.
    "open-clip:laion/CLIP-ViT-B-32-xlm-roberta-base-laion5B-s13B-b90k": dict(
        d_model=768, n_layers=12, n_heads=12, d_head=64, d_mlp=3072,
        n_classes=512, vocab_size=250002, context_length=77,
        activation_name="gelu", normalization_type="LN", eps=1e-5,
        return_type="class_logits", normalize_output=True,
        use_cls_token=False, causal_attention=True),
    "open-clip:laion/CLIP-ViT-B-32-roberta-base-laion2B-s12B-b32k": dict(
        d_model=768, n_layers=12, n_heads=12, d_head=64, d_mlp=3072,
        n_classes=512, vocab_size=50265, context_length=77,
        activation_name="gelu", normalization_type="LN", eps=1e-5,
        return_type="class_logits", normalize_output=True,
        use_cls_token=False, causal_attention=True),
    "open-clip:laion/CLIP-ViT-H-14-frozen-xlm-roberta-large-laion5B-s13B-b90k":
        dict(
            d_model=1024, n_layers=24, n_heads=16, d_head=64, d_mlp=4096,
            n_classes=1024, vocab_size=250002, context_length=77,
            activation_name="gelu", normalization_type="LN", eps=1e-5,
            return_type="class_logits", normalize_output=True,
            use_cls_token=False, causal_attention=True),
}

TEXT_SUPPORTED_MODELS = set(TEXT_MODEL_CONFIGS) | {
    n for n in MODEL_CONFIGS if n.startswith("open-clip:")}


# The reference's verified checkpoint lists (model_loader.py:82-156) —
# loading validation gate (check_model_name).
PASSING_MODELS = frozenset({
    "wkcn/TinyCLIP-ViT-8M-16-Text-3M-YFCC15M",
    "open-clip:laion/CLIP-ViT-B-16-CommonPool.L-s1B-b8K",
    "open-clip:laion/CLIP-ViT-B-16-CommonPool.L.basic-s1B-b8K",
    "open-clip:laion/CLIP-ViT-B-16-CommonPool.L.clip-s1B-b8K",
    "open-clip:laion/CLIP-ViT-B-16-CommonPool.L.image-s1B-b8K",
    "open-clip:laion/CLIP-ViT-B-16-CommonPool.L.laion-s1B-b8K",
    "open-clip:laion/CLIP-ViT-B-16-CommonPool.L.text-s1B-b8K",
    "open-clip:laion/CLIP-ViT-B-16-DataComp.L-s1B-b8K",
    "open-clip:laion/CLIP-ViT-B-16-DataComp.XL-s13B-b90K",
    "open-clip:laion/CLIP-ViT-B-16-laion2B-s34B-b88K",
    "open-clip:laion/CLIP-ViT-B-32-CommonPool.M-s128M-b4K",
    "open-clip:laion/CLIP-ViT-B-32-CommonPool.M.basic-s128M-b4K",
    "open-clip:laion/CLIP-ViT-B-32-CommonPool.M.clip-s128M-b4K",
    "open-clip:laion/CLIP-ViT-B-32-CommonPool.M.image-s128M-b4K",
    "open-clip:laion/CLIP-ViT-B-32-CommonPool.M.laion-s128M-b4K",
    "open-clip:laion/CLIP-ViT-B-32-CommonPool.M.text-s128M-b4K",
    "open-clip:laion/CLIP-ViT-B-32-CommonPool.S-s13M-b4K",
    "open-clip:laion/CLIP-ViT-B-32-CommonPool.S.basic-s13M-b4K",
    "open-clip:laion/CLIP-ViT-B-32-CommonPool.S.clip-s13M-b4K",
    "open-clip:laion/CLIP-ViT-B-32-CommonPool.S.image-s13M-b4K",
    "open-clip:laion/CLIP-ViT-B-32-CommonPool.S.laion-s13M-b4K",
    "open-clip:laion/CLIP-ViT-B-32-CommonPool.S.text-s13M-b4K",
    "open-clip:laion/CLIP-ViT-B-32-DataComp.M-s128M-b4K",
    "open-clip:laion/CLIP-ViT-B-32-DataComp.S-s13M-b4K",
    "open-clip:laion/CLIP-ViT-B-32-DataComp.XL-s13B-b90K",
    "open-clip:laion/CLIP-ViT-B-32-laion2B-s34B-b79K",
    "open-clip:timm/vit_base_patch16_clip_224.laion400m_e31",
    "open-clip:timm/vit_base_patch16_clip_224.laion400m_e32",
    "open-clip:timm/vit_base_patch32_clip_224.laion2b_e16",
    "open-clip:laion/CLIP-ViT-L-14-CommonPool.XL-s13B-b90K",
    "open-clip:laion/CLIP-ViT-L-14-CommonPool.XL.clip-s13B-b90K",
    "open-clip:laion/CLIP-ViT-L-14-CommonPool.XL.laion-s13B-b90K",
    "open-clip:laion/CLIP-ViT-L-14-DataComp.XL-s13B-b90K",
    "open-clip:laion/CLIP-ViT-L-14-laion2B-s32B-b82K",
    "open-clip:timm/vit_large_patch14_clip_224.laion400m_e31",
    "open-clip:timm/vit_large_patch14_clip_224.laion400m_e32",
    "open-clip:laion/CLIP-ViT-H-14-laion2B-s32B-b79K",
    "open-clip:laion/CLIP-ViT-bigG-14-laion2B-39B-b160k",
    "facebook/dino-vitb16",
    "facebook/dino-vitb8",
    "openai/clip-vit-large-patch14-336",
    "openai/clip-vit-large-patch14",
    "openai/clip-vit-base-patch32",
})

FAILING_MODELS = frozenset({
    "open-clip:timm/vit_medium_patch16_clip_224.tinyclip_yfcc15m",
    "open-clip:timm/vit_base_patch16_clip_224.metaclip_2pt5b",
    "open-clip:timm/vit_base_patch16_clip_224.metaclip_400m",
    "open-clip:timm/vit_base_patch16_clip_224.openai",
    "open-clip:timm/vit_base_patch32_clip_224.laion400m_e31",
    "open-clip:timm/vit_base_patch32_clip_224.laion400m_e32",
    "open-clip:timm/vit_base_patch32_clip_224.metaclip_2pt5b",
    "open-clip:timm/vit_base_patch32_clip_224.metaclip_400m",
    "open-clip:timm/vit_base_patch32_clip_224.openai",
    "open-clip:laion/CLIP-ViT-B-32-256x256-DataComp-s34B-b86K",
    "open-clip:laion/CLIP-ViT-B-32-xlm-roberta-base-laion5B-s13B-b90k",
    "open-clip:laion/CLIP-ViT-B-32-roberta-base-laion2B-s12B-b32k",
    "open-clip:laion/CLIP-ViT-H-14-frozen-xlm-roberta-large-laion5B-s13B-b90k",
    "open-clip:timm/vit_base_patch16_plus_clip_240.laion400m_e31",
    "open-clip:timm/vit_base_patch16_plus_clip_240.laion400m_e32",
    "open-clip:timm/vit_large_patch14_clip_224.metaclip_2pt5b",
    "open-clip:timm/vit_large_patch14_clip_224.metaclip_400m",
    "open-clip:timm/vit_large_patch14_clip_224.openai",
    "open-clip:timm/vit_large_patch14_clip_336.openai",
    "open-clip:timm/vit_medium_patch32_clip_224.tinyclip_laion400m",
    "open-clip:timm/vit_xsmall_patch16_clip_224.tinyclip_yfcc15m",
    "open-clip:timm/vit_betwixt_patch32_clip_224.tinyclip_laion400m",
    "open-clip:timm/vit_gigantic_patch14_clip_224.metaclip_2pt5b",
    "open-clip:timm/vit_huge_patch14_clip_224.metaclip_2pt5b",
    "facebook/dino-vits16",
    "facebook/dino-vits8",
})


def check_model_name(model_name: str, allow_failing: bool = False) -> None:
    """Validation gate mirroring model_loader.py:211-241: warn for names
    outside the verified list; raise for known-failing ones unless allowed."""
    import logging
    if model_name in FAILING_MODELS and not allow_failing:
        raise ValueError(
            f"{model_name!r} is on the known-failing checkpoint list "
            f"(numerics were never verified upstream). Pass "
            f"allow_failing=True to load anyway.")
    if model_name not in PASSING_MODELS and model_name not in MODEL_CONFIGS:
        logging.warning(
            "Model %s is not on the verified-checkpoint list; configs are "
            "derived structurally from the name.", model_name)
