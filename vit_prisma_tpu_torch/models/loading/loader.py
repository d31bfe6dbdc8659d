"""Model loader: ``load_hooked_model`` / ``HookedViT.from_pretrained`` /
``HookedTextTransformer.from_pretrained`` (PyTorch port of
``vit_prisma_tpu/models/loading/loader.py``).

Resolve the config (registry) -> get the source state dict -> convert it to
the flat reference-named dict -> fill missing keys -> optionally fold,
centre and refactor -> build the model on its device (the CUDA card unless
the caller passes ``device``).  ``model_type="text"`` loads a CLIP text
tower into a ``HookedTextTransformer``; a whole HF ``CLIPModel`` state dict
serves both towers.

The source state dict is passed in (``state_dict=``) or read from a local
torch or safetensors checkpoint (``checkpoint_path=``); with neither, the
weights are fetched through ``transformers`` (or ``huggingface_hub``,
``timm``) where those packages and a network are available.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from vit_prisma_tpu_torch.configs.vit_config import ViTConfig
from vit_prisma_tpu_torch.models.loading import convert as C
from vit_prisma_tpu_torch.models.loading.processing import process_state_dict
from vit_prisma_tpu_torch.models.loading.registry import (
    ModelCategory,
    categorize,
    check_model_name,
    get_model_config,
)
from vit_prisma_tpu_torch.models.loading.state_dict import (reference_state_dict, stack_params,
                                                            unstack_params)
from vit_prisma_tpu_torch.models.text import (HookedTextTransformer, stack_text_params,
                                              unstack_text_params)
from vit_prisma_tpu_torch.models.vit import HookedViT


def _to_numpy_sd(sd) -> Dict[str, Any]:
    out = {}
    for k, v in sd.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().float().numpy()
        out[k] = v
    return out


def _strip_prefix(sd: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _load_checkpoint(path: str) -> Dict[str, Any]:
    """A local checkpoint's state dict: ``.safetensors`` through the
    ``safetensors`` package, anything else (``.pt``, ``.pth``, ``.bin``)
    through ``torch.load``."""
    if path.endswith(".safetensors"):
        try:
            from safetensors.numpy import load_file
        except ImportError as e:
            raise ImportError(
                f"reading {path!r} needs the safetensors package, which is not "
                "installed; pass a .pt/.pth/.bin checkpoint or state_dict= "
                "instead") from e
        return load_file(path)
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    if next(iter(ckpt)).startswith("module"):
        ckpt = {k[7:]: v for k, v in ckpt.items()}
    return ckpt


def _fetch_from_hub(model_name: str, category: ModelCategory):
    """The source weights from the hub; raises a clear error where the
    packages or the network are missing."""
    try:
        if category == ModelCategory.CLIP:
            from transformers import CLIPModel
            model = CLIPModel.from_pretrained(model_name)
            return {"clip_model_sd": model.state_dict()}
        if category == ModelCategory.DINO:
            from transformers import ViTModel
            return {"sd": ViTModel.from_pretrained(
                model_name, add_pooling_layer=False).state_dict()}
        if category == ModelCategory.HF_VIT:
            from transformers import ViTForImageClassification
            return {"sd": ViTForImageClassification.from_pretrained(
                model_name).state_dict()}
        if category == ModelCategory.VIVIT:
            from transformers import VivitForVideoClassification
            return {"sd": VivitForVideoClassification.from_pretrained(
                model_name).state_dict()}
        if category == ModelCategory.OPEN_CLIP:
            from huggingface_hub import hf_hub_download
            name = model_name
            for p in ("open-clip:", "hf-hub:"):
                if name.startswith(p):
                    name = name[len(p):]
            path = hf_hub_download(name, "open_clip_pytorch_model.bin")
            return {"sd": _load_checkpoint(path)}
        if category == ModelCategory.TIMM:
            import timm
            return {"sd": timm.create_model(
                model_name, pretrained=True).state_dict()}
    except Exception as e:  # noqa: BLE001
        raise RuntimeError(
            f"Could not fetch weights for {model_name!r} from the hub "
            f"(offline environment?). Pass `state_dict=` or "
            f"`checkpoint_path=` instead. Original error: {e}") from e
    raise ValueError(f"Unhandled category {category}")


def convert_weights(category: ModelCategory, raw: Dict[str, Any],
                    cfg: ViTConfig, model_type: str = "vision") -> Dict[str, Any]:
    """The source state dict of ``category`` -> the flat reference-named
    dict (numpy).  ``raw`` holds it under ``"sd"``, or a whole HF
    ``CLIPModel`` state dict under ``"clip_model_sd"``."""
    if category == ModelCategory.CLIP:
        if "clip_model_sd" in raw:
            full = _to_numpy_sd(raw["clip_model_sd"])
        else:
            full = _to_numpy_sd(raw["sd"])
        if model_type == "text":
            text_sd = _strip_prefix(full, "text_model.")
            head = {"weight": full["text_projection.weight"]}
            return C.convert_hf_clip_text_weights(text_sd, head, cfg)
        vision_sd = _strip_prefix(full, "vision_model.")
        head = {"weight": full["visual_projection.weight"]}
        return C.convert_clip_weights(vision_sd, head, cfg)
    raw_sd = _to_numpy_sd(raw["sd"])
    if category == ModelCategory.OPEN_CLIP:
        if model_type == "text":
            return C.convert_open_clip_text_weights(raw_sd, cfg)
        return C.convert_open_clip_weights(raw_sd, cfg)
    if category == ModelCategory.TIMM:
        return C.convert_timm_weights(raw_sd, cfg)
    if category == ModelCategory.DINO:
        return C.convert_dino_weights(raw_sd, cfg)
    if category == ModelCategory.HF_VIT:
        return C.convert_hf_vit_for_image_classification_weights(raw_sd, cfg)
    if category == ModelCategory.VIVIT:
        return C.convert_vivit_weights(raw_sd, cfg)
    if category == ModelCategory.VJEPA:
        return C.convert_vjepa_weights(raw_sd, cfg)
    raise ValueError(f"Unhandled category {category}")


def load_hooked_model(model_name: str, model_type: str = "vision",
                      state_dict: Optional[Dict[str, Any]] = None,
                      checkpoint_path: Optional[str] = None,
                      cfg: Optional[ViTConfig] = None,
                      fold_ln: bool = False,
                      center_writing_weights: bool = False,
                      fold_value_biases: bool = False,
                      refactor_factored_attn_matrices: bool = False,
                      dtype: str = "float32",
                      allow_failing: bool = False,
                      device=None,
                      **config_overrides):
    """Load pretrained weights into a ``HookedViT`` (``model_type="text"``:
    a ``HookedTextTransformer``) on ``device`` (the CUDA card when None).
    The processing flags default to off; the processing runs in float32 on
    the host, before the weights are cast to ``dtype`` and moved."""
    category = categorize(model_name)
    check_model_name(model_name, allow_failing=allow_failing)
    if cfg is None:
        cfg = get_model_config(model_name, model_type=model_type,
                               dtype=dtype, **config_overrides)

    if state_dict is not None:
        raw = {"sd": state_dict} if "clip_model_sd" not in state_dict else state_dict
        # a whole HF CLIPModel state dict may be passed directly
        if category == ModelCategory.CLIP and any(
                k.startswith("vision_model.") for k in state_dict):
            raw = {"clip_model_sd": state_dict}
    elif checkpoint_path is not None:
        raw = {"sd": _load_checkpoint(checkpoint_path)}
        if category == ModelCategory.CLIP and any(
                k.startswith("vision_model.") for k in raw["sd"]):
            raw = {"clip_model_sd": raw["sd"]}
    else:
        raw = _fetch_from_hub(model_name, category)

    flat = convert_weights(category, raw, cfg, model_type)
    text = model_type == "text"
    model = (HookedTextTransformer if text else HookedViT)(cfg, device=device)
    # keys the source lacks keep the new model's initial values
    flat = C.fill_missing_keys(flat, cfg, reference_state_dict(model))
    if fold_ln or center_writing_weights or fold_value_biases or \
            refactor_factored_attn_matrices:
        flat = process_state_dict(
            flat, cfg, fold_ln=fold_ln, center_writing=center_writing_weights,
            fold_value_biases_flag=fold_value_biases,
            refactor_factored=refactor_factored_attn_matrices)
    # through the stacked layout, as the JAX loader: keys the config has no
    # place for (a class token, ln_pre) are dropped, a missing head is zero
    if text:
        model.load_state_dict(unstack_text_params(stack_text_params(flat, cfg), cfg))
    else:
        model.load_state_dict(unstack_params(stack_params(flat, cfg), cfg))
    return model
