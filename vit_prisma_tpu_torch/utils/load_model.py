"""Model/SAE pair loading for the SAE runner (PyTorch port of
``vit_prisma_tpu/utils/load_model.py``): ``load_model(cfg)`` builds the
hooked model an SAE runner config names; ``load_sae_and_model`` loads a
saved SAE together with its subject model."""

from __future__ import annotations

from typing import Optional, Tuple

from vit_prisma_tpu_torch.sae.config import SAERunnerConfig
from vit_prisma_tpu_torch.sae.sae import SparseAutoencoder


def load_model(cfg: SAERunnerConfig, state_dict=None, checkpoint_path=None,
               **kwargs):
    """The subject model of an SAE run, a ``HookedViT`` or a
    ``HookedTextTransformer`` by ``cfg.model_class_name``; ``kwargs`` go to
    ``load_hooked_model`` (``device``, ``dtype``, the processing flags)."""
    from vit_prisma_tpu_torch.models.loading.loader import load_hooked_model
    if cfg.model_class_name == "HookedViT":
        return load_hooked_model(cfg.model_name, state_dict=state_dict,
                                 checkpoint_path=checkpoint_path, **kwargs)
    if cfg.model_class_name == "HookedTextTransformer":
        return load_hooked_model(cfg.model_name, model_type="text",
                                 state_dict=state_dict,
                                 checkpoint_path=checkpoint_path, **kwargs)
    raise ValueError(f"Unknown model class: {cfg.model_class_name}")


def load_sae_and_model(sae_path: str, model_state_dict=None,
                       model_checkpoint_path: Optional[str] = None,
                       **kwargs) -> Tuple[SparseAutoencoder, object]:
    """A saved SAE plus its subject model, both on ``kwargs["device"]``
    (the CUDA card when absent)."""
    sae = SparseAutoencoder.load_from_pretrained(sae_path, device=kwargs.get("device"))
    model = load_model(sae.cfg, state_dict=model_state_dict,
                       checkpoint_path=model_checkpoint_path, **kwargs)
    return sae, model
