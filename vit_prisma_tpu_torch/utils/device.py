"""The device the port's entry points build on.

Every entry point that takes ``device=None`` (``HookedViT``, ``HookedSAEViT``,
``init_sae_params``, ``SparseAutoencoder``, ``init_train_state``,
``init_sweep_state``, the trainers without a store, ``sae_params_from_jax``,
``train_state_from_jax``) resolves it here: the CUDA card, or an error when
there is none.  The CPU is used only when the caller asks for it, as the
tests do with ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the current CUDA
    card.  Raises ``RuntimeError`` when ``None`` is given and there is no
    card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card is available: the port builds on the card unless the "
            "caller passes device='cpu'")
    return torch.device("cuda", torch.cuda.current_device())
