"""Hugging Face hub interop for SAE checkpoints (PyTorch port of
``vit_prisma_tpu/sae/hub.py``).

The hub calls import ``huggingface_hub`` when they run, and raise the JAX
package's ``ImportError`` where it is absent; every function takes local
paths first where the reference would go to the network.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple


def _hf_api():
    try:
        from huggingface_hub import HfApi, hf_hub_download
        return HfApi, hf_hub_download
    except ImportError as e:
        raise ImportError(
            "huggingface_hub is required for hub upload/download; install "
            "it or use local checkpoint paths") from e


def upload_to_huggingface(checkpoint_path: str, repo_id: str, description: str,
                          token: Optional[str] = None,
                          commit_message: str = "Upload checkpoint") -> str:
    """Create (or reuse) ``repo_id``, upload a README built from
    ``description`` and the checkpoint file."""
    import tempfile
    HfApi, _ = _hf_api()
    api = HfApi()
    api.create_repo(repo_id=repo_id, private=False, exist_ok=True, token=token,
                    repo_type="model")
    with tempfile.NamedTemporaryFile(mode="w", delete=False, suffix=".md") as tmp:
        tmp.write(description)
        tmp.flush()
        api.upload_file(path_or_fileobj=tmp.name, path_in_repo="README.md",
                        repo_id=repo_id, token=token, commit_message="Update README.md")
    if not os.path.exists(checkpoint_path) and os.path.exists(checkpoint_path + ".npz"):
        checkpoint_path = checkpoint_path + ".npz"
    api.upload_file(path_or_fileobj=checkpoint_path,
                    path_in_repo=os.path.basename(checkpoint_path),
                    repo_id=repo_id, token=token, commit_message=commit_message)
    return f"https://huggingface.co/{repo_id}"


def download_sae_from_huggingface(repo_name: str, file_id: str, download_dir: str) -> str:
    """``hf_hub_download`` into ``download_dir``."""
    _, hf_hub_download = _hf_api()
    os.makedirs(download_dir, exist_ok=True)
    return hf_hub_download(repo_id=repo_name, filename=file_id, local_dir=download_dir)


def load_remote_sae_and_model(repo_id: str, checkpoint: str, model_name: Optional[str] = None,
                              download_dir: Optional[str] = None, model=None,
                              device=None) -> Tuple[object, object]:
    """An SAE checkpoint (the JAX ``.npz`` format) and its model.  A local
    directory ``repo_id`` short-circuits the hub: ``checkpoint`` resolves
    inside it.  Pass a built ``model`` to skip the model load (offline
    weights).  The SAE goes to ``device`` (the CUDA card when None)."""
    from vit_prisma_tpu_torch.sae.sae import SparseAutoencoder

    if os.path.isdir(repo_id):
        sae_path = os.path.join(repo_id, checkpoint)
    else:
        sae_path = download_sae_from_huggingface(repo_id, checkpoint,
                                                 download_dir or "downloads")
    sae = SparseAutoencoder.load_from_pretrained(sae_path, device=device)
    if model is None:
        from vit_prisma_tpu_torch.models.vit import HookedViT
        model = HookedViT.from_pretrained(model_name or sae.cfg.model_name)
    return sae, model
