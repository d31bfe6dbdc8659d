"""The pretrained-SAE registry: the published Prisma SAE checkpoint tables
(PyTorch port of ``vit_prisma_tpu/sae/pretrained.py``).

``pretrained_saes.json`` beside this module is a copy of the JAX package's
table (71 published checkpoints with their fidelity metrics); the queries
are the JAX package's.  :func:`load_pretrained_sae` imports a reference
checkpoint: from a local directory that holds it, else from the hub, which
needs ``huggingface_hub`` and the network (without the package it raises the
JAX package's ``ImportError``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

_TABLE_PATH = os.path.join(os.path.dirname(__file__), "pretrained_saes.json")
_table: Optional[List[Dict[str, Any]]] = None


def _load_table() -> List[Dict[str, Any]]:
    global _table
    if _table is None:
        with open(_TABLE_PATH) as f:
            _table = json.load(f)["entries"]
    return _table


def list_pretrained_saes(model: Optional[str] = None, family: Optional[str] = None,
                         layer: Optional[int] = None,
                         sublayer: Optional[str] = None) -> List[Dict[str, Any]]:
    """Rows of the published SAE table, filtered.  ``model``: 'clip-b-32' |
    'dino-b-32'; ``family``: 'vanilla-all-patches' | 'vanilla-cls-only' |
    'topk-cls-only-k64' | 'vanilla-spatial-patches'; ``sublayer``:
    'hook_resid_post' | 'hook_mlp_out'."""
    rows = _load_table()
    if model is not None:
        rows = [r for r in rows if r["model"] == model]
    if family is not None:
        rows = [r for r in rows if r["family"] == family]
    if layer is not None:
        rows = [r for r in rows if r["layer"] == layer]
    if sublayer is not None:
        rows = [r for r in rows if r["sublayer"] == sublayer]
    return list(rows)


def get_pretrained_sae_info(repo_id: str) -> Dict[str, Any]:
    """The table row for one published checkpoint (KeyError if unknown)."""
    for r in _load_table():
        if r["repo_id"] == repo_id:
            return dict(r)
    raise KeyError(f"unknown pretrained SAE: {repo_id!r} (see list_pretrained_saes())")


def load_pretrained_sae(repo_id: str, download_dir: str = "saes",
                        filename: str = "n_images_2600058.pt", device=None):
    """A published SAE as a :class:`SparseAutoencoder` on ``device`` (the
    CUDA card when None), through the reference-checkpoint importer.  A
    local directory ``repo_id`` holding ``filename`` is read as it is;
    otherwise the file is downloaded from the hub into ``download_dir``."""
    from vit_prisma_tpu_torch.sae.checkpoint_import import load_reference_sae_checkpoint
    if os.path.isdir(repo_id):
        path = os.path.join(repo_id, filename)
    else:
        from vit_prisma_tpu_torch.sae.hub import download_sae_from_huggingface
        path = download_sae_from_huggingface(repo_id, file_id=filename,
                                             download_dir=download_dir)
    return load_reference_sae_checkpoint(path, device=device)
