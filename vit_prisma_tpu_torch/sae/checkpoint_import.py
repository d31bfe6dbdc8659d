"""Import SAE checkpoints saved by the PyTorch reference (and legacy
SAELens-v2 dumps) into :class:`SparseAutoencoder` (PyTorch port of
``vit_prisma_tpu/sae/checkpoint_import.py``).

The reference pickles its ``VisionModelSAERunnerConfig`` *object* inside the
checkpoint; it is unpickled tolerantly (a class that does not import, as
``vit_prisma``'s do not here, becomes an attribute bag), then its fields are
mapped onto :class:`SAERunnerConfig`.  Such a config carries the whole run's
options (ghost grads, normalization, transcoder fields), which the port's
SAE takes.  Parameter names (W_enc/b_enc/W_dec/b_dec, gated
b_gate/r_mag/b_mag, transcoder W_skip/b_dec_out) are the reference's.
Parameters load as float32 onto ``device`` (the CUDA card when None).
"""

from __future__ import annotations

import gzip
import pickle
import re
from typing import Any, Dict, Optional

import numpy as np
import torch

from vit_prisma_tpu_torch.sae.config import SAERunnerConfig
from vit_prisma_tpu_torch.sae.sae import SparseAutoencoder
from vit_prisma_tpu_torch.utils.device import resolve_device


class _Bag:
    """Attribute bag standing in for any unpicklable class."""

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        elif isinstance(state, tuple) and len(state) == 2 and isinstance(state[1], dict):
            self.__dict__.update(state[1])

    def __reduce__(self):  # pragma: no cover
        return (_Bag, ())


class _TolerantUnpickler(pickle.Unpickler):
    _ALLOW = ("collections", "builtins", "numpy", "torch", "copyreg")

    def find_class(self, module, name):
        if module.split(".")[0] in self._ALLOW:
            try:
                return super().find_class(module, name)
            except Exception:
                pass
        return _Bag


class _TolerantPickleModule:
    Unpickler = _TolerantUnpickler

    @staticmethod
    def load(f, **kw):
        kw.pop("encoding", None)
        return _TolerantUnpickler(f).load()


def _load_checkpoint_obj(path: str):
    if path.endswith(".pkl.gz"):
        with gzip.open(path, "rb") as f:
            return _TolerantUnpickler(f).load()
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            return _TolerantUnpickler(f).load()
    return torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=_TolerantPickleModule)


def _cfg_obj_to_dict(cfg_obj) -> Dict[str, Any]:
    d = dict(getattr(cfg_obj, "__dict__", cfg_obj if isinstance(cfg_obj, dict) else {}))
    # the reference keeps some fields underscored behind properties
    if "_dtype" in d:
        d["dtype"] = d.pop("_dtype")
    d.pop("_device", None)
    d.pop("device", None)
    if not isinstance(d.get("dtype", "float32"), str):
        d["dtype"] = str(d.get("dtype", "float32")).replace("torch.", "")
    hp = d.get("hook_point_layer")
    if isinstance(hp, (list, tuple)) and len(hp) == 1:
        d["hook_point_layer"] = hp[0]
    # layer and subtype from a stored full hook point
    full_hp = d.pop("_custom_hook_point", None) or d.pop("hook_point", None)
    if isinstance(full_hp, str):
        m = re.match(r"blocks\.(\d+)\.(.+)", full_hp)
        if m:
            d["hook_point_layer"] = int(m.group(1))
            d["layer_subtype"] = m.group(2)
    d.pop("vit_model_cfg", None)
    return d


def _to_params(state_dict) -> Dict[str, torch.Tensor]:
    """float32 tensors on the host, as the JAX importer's float32 arrays."""
    out = {}
    for k, v in state_dict.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.detach().cpu().float().clone()
        else:
            out[k] = torch.from_numpy(np.array(v, np.float32))
    return out


def load_reference_sae_checkpoint(path: str, cfg_override: Optional[Dict[str, Any]] = None,
                                  device=None) -> SparseAutoencoder:
    """Load a reference ``save_model`` checkpoint ({"cfg":
    VisionModelSAERunnerConfig, "state_dict": ...}) onto ``device``."""
    obj = _load_checkpoint_obj(path)
    if not (isinstance(obj, dict) and "state_dict" in obj):
        raise ValueError(f"Unrecognized checkpoint structure at {path}: {type(obj)}")
    cfg_dict = _cfg_obj_to_dict(obj.get("cfg", {}))
    if cfg_override:
        cfg_dict.update(cfg_override)
    cfg = SAERunnerConfig.from_dict(cfg_dict)
    params = _to_params(obj["state_dict"])
    if "d_in" not in cfg_dict and "W_enc" in params:
        cfg = cfg.replace(d_in=int(params["W_enc"].shape[0]),
                          expansion_factor=int(params["W_enc"].shape[1] //
                                               params["W_enc"].shape[0]))
    return SparseAutoencoder(cfg, params=params, device=resolve_device(device))


def load_legacy_saelens_v2(path: str, cfg_override: Optional[Dict[str, Any]] = None,
                           device=None) -> SparseAutoencoder:
    """Load a legacy SAELens-v2 dump ({"config": ..., "autoencoder":
    {"state_dict": ...}}) with the reference's field map (its defaults turn
    ghost grads on) onto ``device``."""
    obj = _load_checkpoint_obj(path)
    if not (isinstance(obj, dict) and "config" in obj and "autoencoder" in obj):
        raise ValueError("legacy checkpoint must contain 'config' and 'autoencoder'")
    old = obj["config"]
    if not isinstance(old, dict):
        old = dict(getattr(old, "__dict__", {}))
    cfg_dict: Dict[str, Any] = {
        "model_class_name": "HookedViT",
        "context_size": 50,
        "activation_fn_str": "relu",
        "initialization_method": "encoder_transpose_decoder",
        "b_dec_init_method": "geometric_median",
        "expansion_factor": 16,
        "use_ghost_grads": True,
        "feature_sampling_window": 300,
        "dead_feature_window": 5000,
        "log_to_wandb": False,
    }
    for k, v in old.items():
        if k == "hook_point" and isinstance(v, str):
            m = re.match(r"blocks\.(\d+)\.(.+)", v)
            if m:
                cfg_dict["hook_point_layer"] = int(m.group(1))
                cfg_dict["layer_subtype"] = m.group(2)
            continue
        cfg_dict[k] = v
    if cfg_override:
        cfg_dict.update(cfg_override)
    if not isinstance(cfg_dict.get("dtype", "float32"), str):
        cfg_dict["dtype"] = str(cfg_dict["dtype"]).replace("torch.", "")
    cfg = SAERunnerConfig.from_dict(cfg_dict)
    params = _to_params(obj["autoencoder"]["state_dict"])
    return SparseAutoencoder(cfg, params=params, device=resolve_device(device))
