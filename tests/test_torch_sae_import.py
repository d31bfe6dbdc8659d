"""The SAE import tools, the port against the JAX package: the same
synthetic reference-format checkpoints (``{"cfg": VisionModelSAERunnerConfig
object, "state_dict": ...}`` as ``.pt``, ``.pkl`` and ``.pkl.gz``) and
legacy SAELens-v2 dumps go through both importers, and the configs and
parameters must be equal.  The reference's config class is pickled from a
stand-in module that is gone when the file is read, as ``vit_prisma`` is
here, so the tolerant unpickler's attribute bag is what both read.  The
configs carry the run's options the port now takes (ghost grads, the
normalizations, transcoders); the loaded SAEs' forwards agree within 1e-5
of max(1, each value's absmax) (float32)."""

import gzip
import pickle
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_prisma_tpu.sae.checkpoint_import as jax_import
import vit_prisma_tpu_torch.sae.checkpoint_import as port_import
from tests._torch_parity import assert_close, seeded
from vit_prisma_tpu.sae.sae import sae_forward as jax_sae_forward
from vit_prisma_tpu_torch.sae import SAERunnerConfig
from vit_prisma_tpu_torch.sae.sae import sae_forward as port_sae_forward

ATOL = 1e-5
D_IN, D_SAE = 16, 64


class VisionModelSAERunnerConfig:
    """Stands in for the reference's config class; pickled as if it lived
    in ``vit_prisma.sae.config``."""

    def __init__(self, **fields):
        self.__dict__.update(fields)


class HookedViTConfig:
    def __init__(self, **fields):
        self.__dict__.update(fields)


def _reference_module(monkeypatch):
    """Install ``vit_prisma.sae.config`` with the stand-in classes, so that
    pickle writes them by that name."""
    mods = {name: types.ModuleType(name)
            for name in ("vit_prisma", "vit_prisma.sae", "vit_prisma.sae.config")}
    for cls in (VisionModelSAERunnerConfig, HookedViTConfig):
        setattr(mods["vit_prisma.sae.config"], cls.__name__, cls)
        monkeypatch.setattr(cls, "__module__", "vit_prisma.sae.config")
    for name, mod in mods.items():
        monkeypatch.setitem(sys.modules, name, mod)


def _state(fields, seed=0):
    d_out = fields.get("d_out", D_IN)
    shapes = {"W_enc": (D_IN, D_SAE), "b_enc": (D_SAE,), "W_dec": (D_SAE, d_out),
              "b_dec": (D_IN,)}
    if fields.get("architecture") == "gated":
        shapes.update(b_gate=(D_SAE,), r_mag=(D_SAE,), b_mag=(D_SAE,))
    if fields.get("architecture") == "transcoder":
        shapes["b_dec_out"] = (d_out,)
        if fields.get("transcoder_with_skip_connection", True):
            shapes["W_skip"] = (D_IN, D_IN)
    return {k: torch.from_numpy(seeded(seed + i, s, 0.3)) for i, (k, s) in
            enumerate(sorted(shapes.items()))}


REFERENCE_CFGS = {
    "ghost_layer_norm": dict(use_ghost_grads=True, normalize_activations="layer_norm",
                             hook_point="blocks.7.hook_resid_post"),
    "constant_norm_rescale": dict(normalize_activations="constant_norm_rescale",
                                  hook_point_layer=[4], layer_subtype="hook_mlp_out"),
    "transcoder": dict(architecture="transcoder", is_transcoder=True, d_out=D_IN,
                       hook_point="blocks.9.hook_resid_mid", out_hook_point_layer=9,
                       layer_out_subtype="hook_mlp_out", use_ghost_grads=True),
    "transcoder_no_skip": dict(architecture="transcoder", is_transcoder=True, d_out=24,
                               transcoder_with_skip_connection=False, hook_point_layer=3),
    "gated": dict(architecture="gated", l1_coefficient=3e-4),
    "topk_approx": dict(activation_fn_str="topk", activation_fn_kwargs={"k": 4},
                        topk_use_approx=True),
}


def _write(path, obj):
    if path.endswith(".pkl.gz"):
        with gzip.open(path, "wb") as f:
            pickle.dump(obj, f)
    elif path.endswith(".pkl"):
        with open(path, "wb") as f:
            pickle.dump(obj, f)
    else:
        torch.save(obj, path)


def _reference_file(tmp_path, monkeypatch, fields, suffix=".pt"):
    _reference_module(monkeypatch)
    cfg = VisionModelSAERunnerConfig(
        d_in=D_IN, expansion_factor=D_SAE // D_IN, _device="cpu", _dtype=torch.float32,
        log_to_wandb=False, feature_sampling_method="dropped-field",
        vit_model_cfg=HookedViTConfig(d_model=D_IN, n_layers=12),
        **{"l1_coefficient": 1e-3, **fields})
    path = str(tmp_path / f"ref_sae{suffix}")
    _write(path, {"cfg": cfg, "state_dict": _state(fields)})
    for name in ("vit_prisma.sae.config", "vit_prisma.sae", "vit_prisma"):
        monkeypatch.delitem(sys.modules, name)  # gone when the file is read
    return path


def _assert_same_sae(jsae, psae, fields):
    assert psae.cfg == SAERunnerConfig.from_dict(jsae.cfg.to_dict())
    assert psae.cfg.to_dict() == jsae.cfg.to_dict()
    assert set(psae.params) == set(jsae.params)
    for k, v in jsae.params.items():
        assert psae.params[k].dtype == torch.float32
        np.testing.assert_array_equal(psae.params[k].numpy(), np.asarray(v), err_msg=k)
    x = seeded(5, (6, D_IN))
    y = seeded(6, (6, psae.cfg.d_out)) if psae.cfg.is_transcoder else None
    want = jax_sae_forward(jsae.params, jsae.cfg, jnp.asarray(x),
                           y=None if y is None else jnp.asarray(y), training=False)
    got = port_sae_forward(psae.params, psae.cfg, torch.from_numpy(x),
                           y=None if y is None else torch.from_numpy(y), training=False)
    for field in ("sae_out", "feature_acts", "loss", "mse_loss"):
        w = np.asarray(getattr(want, field))
        assert_close(w, getattr(got, field), ATOL * max(1.0, float(np.abs(w).max())), field)


@pytest.mark.parametrize("variant", list(REFERENCE_CFGS))
def test_reference_checkpoint_loads_as_in_jax(tmp_path, monkeypatch, variant):
    fields = REFERENCE_CFGS[variant]
    path = _reference_file(tmp_path, monkeypatch, fields)
    jsae = jax_import.load_reference_sae_checkpoint(path)
    psae = port_import.load_reference_sae_checkpoint(path, device="cpu")
    _assert_same_sae(jsae, psae, fields)
    assert psae.cfg.d_sae == D_SAE and psae.cfg.dtype == "float32"
    for k, v in fields.items():
        if k not in ("hook_point", "hook_point_layer"):
            assert getattr(psae.cfg, k) == (tuple(v.items()) if isinstance(v, dict) else v), k


@pytest.mark.parametrize("suffix", [".pkl", ".pkl.gz"])
def test_pickled_reference_checkpoints_load_as_in_jax(tmp_path, monkeypatch, suffix):
    fields = REFERENCE_CFGS["transcoder"]
    path = _reference_file(tmp_path, monkeypatch, fields, suffix)
    _assert_same_sae(jax_import.load_reference_sae_checkpoint(path),
                     port_import.load_reference_sae_checkpoint(path, device="cpu"), fields)


def test_reference_checkpoint_without_d_in_and_with_override(tmp_path):
    """No config fields: d_in and the expansion come from W_enc's shape;
    ``cfg_override`` wins over the file's fields in both packages."""
    path = str(tmp_path / "bare.pt")
    torch.save({"state_dict": _state({})}, path)
    jsae = jax_import.load_reference_sae_checkpoint(path, cfg_override={"hook_point_layer": 2})
    psae = port_import.load_reference_sae_checkpoint(path, cfg_override={"hook_point_layer": 2},
                                                     device="cpu")
    _assert_same_sae(jsae, psae, {})
    assert psae.cfg.d_in == D_IN and psae.cfg.hook_point_layer == 2
    torch.save({"weights": 1}, path)
    for load in (jax_import.load_reference_sae_checkpoint,
                 lambda p: port_import.load_reference_sae_checkpoint(p, device="cpu")):
        with pytest.raises(ValueError, match="Unrecognized checkpoint structure"):
            load(path)


@pytest.mark.parametrize("config_as", ["dict", "object"])
def test_legacy_saelens_v2_loads_as_in_jax(tmp_path, monkeypatch, config_as):
    """The legacy map turns ghost grads on by default: the port's SAE now
    takes such a config, and its ghost loss runs in training."""
    config = {"d_in": D_IN, "expansion_factor": D_SAE // D_IN,
              "hook_point": "blocks.3.hook_mlp_out", "l1_coefficient": 5e-4,
              "feature_sampling_method": "dropped-field", "dtype": torch.float32}
    if config_as == "object":
        _reference_module(monkeypatch)
        config = VisionModelSAERunnerConfig(**config)
    path = str(tmp_path / "legacy.pt")
    torch.save({"config": config, "autoencoder": {"state_dict": _state({}, seed=9)}}, path)
    if config_as == "object":
        for name in ("vit_prisma.sae.config", "vit_prisma.sae", "vit_prisma"):
            monkeypatch.delitem(sys.modules, name)
    jsae = jax_import.load_legacy_saelens_v2(path)
    psae = port_import.load_legacy_saelens_v2(path, device="cpu")
    _assert_same_sae(jsae, psae, {})
    assert psae.cfg.use_ghost_grads and psae.cfg.hook_point == "blocks.3.hook_mlp_out"
    assert psae.cfg.initialization_method == "encoder_transpose_decoder"
    out = port_sae_forward(psae.params, psae.cfg, torch.from_numpy(seeded(6, (8, D_IN))),
                      dead_neuron_mask=torch.ones(D_SAE, dtype=torch.bool))
    assert float(out.ghost_grad_loss) > 0
    torch.save({"config": {}}, path)
    with pytest.raises(ValueError, match="'config' and 'autoencoder'"):
        port_import.load_legacy_saelens_v2(path, device="cpu")
