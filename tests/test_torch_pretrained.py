"""The pretrained-SAE registry and the hub tools, the port against the JAX
package: the port's copy of ``pretrained_saes.json`` equals JAX's byte for
byte, every query agrees, and without ``huggingface_hub`` the hub calls
raise JAX's ``ImportError``.  Nothing is fetched: the hub package is made
unimportable in every test that reaches a hub call, and the local paths are
files the tests write."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_prisma_tpu.sae.checkpoint_import as jax_import
import vit_prisma_tpu.sae.hub as jax_hub
import vit_prisma_tpu.sae.pretrained as jax_pretrained
import vit_prisma_tpu_torch.sae.hub as port_hub
import vit_prisma_tpu_torch.sae.pretrained as port_pretrained
from tests._torch_parity import seeded
from vit_prisma_tpu.sae import SAERunnerConfig as JaxSAEConfig
from vit_prisma_tpu.sae import SparseAutoencoder as JaxSAE
from vit_prisma_tpu_torch.sae import SparseAutoencoder

QUERIES = [dict(), dict(model="clip-b-32"), dict(model="dino-b-32"),
           dict(model="clip-b-32", family="vanilla-all-patches"),
           dict(model="clip-b-32", family="topk-cls-only-k64", layer=11),
           dict(family="vanilla-spatial-patches", sublayer="hook_mlp_out"),
           dict(layer=9, sublayer="hook_resid_post"), dict(model="nope")]


def test_table_copy_equals_jax_byte_for_byte():
    with open(port_pretrained._TABLE_PATH, "rb") as f, open(jax_pretrained._TABLE_PATH, "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("query", QUERIES, ids=lambda q: "-".join(map(str, q.values())) or "all")
def test_queries_match_jax(query):
    got = port_pretrained.list_pretrained_saes(**query)
    assert got == jax_pretrained.list_pretrained_saes(**query)
    for row in got[:3]:
        assert port_pretrained.get_pretrained_sae_info(row["repo_id"]) == \
            jax_pretrained.get_pretrained_sae_info(row["repo_id"])


def test_table_counts_and_unknown_repo():
    assert len(port_pretrained.list_pretrained_saes()) == 71
    assert len(port_pretrained.list_pretrained_saes(model="dino-b-32")) == 12
    for module in (port_pretrained, jax_pretrained):
        with pytest.raises(KeyError, match="unknown pretrained SAE"):
            module.get_pretrained_sae_info("nope/nothing")


@pytest.fixture
def no_hub(monkeypatch):
    """``huggingface_hub`` unimportable, so no hub call can reach the
    network."""
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)


def _import_error(fn):
    with pytest.raises(ImportError) as e:
        fn()
    return str(e.value)


def test_offline_hub_calls_raise_jax_error(no_hub, tmp_path):
    repo = port_pretrained.list_pretrained_saes(model="clip-b-32", layer=9)[0]["repo_id"]
    pairs = [
        (lambda: port_pretrained.load_pretrained_sae(repo, download_dir=str(tmp_path)),
         lambda: jax_pretrained.load_pretrained_sae(repo, download_dir=str(tmp_path))),
        (lambda: port_hub.download_sae_from_huggingface(repo, "a.pt", str(tmp_path)),
         lambda: jax_hub.download_sae_from_huggingface(repo, "a.pt", str(tmp_path))),
        (lambda: port_hub.upload_to_huggingface(str(tmp_path / "x"), "me/x", "d"),
         lambda: jax_hub.upload_to_huggingface(str(tmp_path / "x"), "me/x", "d")),
        (lambda: port_hub.load_remote_sae_and_model("me/not-a-dir", "sae.npz", model=object()),
         lambda: jax_hub.load_remote_sae_and_model("me/not-a-dir", "sae.npz", model=object())),
    ]
    for port_call, jax_call in pairs:
        msg = _import_error(port_call)
        assert msg == _import_error(jax_call)
        assert "huggingface_hub is required" in msg


def test_load_pretrained_sae_from_a_local_directory(no_hub, tmp_path):
    """A directory holding the published file name is read as it is: the
    reference importer, the same SAE as JAX's importer gives."""
    state = {"W_enc": torch.from_numpy(seeded(1, (16, 64), 0.3)),
             "b_enc": torch.from_numpy(seeded(2, (64,), 0.1)),
             "W_dec": torch.from_numpy(seeded(3, (64, 16), 0.3)),
             "b_dec": torch.from_numpy(seeded(4, (16,), 0.1))}
    cfg = {"d_in": 16, "expansion_factor": 4, "hook_point": "blocks.9.hook_resid_post",
           "use_ghost_grads": True}
    torch.save({"cfg": cfg, "state_dict": state}, str(tmp_path / "n_images_2600058.pt"))
    sae = port_pretrained.load_pretrained_sae(str(tmp_path), device="cpu")
    want = jax_import.load_reference_sae_checkpoint(str(tmp_path / "n_images_2600058.pt"))
    assert sae.cfg.to_dict() == want.cfg.to_dict() and sae.cfg.use_ghost_grads
    for k, v in want.params.items():
        np.testing.assert_array_equal(sae.params[k].numpy(), np.asarray(v), err_msg=k)


def test_load_remote_sae_and_model_from_a_local_directory(no_hub, tmp_path):
    """A local directory short-circuits the hub in both packages; the
    transcoder's file (the JAX ``.npz``) loads with its target slot's
    parameters."""
    fields = dict(d_in=16, expansion_factor=4, architecture="transcoder", is_transcoder=True,
                  d_out=16, b_dec_init_method="zeros")
    JaxSAE(JaxSAEConfig(**fields)).save_model(str(tmp_path / "sae.npz"))
    model = object()
    psae, pmodel = port_hub.load_remote_sae_and_model(str(tmp_path), "sae.npz", model=model,
                                                      device="cpu")
    jsae, _ = jax_hub.load_remote_sae_and_model(str(tmp_path), "sae.npz", model=model)
    assert pmodel is model and psae.cfg.to_dict() == jsae.cfg.to_dict()
    assert set(psae.params) == set(jsae.params) >= {"b_dec_out", "W_skip"}
    x = seeded(5, (4, 16))
    np.testing.assert_allclose(psae(torch.from_numpy(x)).sae_out.numpy(),
                               np.asarray(jsae(jnp.asarray(x)).sae_out), rtol=0, atol=1e-5)
    assert isinstance(psae, SparseAutoencoder) and os.path.exists(tmp_path / "sae.npz")
