"""The port's tensor-parallel ViT in gloo worlds of 4 and 2 processes on the
CPU (``tests/_torch_dist.py``), against the JAX package's mesh of the same
shape on its 8 virtual CPU devices and the port's world of one: the forward,
the cache per hook name (head- and d_mlp-indexed entries whole),
``HookedViT.shard``, ``shard_vit_forward``, ``incl_bwd``, an editing hook,
the misaligned-heads case and the fused LN-GEMM route; then the multi-host
ordering on stub ranks and ``distributed_init`` as a no-op."""

import jax
import numpy as np
import pytest

import vit_prisma_tpu as jax_pkg
from tests._torch_dist import run_world, vit_cases
from tests._torch_parity import port_from_jax
from vit_prisma_tpu.parallel import batch_sharding, make_mesh as jax_make_mesh
from vit_prisma_tpu.parallel import shard_vit_forward as jax_shard_vit_forward
from vit_prisma_tpu.parallel import vit_param_shardings
from vit_prisma_tpu_torch.parallel import mesh as M

BASE = dict(n_layers=2, d_model=32, d_head=8, n_heads=4, d_mlp=64, patch_size=4,
            image_size=8, n_classes=6, return_type="logits")
MODELS = {
    "base": BASE,
    # 3 heads: a 2- or 4-way model axis keeps attention whole
    "misaligned": dict(BASE, d_model=24, n_heads=3),
    "fused_ln": dict(BASE, use_fused_ln_gemm=True, d_head=32, d_model=128, n_heads=4,
                     d_mlp=256, layer_norm_pre=True),
}
ATOL = 1e-5


def _images(n=8, seed=1):
    return np.random.default_rng(seed).normal(size=(n, 3, 8, 8)).astype(np.float32)


def _models():
    out = {}
    for name, fields in MODELS.items():
        jm = jax_pkg.HookedViT(jax_pkg.ViTConfig(**fields), key=jax.random.PRNGKey(0))
        pm = port_from_jax(jm)
        sd = {k: v.detach().clone() for k, v in pm.state_dict().items()}
        out[name] = (jm, pm, (pm.cfg.to_dict(), sd))
    return out


@pytest.fixture(scope="module")
def setup():
    models = _models()
    images = _images()
    single = {name: vit_cases(pm, images) for name, (_, pm, _) in models.items()}
    return models, images, single


@pytest.fixture(scope="module")
def world4(setup, tmp_path_factory):
    models, images, _ = setup
    payload = {"meshes": [(2, 2), (1, 4), (4, 1)], "images": images,
               "models": {n: m[2] for n, m in models.items()}}
    return run_world(tmp_path_factory.mktemp("w4"), 4, "vit_world", payload)[0]


@pytest.fixture(scope="module")
def world2(setup, tmp_path_factory):
    models, images, _ = setup
    payload = {"meshes": [(1, 2), (2, 1)], "images": images,
               "models": {n: m[2] for n, m in models.items()}}
    return run_world(tmp_path_factory.mktemp("w2"), 2, "vit_world", payload)[0]


def _compare(want, got, atol=ATOL, where=""):
    if isinstance(want, dict):
        assert list(got) == list(want), where
        for k in want:
            _compare(want[k], got[k], atol, f"{where}/{k}")
        return
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=where)


CASES = [((2, 2), "base"), ((1, 4), "base"), ((4, 1), "base"), ((2, 2), "misaligned"),
         ((1, 4), "misaligned"), ((1, 4), "fused_ln")]


@pytest.mark.parametrize("shape,name", CASES)
def test_sharded_vit_matches_world_of_one(setup, world4, shape, name):
    """Forward, stop_at_layer, the whole-tensor cache of every head- and
    d_mlp-indexed hook, incl_bwd gradients and an editing hook: the world
    of 4 equals the port's world of one."""
    _, _, single = setup
    got = world4[(shape, name)]
    for key in ("logits", "stop1", "cache", "grad_cache", "edited"):
        _compare(single[name][key], got[key], ATOL, f"{shape}/{name}/{key}")


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
@pytest.mark.parametrize("name", ["base", "misaligned"])
def test_sharded_vit_world_of_two(setup, world2, shape, name):
    _, _, single = setup
    got = world2[(shape, name)]
    for key in ("logits", "cache", "grad_cache", "edited"):
        _compare(single[name][key], got[key], ATOL, f"{shape}/{name}/{key}")


def test_shard_keeps_local_heads_and_columns(world4, world2):
    """4 heads over model=4 -> 1 local head; 3 heads do not divide -> whole
    attention, d_mlp still split."""
    assert world4[((1, 4), "base")]["n_heads_local"] == 1
    assert world4[((1, 4), "base")]["d_mlp_local"] == 16
    assert world4[((2, 2), "base")]["n_heads_local"] == 2
    assert world4[((1, 4), "misaligned")]["n_heads_local"] == 3
    assert world4[((1, 4), "misaligned")]["d_mlp_local"] == 16
    assert world2[((1, 2), "base")]["n_heads_local"] == 2
    assert world4[((4, 1), "base")]["n_heads_local"] == 4


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_sharded_vit_matches_jax_mesh(setup, world4, shape):
    """The JAX package's sharded forward and cached forward on its mesh of
    the same shape (GSPMD) against the port's world of 4."""
    models, images, _ = setup
    jm = models["base"][0]
    mesh = jax_make_mesh(*shape)
    params = jax.device_put(jm.params, vit_param_shardings(mesh, jm.params))
    x = jax.device_put(images, batch_sharding(mesh))
    want = np.asarray(jax_shard_vit_forward(jm, mesh)(params, x))
    _compare(want, world4[(shape, "base")]["logits"], ATOL, "logits")
    _, cache = jax_shard_vit_forward(jm, mesh, names_filter=lambda n: "resid_post" in n)(
        params, x)
    for k, v in cache.items():
        _compare(np.asarray(v), world4[(shape, "base")]["cache"][k], ATOL, k)
    got = world4[(shape, "shard_vit_forward")]
    _compare(want, got["logits"], ATOL, "shard_vit_forward")
    _compare(np.asarray(cache["blocks.1.hook_resid_post"]),
             got["cache"]["blocks.1.hook_resid_post"], ATOL, "shard_vit_forward cache")


def test_sharded_incl_bwd_matches_jax_mesh(setup, world4):
    """JAX's run_with_cache(incl_bwd=True) under its (2, 2) mesh against the
    port's: activations and gradient entries of resid_post."""
    models, images, _ = setup
    jm = jax_pkg.HookedViT(jax_pkg.ViTConfig(**BASE), key=jax.random.PRNGKey(0))
    jm.shard(jax_make_mesh(2, 2))
    x = jax.device_put(images, batch_sharding(jax_make_mesh(2, 2)))
    _, ref = jm.run_with_cache(x, names_filter=lambda n: n.endswith("hook_resid_post"),
                               incl_bwd=True, return_cache_object=False)
    got = world4[((2, 2), "base")]["grad_cache"]
    for k in ref:
        _compare(np.asarray(ref[k]), got[k], ATOL, k)


# -- in-process: a world of one, plans, multi-host ordering ----------------

def test_world_of_one_mesh_is_the_unsharded_model(setup):
    models, images, single = setup
    _, pm, (cfg, sd) = models["base"]
    from tests._torch_dist import vit_model
    m = vit_model(cfg, sd).shard(M.make_mesh(1, 1, device="cpu"))
    got = vit_cases(m, images)
    for key in ("logits", "cache", "grad_cache", "edited"):
        _compare(single["base"][key], got[key], 0.0, key)
    with pytest.raises(ValueError, match="already sharded"):
        m.shard(M.make_mesh(1, 1, device="cpu"))


def test_vit_plan_mirrors_jax():
    _, pm, _ = _models()["base"]
    plan = M.vit_param_shardings(M.make_mesh(1, 1, device="cpu"), pm)
    assert plan["blocks.0.attn.W_Q"].spec == ("model",)
    assert plan["blocks.1.attn.b_V"].spec == ("model",)
    assert plan["blocks.0.attn.W_O"].spec == ("model",)
    assert plan["blocks.0.attn.b_O"].spec == ()
    assert plan["blocks.0.mlp.W_in"].spec == (None, "model")
    assert plan["blocks.0.mlp.W_out"].spec == ("model",)
    assert plan["blocks.0.mlp.b_out"].spec == ()
    assert plan["embed.W"].spec == () and plan["head.W_H"].spec == ()


class _StubRank:
    def __init__(self, i, host=None):
        self.rank = i
        if host is not None:
            self.host = host


class TestMultiHostMesh:
    def test_model_axis_never_crosses_hosts(self):
        ranks = [_StubRank(i, host=f"h{i % 2}") for i in range(16)]
        arr = M.multislice_device_array(ranks, model=4)
        assert arr.shape == (4, 4)
        for row in arr:
            assert len({r.host for r in row}) == 1
        hosts = [row[0].host for row in arr]
        assert hosts == sorted(hosts)
        assert {r.rank for r in arr.ravel()} == set(range(16))

    def test_ordering_matches_jax(self):
        from vit_prisma_tpu.parallel.mesh import multislice_device_array as jax_msda

        class JaxStub:
            def __init__(self, i, s):
                self.id, self.slice_index, self.process_index = i, s, 0

        jarr = jax_msda([JaxStub(i, i % 2) for i in range(16)], model=4)
        parr = M.multislice_device_array([_StubRank(i, host=i % 2) for i in range(16)], model=4)
        assert [[d.id for d in row] for row in jarr] == [[r.rank for r in row] for row in parr]

    def test_model_must_fit_one_host(self):
        ranks = [_StubRank(i, host=i // 4) for i in range(8)]
        with pytest.raises(ValueError, match="model"):
            M.multislice_device_array(ranks, model=8)

    def test_uneven_hosts_rejected(self):
        ranks = [_StubRank(i, host=0) for i in range(4)] + [_StubRank(9, host=1)]
        with pytest.raises(ValueError, match="uneven"):
            M.multislice_device_array(ranks, model=1)

    def test_single_host_reduces_to_make_mesh(self):
        m = M.make_multislice_mesh(model=1, device="cpu")
        assert tuple(m.shape) == (1, 1) and m.mesh_dim_names == ("data", "model")

    def test_distributed_init_single_process_noop(self, monkeypatch):
        monkeypatch.delenv("WORLD_SIZE", raising=False)
        import torch.distributed as dist
        expect = dist.is_initialized() and dist.get_world_size() > 1
        assert M.distributed_init() is expect
        assert M.distributed_init() is expect
        assert jax.device_count() == 8  # the JAX platform untouched
