"""The port's serving surface against the JAX package's, and the port's
promise to import no JAX."""

import os
import subprocess
import sys

import pytest
import torch

import vit_prisma_tpu
import vit_prisma_tpu_torch
from tests._torch_parity import assert_caches_close, assert_close, jax_and_port, seeded

CFG = dict(n_layers=2, d_model=32, d_head=8, n_heads=4, d_mlp=64,
           patch_size=8, image_size=16, n_classes=7, return_type="class_logits")


@pytest.mark.parametrize("names_filter", [None, "resid_post"])
@pytest.mark.parametrize("n", [3, 4, 9])
def test_compiled_forward_matches_jax(n, names_filter):
    nf = (lambda name: "resid_post" in name) if names_filter else None
    jax_model, port = jax_and_port(**CFG)
    x = seeded(n, (n, 3, 16, 16))
    want = vit_prisma_tpu.CompiledForward(jax_model, batch_size=4, names_filter=nf)(x)
    got = vit_prisma_tpu_torch.CompiledForward(port, batch_size=4, names_filter=nf)(x)
    if nf is None:
        assert tuple(got.shape) == (n, 7)
        assert_close(want, got, 1e-4, "output")
        return
    (want_out, want_cache), (got_out, got_cache) = want, got
    assert_close(want_out, got_out, 1e-4, "output")
    # JAX returns the cache through jit, which sorts its keys
    assert list(got_cache) == [f"blocks.{l}.hook_resid_post" for l in range(2)]
    assert_caches_close(want_cache, {k: got_cache[k] for k in sorted(got_cache)}, 1e-4)
    assert tuple(got_cache["blocks.1.hook_resid_post"].shape) == (n, 5, 32)


def test_compiled_forward_casts_requests_to_parameter_dtype():
    port = vit_prisma_tpu_torch.HookedViT(
        vit_prisma_tpu_torch.ViTConfig(**CFG, dtype="bfloat16"), device="cpu")
    out = vit_prisma_tpu_torch.CompiledForward(port, batch_size=4)(seeded(0, (5, 3, 16, 16)))
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (5, 7)


def test_import_loads_no_jax():
    code = ("import sys, vit_prisma_tpu_torch; "
            "bad = sorted(m for m in sys.modules if m.startswith('jax')); "
            "assert not bad, bad")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=root)


EXPORT_ATOL = 1e-5


def _eager(port, x, names_filter):
    if names_filter is None:
        return port(x)
    return port.run_with_cache(x, names_filter=names_filter)


@pytest.mark.parametrize("names_filter", [None, "resid_post"])
@pytest.mark.parametrize("batch_size,batches", [(None, (1, 3, 6)), (5, (5,))],
                         ids=["polymorphic", "fixed"])
def test_export_forward_matches_eager(tmp_path, batch_size, batches, names_filter):
    """The artifact, loaded from bytes and from its file, against the eager
    forward on the plain routes: batch 1, odd batches and a fixed size."""
    nf = (lambda name: "resid_post" in name) if names_filter else None
    _, port = jax_and_port(**CFG)
    path = str(tmp_path / "forward.pt2")
    data = vit_prisma_tpu_torch.export_forward(port, batch_size=batch_size,
                                               names_filter=nf, path=path)
    assert isinstance(data, bytes) and open(path, "rb").read() == data
    for fwd in (vit_prisma_tpu_torch.load_forward(data), vit_prisma_tpu_torch.load_forward(path)):
        for n in batches:
            x = torch.from_numpy(seeded(n, (n, 3, 16, 16)))
            got, want = fwd(x), _eager(port, x, nf)
            if nf is None:
                assert tuple(got.shape) == (n, 7)
                assert_close(want, got, EXPORT_ATOL, "output")
                continue
            (got_out, got_cache), (want_out, want_cache) = got, want
            assert_close(want_out, got_out, EXPORT_ATOL, "output")
            assert list(got_cache) == [f"blocks.{l}.hook_resid_post" for l in range(2)]
            for k in want_cache:
                assert_close(want_cache[k], got_cache[k], EXPORT_ATOL, k)


def test_export_forward_takes_the_plain_routes(monkeypatch):
    """The exported forward runs the einsum attention and the unfused
    LayerNorm, whatever the model's config asks for, and matches the
    kernel-route forward of the same weights."""
    from vit_prisma_tpu_torch.models import layers as port_layers
    fields = dict(CFG, use_fused_ln_gemm=True)
    _, port = jax_and_port(**fields)
    called = []
    for name in ("_fused_attention", "_fused_ln_attention", "_flash_attention_long"):
        monkeypatch.setattr(port_layers, name,
                            lambda *a, _n=name, **k: called.append(_n))
    fwd = vit_prisma_tpu_torch.load_forward(vit_prisma_tpu_torch.export_forward(port))
    assert called == []
    monkeypatch.undo()
    x = torch.from_numpy(seeded(3, (3, 3, 16, 16)))
    assert_close(port(x), fwd(x), EXPORT_ATOL, "output")


def test_with_cfg_shares_the_weights_and_overrides_the_routes():
    """A route override shares the model's parameters (no copy) and leaves
    the model's own config and blocks as they were."""
    _, port = jax_and_port(**dict(CFG, use_fused_ln_gemm=True))
    plain = port.with_cfg(use_fused_attention=False, use_fused_ln_gemm=False)
    assert not plain.cfg.use_fused_attention and not plain.cfg.use_fused_ln_gemm
    assert all(not b.cfg.use_fused_ln_gemm for b in plain.blocks)
    assert port.cfg.use_fused_attention and port.cfg.use_fused_ln_gemm
    assert all(b.cfg is port.cfg for b in port.blocks)
    ours, theirs = dict(port.named_parameters()), dict(plain.named_parameters())
    assert list(ours) == list(theirs)
    assert all(ours[k] is theirs[k] for k in ours)
    x = torch.from_numpy(seeded(2, (2, 3, 16, 16)))
    assert_close(port(x), plain(x), EXPORT_ATOL, "output")


def test_counted_kernels_lists_every_counted_wrapper():
    """The registry the graphed server reads its launches from holds every
    function of the port's ops modules that counts its launches."""
    import importlib
    import pkgutil
    from vit_prisma_tpu_torch import ops
    registry = ops.counted_kernels()
    found = {}
    for info in pkgutil.iter_modules(ops.__path__):
        module = importlib.import_module(f"vit_prisma_tpu_torch.ops.{info.name}")
        for name, f in vars(module).items():
            if callable(f) and hasattr(f, "launches") and f.__module__ == module.__name__:
                found[name] = f
    assert found and registry == found
