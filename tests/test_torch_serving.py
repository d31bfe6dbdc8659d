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
