"""The port's gradient paths against the JAX package's:
``run_with_cache(incl_bwd=True)`` per ``{name}_grad`` key in float32, the
backward editors (``bwd_hooks``), the discarded (``editable=False``) sites,
``loss_fn``, ``stop_at_layer`` and the key order.  The same numpy inputs and
weights go through both; JAX's fused attention runs its Pallas kernels (B1,
B2) in interpret mode, the port's their plain versions.

Tolerances: activations within 1e-4 (as ``test_torch_vit.py``); each
gradient within 1e-5 of max(1, its absmax): the two differ in summation
order only, and the LayerNorm scale gradients reach ~1e2."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import assert_close, jax_and_port, seeded
from vit_prisma_tpu_torch import HookRuntime, vit_forward
from vit_prisma_tpu_torch.ops import attention as port_ops

ACT_ATOL = 1e-4
GRAD_REL = 1e-5
BASE = dict(n_layers=2, d_model=32, d_head=8, n_heads=4, d_mlp=64,
            patch_size=8, image_size=16, n_classes=7, return_type="logits")
# Hook classes of the JAX package's tests/test_backward_hooks.py.
CLASSES = {
    "resid": (lambda n: "resid" in n, {}),
    "attn": (lambda n: ".attn." in n, {}),
    "mlp": (lambda n: "mlp" in n, dict(use_hook_mlp_in=True)),
    "embed_ln": (lambda n: "embed" in n or "ln" in n, dict(layer_norm_pre=True)),
    "all": (None, {}),
}


def _x(seed=1):
    return seeded(seed, (2, 3, 16, 16))


def _assert_cache_matches(want, got):
    assert list(got) == list(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == tuple(w.shape), k
        if k.endswith("_grad"):
            atol = GRAD_REL * max(1.0, float(np.abs(np.asarray(w, np.float32)).max()))
        else:
            atol = ACT_ATOL
        assert_close(w, got[k], atol, k)


def _run_both(names_filter, cfg=None, port_kw=None, **kw):
    """Both models on the same image batch; ``port_kw`` overrides ``kw`` on
    the port's side (hooks that must build a tensor of its own kind)."""
    jax_model, port = jax_and_port(**{**BASE, **(cfg or {})})
    x = _x()
    want_out, want = jax_model.run_with_cache(
        jnp.asarray(x), names_filter=names_filter, return_cache_object=False, **kw)
    got_out, got = port.run_with_cache(torch.from_numpy(x), names_filter=names_filter,
                                       **{**kw, **(port_kw or {})})
    return want_out, want, got_out, got, port


@pytest.mark.parametrize("hook_class", list(CLASSES))
def test_grad_cache_matches_jax(hook_class):
    names, cfg = CLASSES[hook_class]
    want_out, want, got_out, got, _ = _run_both(names, cfg, incl_bwd=True)
    assert any(k.endswith("_grad") for k in want)
    _assert_cache_matches(want, got)
    assert_close(want_out, got_out, ACT_ATOL, "output")
    assert not got_out.requires_grad and not any(v.requires_grad for v in got.values())


def test_fused_route_grads_match_jax_and_einsum_path():
    # resid_post hooks only: both sides take the fused mix in both directions
    names = lambda n: n.endswith("hook_resid_post")
    before = (port_ops.attention_mix_tnh.launches, port_ops.attention_mix_tnh_bwd.launches)
    want_out, want, got_out, got, port = _run_both(names, dict(layer_norm_pre=True),
                                                   incl_bwd=True)
    assert (port_ops.attention_mix_tnh.launches,
            port_ops.attention_mix_tnh_bwd.launches) == before  # CPU: plain versions
    _assert_cache_matches(want, got)
    einsum = type(port)(port.cfg.replace(use_fused_attention=False), device="cpu")
    einsum.load_state_dict(port.state_dict())
    _, plain = einsum.run_with_cache(torch.from_numpy(_x()), names_filter=names, incl_bwd=True)
    for k in got:
        assert_close(plain[k].numpy(), got[k], GRAD_REL * max(1.0, plain[k].abs().max().item()), k)


def test_discarded_sites_tap_the_live_stream():
    # hook_full_embed's edited value is cached but the stream carries on
    # unedited; its gradient is the live stream's.
    names = ["hook_embed", "hook_full_embed", "hook_ln_final",
             "hook_post_head_pre_normalize"]  # in firing order
    want_out, want, got_out, got, _ = _run_both(
        names, incl_bwd=True, fwd_hooks=[("hook_full_embed", lambda v, hook: v * 2.0)])
    assert [k for k in got if k.endswith("_grad")] == [n + "_grad" for n in reversed(names)]
    _assert_cache_matches(want, got)
    assert_close(want_out, got_out, ACT_ATOL, "output")


def test_backward_editors_match_jax_and_leave_the_forward():
    names = lambda n: "resid" in n
    bwd = [("blocks.0.hook_resid_post", lambda g, hook: g * 0.0),
           ("blocks.1.hook_resid_mid", lambda g, hook: g * 3.0)]
    want_out, want, got_out, got, port = _run_both(names, incl_bwd=True, bwd_hooks=bwd)
    _assert_cache_matches(want, got)
    # the forward is untouched
    plain_out, plain = port.run_with_cache(torch.from_numpy(_x()), names_filter=names)
    assert torch.equal(plain_out, got_out)
    assert all(torch.equal(plain[k], got[k]) for k in plain)
    # an editor's own site caches the gradient arriving there; upstream sees
    # the edited one
    assert got["blocks.0.hook_resid_post_grad"].abs().max() > 0
    assert got["blocks.0.hook_resid_mid_grad"].abs().max() == 0
    assert got["blocks.0.hook_resid_pre_grad"].abs().max() == 0
    _, unedited = port.run_with_cache(torch.from_numpy(_x()), names_filter=names, incl_bwd=True)
    # everything upstream of resid_mid flows through it: scaled by 3
    torch.testing.assert_close(got["blocks.1.hook_resid_mid_grad"],
                               unedited["blocks.1.hook_resid_mid_grad"])
    torch.testing.assert_close(got["blocks.1.hook_resid_pre_grad"],
                               3.0 * unedited["blocks.1.hook_resid_pre_grad"])


@pytest.mark.parametrize("stop_at_layer", [None, 1, -1])
def test_loss_fn_stop_at_layer_and_key_order_match_jax(stop_at_layer):
    if stop_at_layer is None:
        loss_fn = lambda out: (out[:, 3] - out[:, 5]).sum()
    else:
        loss_fn = lambda out: (out * out).mean()
    want_out, want, got_out, got, _ = _run_both(
        None, dict(n_layers=3), incl_bwd=True, loss_fn=loss_fn, stop_at_layer=stop_at_layer)
    _assert_cache_matches(want, got)
    assert_close(want_out, got_out, ACT_ATOL, "output")
    acts = [k for k in got if not k.endswith("_grad")]
    assert list(got) == acts + [k + "_grad" for k in reversed(acts)]


def test_site_the_loss_does_not_reach_gets_zeros():
    # The forward replaces the stream at blocks.1.hook_resid_pre with a
    # constant: nothing upstream reaches the loss.
    want_out, want, got_out, got, _ = _run_both(
        lambda n: "resid" in n, incl_bwd=True,
        fwd_hooks=[("blocks.1.hook_resid_pre", lambda v, hook: jnp.full_like(v, 0.5))],
        port_kw=dict(fwd_hooks=[("blocks.1.hook_resid_pre",
                                 lambda v, hook: torch.full_like(v, 0.5))]))
    _assert_cache_matches(want, got)
    assert got["blocks.0.hook_resid_post_grad"].abs().max() == 0
    assert got["blocks.1.hook_resid_pre_grad"].abs().max() > 0


def test_bwd_hooks_without_incl_bwd_return_the_forward():
    names = lambda n: "resid" in n
    bwd = [("blocks.0.hook_resid_post", lambda g, hook: g * 0.0)]
    want_out, want, got_out, got, port = _run_both(names, bwd_hooks=bwd)
    assert not any(k.endswith("_grad") for k in got)
    _assert_cache_matches(want, got)
    plain_out, plain = port.run_with_cache(torch.from_numpy(_x()), names_filter=names)
    assert torch.equal(plain_out, got_out)


def test_runtime_collects_the_cached_sites_that_fire():
    _, port = jax_and_port(**BASE)
    x = torch.from_numpy(_x())
    sites = set()
    rt = HookRuntime(names_filter=lambda n: "resid" in n or n == "blocks.5.hook_z",
                     grad_sites=sites)
    assert rt.grad_mode
    with torch.no_grad():
        out = vit_forward(port, port.cfg, x, rt)
        assert torch.equal(out, port(x))
    assert sites == {f"blocks.{l}.hook_resid_{s}" for l in range(2)
                     for s in ("pre", "mid", "post")}
