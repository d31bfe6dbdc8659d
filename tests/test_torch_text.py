"""The port's CLIP text tower against the JAX package's on the same weights
and token ids: outputs and every cache entry in each mask mode (causal, the
appended cls embedding over padded rows, bidirectional), with and without
``normalize_output``, ``pre_logits``, ``stop_at_layer``, bfloat16, an
editing forward hook, ``incl_bwd`` gradients with a backward editor,
``stack_text_params``/``unstack_text_params``, ``ActivationCache`` on a
text model, every text name of the registry, ``load_hooked_model(
model_type="text")`` on HF ``CLIPModel`` and open_clip state dicts (raw,
processed and refactored), and every new module imported without JAX.

Tolerances, of max(1, the JAX value's finite absmax): float32 1e-5
(summation order; attention scores hold -inf where masked, compared as
such); bfloat16 3e-2 (a few bf16 ulps: both packages round each matmul and
the attention's output to bf16, in other orders); processed against raw
weights 1e-4 (the folding reorders float32 sums)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_prisma_tpu
import vit_prisma_tpu_torch
from tests._torch_parity import port_from_jax
from vit_prisma_tpu.models import text as jax_text
from vit_prisma_tpu.models.loading import loader as jax_loader
from vit_prisma_tpu.models.loading import registry as jax_registry
from vit_prisma_tpu.prisma.cache import ActivationCache as JaxCache
from vit_prisma_tpu_torch.models import text as port_text
from vit_prisma_tpu_torch.models.loading import loader as port_loader
from vit_prisma_tpu_torch.models.loading import registry as port_registry
from vit_prisma_tpu_torch.models.loading import state_dict as port_sd
from vit_prisma_tpu_torch.prisma.cache import ActivationCache

F32_REL = 1e-5
BF16_REL = 3e-2
PROCESSED_REL = 1e-4

# 2 layers, 32 wide, 4 heads of 8, MLP 64, 12 positions, 60 token ids (EOT
# is the largest, 59), a 16-wide projection.
CTX, VOCAB, EOT = 12, 60, 59
BASE = dict(n_layers=2, d_model=32, d_head=8, n_heads=4, d_mlp=64, context_length=CTX,
            vocab_size=VOCAB, n_classes=16, activation_name="quick_gelu", eps=1e-5,
            return_type="class_logits", normalize_output=True)
MODES = {
    "causal": dict(BASE),
    "cls_padded": dict(BASE, use_cls_emb=True),
    "bidirectional": dict(BASE, causal_attention=False),
    "causal_cls_unnormalized": dict(BASE, normalize_output=False),
    "pre_logits": dict(BASE, return_type="pre_logits"),
}


def close(want, got, rel, name=""):
    """``got`` (torch) within rel x max(1, finite absmax of ``want``) of
    ``want`` (JAX), with infinities in the same places."""
    w = np.asarray(want, np.float32)
    finite = w[np.isfinite(w)]
    scale = max(1.0, float(np.abs(finite).max())) if finite.size else 1.0
    np.testing.assert_allclose(got.detach().float().numpy(), w, rtol=0, atol=rel * scale,
                               err_msg=name)


def seeded_text_flat(fields, seed=0):
    """A flat reference-named text state dict (numpy float32) for
    ``fields``, every parameter drawn from ``seed``: LayerNorm weights near
    1, biases 0.1, embeddings 0.5, matrices scaled by 1/sqrt(fan in)."""
    cfg = vit_prisma_tpu.TextTransformerConfig(**fields)
    shapes = {k: np.shape(v) for k, v in jax_text.unstack_text_params(
        jax_text.init_text_params(cfg, jax.random.PRNGKey(0)), cfg).items()}
    rng = np.random.default_rng(seed)
    flat = {}
    for k, shape in sorted(shapes.items()):
        z = rng.standard_normal(shape)
        leaf = k.rsplit(".", 1)[-1]
        if leaf == "w":
            z = 1.0 + 0.1 * z
        elif leaf.startswith("b"):
            z = 0.1 * z
        elif k in ("token_embed.W_E", "pos_embed.W_pos", "cls_emb"):
            z = 0.5 * z
        else:
            z = z / np.sqrt(shape[-2])
        flat[k] = z.astype(np.float32)
    return flat


def text_models(fields, seed=0):
    """The JAX package's HookedTextTransformer and the port's (on the CPU)
    with the same :func:`seeded_text_flat` weights."""
    flat = seeded_text_flat(fields, seed)
    jcfg = vit_prisma_tpu.TextTransformerConfig(**fields)
    jax_model = vit_prisma_tpu.HookedTextTransformer(
        jcfg, params=jax_text.stack_text_params(flat, jcfg))
    port = vit_prisma_tpu_torch.HookedTextTransformer(
        vit_prisma_tpu_torch.TextTransformerConfig(**fields), device="cpu")
    port.load_state_dict(flat)
    return jax_model, port


def token_ids(batch=4, length=CTX, seed=1):
    """Seeded int32 ids: SOT-like id 1, words in [2, EOT), EOT, then
    padding (0), each row of another length; the first row fills every
    position, so EOT is last."""
    rng = np.random.default_rng(seed)
    out = np.zeros((batch, length), np.int32)
    for r in range(batch):
        n = length if r == 0 else int(rng.integers(3, length))
        out[r, 0] = 1
        out[r, 1:n - 1] = rng.integers(2, EOT, size=n - 2)
        out[r, n - 1] = EOT
    return out


def _length(fields):
    # the appended cls embedding takes one of the CTX positions
    return CTX - 1 if fields.get("use_cls_emb") else CTX


@pytest.mark.parametrize("mode", list(MODES))
def test_text_output_and_full_cache_match_jax(mode):
    fields = MODES[mode]
    jax_model, port = text_models(fields)
    toks = token_ids(length=_length(fields))
    want_out, want = jax_model.run_with_cache(jnp.asarray(toks), return_cache_object=False)
    got_out, got = port.run_with_cache(torch.from_numpy(toks), return_cache_object=False)
    assert list(got) == list(want) == port_text.text_hook_names(port.cfg)
    for name in want:
        assert tuple(got[name].shape) == tuple(want[name].shape), name
        close(want[name], got[name], F32_REL, name)
    close(want_out, got_out, F32_REL, "output")
    # the plain forward: B1's causal route where the mask is the marker
    close(jax_model(jnp.asarray(toks)), port(torch.from_numpy(toks)), F32_REL, "forward")


@pytest.mark.parametrize("mode", ["causal", "cls_padded"])
def test_text_stop_at_layer_matches_jax(mode):
    fields = MODES[mode]
    jax_model, port = text_models(fields, seed=2)
    toks = token_ids(length=_length(fields), seed=3)
    close(jax_model(jnp.asarray(toks), stop_at_layer=1),
          port(torch.from_numpy(toks), stop_at_layer=1), F32_REL, "stop_at_layer")
    want_out, want = jax_model.run_with_cache(jnp.asarray(toks), stop_at_layer=1,
                                              return_cache_object=False)
    got_out, got = port.run_with_cache(torch.from_numpy(toks), stop_at_layer=1,
                                       return_cache_object=False)
    assert list(got) == list(want)
    assert not any(n.startswith("blocks.1") for n in got)
    for name in want:
        close(want[name], got[name], F32_REL, name)
    close(want_out, got_out, F32_REL, "output")


def test_text_bfloat16_matches_jax():
    fields = dict(BASE, dtype="bfloat16")
    jax_model, port = text_models(fields, seed=4)
    toks = token_ids(seed=5)
    names = lambda n: "resid_post" in n or n == "hook_post_head_pre_normalize"
    want_out, want = jax_model.run_with_cache(jnp.asarray(toks), names_filter=names,
                                              return_cache_object=False)
    got_out, got = port.run_with_cache(torch.from_numpy(toks), names_filter=names,
                                       return_cache_object=False)
    assert got_out.dtype == torch.bfloat16 and list(got) == list(want)
    for name in want:
        close(want[name], got[name], BF16_REL, name)
    close(want_out, got_out, BF16_REL, "output")
    close(jax_model(jnp.asarray(toks)), port(torch.from_numpy(toks)), BF16_REL, "forward")


@pytest.mark.parametrize("overrides", [dict(use_fused_attention=False),
                                       dict(use_fused_ln_gemm=True)],
                         ids=["einsum", "fused_ln"])
def test_text_with_cfg_shares_the_weights_and_matches_jax(overrides):
    """A route override of the text tower shares its parameters (no copy),
    leaves the model's own config as it was, and still computes JAX's
    output."""
    jax_model, port = text_models(MODES["causal"], seed=12)
    other = port.with_cfg(**overrides)
    assert isinstance(other.cfg, vit_prisma_tpu_torch.TextTransformerConfig)
    assert all(getattr(other.cfg, k) == v for k, v in overrides.items())
    assert all(b.cfg is other.cfg for b in other.blocks)
    assert all(b.cfg is port.cfg for b in port.blocks)
    assert port.cfg.use_fused_attention and not port.cfg.use_fused_ln_gemm
    ours, theirs = dict(port.named_parameters()), dict(other.named_parameters())
    assert list(ours) == list(theirs) and all(ours[k] is theirs[k] for k in ours)
    toks = token_ids(seed=13)
    close(jax_model(jnp.asarray(toks)), other(torch.from_numpy(toks)), F32_REL, "output")


@pytest.mark.parametrize("edit", ["resid_pre", "pattern", "embed"])
def test_text_run_with_hooks_editing_hook_matches_jax(edit):
    jax_model, port = text_models(MODES["causal"], seed=6)
    toks = token_ids(seed=7)
    if edit == "resid_pre":
        name, jf, pf = "blocks.1.hook_resid_pre", lambda v, h: v * 0.5, lambda v, h: v * 0.5
    elif edit == "pattern":  # an attention-internal hook: the einsum route
        name = "blocks.0.attn.hook_pattern"
        jf = lambda v, h: v.at[:, 1].set(0.0)

        def pf(v, h):
            v = v.clone()
            v[:, 1] = 0.0
            return v
    else:
        name, jf, pf = "hook_embed", lambda v, h: v * 2.0, lambda v, h: v * 2.0
    want = jax_model.run_with_hooks(jnp.asarray(toks), fwd_hooks=[(name, jf)])
    got = port.run_with_hooks(torch.from_numpy(toks), fwd_hooks=[(name, pf)])
    close(want, got, F32_REL, edit)
    assert (got - port(torch.from_numpy(toks))).abs().max() > 1e-3  # the edit acted


@pytest.mark.parametrize("mode", ["causal", "cls_padded"])
def test_text_incl_bwd_gradients_match_jax(mode):
    fields = MODES[mode]
    jax_model, port = text_models(fields, seed=8)
    toks = token_ids(length=_length(fields), seed=9)
    names = lambda n: "resid_post" in n or "resid_pre" in n
    want_out, want = jax_model.run_with_cache(jnp.asarray(toks), names_filter=names,
                                              incl_bwd=True, return_cache_object=False)
    got_out, got = port.run_with_cache(torch.from_numpy(toks), names_filter=names,
                                       incl_bwd=True, return_cache_object=False)
    assert list(got) == list(want)
    assert "blocks.0.hook_resid_pre_grad" in got
    for name in want:
        close(want[name], got[name], F32_REL, name)
    close(want_out, got_out, F32_REL, "output")

    # a loss, and a backward editor doubling the gradient leaving layer 1
    jloss = lambda out: (out[:, :3] ** 2).sum()
    ploss = lambda out: (out[:, :3] ** 2).sum()
    jb = [("blocks.1.hook_resid_pre", lambda g, h: g * 2.0)]
    pb = [("blocks.1.hook_resid_pre", lambda g, h: g * 2.0)]
    _, want = jax_model.run_with_cache(jnp.asarray(toks), names_filter=names, incl_bwd=True,
                                       bwd_hooks=jb, loss_fn=jloss, return_cache_object=False)
    _, got = port.run_with_cache(torch.from_numpy(toks), names_filter=names, incl_bwd=True,
                                 bwd_hooks=pb, loss_fn=ploss, return_cache_object=False)
    assert list(got) == list(want)
    for name in want:
        close(want[name], got[name], F32_REL, name)


@pytest.mark.parametrize("fields", [BASE, dict(BASE, use_cls_emb=True),
                                    dict(BASE, normalization_type=None)],
                         ids=["ln", "cls", "no_norm"])
def test_stack_unstack_text_params_match_jax(fields):
    flat = seeded_text_flat(fields, seed=10)
    jcfg = vit_prisma_tpu.TextTransformerConfig(**fields)
    pcfg = vit_prisma_tpu_torch.TextTransformerConfig(**fields)
    want = jax.tree.map(np.asarray, jax_text.stack_text_params(flat, jcfg))
    got = port_text.stack_text_params(flat, pcfg)
    assert (jax.tree_util.tree_structure(want)
            == jax.tree_util.tree_structure(jax.tree.map(lambda t: 0, got)))
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree_util.tree_leaves(got)):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=str(path))
    back = port_text.unstack_text_params(got, pcfg)
    want_back = jax_text.unstack_text_params(want, jcfg)
    assert sorted(back) == sorted(want_back) == sorted(flat)
    for k in back:
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(want_back[k]), err_msg=k)
    # the alternative embedding names the JAX function takes
    alt = dict(flat)
    alt["token_embed.weight"] = alt.pop("token_embed.W_E")
    alt["pos_embed"] = alt.pop("pos_embed.W_pos")
    again = port_text.stack_text_params(alt, pcfg)
    assert torch.equal(again["token_embed"]["W_E"], got["token_embed"]["W_E"])
    assert torch.equal(again["pos_embed"]["W_pos"], got["pos_embed"]["W_pos"])
    # the JAX tree's parameters read into the port through params_from_jax
    jax_model = vit_prisma_tpu.HookedTextTransformer(
        jcfg, params=jax_text.stack_text_params(flat, jcfg))
    port = port_from_jax(jax_model)
    assert isinstance(port, vit_prisma_tpu_torch.HookedTextTransformer)
    ref = port_sd.reference_state_dict(port)
    assert sorted(ref) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(ref[k].numpy(), flat[k], err_msg=k)


@pytest.mark.parametrize("apply_ln", [False, True])
def test_text_activation_cache_accumulated_resid_matches_jax(apply_ln):
    jax_model, port = text_models(MODES["causal"], seed=11)
    toks = token_ids(seed=12)
    _, want_cache = jax_model.run_with_cache(jnp.asarray(toks))
    _, got_cache = port.run_with_cache(torch.from_numpy(toks))
    assert isinstance(want_cache, JaxCache) and isinstance(got_cache, ActivationCache)
    for layer in (None, 1):
        want, want_labels = want_cache.accumulated_resid(layer, apply_ln=apply_ln,
                                                         return_labels=True)
        got, got_labels = got_cache.accumulated_resid(layer, apply_ln=apply_ln,
                                                      return_labels=True)
        assert got_labels == want_labels
        close(want, got, F32_REL, f"accumulated_resid {layer}")
    close(want_cache["blocks.1.hook_resid_post"], got_cache[("resid_post", -1)], F32_REL)


TEXT_NAMES = sorted(jax_registry.TEXT_SUPPORTED_MODELS)


@pytest.mark.parametrize("name", TEXT_NAMES)
def test_text_registry_name_matches_jax(name):
    try:
        want = jax_registry.get_model_config(name, model_type="text")
    except (KeyError, ValueError) as e:  # a size or modifier with no text tower
        with pytest.raises(type(e)) as got:
            port_registry.get_model_config(name, model_type="text")
        assert type(got.value) is type(e) and str(got.value) == str(e)
        return
    got = port_registry.get_model_config(name, model_type="text")
    assert isinstance(got, vit_prisma_tpu_torch.TextTransformerConfig)
    assert got.to_dict() == want.to_dict()
    assert (port_registry.get_model_config(name, model_type="text", dtype="bfloat16").to_dict()
            == jax_registry.get_model_config(name, model_type="text",
                                             dtype="bfloat16").to_dict())
    if name not in jax_registry.TEXT_MODEL_CONFIGS:
        assert (port_registry.open_clip_text_config(name).to_dict()
                == jax_registry.open_clip_text_config(name).to_dict())


def test_text_registry_tables_and_errors_match_jax():
    assert port_registry.TEXT_SUPPORTED_MODELS == jax_registry.TEXT_SUPPORTED_MODELS
    assert port_registry.TEXT_MODEL_CONFIGS == jax_registry.TEXT_MODEL_CONFIGS
    for name in ("something/else", "open-clip:laion/CLIP-ViT-X-99"):
        with pytest.raises(Exception) as want:
            jax_registry.get_model_config(name, model_type="text")
        with pytest.raises(Exception) as got:
            port_registry.get_model_config(name, model_type="text")
        assert type(got.value) is type(want.value) and str(got.value) == str(want.value)


# load_hooked_model(model_type="text"): state dicts drawn from a seed in the
# HF CLIPModel layout (both towers; the loader picks the text one) and the
# open_clip layout (text keys only).
D, L, M, E = 32, 2, 64, 16


def _draw(layout, seed):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * 0.3).astype(np.float32) for k, s in layout.items()}


def _hf_layers(prefix):
    out = {}
    for l in range(L):
        k = f"{prefix}encoder.layers.{l}."
        for i in (1, 2):
            out[f"{k}layer_norm{i}.weight"] = out[f"{k}layer_norm{i}.bias"] = (D,)
        for m in ("q", "k", "v", "out"):
            out[f"{k}self_attn.{m}_proj.weight"] = (D, D)
            out[f"{k}self_attn.{m}_proj.bias"] = (D,)
        out.update({k + "mlp.fc1.weight": (M, D), k + "mlp.fc1.bias": (M,),
                    k + "mlp.fc2.weight": (D, M), k + "mlp.fc2.bias": (D,)})
    return out


def hf_clip_model_layout():
    vision = {"vision_model.embeddings.class_embedding": (D,),
              "vision_model.embeddings.position_embedding.weight": (5, D),
              "vision_model.embeddings.patch_embedding.weight": (D, 3, 4, 4),
              "vision_model.pre_layrnorm.weight": (D,), "vision_model.pre_layrnorm.bias": (D,),
              "vision_model.post_layernorm.weight": (D,),
              "vision_model.post_layernorm.bias": (D,),
              **_hf_layers("vision_model."), "visual_projection.weight": (E, D)}
    text = {"text_model.embeddings.token_embedding.weight": (VOCAB, D),
            "text_model.embeddings.position_embedding.weight": (CTX, D),
            "text_model.final_layer_norm.weight": (D,), "text_model.final_layer_norm.bias": (D,),
            **_hf_layers("text_model."), "text_projection.weight": (E, D)}
    return {**vision, **text}


def open_clip_text_layout():
    out = {"token_embedding.weight": (VOCAB, D), "positional_embedding": (CTX, D),
           "ln_final.weight": (D,), "ln_final.bias": (D,), "text_projection": (D, E)}
    for l in range(L):
        k = f"transformer.resblocks.{l}."
        out.update({k + "ln_1.weight": (D,), k + "ln_1.bias": (D,), k + "ln_2.weight": (D,),
                    k + "ln_2.bias": (D,), k + "attn.in_proj_weight": (3 * D, D),
                    k + "attn.in_proj_bias": (3 * D,), k + "attn.out_proj.weight": (D, D),
                    k + "attn.out_proj.bias": (D,), k + "mlp.c_fc.weight": (M, D),
                    k + "mlp.c_fc.bias": (M,), k + "mlp.c_proj.weight": (D, M),
                    k + "mlp.c_proj.bias": (D,)})
    return out


SOURCES = {"hf_clip_model": ("openai/clip-vit-base-patch32", hf_clip_model_layout),
           "open_clip": ("open-clip:laion/CLIP-ViT-B-32-laion2B-s34B-b79K",
                         open_clip_text_layout)}
PROCESSING = {"raw": {},
              "processed": dict(fold_ln=True, center_writing_weights=True,
                                fold_value_biases=True),
              "refactored": dict(fold_ln=True, center_writing_weights=True,
                                 fold_value_biases=True, refactor_factored_attn_matrices=True)}
OVERRIDES = dict(n_layers=L, d_model=D, n_heads=4, d_head=8, d_mlp=M, n_classes=E,
                 vocab_size=VOCAB, context_length=CTX)


@pytest.mark.parametrize("processing", list(PROCESSING))
@pytest.mark.parametrize("source", list(SOURCES))
def test_load_hooked_model_text_matches_jax(source, processing):
    name, layout = SOURCES[source]
    sd = _draw(layout(), 13)
    flags = PROCESSING[processing]
    want = jax_loader.load_hooked_model(name, model_type="text", state_dict=sd, **flags,
                                        **OVERRIDES)
    got = port_loader.load_hooked_model(name, model_type="text", state_dict=sd, device="cpu",
                                        **flags, **OVERRIDES)
    assert isinstance(got, vit_prisma_tpu_torch.HookedTextTransformer)
    assert got.cfg.to_dict() == want.cfg.to_dict()
    want_flat = jax_text.unstack_text_params(want.params, want.cfg)
    got_flat = port_sd.reference_state_dict(got)
    assert sorted(got_flat) == sorted(want_flat)
    for k in want_flat:
        close(want_flat[k], got_flat[k], PROCESSED_REL if flags else 0.0, k)
    toks = token_ids(seed=14)
    names = lambda n: "resid_post" in n or n == "hook_ln_final"
    want_out, want_cache = want.run_with_cache(jnp.asarray(toks), names_filter=names,
                                               return_cache_object=False)
    got_out, got_cache = got.run_with_cache(torch.from_numpy(toks), names_filter=names,
                                            return_cache_object=False)
    for k in want_cache:
        close(want_cache[k], got_cache[k], PROCESSED_REL, k)
    close(want_out, got_out, F32_REL, "output")
    if flags:  # the processing preserves the output
        raw = port_loader.load_hooked_model(name, model_type="text", state_dict=sd,
                                            device="cpu", **OVERRIDES)
        close(raw(torch.from_numpy(toks)), got_out, PROCESSED_REL, "processed vs raw")


def test_from_pretrained_is_the_text_loader():
    sd = _draw(hf_clip_model_layout(), 15)
    got = vit_prisma_tpu_torch.HookedTextTransformer.from_pretrained(
        "openai/clip-vit-base-patch32", state_dict=sd, device="cpu", **OVERRIDES)
    want = port_loader.load_hooked_model("openai/clip-vit-base-patch32", model_type="text",
                                         state_dict=sd, device="cpu", **OVERRIDES)
    assert all(torch.equal(a, b) for a, b in zip(got.state_dict().values(),
                                                 want.state_dict().values()))
    # the stacked weight properties, against the JAX model's
    jax_model = jax_loader.load_hooked_model("openai/clip-vit-base-patch32",
                                             model_type="text", state_dict=sd, **OVERRIDES)
    for prop in ("W_Q", "W_K", "W_V", "W_O", "W_in", "W_out", "W_E", "W_pos"):
        np.testing.assert_array_equal(getattr(got, prop).detach().numpy(),
                                      np.asarray(getattr(jax_model, prop)), err_msg=prop)


def test_text_modules_import_without_jax():
    """The text tower, the tokenizer, the templates, the zero-shot
    evaluation and the model/SAE loader import with jax made
    unimportable."""
    code = ("import sys; sys.modules['jax'] = None; "
            "import vit_prisma_tpu_torch, vit_prisma_tpu_torch.models.text, "
            "vit_prisma_tpu_torch.utils.clip_tokenizer, "
            "vit_prisma_tpu_torch.utils.openai_templates, "
            "vit_prisma_tpu_torch.model_eval, vit_prisma_tpu_torch.model_eval.zero_shot, "
            "vit_prisma_tpu_torch.utils.load_model, "
            "vit_prisma_tpu_torch.models.loading.loader; "
            "from vit_prisma_tpu_torch import HookedTextTransformer, TextTransformerConfig; "
            "TextTransformerConfig(); "
            "bad = sorted(m for m, mod in sys.modules.items() if mod is not None and "
            "(m.startswith(('jax', 'vit_prisma_tpu.')) or m == 'vit_prisma_tpu')); "
            "assert not bad, bad")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=root)
