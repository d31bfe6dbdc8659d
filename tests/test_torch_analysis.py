"""The port's analysis surface against the JAX package's, on the same numpy
weights and images in float32: every ``ActivationCache`` method, the
``FactoredMatrix`` operations and the model's ``OV``/``QK`` circuits,
``accumulated_bias``, ``tokens_to_residual_directions``, both logit-lens
functions, ``to_numpy``/``Slice`` over every input kind, ``test_prompt``'s
printed lines, the ImageNet tables, and ``HookedSAEViT.run_with_cache``
returning the cache object.

Tolerances: activations and analyses within 1e-4 (as ``test_torch_vit.py``:
the two packages differ in summation order only); FactoredMatrix products
within 1e-5 of max(1, their absmax).  SVDs are compared by what they compute
(U·S·Vhᵀ, the singular values, the even pair's product), never by raw U or
Vh, whose signs are the solver's."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_prisma_tpu
from tests._torch_parity import assert_close, seeded, seeded_models
from vit_prisma_tpu.dataloaders import imagenet_names as jax_names
from vit_prisma_tpu.prisma import logit_lens as jax_lens
from vit_prisma_tpu.prisma.factored_matrix import FactoredMatrix as JaxFM
from vit_prisma_tpu.utils import prisma_utils as jax_utils
from vit_prisma_tpu_torch import ActivationCache, FactoredMatrix
from vit_prisma_tpu_torch.dataloaders import imagenet_names as port_names
from vit_prisma_tpu_torch.prisma import logit_lens as port_lens
from vit_prisma_tpu_torch.utils import prisma_utils as port_utils

ATOL = 1e-4
FM_REL = 1e-5

# test_weight_properties.py's 3-layer config, a CLIP-like one (class token,
# ln_pre, quick_gelu) and one without a class token, whose embeddings sum
# into the residual.
CONFIGS = {
    "three_layer": dict(n_layers=3, d_model=12, d_head=3, n_heads=4, d_mlp=24,
                        patch_size=4, image_size=8, n_classes=5, return_type="logits"),
    "clip_like": dict(n_layers=2, d_model=16, d_head=4, n_heads=4, d_mlp=32,
                      patch_size=4, image_size=8, n_classes=6,
                      activation_name="quick_gelu", layer_norm_pre=True, eps=1e-5,
                      return_type="class_logits"),
    "no_cls": dict(n_layers=2, d_model=12, d_head=3, n_heads=4, d_mlp=24,
                   patch_size=4, image_size=8, n_classes=5, use_cls_token=False,
                   classification_type="gaap", return_type="logits"),
}


def _names_filter(fields):
    """hook_embed fires before the class token is prepended, so an
    embedding-inclusive decomposition only fits a model without one: the
    class-token models' caches leave the embeddings out."""
    if fields.get("use_cls_token", True):
        return lambda n: n not in ("hook_embed", "hook_pos_embed")
    return None


_CACHES = {}


def _caches(config):
    """(JAX cache, port cache, JAX model, port model) for ``config``, built
    once per worker; each call site gets fresh cache objects."""
    if config not in _CACHES:
        fields = CONFIGS[config]
        jax_model, port = seeded_models(fields, seed=7)
        x = seeded(1, (2, 3, 8, 8))
        filt = _names_filter(fields)
        _, want = jax_model.run_with_cache(jnp.asarray(x), names_filter=filt)
        _, got = port.run_with_cache(torch.from_numpy(x), names_filter=filt)
        _CACHES[config] = (want.cache_dict, got.cache_dict, jax_model, port)
    want, got, jax_model, port = _CACHES[config]
    return (vit_prisma_tpu.ActivationCache(dict(want), jax_model),
            ActivationCache(dict(got), port), jax_model, port)


def _assert_same(want, got, name):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), name
        for i, (w, g) in enumerate(zip(want, got)):
            _assert_same(w, g, f"{name}[{i}]")
    elif isinstance(want, list):
        assert list(got) == list(want), name
    else:
        assert isinstance(got, torch.Tensor), name
        assert tuple(got.shape) == tuple(np.shape(want)), name
        assert_close(want, got, ATOL, name)


CALLS = {
    "accumulated_resid": lambda c: c.accumulated_resid(),
    "accumulated_resid_mid": lambda c: c.accumulated_resid(layer=1, incl_mid=True,
                                                           return_labels=True),
    "accumulated_resid_ln": lambda c: c.accumulated_resid(apply_ln=True, return_labels=True),
    "accumulated_resid_mlp_input": lambda c: c.accumulated_resid(
        layer=1, mlp_input=True, apply_ln=True, pos_slice=(0, 3)),
    "accumulated_resid_pos_int": lambda c: c.accumulated_resid(pos_slice=0, apply_ln=True),
    "decompose_resid": lambda c: c.decompose_resid(return_labels=True),
    "decompose_resid_attn": lambda c: c.decompose_resid(layer=1, mlp_input=True, mode="attn",
                                                        apply_ln=True, return_labels=True),
    "decompose_resid_mlp": lambda c: c.decompose_resid(mode="mlp", pos_slice=[0, 2],
                                                       apply_ln=True),
    "stack_head_results": lambda c: c.stack_head_results(return_labels=True,
                                                         incl_remainder=True),
    "stack_head_results_ln": lambda c: c.stack_head_results(layer=1, apply_ln=True,
                                                            pos_slice=slice(1, None)),
    "stack_head_results_none": lambda c: c.stack_head_results(layer=0, incl_remainder=True,
                                                              return_labels=True),
    "stack_activation": lambda c: c.stack_activation("resid_post"),
    "stack_activation_pattern": lambda c: c.stack_activation("pattern", layer=2),
    "get_neuron_results": lambda c: c.get_neuron_results(1),
    "get_neuron_results_sliced": lambda c: c.get_neuron_results(
        0, neuron_slice=[1, 5, 7], pos_slice=2),
    "stack_neuron_results": lambda c: c.stack_neuron_results(-1, return_labels=True,
                                                             incl_remainder=True),
    "stack_neuron_results_sliced": lambda c: c.stack_neuron_results(
        1, neuron_slice=(0, 10, 3), apply_ln=True, return_labels=True),
    "apply_ln_to_stack": lambda c: c.apply_ln_to_stack(
        c.stack_activation("resid_pre"), layer=1, mlp_input=True, batch_slice=1),
    "full_resid_decomposition": lambda c: c.get_full_resid_decomposition(return_labels=True),
    "full_resid_decomposition_mlp": lambda c: c.get_full_resid_decomposition(
        layer=1, mlp_input=True, expand_neurons=False, apply_ln=True, return_labels=True),
    "full_resid_decomposition_pos": lambda c: c.get_full_resid_decomposition(
        apply_ln=True, pos_slice=0),
    "compute_head_results": lambda c: (c.compute_head_results(),
                                       c["blocks.1.attn.hook_result"])[1],
}


@pytest.mark.parametrize("call", list(CALLS))
@pytest.mark.parametrize("config", list(CONFIGS))
def test_cache_method_matches_jax(config, call):
    want_cache, got_cache, _, _ = _caches(config)
    _assert_same(CALLS[call](want_cache), CALLS[call](got_cache), f"{config}.{call}")


@pytest.mark.parametrize("config", list(CONFIGS))
def test_cache_dict_protocol_matches_jax(config):
    want, got, _, port = _caches(config)
    assert list(got) == list(want) and list(got.keys()) == list(want.keys())
    assert len(got) == len(want)
    for key in [("resid_pre", 1), ("resid_post", -1), ("pattern", -1), "scale",
                "ln_final.hook_scale", ("scale", 0, "ln1"), "resid_pre1", ("q", 0)]:
        assert (key in got) == (key in want), key
        if key in want:
            assert_close(want[key], got[key], ATOL, str(key))
    assert ("resid_pre", 99) not in got
    assert repr(got) == f"ActivationCache with keys {list(got.keys())}"
    assert got.model is port and got.has_batch_dim
    assert got.has_embed == want.has_embed and got.has_pos_embed == want.has_pos_embed


def test_remove_batch_dim_matches_jax(caplog):
    fields = CONFIGS["clip_like"]
    jax_model, port = seeded_models(fields, seed=7)
    x = seeded(1, (1, 3, 8, 8))
    _, want = jax_model.run_with_cache(jnp.asarray(x))
    _, got = port.run_with_cache(torch.from_numpy(x))
    assert got.remove_batch_dim() is got and not got.has_batch_dim
    want.remove_batch_dim()
    for k in want:
        assert_close(want[k], got[k], ATOL, k)
    got.remove_batch_dim()  # a second call only warns
    assert "already" in caplog.text
    _, got2 = port.run_with_cache(torch.from_numpy(x), remove_batch_dim=True)
    assert isinstance(got2, ActivationCache) and not got2.has_batch_dim
    assert_close(want["blocks.1.hook_resid_post"], got2["blocks.1.hook_resid_post"], ATOL)
    _, two = port.run_with_cache(torch.from_numpy(seeded(2, (2, 3, 8, 8))))
    with pytest.raises(AssertionError, match="batch size > 1"):
        two.remove_batch_dim()


def test_cache_invariants():
    """heads + remainder = the last resid_post; neuron results + b_out =
    mlp_out; heads + neurons + bias + the first resid_pre = the last
    resid_post (the class-token model's decomposition)."""
    want, cache, _, port = _caches("clip_like")
    last = cache["blocks.1.hook_resid_post"]
    heads = cache.stack_head_results(incl_remainder=True)
    torch.testing.assert_close(heads.sum(0), last, rtol=0, atol=1e-5)
    for l in range(port.cfg.n_layers):
        neurons = cache.get_neuron_results(l).sum(-2) + port.b_out[l].detach()
        torch.testing.assert_close(neurons, cache[("mlp_out", l)], rtol=0, atol=1e-5)
    full = cache.get_full_resid_decomposition(expand_neurons=True)
    assert full.shape[0] == 2 * 4 + 2 * 32 + 1
    torch.testing.assert_close(full.sum(0) + cache[("resid_pre", 0)], last, rtol=0, atol=1e-4)


def test_run_with_cache_returns_the_cache_object():
    jax_model, port = seeded_models(CONFIGS["three_layer"], seed=7)
    x = torch.from_numpy(seeded(1, (2, 3, 8, 8)))
    _, cache = port.run_with_cache(x)
    _, plain = port.run_with_cache(x, return_cache_object=False)
    assert isinstance(cache, ActivationCache) and type(plain) is dict
    assert list(cache) == list(plain)
    assert all(torch.equal(cache[k], plain[k]) for k in plain)


# ---------------------------------------------------------------------------
# FactoredMatrix
# ---------------------------------------------------------------------------

def _fm_close(want, got, name=""):
    want = np.asarray(want)
    atol = FM_REL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=atol, err_msg=name)


def _fms(a_shape=(2, 5, 3), b_shape=(2, 3, 6), seed=30):
    A, B = seeded(seed, a_shape), seeded(seed + 1, b_shape)
    return JaxFM(jnp.asarray(A), jnp.asarray(B)), FactoredMatrix(torch.from_numpy(A),
                                                                 torch.from_numpy(B))


FM_OPS = {
    "AB": lambda fm, np_: fm.AB,
    "T": lambda fm, np_: fm.T.AB,
    "matmul_vector": lambda fm, np_: fm @ np_(seeded(40, (6,))),
    "matmul_matrix_wide": lambda fm, np_: (fm @ np_(seeded(41, (6, 4)))).AB,
    "matmul_matrix_narrow": lambda fm, np_: (fm @ np_(seeded(42, (6, 2)))).AB,
    "rmatmul_vector": lambda fm, np_: np_(seeded(43, (5,))) @ fm,
    "rmatmul_matrix_wide": lambda fm, np_: (np_(seeded(44, (4, 5))) @ fm).AB,
    "rmatmul_matrix_narrow": lambda fm, np_: (np_(seeded(45, (2, 5))) @ fm).AB,
    "mul": lambda fm, np_: (fm * 2.5).AB,
    "rmul": lambda fm, np_: (-1.5 * fm).AB,
    "matmul_factored": lambda fm, np_: (fm @ type(fm)(np_(seeded(46, (2, 6, 2))),
                                                      np_(seeded(47, (2, 2, 5))))).AB,
    "rmatmul_factored": lambda fm, np_: (type(fm)(np_(seeded(48, (2, 4, 2))),
                                                  np_(seeded(49, (2, 2, 5)))) @ fm).AB,
    "svd_product": lambda fm, np_: (fm.U * fm.S[..., None, :]) @ fm.Vh.swapaxes(-1, -2),
    "S": lambda fm, np_: fm.S,
    "norm": lambda fm, np_: fm.norm(),
    "make_even": lambda fm, np_: fm.make_even().AB,
    "make_even_balanced": lambda fm, np_: (
        (fm.make_even().A ** 2).sum(-2) - (fm.make_even().B ** 2).sum(-1)),
    "collapse_l": lambda fm, np_: fm.U @ fm.collapse_l(),
    "collapse_r": lambda fm, np_: fm.collapse_r() @ fm.Vh.swapaxes(-1, -2),
    "unsqueeze": lambda fm, np_: fm.unsqueeze(1).AB,
    "get_corner": lambda fm, np_: fm.get_corner(2),
    "index_leading": lambda fm, np_: fm[1].AB,
    "index_rows": lambda fm, np_: fm[0, 1:4].AB,
    "index_row_int": lambda fm, np_: fm[1, 2].AB,
    "index_full": lambda fm, np_: fm[1, 0:3, 2].AB,
    "pair": lambda fm, np_: fm.pair[0] @ fm.pair[1],
}


@pytest.mark.parametrize("op", list(FM_OPS))
def test_factored_matrix_op_matches_jax(op):
    jfm, pfm = _fms()
    want = FM_OPS[op](jfm, jnp.asarray)
    got = FM_OPS[op](pfm, torch.from_numpy)
    assert tuple(got.shape) == tuple(want.shape), op
    _fm_close(want, got, op)


def test_factored_matrix_square_and_meta():
    jfm, pfm = _fms((3, 4, 2), (3, 2, 4), seed=31)
    _fm_close(jfm.BA, pfm.BA, "BA")
    want = np.sort_complex(np.asarray(jfm.eigenvalues).round(4))
    got = np.sort_complex(pfm.eigenvalues.numpy().round(4))
    np.testing.assert_allclose(got, want, atol=1e-3)
    assert pfm.shape == jfm.shape and pfm.ndim == jfm.ndim == 3
    assert (pfm.ldim, pfm.mdim, pfm.rdim) == (jfm.ldim, jfm.mdim, jfm.rdim)
    assert repr(pfm) == repr(jfm)
    _fm_close((jfm * jnp.asarray(2.0)).AB, (pfm * torch.tensor(2.0)).AB)
    with pytest.raises(AssertionError, match="scalar"):
        pfm * torch.ones(2)
    with pytest.raises(ValueError, match="too long"):
        pfm[0, 0, 0, 0]
    # broadcast leading dims
    b = FactoredMatrix(torch.from_numpy(seeded(32, (4, 2))),
                       torch.from_numpy(seeded(33, (3, 2, 4))))
    assert b.shape == (3, 4, 4) and b.has_leading_dims


def test_ov_qk_circuits_match_jax():
    jax_model, port = seeded_models(CONFIGS["clip_like"], seed=8)
    for name in ("OV", "QK"):
        want, got = getattr(jax_model, name), getattr(port, name)
        assert got.shape == want.shape
        _fm_close(want.AB, got.AB, name)
        _fm_close(want.S, got.S, name + ".S")
        _fm_close(want.norm(), got.norm(), name + ".norm")
    _fm_close(jax_model.OV[1, 2].AB, port.OV[1, 2].AB, "OV[1, 2]")


@pytest.mark.parametrize("layer,mlp_input,include_mlp", [
    (0, False, True), (1, False, True), (2, False, False), (1, True, True), (0, True, False)])
def test_accumulated_bias_matches_jax(layer, mlp_input, include_mlp):
    fields = CONFIGS["clip_like"]
    jax_model, port = seeded_models(fields, seed=9)
    want = jax_model.accumulated_bias(layer, mlp_input, include_mlp_biases=include_mlp)
    got = port.accumulated_bias(layer, mlp_input, include_mlp_biases=include_mlp)
    assert got.dtype == torch.float32
    assert_close(want, got, 1e-6, "accumulated_bias")


def test_tokens_to_residual_directions_matches_jax():
    jax_model, port = seeded_models(CONFIGS["clip_like"], seed=9)
    for labels in ([3], [0, 5, 2], np.array([1, 1, 4])):
        want = jax_model.tokens_to_residual_directions(labels)
        got = port.tokens_to_residual_directions(labels)
        assert tuple(got.shape) == (len(labels), 16)
        assert_close(want, got, 0.0, "directions")


# ---------------------------------------------------------------------------
# Logit lens
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("incl_mid", [False, True])
def test_patch_logit_directions_match_jax(incl_mid):
    want_cache, got_cache, _, _ = _caches("clip_like")
    answers = seeded(50, (10, 16))
    want, wl = jax_lens.get_patch_logit_directions(want_cache, answers, incl_mid=incl_mid)
    got, gl = port_lens.get_patch_logit_directions(got_cache, torch.from_numpy(answers),
                                                   incl_mid=incl_mid)
    assert gl == wl and tuple(got.shape) == tuple(want.shape)
    assert_close(want, got, ATOL, "directions")
    only = port_lens.get_patch_logit_directions(got_cache, answers, incl_mid=incl_mid,
                                                return_labels=False)
    assert torch.equal(only, got)


def test_patch_logit_dictionary_matches_jax():
    want_cache, got_cache, _, _ = _caches("clip_like")
    answers = seeded(51, (1000, 16))
    want = jax_lens.get_patch_logit_directions(want_cache, answers)
    got = port_lens.get_patch_logit_directions(got_cache, answers)
    names = port_names.load_imagenet_dict()

    def by_name(word):
        return port_names.imagenet_index_from_word(word, mapping=names)

    for kw in (dict(), dict(class_names=names),
               dict(class_names=[names[i] for i in range(1000)], batch_idx=1),
               dict(class_names=names, rank_label="goldfish", name_to_index=by_name)):
        w = jax_lens.get_patch_logit_dictionary(want, **kw)
        g = port_lens.get_patch_logit_dictionary(got, **kw)
        assert list(g) == list(w)
        for patch in w:
            assert [t[1:] for t in g[patch]] == [t[1:] for t in w[patch]], patch
            np.testing.assert_allclose([t[0] for t in g[patch]], [t[0] for t in w[patch]],
                                       atol=ATOL)


# ---------------------------------------------------------------------------
# to_numpy, Slice, test_prompt, ImageNet tables
# ---------------------------------------------------------------------------

SLICE_INPUTS = {
    "none": None, "int": 2, "negative_int": -1, "pair": (1, 4), "triple": (0, 5, 2),
    "list": [0, 3, 1], "array": np.array([4, 2]), "slice": slice(1, None, 2),
    "numpy_int": np.int64(3),
}


@pytest.mark.parametrize("kind", list(SLICE_INPUTS))
def test_slice_matches_jax(kind):
    arg = SLICE_INPUTS[kind]
    want_s, got_s = jax_utils.Slice(arg), port_utils.Slice(arg)
    assert got_s.mode == want_s.mode
    x = seeded(60, (5, 6, 7))
    for dim in (0, 1, -1, -2):
        want = want_s.apply(x, dim=dim)
        for got in (got_s.apply(x, dim=dim), got_s.apply(torch.from_numpy(x), dim=dim)):
            np.testing.assert_array_equal(port_utils.to_numpy(got), want, err_msg=str(dim))
    if got_s.mode != "identity" or kind == "none":
        np.testing.assert_array_equal(got_s.indices(6), want_s.indices(6))
    assert repr(got_s) == repr(want_s)
    again = port_utils.Slice(got_s)
    assert (again.mode, repr(again)) == (got_s.mode, repr(got_s))


def test_slice_of_tensor_and_errors():
    s = port_utils.Slice(torch.tensor([3, 0]))
    assert s.mode == "array"
    np.testing.assert_array_equal(s.apply(torch.arange(5)).numpy(), [3, 0])
    with pytest.raises(ValueError, match="Invalid slice"):
        port_utils.Slice("x")
    with pytest.raises(ValueError, match="max_ctx"):
        port_utils.Slice(None).indices()


@pytest.mark.parametrize("value", [
    np.arange(3.0), [1, 2], (3, 4), 5, 2.5, True, np.float32(1.5),
    torch.arange(4.0), torch.ones(2, requires_grad=True), torch.arange(3).bfloat16()])
def test_to_numpy_matches_jax(value):
    got = port_utils.to_numpy(value)
    assert isinstance(got, np.ndarray)
    want = jax_utils.to_numpy(value.float() if isinstance(value, torch.Tensor) else value)
    np.testing.assert_array_equal(got, want)


def test_test_prompt_prints_as_jax(capsys):
    logits = seeded(70, (1, 1000), 3.0)
    port_utils.test_prompt(np.zeros((3, 8, 8), np.float32), lambda x: torch.from_numpy(logits),
                           example_answer="goldfish", top_k=7)
    got = capsys.readouterr().out
    jax_utils.test_prompt(np.zeros((3, 8, 8), np.float32), lambda x: logits,
                          example_answer="goldfish", top_k=7)
    want = capsys.readouterr().out
    assert got == want and got.count("\n") == 9
    names = [f"c{i}" for i in range(1000)]
    port_utils.test_prompt(np.zeros((3, 8, 8), np.float32), lambda x: torch.from_numpy(logits),
                           top_k=3, class_names=names)
    got = capsys.readouterr().out
    jax_utils.test_prompt(np.zeros((3, 8, 8), np.float32), lambda x: logits,
                          top_k=3, class_names=names)
    assert got == capsys.readouterr().out


def test_test_prompt_runs_the_model(capsys):
    """On a model the image goes to the parameters' device and the lines
    name the model's top classes, as JAX's do for the same weights."""
    fields = dict(CONFIGS["clip_like"], n_classes=1000)
    jax_model, port = seeded_models(fields, seed=11)
    image = seeded(71, (3, 8, 8))
    port_utils.test_prompt(image, port, top_k=4)
    got = capsys.readouterr().out.splitlines()
    jax_utils.test_prompt(image, jax_model, top_k=4)
    want = capsys.readouterr().out.splitlines()
    assert [g.split("Label:")[1] for g in got] == [w.split("Label:")[1] for w in want]


def test_imagenet_tables_match_jax():
    for name in ("imagenet_dict.json", "imagenet_emoji.json", "imagenet100_classes.json"):
        with open(os.path.join(jax_names._DATA_DIR, name)) as f:
            want = json.load(f)
        with open(os.path.join(port_names._DATA_DIR, name)) as f:
            assert json.load(f) == want, name
    assert port_names.load_imagenet_dict() == jax_names.load_imagenet_dict()
    assert port_names.load_imagenet_emoji() == jax_names.load_imagenet_emoji()
    assert port_names.load_imagenet100_classes() == jax_names.load_imagenet100_classes()
    assert port_names.get_imagenet_text_labels() == jax_names.get_imagenet_text_labels()
    for word in ("goldfish", "tabby", "Zebra"):
        assert port_names.imagenet_index_from_word(word) == jax_names.imagenet_index_from_word(word)
    with pytest.raises(KeyError):
        port_names.imagenet_index_from_word("no such class")
    assert port_names.load_imagenet_dict(n_classes=7) == jax_names.load_imagenet_dict(n_classes=7)


# ---------------------------------------------------------------------------
# HookedSAEViT
# ---------------------------------------------------------------------------

def test_sae_vit_run_with_cache_returns_the_cache_object():
    from tests.test_torch_sae_vit import _models, _x
    jax_model, port, jax_sae, port_sae = _models("relu")
    x = _x()
    _, want = jax_model.run_with_cache_with_saes(jnp.asarray(x), saes=[jax_sae])
    _, got = port.run_with_cache_with_saes(torch.from_numpy(x), saes=[port_sae])
    assert isinstance(got, ActivationCache) and got.model is port
    assert list(got) == list(want)
    for k in want:
        assert_close(want[k], got[k], ATOL, k)
    _assert_same(want.accumulated_resid(layer=1, return_labels=True),
                 got.accumulated_resid(layer=1, return_labels=True), "accumulated_resid")
    _, plain = port.run_with_cache_with_saes(torch.from_numpy(x), saes=[port_sae],
                                             return_cache_object=False)
    assert type(plain) is dict and list(plain) == list(got)
    with port.saes(saes=[port_sae]):
        _, spliced = port.run_with_cache(torch.from_numpy(x), names_filter=lambda n: "sae" in n)
    assert isinstance(spliced, ActivationCache)
    assert list(spliced) == ["blocks.1.hook_resid_post.hook_sae_in",
                             "blocks.1.hook_resid_post.hook_sae_out"]
