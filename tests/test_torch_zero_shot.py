"""The port's CLIP tokenizer, prompt templates and zero-shot evaluation
against the JAX package's: the tokenizer id for id on a synthetic merge
table (the public table is not in the repository) in both file formats,
with framing, truncation and special tokens; the templates; the zero-shot
classifier on the same text-tower weights; ``accuracy``, ``run`` (with and
without forward hooks, and a bfloat16 image model against a float32
classifier) and ``zero_shot_eval`` with equal counts, tied logits
included; ``load_classifier``/``save_classifier``; ``load_model`` and
``load_sae_and_model`` for both model classes.

Tolerances: token ids, counts and loaded weights exact; classifier columns
within 1e-5 of max(1, absmax) (float32, summation order)."""

import gzip
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_prisma_tpu
import vit_prisma_tpu_torch
from tests._torch_parity import seeded_models
from vit_prisma_tpu.model_eval import zero_shot as jax_zs
from vit_prisma_tpu.models import text as jax_text
from vit_prisma_tpu.utils import clip_tokenizer as jax_tok
from vit_prisma_tpu.utils import load_model as jax_load_model
from vit_prisma_tpu.utils import openai_templates as jax_templates
from vit_prisma_tpu_torch.model_eval import zero_shot as port_zs
from vit_prisma_tpu_torch.models.loading import state_dict as port_sd
from vit_prisma_tpu_torch.utils import clip_tokenizer as port_tok
from vit_prisma_tpu_torch.utils import load_model as port_load_model
from vit_prisma_tpu_torch.utils import openai_templates as port_templates

F32_REL = 1e-5

# The merge table and strings of tests/test_clip_tokenizer.py: `h e` outranks
# `t h`, merged pairs feed later merges, `l l` / `ll o</w>` chain passes.
SYNTH_MERGES = [
    ("h", "e"), ("t", "h"), ("th", "e</w>"), ("l", "l"), ("ll", "o</w>"), ("he", "ll"),
    ("a", "n"), ("an", "d</w>"), ("i", "n"), ("in", "g</w>"), ("o", "f</w>"), ("c", "a"),
    ("ca", "t</w>"), ("1", "2"), ("ĠĠ", "ĠĠ"), ("e", "r</w>"), ("he", "r</w>"), ("t", "t"),
    ("tt", "t"),
]
TRICKY_TEXTS = [
    "hello the cat and the hat",
    "Doesn't it's we're I'll they'd you've I'm",
    "hello, world!! -- (parens) [brackets] ...",
    "123 456 7th a1b2",
    "café naïve 東京 über",
    "thththth ttttt hehehe",
    "HeLLo THE CaT AnD",
    "  leading   and\ttrailing \n whitespace  ",
    "a&amp;b &lt;tag&gt;",
    "of of of offff",
    "",
    "x",
    "hello <|endoftext|> cat <|startoftext|>",
]
# the synthetic table's vocabulary: 512 byte symbols, the merges, SOT, EOT
SYNTH_VOCAB = 512 + len(SYNTH_MERGES) + 2


def _write_openai_gz(path, merges):
    lines = ["bpe_simple_vocab_16e6.txt#version: 0.2"] + [f"{a} {b}" for a, b in merges]
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(lines))


def _write_hf_merges(path, merges):
    path.write_text("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges) + "\n")


@pytest.fixture(scope="module", params=["openai_gz", "hf_merges"])
def tokenizers(request, tmp_path_factory):
    """(JAX's, the port's) tokenizer from one synthetic table file."""
    tmp = tmp_path_factory.mktemp("bpe")
    if request.param == "openai_gz":
        path = tmp / "bpe_simple_vocab_16e6.txt.gz"
        _write_openai_gz(path, SYNTH_MERGES)
    else:
        path = tmp / "merges.txt"
        _write_hf_merges(path, SYNTH_MERGES)
    return (jax_tok.CLIPTokenizer.from_file(str(path)),
            port_tok.CLIPTokenizer.from_file(str(path)))


def test_tokenizer_encode_and_vocab_match_jax(tokenizers):
    want, got = tokenizers
    assert got.encoder == want.encoder and got.vocab_size == want.vocab_size == SYNTH_VOCAB
    assert (got.sot_id, got.eot_id) == (want.sot_id, want.eot_id) == (SYNTH_VOCAB - 2,
                                                                     SYNTH_VOCAB - 1)
    assert port_tok.byte_unicode_table() == jax_tok.byte_unicode_table()
    for text in TRICKY_TEXTS:
        assert got.encode(text) == want.encode(text), repr(text)
        assert got.decode(got.encode(text)) == want.decode(want.encode(text)), repr(text)
    prompts = [t.format(c=c) for t in port_templates.OPENAI_IMAGENET_TEMPLATE_STRINGS
               for c in ("tench", "great white shark", "jack-o'-lantern")]
    np.testing.assert_array_equal(got(prompts), want(prompts))


def test_tokenizer_framing_truncation_and_specials_match_jax(tokenizers):
    want, got = tokenizers
    for ctx in (8, 77):
        arr = got(TRICKY_TEXTS, context_length=ctx)
        assert arr.dtype == np.int32 and arr.shape == (len(TRICKY_TEXTS), ctx)
        np.testing.assert_array_equal(arr, want(TRICKY_TEXTS, context_length=ctx))
    long = got("hello " * 50, context_length=8)
    np.testing.assert_array_equal(long, want("hello " * 50, context_length=8))
    assert long[0, 0] == got.sot_id and long[0, -1] == got.eot_id
    for tok in (want, got):
        with pytest.raises(ValueError, match="context_length=8"):
            tok("hello " * 50, context_length=8, truncate=False)
    assert got.eot_id in got.encode("hello <|endoftext|> cat")
    np.testing.assert_array_equal(got("the"), want("the"))  # a single string


def test_tokenizer_applies_ftfy_where_installed(tokenizers, monkeypatch):
    """ftfy is optional: JAX's module imports it at every call, the port's
    once at import; with it present both repair the text first."""
    stub = types.SimpleNamespace(fix_text=lambda s: s.replace("x", "cat"))
    monkeypatch.setitem(sys.modules, "ftfy", stub)
    monkeypatch.setattr(port_tok, "ftfy", stub)
    want, got = tokenizers
    assert got.encode("x and x") == want.encode("x and x") == want.encode("cat and cat")


def test_tokenizer_extra_special_tokens_and_bad_file_match_jax(tmp_path):
    path = tmp_path / "merges.txt"
    _write_hf_merges(path, SYNTH_MERGES)
    want = jax_tok.CLIPTokenizer.from_file(str(path), extra_special_tokens=["<|pad|>"])
    got = port_tok.CLIPTokenizer.from_file(str(path), extra_special_tokens=["<|pad|>"])
    assert got.encoder == want.encoder
    assert got.encode("a <|pad|> cat") == want.encode("a <|pad|> cat")
    empty = tmp_path / "empty.txt"
    empty.write_text("#version: 0.2\n")
    with pytest.raises(ValueError, match="no BPE merges"):
        port_tok.CLIPTokenizer.from_file(str(empty))


def test_default_tokenizer_from_the_environment(tmp_path, monkeypatch):
    path = tmp_path / "bpe.txt.gz"
    _write_openai_gz(path, SYNTH_MERGES)
    monkeypatch.setenv("VIT_PRISMA_TPU_CLIP_BPE", str(path))
    port_tok.get_default_tokenizer.cache_clear()
    jax_tok.get_default_tokenizer.cache_clear()
    try:
        np.testing.assert_array_equal(port_tok.tokenize(["a cat", "the hello"]),
                                      jax_tok.tokenize(["a cat", "the hello"]))
        monkeypatch.delenv("VIT_PRISMA_TPU_CLIP_BPE")
        port_tok.get_default_tokenizer.cache_clear()
        if not port_tok.os.path.exists(port_tok._PACKAGED_BPE):
            with pytest.raises(FileNotFoundError, match="bpe_simple_vocab"):
                port_tok.get_default_tokenizer()
    finally:
        port_tok.get_default_tokenizer.cache_clear()
        jax_tok.get_default_tokenizer.cache_clear()


def test_templates_match_jax():
    assert (port_templates.OPENAI_IMAGENET_TEMPLATE_STRINGS
            == jax_templates.OPENAI_IMAGENET_TEMPLATE_STRINGS)
    assert len(port_templates.OPENAI_IMAGENET_TEMPLATE_STRINGS) == 80
    assert ([f("cat") for f in port_templates.OPENAI_IMAGENET_TEMPLATES]
            == [f("cat") for f in jax_templates.OPENAI_IMAGENET_TEMPLATES])
    assert (port_templates.apply_template("a {c}.", "cat")
            == jax_templates.apply_template("a {c}.", "cat"))


# A text tower over the synthetic table's vocabulary at CLIP's context.
TEXT = dict(n_layers=2, d_model=32, d_head=8, n_heads=4, d_mlp=64, context_length=77,
            vocab_size=SYNTH_VOCAB, n_classes=16, activation_name="quick_gelu", eps=1e-5,
            return_type="class_logits", normalize_output=True)
CLASSNAMES = ["tench", "goldfish", "great white shark", "tiger shark", "hammerhead"]


def _text_towers(fields, seed=0):
    """Both packages' text towers with the same seeded weights (scales as
    in tests/test_torch_text.py)."""
    jcfg = vit_prisma_tpu.TextTransformerConfig(**fields)
    rng = np.random.default_rng(seed)
    flat = {}
    for k, v in sorted(jax_text.unstack_text_params(
            jax_text.init_text_params(jcfg, jax.random.PRNGKey(0)), jcfg).items()):
        shape, leaf = np.shape(v), k.rsplit(".", 1)[-1]
        z = rng.standard_normal(shape)
        z = (1.0 + 0.1 * z if leaf == "w" else 0.1 * z if leaf.startswith("b")
             else 0.5 * z if k in ("token_embed.W_E", "pos_embed.W_pos")
             else z / np.sqrt(shape[-2]))
        flat[k] = z.astype(np.float32)
    want = vit_prisma_tpu.HookedTextTransformer(jcfg,
                                                params=jax_text.stack_text_params(flat, jcfg))
    got = vit_prisma_tpu_torch.HookedTextTransformer(
        vit_prisma_tpu_torch.TextTransformerConfig(**fields), device="cpu")
    got.load_state_dict(flat)
    return want, got


def _close(want, got, rel=F32_REL, name=""):
    w = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), w, rtol=0,
                               atol=rel * max(1.0, float(np.abs(w).max())), err_msg=name)


@pytest.mark.parametrize("batch_size", [64, 7])
def test_zero_shot_classifier_matches_jax(tokenizers, batch_size):
    jtok, ptok = tokenizers
    want_model, got_model = _text_towers(TEXT)
    want = jax_zs.zero_shot_classifier(want_model, jtok, CLASSNAMES, batch_size=batch_size)
    got = port_zs.zero_shot_classifier(got_model, ptok, CLASSNAMES, batch_size=batch_size)
    assert tuple(got.shape) == tuple(want.shape) == (16, len(CLASSNAMES))
    _close(want, got, name="classifier")
    np.testing.assert_allclose(torch.linalg.norm(got, dim=0).numpy(), 1.0, rtol=1e-5)
    # callable templates and the default tokenizer, as in JAX
    templates = [lambda c: f"a photo of a {c}.", "the {c}"]
    _close(jax_zs.zero_shot_classifier(want_model, jtok, CLASSNAMES[:2], templates=templates),
           port_zs.zero_shot_classifier(got_model, ptok, CLASSNAMES[:2], templates=templates))


def test_zero_shot_classifier_bfloat16_matches_jax(tokenizers):
    jtok, ptok = tokenizers
    want_model, got_model = _text_towers(dict(TEXT, dtype="bfloat16"), seed=1)
    want = jax_zs.zero_shot_classifier(want_model, jtok, CLASSNAMES[:3])
    got = port_zs.zero_shot_classifier(got_model, ptok, CLASSNAMES[:3])
    assert got.dtype == torch.bfloat16
    _close(want, got, rel=3e-2, name="bf16 classifier")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_accuracy_with_ties_matches_jax(dtype):
    rng = np.random.default_rng(3)
    # logits drawn from 4 values: many ties inside each row's top 5
    logits = rng.integers(0, 4, size=(64, 10)).astype(np.float32)
    logits[:8] = 1.0  # rows of one value
    target = rng.integers(0, 10, size=64)
    want = jax_zs.accuracy(jnp.asarray(logits, dtype), jnp.asarray(target), topk=(1, 3, 5))
    got = port_zs.accuracy(torch.from_numpy(logits).to(getattr(torch, dtype)),
                           torch.from_numpy(target), topk=(1, 3, 5))
    assert got == want


# Image towers: a CLIP-like ViT whose 16-wide output meets the classifier.
VISION = dict(n_layers=2, d_model=32, d_head=8, n_heads=4, d_mlp=64, patch_size=8,
              image_size=16, n_classes=16, activation_name="quick_gelu", layer_norm_pre=True,
              return_type="class_logits", normalize_output=True)


def _batches(n, bs, seed, n_classes):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((n, 3, 16, 16)).astype(np.float32)
    labels = rng.integers(0, n_classes, size=n)
    return [(images[i:i + bs], labels[i:i + bs]) for i in range(0, n, bs)]


def _classifier(n_classes, seed=4):
    c = np.random.default_rng(seed).standard_normal((16, n_classes)).astype(np.float32)
    return c / np.linalg.norm(c, axis=0)


@pytest.mark.parametrize("hooked", [False, True])
def test_run_matches_jax(hooked):
    jax_model, port = seeded_models(VISION, seed=5)
    classifier = _classifier(8)
    data = _batches(24, 8, 6, 8)
    jhooks = [("blocks.1.hook_resid_pre", lambda v, h: v * 0.5)] if hooked else None
    phooks = [("blocks.1.hook_resid_pre", lambda v, h: v * 0.5)] if hooked else None
    want = jax_zs.run(jax_model, jnp.asarray(classifier),
                      [(jnp.asarray(x), jnp.asarray(y)) for x, y in data], fwd_hooks=jhooks)
    got = port_zs.run(port, torch.from_numpy(classifier),
                      [(torch.from_numpy(x), torch.from_numpy(y)) for x, y in data],
                      fwd_hooks=phooks)
    assert got == want
    assert 0.0 <= got[0] <= got[1] <= 1.0


def test_run_bfloat16_model_float32_classifier_matches_jax():
    """A bfloat16 image model's scaled features against a float32
    classifier: both packages multiply in float32 (the classifier is not cast
    down)."""
    fields = dict(VISION, dtype="bfloat16")
    jax_model, port = seeded_models(fields, seed=7)
    classifier = _classifier(8, seed=8)
    data = _batches(24, 8, 9, 8)
    want = jax_zs.run(jax_model, jnp.asarray(classifier),
                      [(jnp.asarray(x), jnp.asarray(y)) for x, y in data])
    got = port_zs.run(port, torch.from_numpy(classifier),
                      [(torch.from_numpy(x), torch.from_numpy(y)) for x, y in data])
    assert got == want


def test_zero_shot_eval_matches_jax(tokenizers):
    jtok, ptok = tokenizers
    want_text, got_text = _text_towers(TEXT, seed=10)
    jax_model, port = seeded_models(VISION, seed=11)
    val, v2 = _batches(16, 8, 12, len(CLASSNAMES)), _batches(8, 4, 13, len(CLASSNAMES))
    jdata = {"imagenet-val": val, "imagenet-v2": v2}
    want = jax_zs.zero_shot_eval(jax_model, jdata, text_encoder=want_text, tokenizer=jtok,
                                 classnames=CLASSNAMES)
    got = port_zs.zero_shot_eval(port, jdata, text_encoder=got_text, tokenizer=ptok,
                                 classnames=CLASSNAMES)
    assert got == want and sorted(got) == sorted(
        ["imagenet-zeroshot-val-top1", "imagenet-zeroshot-val-top5",
         "imagenetv2-zeroshot-val-top1", "imagenetv2-zeroshot-val-top5"])
    classifier = _classifier(len(CLASSNAMES), seed=14)
    hooks = [("blocks.0.hook_resid_post", lambda v, h: v * 0.0)]
    assert (port_zs.zero_shot_eval(port, {"imagenet-val": val},
                                   pretrained_classifier=torch.from_numpy(classifier),
                                   fwd_hooks=hooks)
            == jax_zs.zero_shot_eval(jax_model, {"imagenet-val": val},
                                     pretrained_classifier=jnp.asarray(classifier),
                                     fwd_hooks=hooks))
    assert port_zs.zero_shot_eval(port, {"other": val}) == {}
    with pytest.raises(ValueError, match="text_encoder"):
        port_zs.zero_shot_eval(port, {"imagenet-val": val})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_save_and_load_classifier(tmp_path, dtype):
    classifier = torch.from_numpy(_classifier(6)).to(getattr(torch, dtype))
    path = str(tmp_path / "sub" / "classifier.npy")
    port_zs.save_classifier(path, classifier)
    got = port_zs.load_classifier(path)
    assert got.dtype == classifier.dtype and torch.equal(got, classifier)
    # a file the JAX package wrote
    jax_path = str(tmp_path / "jax.npy")
    jax_classifier = jnp.asarray(_classifier(6), dtype)
    jax_zs.save_classifier(jax_path, jax_classifier)
    want = torch.from_numpy(np.asarray(jax_classifier.astype(jnp.float32)))
    loaded = port_zs.load_classifier(jax_path)
    assert loaded.dtype == classifier.dtype and torch.equal(loaded.float(), want)


# load_model / load_sae_and_model: an HF CLIPModel state dict of both towers.
D, L, M, E, VOCAB, CTX = 32, 2, 64, 16, 50, 12
OVERRIDES = {
    "HookedViT": dict(n_layers=L, d_model=D, n_heads=4, d_head=8, d_mlp=M, n_classes=E,
                      patch_size=8, image_size=16),
    "HookedTextTransformer": dict(n_layers=L, d_model=D, n_heads=4, d_head=8, d_mlp=M,
                                  n_classes=E, vocab_size=VOCAB, context_length=CTX),
}


def _clip_model_sd(seed):
    layout = {"vision_model.embeddings.class_embedding": (D,),
              "vision_model.embeddings.position_embedding.weight": (5, D),
              "vision_model.embeddings.patch_embedding.weight": (D, 3, 8, 8),
              "vision_model.pre_layrnorm.weight": (D,), "vision_model.pre_layrnorm.bias": (D,),
              "vision_model.post_layernorm.weight": (D,),
              "vision_model.post_layernorm.bias": (D,), "visual_projection.weight": (E, D),
              "text_model.embeddings.token_embedding.weight": (VOCAB, D),
              "text_model.embeddings.position_embedding.weight": (CTX, D),
              "text_model.final_layer_norm.weight": (D,),
              "text_model.final_layer_norm.bias": (D,), "text_projection.weight": (E, D)}
    for tower in ("vision_model.", "text_model."):
        for l in range(L):
            k = f"{tower}encoder.layers.{l}."
            for i in (1, 2):
                layout[f"{k}layer_norm{i}.weight"] = layout[f"{k}layer_norm{i}.bias"] = (D,)
            for m in ("q", "k", "v", "out"):
                layout[f"{k}self_attn.{m}_proj.weight"] = (D, D)
                layout[f"{k}self_attn.{m}_proj.bias"] = (D,)
            layout.update({k + "mlp.fc1.weight": (M, D), k + "mlp.fc1.bias": (M,),
                           k + "mlp.fc2.weight": (D, M), k + "mlp.fc2.bias": (D,)})
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * 0.3).astype(np.float32) for k, s in layout.items()}


def _jax_flat(model):
    if isinstance(model, vit_prisma_tpu.HookedTextTransformer):
        return jax_text.unstack_text_params(model.params, model.cfg)
    return model.state_dict()


@pytest.mark.parametrize("model_class", list(OVERRIDES))
def test_load_model_and_sae_match_jax(model_class, tmp_path):
    sd = _clip_model_sd(16)
    fields = dict(model_class_name=model_class, model_name="openai/clip-vit-base-patch32",
                  d_in=D, expansion_factor=2)
    jcfg = vit_prisma_tpu.sae.config.SAERunnerConfig(**fields)
    pcfg = vit_prisma_tpu_torch.sae.SAERunnerConfig(**fields)
    want = jax_load_model.load_model(jcfg, state_dict=sd, **OVERRIDES[model_class])
    got = port_load_model.load_model(pcfg, state_dict=sd, device="cpu",
                                     **OVERRIDES[model_class])
    assert type(got).__name__ == model_class
    want_flat, got_flat = _jax_flat(want), port_sd.reference_state_dict(got)
    assert sorted(got_flat) == sorted(want_flat)
    for k in want_flat:
        np.testing.assert_array_equal(got_flat[k].numpy(), np.asarray(want_flat[k]), err_msg=k)

    sae = vit_prisma_tpu_torch.sae.SparseAutoencoder(pcfg, device="cpu")
    path = str(tmp_path / "sae")
    sae.save_model(path)
    jsae, jmodel = jax_load_model.load_sae_and_model(path + ".npz", model_state_dict=sd,
                                                     **OVERRIDES[model_class])
    psae, pmodel = port_load_model.load_sae_and_model(path + ".npz", model_state_dict=sd,
                                                      device="cpu", **OVERRIDES[model_class])
    assert psae.cfg.to_dict() == pcfg.to_dict() and type(pmodel).__name__ == model_class
    for k, v in psae.params.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jsae.params[k]), err_msg=k)
    got_flat = port_sd.reference_state_dict(pmodel)
    for k, v in _jax_flat(jmodel).items():
        np.testing.assert_array_equal(got_flat[k].numpy(), np.asarray(v), err_msg=k)
    with pytest.raises(ValueError, match="Unknown model class"):
        port_load_model.load_model(pcfg.replace(model_class_name="Other"), state_dict=sd)
