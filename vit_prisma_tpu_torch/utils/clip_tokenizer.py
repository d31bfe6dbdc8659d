"""Self-contained CLIP BPE tokenizer (a copy of
``vit_prisma_tpu/utils/clip_tokenizer.py``, which imports no JAX; the port
keeps its own, held to it id for id by ``tests/test_torch_zero_shot.py``).

It implements CLIP's lower-cased close-vocabulary BPE (49,408 entries: 256
byte symbols, 256 byte+``</w>`` symbols, 48,894 learned merges, 2 special
tokens) with no external tokenizer, so the zero-shot classifier builds from
raw strings offline.

The *algorithm* (byte-to-unicode mapping, rank-ordered pair merging with an
end-of-word marker, the token split regex) is the public CLIP/GPT-2 BPE
scheme; the *learned merge table* is data, loaded from disk:

* the packaged file ``dataloaders/data/bpe_simple_vocab_16e6.txt.gz``
  (OpenAI format) if present (not shipped: drop the public file there to
  enable ``get_default_tokenizer()``);
* a path in ``$VIT_PRISMA_TPU_CLIP_BPE`` (either the OpenAI ``.txt.gz``
  or a HuggingFace ``merges.txt``);
* an explicit ``CLIPTokenizer.from_file(path)``.

It runs once per prompt at classifier-build time, in Python on the host.
The only change from the JAX module: ftfy, which is optional, is imported
once with the module instead of at every ``_clean``.
"""

from __future__ import annotations

import gzip
import html
import os
from functools import lru_cache
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

try:  # optional mojibake repair; ASCII classnames and templates need none
    import ftfy
except ImportError:
    ftfy = None

# The two CLIP special tokens, in vocab order (ids 49406, 49407 with the
# full table).  open_clip also accepts the <start_of_text> spelling; both
# map to the same ids.
SOT = "<|startoftext|>"
EOT = "<|endoftext|>"
CONTEXT_LENGTH = 77
# OpenAI's file carries ~262k candidate merges; CLIP uses the first
# 49152 - 256 - 2 - 256 = 48894 so the final vocab is exactly 49408.
N_CLIP_MERGES = 49152 - 256 - 2 - 256

_PACKAGED_BPE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "dataloaders", "data", "bpe_simple_vocab_16e6.txt.gz")


@lru_cache()
def byte_unicode_table() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable-unicode map: printable latin-1
    bytes map to themselves, the rest to the 256.. codepoint block, so BPE
    operates on strings with no whitespace/control characters."""
    keep = list(range(ord("!"), ord("~") + 1)) \
        + list(range(ord("\xa1"), ord("\xac") + 1)) \
        + list(range(ord("\xae"), ord("\xff") + 1))
    table: Dict[int, str] = {b: chr(b) for b in keep}
    shift = 0
    for b in range(256):
        if b not in table:
            table[b] = chr(256 + shift)
            shift += 1
    return table


def _clean(text: str) -> str:
    """basic_clean + whitespace_clean: optional ftfy mojibake repair,
    double HTML unescape, whitespace collapse.  ftfy is looked up once, at
    import: an import that fails is not cached, and retrying it for every
    prompt cost more than the BPE itself (a failed import searches
    ``sys.path`` again each time)."""
    if ftfy is not None:
        text = ftfy.fix_text(text)
    text = html.unescape(html.unescape(text))
    return " ".join(text.split()).strip()


def _merge_pass(symbols: List[str], pair: Tuple[str, str]) -> List[str]:
    """Fuse every non-overlapping left-to-right occurrence of ``pair``."""
    fused: List[str] = []
    i, n = 0, len(symbols)
    while i < n:
        if i + 1 < n and symbols[i] == pair[0] and symbols[i + 1] == pair[1]:
            fused.append(pair[0] + pair[1])
            i += 2
        else:
            fused.append(symbols[i])
            i += 1
    return fused


class CLIPTokenizer:
    """CLIP's close-vocabulary lower-cased BPE.

    ``merges`` is the ordered learned pair table; the vocabulary is derived
    from it deterministically (bytes, bytes+``</w>``, merges, specials), so
    a single data file fully specifies the tokenizer.
    """

    def __init__(self, merges: Sequence[Tuple[str, str]],
                 extra_special_tokens: Sequence[str] = ()):
        import regex  # unicode-category classes (\p{L}) need `regex`

        merges = [tuple(m) for m in merges[:N_CLIP_MERGES]]
        self.byte_encoder = byte_unicode_table()
        self.byte_decoder = {c: b for b, c in self.byte_encoder.items()}
        self.ranks: Dict[Tuple[str, str], int] = {
            pair: rank for rank, pair in enumerate(merges)}

        symbols = list(self.byte_encoder.values())
        vocab = symbols + [s + "</w>" for s in symbols] \
            + ["".join(pair) for pair in merges]
        self.special_tokens = [SOT, EOT, *extra_special_tokens]
        vocab += self.special_tokens
        self.encoder: Dict[str, int] = {t: i for i, t in enumerate(vocab)}
        self.decoder: Dict[int, str] = {i: t for t, i in self.encoder.items()}
        self.sot_id = self.encoder[SOT]
        self.eot_id = self.encoder[EOT]
        self.vocab_size = len(self.encoder)
        self._word_cache: Dict[str, List[str]] = {
            t: [t] for t in self.special_tokens}
        specials = "|".join(regex.escape(t) for t in self.special_tokens)
        self._split = regex.compile(
            specials
            + r"""|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
            regex.IGNORECASE)

    # -- construction from data files ------------------------------------

    @classmethod
    def from_file(cls, path: str, **kw) -> "CLIPTokenizer":
        """Load from either data format: OpenAI ``bpe_simple_vocab_16e6
        .txt.gz`` (gzip, version header line) or HuggingFace ``merges.txt``
        (plain text, ``#version`` header)."""
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            lines = f.read().decode("utf-8").split("\n")
        # both formats open with a version header ("...txt#version: 0.2"
        # in the OpenAI gz, "#version: 0.2" in HF merges.txt)
        if lines and ("#version" in lines[0] or not _is_merge_line(lines[0])):
            lines = lines[1:]
        merges = [tuple(ln.split()) for ln in lines if _is_merge_line(ln)]
        if len(merges) < 1:
            raise ValueError(f"no BPE merges parsed from {path}")
        return cls(merges, **kw)

    # -- encoding ---------------------------------------------------------

    def _bpe_word(self, token: str) -> List[str]:
        """BPE-merge one pre-split token (already byte-mapped); the last
        symbol carries the ``</w>`` end-of-word marker."""
        cached = self._word_cache.get(token)
        if cached is not None:
            return cached
        word = list(token[:-1]) + [token[-1] + "</w>"]
        while len(word) > 1:
            # lowest-rank adjacent pair anywhere in the word ...
            best: Optional[Tuple[str, str]] = None
            best_rank = len(self.ranks)
            for pair in zip(word, word[1:]):
                rank = self.ranks.get(pair, -1)
                if 0 <= rank < best_rank:
                    best, best_rank = pair, rank
            if best is None:
                break
            # ... fused at every occurrence before re-ranking
            word = _merge_pass(word, best)
        self._word_cache[token] = word
        return word

    def encode(self, text: str) -> List[int]:
        """Raw string -> BPE ids (no SOT/EOT, no padding)."""
        ids: List[int] = []
        for token in self._split.findall(_clean(text).lower()):
            if token in self.special_tokens:
                ids.append(self.encoder[token])
                continue
            mapped = "".join(self.byte_encoder[b]
                             for b in token.encode("utf-8"))
            ids.extend(self.encoder[s] for s in self._bpe_word(mapped))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        for t in self.special_tokens:
            text = text.replace(t, "")
        raw = bytes(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def __call__(self, texts: Union[str, Sequence[str]],
                 context_length: int = CONTEXT_LENGTH,
                 truncate: bool = True) -> np.ndarray:
        """Batch tokenize to a zero-padded ``[n, context_length]`` int32
        array with SOT/EOT framing; over-long prompts truncate with EOT
        kept as the final token (open_clip's ``tokenize`` semantics — the
        text transformer pools at the EOT position, models/text.py)."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), np.int32)
        for row, text in enumerate(texts):
            ids = [self.sot_id, *self.encode(text), self.eot_id]
            if len(ids) > context_length:
                if not truncate:
                    raise ValueError(
                        f"input {row} is {len(ids)} tokens "
                        f"(> context_length={context_length})")
                ids = ids[:context_length]
                ids[-1] = self.eot_id
            out[row, :len(ids)] = ids
        return out


def _is_merge_line(line: str) -> bool:
    return len(line.split()) == 2


@lru_cache()
def get_default_tokenizer() -> CLIPTokenizer:
    """The full 49,408-entry CLIP tokenizer, from the packaged data file or
    ``$VIT_PRISMA_TPU_CLIP_BPE``."""
    for path in (os.environ.get("VIT_PRISMA_TPU_CLIP_BPE"), _PACKAGED_BPE):
        if path and os.path.exists(path) and os.path.getsize(path) > 0:
            return CLIPTokenizer.from_file(path)
    raise FileNotFoundError(
        "CLIP BPE merge table not found. Place the public "
        "bpe_simple_vocab_16e6.txt.gz (openai/CLIP) at "
        f"{_PACKAGED_BPE} or point $VIT_PRISMA_TPU_CLIP_BPE at it "
        "(a HuggingFace CLIP merges.txt also works).")


def tokenize(texts: Union[str, Sequence[str]],
             context_length: int = CONTEXT_LENGTH) -> np.ndarray:
    """Module-level convenience mirroring ``open_clip.tokenize``."""
    return get_default_tokenizer()(texts, context_length=context_length)
