"""CLIP byte-pair-encoding tokenizer (host-side, pure Python + numpy).

Counterpart of ``lc2is_tpu/ops/bpe.py`` (``tokenize``), kept in the port so
that the port imports nothing of the JAX package.  Same contract and the same
ids:

- with a merges file (env ``LC2IS_BPE_PATH`` or argument), OpenAI-CLIP byte
  level BPE (lowercase, whitespace-clean, ``</w>`` word suffix);
- without one, the deterministic fallback that maps each cleaned word to a
  stable id in the CLIP vocab range by FNV-1a hashing, with a linear reprobe
  so that two words never share an id.  The ids are not CLIP's, the shapes
  and SOT/EOT placement are.

``tokenize_batch_padded`` is the HF tokenizer's path (pad to the longest,
an attention mask), which ``data/collators.py`` takes for the reference's
text collators.
"""

from __future__ import annotations

import functools
import gzip
import html
import logging
import os
import re
from typing import List, Optional, Sequence, Union

import numpy as np

_LOG = logging.getLogger("lc2is_tpu_torch.bpe")
_LOG.addHandler(logging.NullHandler())

SOT = 49406
EOT = 49407


@functools.lru_cache()
def bytes_to_unicode():
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    return set(zip(word[:-1], word[1:]))


def _clean(text: str) -> str:
    """html-unescape twice, collapse whitespace, lowercase."""
    text = html.unescape(html.unescape(text)).strip()
    return re.sub(r"\s+", " ", text).strip().lower()


_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
    re.IGNORECASE,
)


class CLIPBPETokenizer:
    """OpenAI-CLIP byte-level BPE against a real merges file."""

    def __init__(self, bpe_path: str):
        self.byte_encoder = bytes_to_unicode()
        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = [tuple(m.split()) for m in merges[1: 49152 - 256 - 2 + 1]]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab] + ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {"<|startoftext|>": "<|startoftext|>", "<|endoftext|>": "<|endoftext|>"}

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        tokens: List[int] = []
        for tok in re.findall(_PAT, _clean(text)):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            tokens.extend(self.encoder[t] for t in self.bpe(tok).split(" "))
        return tokens


class HashTokenizer:
    """Deterministic offline fallback: one stable pseudo-token per word,
    reprobed linearly until no other word of this process holds it."""

    def __init__(self):
        self._word_to_id: dict = {}
        self._id_to_word: dict = {}

    def _assign(self, word: str) -> int:
        if word in self._word_to_id:
            return self._word_to_id[word]
        h = 14695981039346656037
        for b in word.encode("utf-8"):
            h = (h ^ b) * 1099511628211 % 2 ** 64
        tid = h % (SOT - 1) + 1  # ids in [1, 49405]
        while tid in self._id_to_word:
            tid = tid % (SOT - 1) + 1
        self._word_to_id[word] = tid
        self._id_to_word[tid] = word
        return tid

    def encode(self, text: str) -> List[int]:
        return [self._assign(word) for word in re.findall(_PAT, _clean(text))]


_tokenizers: dict = {}


def get_tokenizer(bpe_path: Optional[str] = None):
    path = bpe_path or os.environ.get("LC2IS_BPE_PATH")
    if path and not os.path.exists(path):
        raise FileNotFoundError(f"CLIP merges file not readable: {path!r} "
                                "(from LC2IS_BPE_PATH or bpe_path argument)")
    if path not in _tokenizers:
        if path is not None:
            _tokenizers[path] = CLIPBPETokenizer(path)
        else:
            _LOG.warning("no CLIP merges file found (set LC2IS_BPE_PATH); using the "
                         "hash-fallback tokenizer: shapes and specials match CLIP, "
                         "token ids do not")
            _tokenizers[path] = HashTokenizer()
    return _tokenizers[path]


def tokenize(texts: Union[str, Sequence[str]], context_length: int = 77,
             truncate: bool = True, bpe_path: Optional[str] = None) -> np.ndarray:
    """DenseCLIP/OpenAI ``tokenize``: (N, context_length) int64 with SOT/EOT."""
    if isinstance(texts, str):
        texts = [texts]
    tok = get_tokenizer(bpe_path)
    result = np.zeros((len(texts), context_length), dtype=np.int64)
    for i, text in enumerate(texts):
        ids = [SOT] + tok.encode(text) + [EOT]
        if len(ids) > context_length:
            if not truncate:
                raise ValueError(f"text too long for context_length={context_length}: {text!r}")
            ids = ids[: context_length - 1] + [EOT]
        result[i, : len(ids)] = ids
    return result


def tokenize_batch_padded(texts: Sequence[str], bpe_path: Optional[str] = None,
                          max_length: int = 77):
    """HF ``CLIPTokenizerFast(..., padding=True)`` contract
    (``lc2is_tpu/ops/bpe.py:228-241``): pad to the longest sequence; returns
    (input_ids, attention_mask), (N, L) int64."""
    tok = get_tokenizer(bpe_path)
    seqs = [[SOT] + tok.encode(t)[: max_length - 2] + [EOT] for t in texts]
    ln = max(len(s) for s in seqs)
    ids = np.zeros((len(seqs), ln), dtype=np.int64)
    mask = np.zeros((len(seqs), ln), dtype=np.int64)
    for i, s in enumerate(seqs):
        ids[i, : len(s)] = s
        mask[i, : len(s)] = 1
    return ids, mask
