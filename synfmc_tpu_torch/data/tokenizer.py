"""Text tokenization for the CLIP conditioning path.

``CLIPTokenizer`` is CLIP's byte-level BPE read from a local ``vocab.json``
and ``merges.txt``, written with the standard library alone.  It gives the
ids that ``transformers.CLIPTokenizer`` gives when ``ftfy`` is absent (the
JAX package's ``load_tokenizer``; neither machine has ftfy):

1. the special tokens (bos, eos, unk, pad) are split out of the raw text;
2. each other piece goes through transformers' ``BasicTokenizer(
   strip_accents=False, do_split_on_punc=False)``: control characters
   dropped, whitespace made spaces, spaces put around CJK ideographs, NFC,
   lower case, split on whitespace;
3. the pieces, joined by spaces, are split as the pattern
   ``<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|\\p{L}+|\\p{N}|
   [^\\s\\p{L}\\p{N}]+`` (case-insensitive) splits them, with Unicode
   categories standing in for ``\\p{L}`` and ``\\p{N}``;
4. each word's UTF-8 bytes map through ``bytes_to_unicode``, the last symbol
   gets ``</w>``, and ``merges.txt``'s ranks merge pairs, lowest rank first;
5. ids: the body truncated to ``max_length - 2``, bos + body + eos, padded
   with the pad token to ``max_length``.

``HashTokenizer`` is the deterministic offline stand-in (a copy of
synfmc_tpu/data/tokenizer.py's), used when no vocabulary is configured.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import unicodedata
from functools import lru_cache

import numpy as np

from synfmc_tpu_torch.config import is_placeholder_path

logger = logging.getLogger(__name__)

BOS_ID = 49406
EOS_ID = 49407
VOCAB_SIZE = 49408
MAX_LENGTH = 77
BOS, EOS = "<|startoftext|>", "<|endoftext|>"
# transformers reads at most this many merges (tokenization_clip.py)
MAX_MERGES = 49152 - 256 - 2
CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
# The pattern is case-insensitive; after lower-casing, the one character that
# still folds onto a letter of a contraction or a special token is the long s.
_FOLD = {"ſ": "s"}


class HashTokenizer:
    """[BOS] word-hash ids... [EOS], then EOS padding to max_length."""

    vocab_size = VOCAB_SIZE

    def __call__(self, texts, max_length: int = MAX_LENGTH) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), max_length), EOS_ID, dtype=np.int32)
        for row, text in enumerate(texts):
            ids = [BOS_ID]
            for word in text.lower().split():
                h = int.from_bytes(hashlib.sha1(word.encode()).digest()[:4], "little")
                ids.append(1000 + h % (BOS_ID - 1001))
                if len(ids) >= max_length - 1:
                    break
            ids.append(EOS_ID)
            out[row, : len(ids)] = ids
        return out


@lru_cache(maxsize=None)
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte -> printable character table."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _is_control(ch: str) -> bool:
    return ch not in "\t\n\r" and unicodedata.category(ch).startswith("C")


def _is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
            or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def basic_tokenize(text: str) -> list[str]:
    """transformers' BasicTokenizer(strip_accents=False, do_split_on_punc=False)."""
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if _is_whitespace(ch):
            out.append(" ")
        elif _is_cjk(cp):
            out.append(f" {ch} ")
        else:
            out.append(ch)
    text = unicodedata.normalize("NFC", "".join(out))
    return " ".join(tok.lower() for tok in text.split()).split()


def _is_letter(ch: str) -> bool:
    return unicodedata.category(ch)[0] == "L"


def _is_number(ch: str) -> bool:
    return unicodedata.category(ch)[0] == "N"


def _matches_at(text: str, i: int, literal: str) -> bool:
    """``literal`` at ``text[i:]``, case-insensitively as the pattern matches."""
    if i + len(literal) > len(text):
        return False
    return all(_FOLD.get(c, c) == w for c, w in zip(text[i:i + len(literal)], literal))


def split_words(text: str) -> list[str]:
    """The pattern's matches, left to right (step 3 of the module docstring)."""
    words, i, n = [], 0, len(text)
    while i < n:
        ch = text[i]
        if ch.isspace():
            i += 1
            continue
        lit = next((s for s in (BOS, EOS) + CONTRACTIONS if _matches_at(text, i, s)), None)
        if lit is not None:
            j = i + len(lit)
        elif _is_letter(ch):
            j = i + 1
            while j < n and _is_letter(text[j]):
                j += 1
        elif _is_number(ch):
            j = i + 1
        else:
            j = i + 1
            while j < n and not (text[j].isspace() or _is_letter(text[j]) or _is_number(text[j])):
                j += 1
        words.append(text[i:j])
        i = j
    return words


def _token_content(value) -> str:
    """A special token of a tokenizer config: a string or an AddedToken dict."""
    return value["content"] if isinstance(value, dict) else str(value)


class CLIPTokenizer:
    """CLIP's BPE over a local vocabulary; ``__call__`` returns (N,
    max_length) int32 ids as the pipeline wants them."""

    def __init__(self, vocab_file: str, merges_file: str, bos_token: str = BOS,
                 eos_token: str = EOS, unk_token: str = EOS, pad_token: str = EOS):
        with open(vocab_file, encoding="utf-8") as fh:
            self.encoder: dict[str, int] = json.load(fh)
        with open(merges_file, encoding="utf-8") as fh:
            lines = fh.read().strip().split("\n")[1:MAX_MERGES + 1]  # line 1: "#version"
        self.ranks = {tuple(line.split()): r for r, line in enumerate(lines)}
        self.byte_encoder = bytes_to_unicode()
        self.cache = {BOS: BOS, EOS: EOS}
        # added tokens take the vocabulary's id, or the next free one
        self.added: dict[str, int] = {}
        for tok in (bos_token, eos_token, unk_token, pad_token):
            if tok not in self.added:
                self.added[tok] = self.encoder.get(tok, len(self.encoder) + len(
                    [t for t in self.added if t not in self.encoder]))
        self.bos_id, self.eos_id = self.added[bos_token], self.added[eos_token]
        self.unk_token, self.pad_id = unk_token, self.added[pad_token]
        self._specials = sorted(self.added, key=len, reverse=True)

    @classmethod
    def from_dir(cls, folder: str) -> "CLIPTokenizer":
        """``vocab.json`` and ``merges.txt`` of ``folder``; special tokens from
        ``tokenizer_config.json``, then ``special_tokens_map.json`` (which
        wins), where present."""
        kw = {}
        for name in ("tokenizer_config.json", "special_tokens_map.json"):
            path = os.path.join(folder, name)
            if os.path.exists(path):
                with open(path, encoding="utf-8") as fh:
                    conf = json.load(fh)
                for key in ("bos_token", "eos_token", "unk_token", "pad_token"):
                    if conf.get(key) is not None:
                        kw[key] = _token_content(conf[key])
        return cls(os.path.join(folder, "vocab.json"), os.path.join(folder, "merges.txt"), **kw)

    def bpe(self, token: str) -> list[str]:
        if token in self.cache:
            return self.cache[token].split(" ")
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = {(a, b) for a, b in zip(word, word[1:])}
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        self.cache[token] = " ".join(word)
        return list(word)

    def _split_specials(self, text: str) -> list[str]:
        """The raw text cut at the added tokens (kept as pieces of their own)."""
        pieces, start, i = [], 0, 0
        while i < len(text):
            tok = next((s for s in self._specials if text.startswith(s, i)), None)
            if tok is None:
                i += 1
                continue
            if i > start:
                pieces.append(text[start:i])
            pieces.append(tok)
            i = start = i + len(tok)
        if start < len(text):
            pieces.append(text[start:])
        return pieces

    def tokenize(self, text: str) -> list[str]:
        tokens = []
        for piece in self._split_specials(text):
            if piece in self.added:
                tokens.append(piece)
                continue
            for word in split_words(" ".join(basic_tokenize(piece))):
                tokens += self.bpe("".join(self.byte_encoder[b] for b in word.encode("utf-8")))
        return tokens

    def token_id(self, token: str) -> int:
        if token in self.added:
            return self.added[token]
        return self.encoder.get(token, self.encoder.get(self.unk_token))

    def encode(self, text: str, max_length: int = MAX_LENGTH) -> list[int]:
        body = [self.token_id(t) for t in self.tokenize(text)][:max(max_length - 2, 0)]
        ids = [self.bos_id, *body, self.eos_id]
        return ids + [self.pad_id] * (max_length - len(ids))

    def __call__(self, texts, max_length: int = MAX_LENGTH) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        return np.asarray([self.encode(t, max_length) for t in texts], dtype=np.int32)


def load_tokenizer(pretrained_path=None, strict: bool = False):
    """CLIPTokenizer from a local SD checkpoint directory (its ``tokenizer/``
    subfolder, else the directory itself), else the HashTokenizer.

    The fallback is loud: a run pointed at a slightly wrong SD path would
    otherwise condition on hash tokens while looking healthy.  ``strict``
    (config ``strict_pretrained``) makes it fatal.  '[path to ...]'
    placeholders count as no path (quiet)."""
    if pretrained_path and is_placeholder_path(pretrained_path):
        pretrained_path = None
    if pretrained_path:
        tok_dir = os.path.join(pretrained_path, "tokenizer")
        target = tok_dir if os.path.isdir(tok_dir) else pretrained_path
        if os.path.exists(os.path.join(target, "vocab.json")):
            return CLIPTokenizer.from_dir(target)
    if strict:
        raise FileNotFoundError(
            f"strict_pretrained: no CLIP tokenizer vocab.json under {pretrained_path!r} — "
            f"refusing the HashTokenizer fallback")
    if pretrained_path:
        logger.error(
            f"no CLIP vocab.json under {pretrained_path!r} — FALLING BACK to the deterministic "
            f"HashTokenizer. Text conditioning will be meaningless with real weights; set "
            f"strict_pretrained: true to make this fatal.")
    return HashTokenizer()
