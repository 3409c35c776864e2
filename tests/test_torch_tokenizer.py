"""The port's CLIP BPE tokenizer against the JAX package's ``load_tokenizer``
(transformers.CLIPTokenizer; no ftfy on either machine) on a synthetic
byte-level vocabulary the test writes: fixed prompts, a hypothesis property
over random text, both pad tokens, and the HashTokenizer fallback rules.
"""

import json
import logging
import os

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from chip_smoke import write_tokenizer
from synfmc_tpu.data.tokenizer import HashTokenizer as JHash
from synfmc_tpu.data.tokenizer import load_tokenizer as jax_load_tokenizer
from synfmc_tpu_torch.data.tokenizer import CLIPTokenizer, HashTokenizer, load_tokenizer

CORPUS = [
    "a turtle paddles through a coral reef", "a yellow bird hops along the road",
    "a knight marches across a field", "the blue dragon soars, seen from behind",
    "a red car drives along the coast road", "it's the dog's bone; they're here, we'll go",
    "café naïve résumé 2024 über", "森林 中 的 小屋",
]
PROMPTS = [
    "a turtle paddles through a coral reef!",
    "It's   the DOG'S\tbone!!  they'RE here, we'll see; I'd've gone",
    "12345 and 3.14159, 1st 2nd",
    "café naïve RÉSUMÉ über Ångström",
    "中文字 and 森林小屋 mixed",
    "tabs\tand\nnewlines\r\nand  many   spaces",
    "<|endoftext|>special<|startoftext|> tokens inside",
    "'ſ ſtart <|ſtartoftext|> the long s",
    "\x00\x07control\x1bchars​ zero-width",
    "ＦＵＬＬ width Ⅻ ½ ² ①",
    "emoji 🐢🦜 and symbols @#$%^&*()[]{}",
    "",
    " ".join(["word"] * 120),  # more than 77 tokens: truncated, BOS and EOS kept
]


def write_bpe_vocab(folder, corpus=CORPUS, n_merges=300, pad_token=None) -> str:
    """chip_smoke.py's synthetic byte-level BPE vocabulary (the 256 byte
    symbols, the same with ``</w>``, ``n_merges`` merges learnt greedily from
    ``corpus``, then <|startoftext|> and <|endoftext|>); ``pad_token`` (e.g.
    "!", as SD2's tokenizers) goes into special_tokens_map.json."""
    write_tokenizer(folder, corpus, n_merges)
    if pad_token is not None:
        with open(os.path.join(folder, "special_tokens_map.json"), "w") as fh:
            json.dump({"pad_token": pad_token}, fh)
    return folder


@pytest.fixture(scope="module", params=["endoftext", "bang"])
def tokenizers(request, tmp_path_factory):
    """Both packages' tokenizers on one SD-layout directory (tokenizer/
    subfolder), padding with <|endoftext|> or with "!"."""
    root = tmp_path_factory.mktemp(f"sd_{request.param}")
    write_bpe_vocab(str(root / "tokenizer"), pad_token="!" if request.param == "bang" else None)
    return jax_load_tokenizer(str(root)), load_tokenizer(str(root))


def test_fixed_prompts_match_transformers(tokenizers):
    want, got = tokenizers
    assert isinstance(got, CLIPTokenizer)
    w, g = want(PROMPTS), got(PROMPTS)
    assert g.dtype == np.int32 and g.shape == (len(PROMPTS), 77)
    for text, a, b in zip(PROMPTS, w, g):
        assert list(a) == list(b), text
    long = g[-1]
    assert long[0] == got.bos_id and long[-1] == got.eos_id  # truncated to 75 + 2


def test_pad_token_is_the_configured_one(tokenizers):
    _, got = tokenizers
    ids = got("a knight")[0]
    assert ids[4:].tolist() == [got.pad_id] * 73
    # "!" is an added token when it pads: it maps to its own id, not "!</w>"
    assert (got.pad_id == got.encoder["!"]) == ("!" in got.added)


@settings(max_examples=200, deadline=None)
@given(text=st.text(max_size=80))
def test_random_text_matches_transformers(tokenizers, text):
    want, got = tokenizers
    assert want(text).tolist() == got(text).tolist()


@pytest.mark.parametrize("max_length", [3, 5, 77])
def test_max_length_matches_transformers(tokenizers, max_length):
    want, got = tokenizers
    text = "a yellow bird hops along the road, twice: a yellow bird hops"
    assert want(text, max_length=max_length).tolist() == got(text, max_length=max_length).tolist()


def test_fallback_rules_match_jax(tmp_path, caplog):
    """No vocabulary: HashTokenizer (the same ids as the JAX package's),
    quietly for a placeholder or no path, with an ERROR for a real path
    without vocab.json, and an error under strict."""
    for path in (None, "[path to SD1.5 weights dir]"):
        with caplog.at_level(logging.ERROR):
            caplog.clear()
            tok = load_tokenizer(path)
        assert isinstance(tok, HashTokenizer) and not caplog.records
        assert tok(["a red car"]).tolist() == JHash()(["a red car"]).tolist()
    with caplog.at_level(logging.ERROR):
        caplog.clear()
        assert isinstance(load_tokenizer(str(tmp_path)), HashTokenizer)
    assert [r.levelno for r in caplog.records] == [logging.ERROR]
    for fn in (load_tokenizer, jax_load_tokenizer):
        with pytest.raises(FileNotFoundError, match="strict_pretrained"):
            fn(str(tmp_path), strict=True)
