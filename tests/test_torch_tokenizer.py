"""The port's pure-Python BERT tokenizer against ``BertTokenizerFast`` on
the repository's uncased vocabulary (``bert_model/``)."""

import os

import numpy as np
import pytest

from ldm_tf2_tpu.data import tokenizer as jtok
from ldm_tf2_tpu_torch.data import tokenizer as ttok

VOCAB_DIR = os.path.join(os.path.dirname(__file__), os.pardir, "bert_model")

PROMPTS = [
    "a virus monster is playing guitar, oil on canvas",
    "",
    "Hello, World!! (really?) -- yes; #1 @home & 50% off...",
    "Café naïve résumé Ångström façade",
    "3.14159, 42nd street, $1,000,000 and 2024-10-16",
    "中文字符 test 日本語 한국어",
    "emoji 😀 — “quotes” … ß ﬁ İstanbul",
    "tabs\tand\nnewlines\r and  spaces",
    "supercalifragilisticexpialidocious " + "x" * 120,
    " ".join(["word"] * 100),  # truncated at 77 ids
]


@pytest.fixture(scope="module")
def tokenizers():
    return jtok.load_tokenizer(VOCAB_DIR), ttok.load_tokenizer(VOCAB_DIR)


@pytest.mark.parametrize("prompt", PROMPTS, ids=range(len(PROMPTS)))
def test_matches_bert_tokenizer_fast(tokenizers, prompt):
    fast, ours = tokenizers
    want = jtok.tokenize_prompts(fast, [prompt], 77)
    got = ttok.tokenize_prompts(ours, [prompt], 77)
    assert got.dtype == np.int32 and got.shape == (1, 77)
    np.testing.assert_array_equal(got, want)


def test_cfg_token_ids_match(tokenizers):
    fast, ours = tokenizers
    for prompt, negative in (("a cat", ""), (["a cat", "a dog"], "blurry")):
        np.testing.assert_array_equal(
            ttok.cfg_token_ids(ours, prompt, 2, 77, negative),
            jtok.cfg_token_ids(fast, prompt, 2, 77, negative),
        )
    with pytest.raises(ValueError):
        ttok.cfg_token_ids(ours, ["a", "b", "c"], 2)


def test_packed_cfg_token_ids_match(tokenizers):
    """The server's per-slot negatives (uncond rows) then per-slot prompts."""
    fast, ours = tokenizers
    prompts, negatives = ["a red fox", "two cats"], ["", "blurry, dark"]
    np.testing.assert_array_equal(
        ttok.packed_cfg_token_ids(ours, prompts, negatives, 12),
        jtok.packed_cfg_token_ids(fast, prompts, negatives, 12),
    )
    with pytest.raises(ValueError):
        ttok.packed_cfg_token_ids(ours, prompts, negatives[:1])
