"""The port's table-driven BERT tokenizer against ``BertTokenizerFast`` on
every code point of planes 0-2: each ``c`` in 0-0x2FFFF but the
surrogates, as ``"ab" + chr(c) + "cd"``, must give the same ids.  Also
the table's own shape and a Greek final sigma, which the tokenizer
lower-cases character by character (Python's ``str.lower`` would not)."""

import os

import numpy as np
import pytest

from ldm_tf2_tpu_torch.data import tokenizer as ttok

VOCAB_DIR = os.path.join(os.path.dirname(__file__), os.pardir, "bert_model")


def _fast():
    transformers = pytest.importorskip("transformers")
    return transformers.BertTokenizerFast.from_pretrained(VOCAB_DIR)


def test_every_code_point_of_planes_0_to_2_matches_bert_tokenizer_fast():
    fast = _fast()
    ours = ttok.load_tokenizer(VOCAB_DIR)
    codes = [c for c in range(0x30000) if not 0xD800 <= c <= 0xDFFF]
    texts = [f"ab{chr(c)}cd" for c in codes]
    want = fast(texts, truncation=True, max_length=16, padding="max_length")["input_ids"]
    got = [ours.encode(t, 16) for t in texts]
    bad = [f"U+{c:04X}: {g} != {w}" for c, g, w in zip(codes, got, want) if g != w]
    assert len(codes) == 0x30000 - 0x800
    assert not bad, f"{len(bad)} code points differ, first: {bad[:10]}"


@pytest.mark.parametrize("text", ["a cat on a mat", "ab\U0002B820cd",
                                  "ΟΔΟΣ ΟΔΟΣ.", "İstanbul ǅ ﬁ", "x\U000E0001y\U0010FFFDz"])
def test_rules_where_python_unicodedata_differs(text):
    """U+2028/9 are whitespace, U+2B820 is no CJK ideograph to the tokenizer,
    and the table, not the host's Unicode version, decides the rest."""
    fast = _fast()
    ours = ttok.load_tokenizer(VOCAB_DIR)
    want = fast([text], truncation=True, max_length=24, padding="max_length")["input_ids"]
    np.testing.assert_array_equal(ttok.tokenize_prompts(ours, [text], 24), np.asarray(want))


def test_table_covers_disjoint_ranges():
    chars = ttok._chars()
    for starts, rows in (chars._norm, chars._split):
        assert starts == sorted(starts)
        assert all(lo <= hi for lo, hi, _ in rows)
        assert all(a[1] < b[0] for a, b in zip(rows, rows[1:]))
    assert chars.normalize(" ") == " " and chars.split_kind(" ") == "whitespace"
    assert chars.normalize("中") == " 中 " and chars.normalize("\x00") == ""
