"""Uncased BERT WordPiece tokenization of prompts, in pure Python.

Counterpart of ``ldm_tf2_tpu.data.tokenizer`` without the ``transformers``
dependency: it reproduces ``BertTokenizerFast`` on an uncased ``vocab.txt``
(clean text, CJK spacing, accent stripping, lower-casing, whitespace and
punctuation split, greedy longest-match WordPiece with ``##``
continuations, ``[CLS] ... [SEP]``, truncation and padding to a fixed
length).

Each character is classified from ``bert_chars.json``, a table of what
``BertTokenizerFast``'s own normalizer and pre-tokenizer do with every code
point (``make_bert_chars.py`` regenerates it), never from the host's
``unicodedata``: so the ids do not depend on the Python version, and the
character rules are the tokenizer's (its whitespace and CJK ranges, its
Unicode tables, its per-character lower-casing).  The normalizer maps
each character on its own; the one thing that is not per character,
canonical reordering of combining marks that are not stripped, is not
reproduced.
"""

from __future__ import annotations

import bisect
import json
import os

import numpy as np

MAX_CHARS_PER_WORD = 100
_TABLE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bert_chars.json")


class _Chars:
    """``bert_chars.json`` as lookups: ``normalize(ch)`` is the string the
    normalizer makes of ``ch``; ``split_kind(ch)`` is "whitespace",
    "punctuation" or None, as the pre-tokenizer splits on it."""

    def __init__(self, path: str = _TABLE):
        with open(path, encoding="utf-8") as f:
            table = json.load(f)
        norm = table["normalize"]
        self._map = {int(k, 16): v for k, v in norm["map"].items()}
        self._norm = self._index({k: norm[k] for k in ("remove", "space", "cjk")})
        self._split = self._index(table["split"])

    @staticmethod
    def _index(kinds):
        rows = sorted((lo, hi, kind) for kind, ranges in kinds.items() for lo, hi in ranges)
        return [r[0] for r in rows], rows

    @staticmethod
    def _kind(index, cp: int):
        starts, rows = index
        i = bisect.bisect_right(starts, cp) - 1
        if i >= 0 and cp <= rows[i][1]:
            return rows[i][2]
        return None

    def normalize(self, ch: str) -> str:
        cp = ord(ch)
        mapped = self._map.get(cp)
        if mapped is not None:
            return mapped
        kind = self._kind(self._norm, cp)
        if kind == "remove":
            return ""
        if kind == "space":
            return " "
        if kind == "cjk":
            return f" {ch} "
        return ch

    def split_kind(self, ch: str):
        return self._kind(self._split, ord(ch))


_CHARS: list[_Chars] = []


def _chars() -> _Chars:
    if not _CHARS:
        _CHARS.append(_Chars())
    return _CHARS[0]


class BertTokenizer:
    """Uncased BERT tokenizer over a WordPiece ``vocab.txt``."""

    def __init__(self, vocab_file: str):
        with open(vocab_file, encoding="utf-8") as f:
            tokens = [line.rstrip("\n") for line in f]
        self.vocab = {tok: i for i, tok in enumerate(tokens)}
        self.cls_id = self.vocab["[CLS]"]
        self.sep_id = self.vocab["[SEP]"]
        self.pad_id = self.vocab["[PAD]"]
        self.unk_id = self.vocab["[UNK]"]

    def _normalize(self, text: str) -> str:
        chars = _chars()
        return "".join(chars.normalize(ch) for ch in text)

    def _split(self, text: str) -> list[str]:
        chars = _chars()
        words, cur = [], []
        for ch in text:
            kind = chars.split_kind(ch)
            if kind is None:
                cur.append(ch)
                continue
            if cur:
                words.append("".join(cur))
                cur = []
            if kind == "punctuation":
                words.append(ch)
        if cur:
            words.append("".join(cur))
        return words

    def _wordpiece(self, word: str) -> list[int]:
        if len(word) > MAX_CHARS_PER_WORD:
            return [self.unk_id]
        ids, start = [], 0
        while start < len(word):
            end = len(word)
            found = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    found = self.vocab[piece]
                    break
                end -= 1
            if found is None:
                return [self.unk_id]
            ids.append(found)
            start = end
        return ids

    def encode(self, text: str, max_length: int = 77) -> list[int]:
        """[CLS] pieces [SEP], truncated to and padded to ``max_length``."""
        ids = []
        for word in self._split(self._normalize(text)):
            ids.extend(self._wordpiece(word))
        ids = [self.cls_id] + ids[: max_length - 2] + [self.sep_id]
        return ids + [self.pad_id] * (max_length - len(ids))


def load_tokenizer(vocab_dir: str) -> BertTokenizer:
    return BertTokenizer(os.path.join(vocab_dir, "vocab.txt"))


def tokenize_prompts(tokenizer: BertTokenizer, prompts, max_length: int = 77):
    """[len(prompts), max_length] int32 token ids."""
    return np.asarray(
        [tokenizer.encode(p, max_length) for p in prompts], dtype=np.int32
    )


def cfg_token_ids(tokenizer: BertTokenizer, prompt, batch_size: int,
                  max_length: int = 77, negative_prompt: str = ""):
    """[2B, L] ids: B copies of the tokenized ``negative_prompt`` (the
    unconditional half, "" by default) then the B conditional rows.
    ``prompt`` is one string (tiled over the batch) or a list of
    ``batch_size`` strings."""
    prompts = [prompt] if isinstance(prompt, str) else list(prompt)
    if len(prompts) not in (1, batch_size):
        raise ValueError(
            f"text_prompt must be one string or a list of {batch_size}, "
            f"got {len(prompts)} prompts"
        )
    ids = tokenize_prompts(tokenizer, [negative_prompt] + prompts, max_length)
    uncond, cond = ids[0], ids[1:]
    if cond.shape[0] == 1:
        cond = np.tile(cond, (batch_size, 1))
    return np.concatenate([np.tile(uncond, (batch_size, 1)), cond])


def packed_cfg_token_ids(tokenizer: BertTokenizer, prompts, negative_prompts,
                         max_length: int = 77):
    """[2B, L] ids for a micro-batched CFG call: one negative prompt per
    slot (the unconditional rows), then the per-slot prompts."""
    if len(prompts) != len(negative_prompts):
        raise ValueError(
            f"{len(prompts)} prompts vs {len(negative_prompts)} negatives"
        )
    return tokenize_prompts(tokenizer, list(negative_prompts) + list(prompts),
                            max_length)


def null_condition_ids(batch_size: int, max_length: int = 77) -> np.ndarray:
    """Tokenized "" = [CLS][SEP] pad ids, tiled over the batch: the
    trainer's condition-dropout ids."""
    row = np.zeros((max_length,), dtype=np.int64)
    row[0], row[1] = 101, 102
    return np.tile(row, (batch_size, 1))
