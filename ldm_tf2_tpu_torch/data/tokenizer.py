"""Uncased BERT WordPiece tokenization of prompts, in pure Python.

Counterpart of ``ldm_tf2_tpu.data.tokenizer`` without the ``transformers``
dependency: it reproduces ``BertTokenizerFast`` on an uncased ``vocab.txt``
(clean text, CJK spacing, lower-casing, accent stripping, whitespace and
punctuation split, greedy longest-match WordPiece with ``##``
continuations, ``[CLS] ... [SEP]``, truncation and padding to a fixed
length).
"""

from __future__ import annotations

import os
import unicodedata

import numpy as np

MAX_CHARS_PER_WORD = 100


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch) in ("Cc", "Cf", "Cn", "Co", "Cs")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


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
        text = unicodedata.normalize("NFD", "".join(out))
        text = "".join(c for c in text if unicodedata.category(c) != "Mn")
        return text.lower()

    def _split(self, text: str) -> list[str]:
        words, cur = [], []
        for ch in text:
            if _is_whitespace(ch):
                if cur:
                    words.append("".join(cur))
                    cur = []
            elif _is_punctuation(ch):
                if cur:
                    words.append("".join(cur))
                    cur = []
                words.append(ch)
            else:
                cur.append(ch)
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
