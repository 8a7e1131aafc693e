"""Regenerate ``bert_chars.json``: how ``BertTokenizerFast`` treats each
code point, for the port's pure-Python tokenizer.

    python -m ldm_tf2_tpu_torch.data.make_bert_chars [--vocab_dir bert_model]

Needs ``transformers`` and ``tokenizers`` (the port does not: it reads the
table).  For every code point in 0-0x10FFFF except the surrogates it asks
the uncased tokenizer's own normalizer what the character becomes
(removed as a control or unassigned character, a space, a spaced CJK
ideograph, or another string: accents stripped, lower-cased), and its
pre-tokenizer whether the character splits words as whitespace or as
punctuation.  Ranges and the mapped characters are written as JSON.
"""

from __future__ import annotations

import argparse
import json
import os

TABLE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bert_chars.json")
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _ranges(codes):
    out = []
    for c in codes:
        if out and out[-1][1] == c - 1:
            out[-1][1] = c
        else:
            out.append([c, c])
    return out


def build(vocab_dir: str) -> dict:
    import tokenizers
    import transformers
    from transformers import BertTokenizerFast

    backend = BertTokenizerFast.from_pretrained(vocab_dir).backend_tokenizer
    normalizer, pre = backend.normalizer, backend.pre_tokenizer
    kinds = {"remove": [], "space": [], "cjk": []}
    mapped = {}
    split = {"whitespace": [], "punctuation": []}
    for c in range(0x110000):
        if 0xD800 <= c <= 0xDFFF:
            continue
        ch = chr(c)
        norm = normalizer.normalize_str(ch)
        if norm == "":
            kinds["remove"].append(c)
        elif norm == " ":
            kinds["space"].append(c)
        elif norm == f" {ch} ":
            kinds["cjk"].append(c)
        elif norm != ch:
            mapped[f"{c:x}"] = norm
        words = [w for w, _ in pre.pre_tokenize_str(f"a{ch}b")]
        if words == ["a", "b"]:
            split["whitespace"].append(c)
        elif words == ["a", ch, "b"]:
            split["punctuation"].append(c)
        elif words != [f"a{ch}b"]:
            raise ValueError(f"U+{c:04X} pre-tokenizes as {words}")
    return {
        "source": f"BertTokenizerFast (uncased, {os.path.basename(vocab_dir)}), transformers "
                  f"{transformers.__version__}, tokenizers {tokenizers.__version__}",
        "normalize": {**{k: _ranges(v) for k, v in kinds.items()}, "map": mapped},
        "split": {k: _ranges(v) for k, v in split.items()},
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--vocab_dir", default=os.path.join(_ROOT, "bert_model"))
    parser.add_argument("--out", default=TABLE)
    args = parser.parse_args()
    table = build(args.vocab_dir)
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump(table, f, ensure_ascii=False, separators=(",", ":"), sort_keys=True)
        f.write("\n")
    counts = {k: len(v) for k, v in {**table["normalize"], **table["split"]}.items()}
    print(f"wrote {args.out}: {counts}")


if __name__ == "__main__":
    main()
