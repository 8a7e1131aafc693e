"""Prompt tokenization for the PyTorch port."""

from ldm_tf2_tpu_torch.data.tokenizer import (
    BertTokenizer, cfg_token_ids, load_tokenizer, tokenize_prompts,
)

__all__ = ["BertTokenizer", "cfg_token_ids", "load_tokenizer", "tokenize_prompts"]
