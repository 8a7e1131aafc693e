"""BERT-style pre-LN text encoder (the LDM condition-stage model).

Counterpart of ``ldm_tf2_tpu.models.transformer.TransformerModel``; the
production config is 32 layers, hidden 1280, 8 heads x 64 (the attention
width 512 is narrower than the hidden size, as in the CompVis checkpoint).
Its attention runs in plain PyTorch (77 tokens: ``ops.attention``).
Training mode (``forward(ids, training=True, generator=g)``, used when
``train_cond_model`` is on) applies the JAX package's dropout at
``dropout_rate``: after the embeddings, after each attention and each FFN
before its residual add, and inside the FFN after the GELU.
Under tensor parallelism the attention passes its replicated input
through ``ops/tp.py::copy_to_model`` once for q, k and v, the FFN's
column-parallel filter does the same for its own, and the FFN's dropout
keeps this rank's columns of one process's mask.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ldm_tf2_tpu_torch.models.layers import (
    Dense, Embed, LayerNorm, Projection, dropout,
)
from ldm_tf2_tpu_torch.ops import tp as _tp
from ldm_tf2_tpu_torch.ops.attention import attention

LAYER_NORM_EPS = 1e-5


class Attention(nn.Module):
    """Multi-head attention with Projection-shaped params."""

    def __init__(self, num_heads: int, size_per_head: int,
                 hidden_size: int | None = None):
        super().__init__()
        self.scale = size_per_head**-0.5
        self.query = Projection(num_heads, size_per_head, hidden_size)
        self.key = Projection(num_heads, size_per_head, hidden_size)
        self.value = Projection(num_heads, size_per_head, hidden_size)
        self.output = Projection(num_heads, size_per_head, hidden_size,
                                 use_bias=True, mode="merge")

    def forward(self, query, context):
        if self.query.tp is not None:  # column-parallel over the heads
            copied = _tp.copy_to_model(query)
            context = copied if context is query else _tp.copy_to_model(context)
            query = copied
        out = attention(
            self.query(query), self.key(context), self.value(context),
            self.scale,
        )
        return self.output(out)


class FeedForwardNetwork(nn.Module):
    def __init__(self, hidden_size: int, filter_size: int,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.filter = Dense(hidden_size, filter_size)
        self.output = Dense(filter_size, hidden_size)

    def forward(self, x, generator=None):
        h = dropout(F.gelu(self.filter(x)), self.dropout_rate, generator,
                    shard=self.filter.tp)
        return self.output(h)


class EncoderLayer(nn.Module):
    def __init__(self, hidden_size, num_heads, size_per_head, filter_size,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.layernorm_mha = LayerNorm(hidden_size, LAYER_NORM_EPS)
        self.mha = Attention(num_heads, size_per_head, hidden_size)
        self.layernorm_ffn = LayerNorm(hidden_size, LAYER_NORM_EPS)
        self.ffn = FeedForwardNetwork(hidden_size, filter_size, dropout_rate)

    def forward(self, x, generator=None):
        rate = self.dropout_rate
        y = self.layernorm_mha(x)
        x = dropout(self.mha(y, y), rate, generator) + x
        y = self.ffn(self.layernorm_ffn(x), generator)
        return dropout(y, rate, generator) + x


class TransformerModel(nn.Module):
    """Token + learned positional embeddings -> N pre-LN layers -> final LN.
    Output [B, seq, hidden] is the U-Net's cross-attention context.
    ``dropout_rate`` applies only in training mode."""

    def __init__(self, vocab_size: int, encoder_stack_size: int = 6,
                 hidden_size: int = 512, num_heads: int = 8,
                 size_per_head: int = 64, max_seq_len: int = 77,
                 filter_size: int = 2048, dropout_rate: float = 0.1,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        self.token_embedding = Embed(vocab_size, hidden_size)
        self.positional_embedding = Embed(max_seq_len, hidden_size)
        for i in range(encoder_stack_size):
            self.add_module(
                f"layer_{i}",
                EncoderLayer(hidden_size, num_heads, size_per_head, filter_size,
                             dropout_rate),
            )
        self.num_layers = encoder_stack_size
        self.layernorm_out = LayerNorm(hidden_size, LAYER_NORM_EPS)

    def forward(self, token_ids, *, training: bool = False,
                generator: torch.Generator | None = None):
        if training and self.dropout_rate > 0.0 and generator is None:
            raise ValueError("training with dropout needs a generator")
        gen = generator if training else None
        seq_len = token_ids.shape[1]
        pos = torch.arange(seq_len, device=token_ids.device)[None]
        x = self.token_embedding(token_ids, self.dtype) + self.positional_embedding(
            pos, self.dtype
        )
        x = dropout(x, self.dropout_rate, gen)
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, gen)
        return self.layernorm_out(x)
