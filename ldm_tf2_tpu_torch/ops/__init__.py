"""Operators of the PyTorch port: plain PyTorch, plus the CUDA kernels
built from ``csrc/`` on first use: ``flash_attention.flash_attention``,
``flash_attention.flash_attention_pv_int8``, ``fused_ffn.fused_ffn``,
``quant_conv.gn_silu_quant`` and ``quant_conv.s8_conv3x3``."""
