"""Operators of the PyTorch port: plain PyTorch, plus the two CUDA kernels
(``flash_attention.flash_attention``, ``fused_ffn.fused_ffn``) built from
``csrc/`` on first use."""
