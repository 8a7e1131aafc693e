"""CompVis latent-diffusion PyTorch checkpoint -> param tree in the JAX
package's layout (numpy arrays in, numpy arrays out; the port's copy of
``ldm_tf2_tpu.checkpoints.convert_pytorch``, its transposes done by
torch's parallel copy).

Every PyTorch key is translated by name to a path in the param tree plus a
layout transform; when a reference tree is given, coverage is verified:
every leaf of the reference must be written exactly once, at its shape.
The output is the tree the weight blob stores (``checkpoints/blob.py``),
the one interchange format that both packages read; ``params_from_jax``
maps it onto the port's modules.  The reference tree comes from the port's
own models through ``checkpoints/bridge.py::params_to_jax`` (on the meta
device, so no weights are allocated for the shapes).

Layout transforms:
  conv   [O,I,kh,kw] -> HWIO                    (transpose 2,3,1,0)
  linear [O,I]       -> [I,O]                   (.T)
  1x1 conv [O,I,1,1] -> Dense kernel [I,O]      (squeeze + .T)
  attention to_{q,k,v} [H*S, D] -> [D,H,S]      (.T then reshape)
  attention to_out  [D, H*S]   -> [H,S,D]
  norm weight/bias -> scale/bias (flax naming)
  embedding -> embedding

Source key structure (CompVis `txt2img-f8-large` state_dict):
  cond_stage_model.transformer.attn_layers.layers.{2i}.0   pre-attn LN
  cond_stage_model.transformer.attn_layers.layers.{2i}.1   attention
  cond_stage_model.transformer.attn_layers.layers.{2i+1}.0 pre-FFN LN
  cond_stage_model.transformer.attn_layers.layers.{2i+1}.1.net ffn
  model.diffusion_model.{input_blocks,middle_block,output_blocks,out,...}
  first_stage_model.{encoder,decoder,quant_conv,post_quant_conv,quantize}
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

Array = np.ndarray
StateDict = Mapping[str, Array]
ParamTree = dict


def _layout(w: Array, perm: tuple[int, ...]) -> Array:
    """``np.ascontiguousarray(np.transpose(w, perm))``, the copy made by
    torch's parallel CPU copy (bit-identical data movement; numpy's
    single-threaded strided copy is the slowest part of a full-width
    conversion)."""
    return torch.from_numpy(np.ascontiguousarray(w)).permute(perm).contiguous().numpy()


def _conv(w: Array) -> Array:
    return _layout(w, (2, 3, 1, 0))


def _linear(w: Array) -> Array:
    return _layout(w, (1, 0))


def _conv1x1(w: Array) -> Array:
    return _layout(w.reshape(w.shape[0], w.shape[1]), (1, 0))


def _split_proj(w: Array, num_heads: int) -> Array:
    """[H*S, D] torch linear -> [D, H, S] split-projection kernel."""
    out_dim, in_dim = w.shape
    return _layout(w, (1, 0)).reshape(in_dim, num_heads, out_dim // num_heads)


def _merge_proj(w: Array, num_heads: int) -> Array:
    """[D, H*S] torch linear -> [H, S, D] merge-projection kernel."""
    out_dim, in_dim = w.shape
    return _layout(w, (1, 0)).reshape(num_heads, in_dim // num_heads, out_dim)


def _set(tree: ParamTree, path: tuple[str, ...], value: Array) -> None:
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    if path[-1] in node:
        raise ValueError(f"duplicate write to {'/'.join(path)}")
    node[path[-1]] = value


def _leaf_shapes(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for key, child in tree.items():
            out.update(_leaf_shapes(child, prefix + (str(key),)))
        return out
    return {"/".join(prefix): tuple(tree.shape)}


def _verify_against(params: ParamTree, converted: ParamTree, name: str) -> None:
    """Check converted tree has exactly the same structure/shapes as params."""
    expected = _leaf_shapes(params)
    got = _leaf_shapes(converted)
    missing = sorted(set(expected) - set(got))
    extra = sorted(set(got) - set(expected))
    if missing or extra:
        raise ValueError(
            f"{name}: conversion incomplete; missing={missing[:8]} "
            f"extra={extra[:8]} (of {len(missing)}/{len(extra)})"
        )
    for k in expected:
        if expected[k] != got[k]:
            raise ValueError(
                f"{name}: shape mismatch at {k}: expected {expected[k]}, "
                f"got {got[k]}"
            )


# --------------------------------------------------------------------------
# Text transformer (convert_ckpt_pytorch_to_tf2.py:23-70)
# --------------------------------------------------------------------------


def convert_transformer(
    sd: StateDict,
    num_layers: int = 32,
    num_heads: int = 8,
    prefix: str = "cond_stage_model.transformer.",
    reference_params: ParamTree | None = None,
) -> ParamTree:
    """Build the TransformerModel param tree from a CompVis state_dict."""
    p: ParamTree = {}
    g = lambda k: np.asarray(sd[prefix + k])

    _set(p, ("token_embedding", "embedding"), g("token_emb.weight"))
    _set(p, ("positional_embedding", "embedding"), g("pos_emb.emb.weight"))
    _set(p, ("layernorm_out", "scale"), g("norm.weight"))
    _set(p, ("layernorm_out", "bias"), g("norm.bias"))

    for i in range(num_layers):
        attn = f"attn_layers.layers.{2 * i}"
        ffn = f"attn_layers.layers.{2 * i + 1}"
        layer = f"layer_{i}"
        _set(p, (layer, "layernorm_mha", "scale"), g(f"{attn}.0.weight"))
        _set(p, (layer, "layernorm_mha", "bias"), g(f"{attn}.0.bias"))
        for ours, theirs in (("query", "to_q"), ("key", "to_k"),
                             ("value", "to_v")):
            _set(
                p,
                (layer, "mha", ours, "kernel"),
                _split_proj(g(f"{attn}.1.{theirs}.weight"), num_heads),
            )
        _set(
            p,
            (layer, "mha", "output", "kernel"),
            _merge_proj(g(f"{attn}.1.to_out.weight"), num_heads),
        )
        _set(p, (layer, "mha", "output", "bias"), g(f"{attn}.1.to_out.bias"))

        _set(p, (layer, "layernorm_ffn", "scale"), g(f"{ffn}.0.weight"))
        _set(p, (layer, "layernorm_ffn", "bias"), g(f"{ffn}.0.bias"))
        _set(p, (layer, "ffn", "filter", "kernel"),
             _linear(g(f"{ffn}.1.net.0.0.weight")))
        _set(p, (layer, "ffn", "filter", "bias"), g(f"{ffn}.1.net.0.0.bias"))
        _set(p, (layer, "ffn", "output", "kernel"),
             _linear(g(f"{ffn}.1.net.2.weight")))
        _set(p, (layer, "ffn", "output", "bias"), g(f"{ffn}.1.net.2.bias"))

    if reference_params is not None:
        _verify_against(reference_params, p, "transformer")
    return p


# --------------------------------------------------------------------------
# U-Net (convert_ckpt_pytorch_to_tf2.py:73-232)
# --------------------------------------------------------------------------


def _convert_unet_residual(g, p, src: str, dst: tuple[str, ...],
                           has_shortcut: bool) -> None:
    """CompVis ResBlock: in_layers.0=GN1, in_layers.2=conv1,
    emb_layers.1=time dense, out_layers.0=GN2, out_layers.3=conv2,
    skip_connection=1x1 shortcut."""
    _set(p, dst + ("group_norm_1", "scale"), g(f"{src}.in_layers.0.weight"))
    _set(p, dst + ("group_norm_1", "bias"), g(f"{src}.in_layers.0.bias"))
    _set(p, dst + ("conv2d_1", "kernel"), _conv(g(f"{src}.in_layers.2.weight")))
    _set(p, dst + ("conv2d_1", "bias"), g(f"{src}.in_layers.2.bias"))
    _set(p, dst + ("dense", "kernel"), _linear(g(f"{src}.emb_layers.1.weight")))
    _set(p, dst + ("dense", "bias"), g(f"{src}.emb_layers.1.bias"))
    _set(p, dst + ("group_norm_2", "scale"), g(f"{src}.out_layers.0.weight"))
    _set(p, dst + ("group_norm_2", "bias"), g(f"{src}.out_layers.0.bias"))
    _set(p, dst + ("conv2d_2", "kernel"), _conv(g(f"{src}.out_layers.3.weight")))
    _set(p, dst + ("conv2d_2", "bias"), g(f"{src}.out_layers.3.bias"))
    if has_shortcut:
        _set(p, dst + ("shortcut", "kernel"),
             _conv1x1(g(f"{src}.skip_connection.weight")))
        _set(p, dst + ("shortcut", "bias"), g(f"{src}.skip_connection.bias"))


def _convert_spatial_transformer(g, p, src: str, dst: tuple[str, ...],
                                 num_heads: int) -> None:
    """CompVis SpatialTransformer: norm (GN), proj_in/out (1x1 convs),
    transformer_blocks.0.{attn1,attn2,ff,norm1,norm2,norm3}."""
    _set(p, dst + ("group_norm", "scale"), g(f"{src}.norm.weight"))
    _set(p, dst + ("group_norm", "bias"), g(f"{src}.norm.bias"))
    _set(p, dst + ("proj_in", "kernel"), _conv1x1(g(f"{src}.proj_in.weight")))
    _set(p, dst + ("proj_in", "bias"), g(f"{src}.proj_in.bias"))
    _set(p, dst + ("proj_out", "kernel"), _conv1x1(g(f"{src}.proj_out.weight")))
    _set(p, dst + ("proj_out", "bias"), g(f"{src}.proj_out.bias"))

    tb = f"{src}.transformer_blocks.0"
    blk = dst + ("block",)
    for n in (1, 2, 3):
        _set(p, blk + (f"layernorm{n}", "scale"), g(f"{tb}.norm{n}.weight"))
        _set(p, blk + (f"layernorm{n}", "bias"), g(f"{tb}.norm{n}.bias"))
    for ours, theirs in (("att_layer1", "attn1"), ("att_layer2", "attn2")):
        for o, t in (("query", "to_q"), ("key", "to_k"), ("value", "to_v")):
            _set(
                p,
                blk + (ours, o, "kernel"),
                _split_proj(g(f"{tb}.{theirs}.{t}.weight"), num_heads),
            )
        _set(
            p,
            blk + (ours, "output", "kernel"),
            _merge_proj(g(f"{tb}.{theirs}.to_out.0.weight"), num_heads),
        )
        _set(p, blk + (ours, "output", "bias"), g(f"{tb}.{theirs}.to_out.0.bias"))
    # CompVis GEGLU is one fused Linear(D, 2F) chunked value-first; the
    # tree stores separate value/gate leaves, so split the converted
    # [D, 2F] columns in half.
    w_fused = _linear(g(f"{tb}.ff.net.0.proj.weight"))
    b_fused = g(f"{tb}.ff.net.0.proj.bias")
    half = w_fused.shape[-1] // 2
    _set(p, blk + ("ffn", "geglu", "value", "kernel"), w_fused[:, :half])
    _set(p, blk + ("ffn", "geglu", "value", "bias"), b_fused[:half])
    _set(p, blk + ("ffn", "geglu", "gate", "kernel"), w_fused[:, half:])
    _set(p, blk + ("ffn", "geglu", "gate", "bias"), b_fused[half:])
    _set(p, blk + ("ffn", "dense", "kernel"), _linear(g(f"{tb}.ff.net.2.weight")))
    _set(p, blk + ("ffn", "dense", "bias"), g(f"{tb}.ff.net.2.bias"))


def convert_unet(
    sd: StateDict,
    num_blocks: int = 2,
    channel_mult: tuple[int, ...] = (1, 2, 4, 4),
    num_heads: int = 8,
    prefix: str = "model.diffusion_model.",
    reference_params: ParamTree | None = None,
) -> ParamTree:
    """Build the UNet param tree from a CompVis state_dict.

    The reference's hard-coded index maps (convert_ckpt:74-75, :87, :103,
    :107, :191, :219-223) are re-derived here from the architecture config so
    the converter works for any channel_mult/num_blocks.
    """
    p: ParamTree = {}
    g = lambda k: np.asarray(sd[prefix + k])
    num_levels = len(channel_mult)

    _set(p, ("conv_in", "kernel"), _conv(g("input_blocks.0.0.weight")))
    _set(p, ("conv_in", "bias"), g("input_blocks.0.0.bias"))
    _set(p, ("time_dense1", "kernel"), _linear(g("time_embed.0.weight")))
    _set(p, ("time_dense1", "bias"), g("time_embed.0.bias"))
    _set(p, ("time_dense2", "kernel"), _linear(g("time_embed.2.weight")))
    _set(p, ("time_dense2", "bias"), g("time_embed.2.bias"))

    # Input trunk: CompVis input_blocks.{i} for i>=1 maps to our
    # input_block_{i-1}.  Downsample positions and channel-change residuals
    # derive from the level structure.
    src_idx = 1
    ours_idx = 0
    prev_mult = 1
    for level, mult in enumerate(channel_mult):
        for j in range(num_blocks):
            src = f"input_blocks.{src_idx}.0"
            dst = (f"input_block_{ours_idx}", "residual")
            has_shortcut = (mult != prev_mult) and j == 0
            _convert_unet_residual(g, p, src, dst, has_shortcut)
            if level < num_levels - 1:
                _convert_spatial_transformer(
                    g, p, f"input_blocks.{src_idx}.1",
                    (f"input_block_{ours_idx}", "spatial_transformer"),
                    num_heads,
                )
            src_idx += 1
            ours_idx += 1
        prev_mult = mult
        if level < num_levels - 1:
            _set(
                p,
                (f"input_block_{ours_idx}", "downsample", "conv", "kernel"),
                _conv(g(f"input_blocks.{src_idx}.0.op.weight")),
            )
            _set(
                p,
                (f"input_block_{ours_idx}", "downsample", "conv", "bias"),
                g(f"input_blocks.{src_idx}.0.op.bias"),
            )
            src_idx += 1
            ours_idx += 1

    # Middle block: CompVis middle_block.{0,1,2}.
    _convert_unet_residual(
        g, p, "middle_block.0", ("middle_block", "residual1"), False
    )
    _convert_spatial_transformer(
        g, p, "middle_block.1", ("middle_block", "spatial_transformer"),
        num_heads,
    )
    _convert_unet_residual(
        g, p, "middle_block.2", ("middle_block", "residual2"), False
    )

    # Output trunk: CompVis output_blocks.{i} -> output_block_{i}.  Every
    # residual has a skip_connection (the concat always changes channels);
    # spatial transformers on all but the deepest level; upsample at the end
    # of each level except the last processed (shallowest).
    ours_idx = 0
    for level, mult in reversed(list(enumerate(channel_mult))):
        for j in range(num_blocks + 1):
            src = f"output_blocks.{ours_idx}"
            dst = (f"output_block_{ours_idx}",)
            _convert_unet_residual(g, p, f"{src}.0", dst + ("residual",), True)
            has_st = level < num_levels - 1
            if has_st:
                _convert_spatial_transformer(
                    g, p, f"{src}.1", dst + ("spatial_transformer",), num_heads
                )
            if level > 0 and j == num_blocks:
                up_idx = 2 if has_st else 1
                _set(
                    p,
                    dst + ("upsample", "conv", "kernel"),
                    _conv(g(f"{src}.{up_idx}.conv.weight")),
                )
                _set(
                    p,
                    dst + ("upsample", "conv", "bias"),
                    g(f"{src}.{up_idx}.conv.bias"),
                )
            ours_idx += 1

    _set(p, ("group_norm", "scale"), g("out.0.weight"))
    _set(p, ("group_norm", "bias"), g("out.0.bias"))
    _set(p, ("conv_out", "kernel"), _conv(g("out.2.weight")))
    _set(p, ("conv_out", "bias"), g("out.2.bias"))

    if reference_params is not None:
        _verify_against(reference_params, p, "unet")
    return p


# --------------------------------------------------------------------------
# Autoencoder (convert_ckpt_pytorch_to_tf2.py:235-372, :413-421)
# --------------------------------------------------------------------------


def _convert_ae_residual(g, p, src: str, dst: tuple[str, ...],
                         has_shortcut: bool) -> None:
    _set(p, dst + ("group_norm1", "scale"), g(f"{src}.norm1.weight"))
    _set(p, dst + ("group_norm1", "bias"), g(f"{src}.norm1.bias"))
    _set(p, dst + ("conv1", "kernel"), _conv(g(f"{src}.conv1.weight")))
    _set(p, dst + ("conv1", "bias"), g(f"{src}.conv1.bias"))
    _set(p, dst + ("group_norm2", "scale"), g(f"{src}.norm2.weight"))
    _set(p, dst + ("group_norm2", "bias"), g(f"{src}.norm2.bias"))
    _set(p, dst + ("conv2", "kernel"), _conv(g(f"{src}.conv2.weight")))
    _set(p, dst + ("conv2", "bias"), g(f"{src}.conv2.bias"))
    if has_shortcut:
        _set(p, dst + ("shortcut", "kernel"),
             _conv1x1(g(f"{src}.nin_shortcut.weight")))
        _set(p, dst + ("shortcut", "bias"), g(f"{src}.nin_shortcut.bias"))


def _convert_ae_attention(g, p, src: str, dst: tuple[str, ...]) -> None:
    _set(p, dst + ("group_norm", "scale"), g(f"{src}.norm.weight"))
    _set(p, dst + ("group_norm", "bias"), g(f"{src}.norm.bias"))
    for ours, theirs in (("query", "q"), ("key", "k"), ("value", "v"),
                         ("output", "proj_out")):
        _set(p, dst + (ours, "kernel"), _conv1x1(g(f"{src}.{theirs}.weight")))
        _set(p, dst + (ours, "bias"), g(f"{src}.{theirs}.bias"))


def _ae_block_has_attention(
    sd: StateDict, prefix: str, src: str
) -> bool:
    return f"{prefix}{src}.norm.weight" in sd


def _convert_encoder(
    g, sd, p, prefix: str, num_blocks: int, multipliers
) -> None:
    enc = ("encoder",)
    _set(p, enc + ("conv_in", "kernel"), _conv(g("encoder.conv_in.weight")))
    _set(p, enc + ("conv_in", "bias"), g("encoder.conv_in.bias"))

    idx = 0
    prev_mult = 1
    for level, mult in enumerate(multipliers):
        for j in range(num_blocks):
            src = f"encoder.down.{level}.block.{j}"
            dst = enc + (f"down_{idx}", "residual")
            _convert_ae_residual(g, p, src, dst, mult != prev_mult and j == 0)
            attn_src = f"encoder.down.{level}.attn.{j}"
            if _ae_block_has_attention(sd, prefix, attn_src):
                _convert_ae_attention(
                    g, p, attn_src, enc + (f"down_{idx}", "attention")
                )
            idx += 1
        prev_mult = mult
        if level < len(multipliers) - 1:
            src = f"encoder.down.{level}.downsample.conv"
            _set(p, enc + (f"down_{idx}", "conv", "kernel"),
                 _conv(g(f"{src}.weight")))
            _set(p, enc + (f"down_{idx}", "conv", "bias"), g(f"{src}.bias"))
            idx += 1

    _convert_ae_residual(
        g, p, "encoder.mid.block_1", enc + ("middle", "residual1"), False
    )
    _convert_ae_attention(g, p, "encoder.mid.attn_1",
                          enc + ("middle", "attention"))
    _convert_ae_residual(
        g, p, "encoder.mid.block_2", enc + ("middle", "residual2"), False
    )
    _set(p, enc + ("group_norm", "scale"), g("encoder.norm_out.weight"))
    _set(p, enc + ("group_norm", "bias"), g("encoder.norm_out.bias"))
    _set(p, enc + ("conv_out", "kernel"), _conv(g("encoder.conv_out.weight")))
    _set(p, enc + ("conv_out", "bias"), g("encoder.conv_out.bias"))


def _convert_decoder(
    g, sd, p, prefix: str, num_blocks: int, multipliers
) -> None:
    dec = ("decoder",)
    _set(p, dec + ("conv_in", "kernel"), _conv(g("decoder.conv_in.weight")))
    _set(p, dec + ("conv_in", "bias"), g("decoder.conv_in.bias"))
    _convert_ae_residual(
        g, p, "decoder.mid.block_1", dec + ("middle", "residual1"), False
    )
    _convert_ae_attention(g, p, "decoder.mid.attn_1",
                          dec + ("middle", "attention"))
    _convert_ae_residual(
        g, p, "decoder.mid.block_2", dec + ("middle", "residual2"), False
    )

    idx = 0
    mult_list = list(multipliers)
    for level in reversed(range(len(mult_list))):
        for j in range(num_blocks + 1):
            src = f"decoder.up.{level}.block.{j}"
            dst = dec + (f"up_{idx}", "residual")
            has_shortcut = f"{prefix}{src}.nin_shortcut.weight" in sd
            _convert_ae_residual(g, p, src, dst, has_shortcut)
            attn_src = f"decoder.up.{level}.attn.{j}"
            if _ae_block_has_attention(sd, prefix, attn_src):
                _convert_ae_attention(
                    g, p, attn_src, dec + (f"up_{idx}", "attention")
                )
            idx += 1
        if level > 0:
            src = f"decoder.up.{level}.upsample.conv"
            _set(p, dec + (f"up_{idx}", "conv", "kernel"),
                 _conv(g(f"{src}.weight")))
            _set(p, dec + (f"up_{idx}", "conv", "bias"), g(f"{src}.bias"))
            idx += 1

    _set(p, dec + ("group_norm", "scale"), g("decoder.norm_out.weight"))
    _set(p, dec + ("group_norm", "bias"), g("decoder.norm_out.bias"))
    _set(p, dec + ("conv_out", "kernel"), _conv(g("decoder.conv_out.weight")))
    _set(p, dec + ("conv_out", "bias"), g("decoder.conv_out.bias"))


def _convert_autoencoder(sd, num_blocks, multipliers, prefix) -> ParamTree:
    """Shared KL/VQ body: encoder + decoder + (post_)quant 1x1 convs."""
    p: ParamTree = {}
    g = lambda k: np.asarray(sd[prefix + k])
    _convert_encoder(g, sd, p, prefix, num_blocks, multipliers)
    _convert_decoder(g, sd, p, prefix, num_blocks, multipliers)
    _set(p, ("quant_conv", "kernel"), _conv1x1(g("quant_conv.weight")))
    _set(p, ("quant_conv", "bias"), g("quant_conv.bias"))
    _set(p, ("post_quant_conv", "kernel"), _conv1x1(g("post_quant_conv.weight")))
    _set(p, ("post_quant_conv", "bias"), g("post_quant_conv.bias"))
    return p


def convert_autoencoder_kl(
    sd: StateDict,
    num_blocks: int = 2,
    multipliers: tuple[int, ...] = (1, 2, 4, 4),
    prefix: str = "first_stage_model.",
    reference_params: ParamTree | None = None,
) -> ParamTree:
    p = _convert_autoencoder(sd, num_blocks, multipliers, prefix)
    if reference_params is not None:
        _verify_against(reference_params, p, "autoencoder_kl")
    return p


def convert_autoencoder_vq(
    sd: StateDict,
    num_blocks: int = 2,
    multipliers: tuple[int, ...] = (1, 2, 2, 4),
    prefix: str = "first_stage_model.",
    reference_params: ParamTree | None = None,
) -> ParamTree:
    p = _convert_autoencoder(sd, num_blocks, multipliers, prefix)
    g = lambda k: np.asarray(sd[prefix + k])
    _set(p, ("quantize", "kernel"), g("quantize.embedding.weight"))
    if reference_params is not None:
        _verify_against(reference_params, p, "autoencoder_vq")
    return p
