"""Sequence-parallel (Ulysses) attention over a mesh axis (the counterpart
of ``ldm_tf2_tpu.ops.sequence_parallel``).

* tokens arrive split over the axis ([B, T/P, H, S] on each rank);
* one all-to-all sends heads instead of tokens ([B, T, H/P, S]), so every
  rank runs full-sequence attention on a subset of heads with the kernels
  of the single-card path;
* a second all-to-all restores the token split.

Each all-to-all is one ``torch.distributed.nn.functional.all_to_all_single``
of one packed buffer, which carries the gradient (its backward is the
inverse exchange).  Requires num_heads % P == 0 (the autoencoder's single
head is never claimed).

``sequence_parallel_attention`` is the global view the models call: the
rest of the model runs replicated on every rank of the axis, so it takes
this rank's block of tokens, runs Ulysses, and all-gathers the tokens
again (what GSPMD's reshard does in the JAX package).  The gather's
gradient is this rank's block of the output gradient and the split's is the
all-gathered input gradient, so the gradients are the replicated ones.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.nn.functional import all_to_all_single


def _exchange(x: torch.Tensor, p: int, split: int, concat: int, group) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split, concat, tiled=True)``: ``x``'s
    dimension ``split`` cut into ``p`` blocks, block j sent to rank j, the
    received blocks concatenated along ``concat`` in rank order."""
    blocks = torch.stack(x.chunk(p, dim=split))  # [p, ...] block j for rank j
    out = all_to_all_single(torch.empty_like(blocks), blocks.contiguous(), group=group)
    return torch.cat(out.unbind(0), dim=concat)


def _local_attention(q, k, v, scale):
    from ldm_tf2_tpu_torch.ops.flash_attention import flash_attention

    return flash_attention(q, k, v, scale)


def ulysses_attention(q, k, v, scale: float | None = None, *, mesh, axis: str = "model",
                      local=None):
    """Attention on sequence-split inputs: q [B, Tq/P, H, S], k/v [B, Tkv/P,
    H, S], this rank's blocks along ``mesh``'s ``axis`` of size P.  Returns
    this rank's [B, Tq/P, H, S] block of the output.  ``local(q, k, v,
    scale)`` is the attention on all tokens and H/P heads (the flash kernel
    by default)."""
    p, group = mesh.size(axis), mesh.group(axis)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    # scatter heads (dim 2), gather the sequence (dim 1)
    qh, kh, vh = (_exchange(t, p, 2, 1, group) for t in (q, k, v))
    out = (local or _local_attention)(qh, kh, vh, scale)
    # scatter the sequence (dim 1), gather heads (dim 2)
    return _exchange(out, p, 1, 2, group)


class _TakeBlock(torch.autograd.Function):
    """This rank's block of tokens of a replicated tensor; the gradient is
    every rank's block gathered."""

    @staticmethod
    def forward(ctx, x, p, index, group):
        ctx.p, ctx.group = p, group
        return x.chunk(p, dim=1)[index].contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _gather_tokens(grad, ctx.p, ctx.group), None, None, None


class _GatherTokens(torch.autograd.Function):
    """Every rank's block of tokens, concatenated; the gradient is this
    rank's block (each rank's loss reads the same replicated tensor)."""

    @staticmethod
    def forward(ctx, x, p, index, group):
        ctx.p, ctx.index = p, index
        return _gather_tokens(x, p, group)

    @staticmethod
    def backward(ctx, grad):
        return grad.chunk(ctx.p, dim=1)[ctx.index].contiguous(), None, None, None


def _gather_tokens(x, p, group):
    parts = [torch.empty_like(x) for _ in range(p)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=1)


def sequence_parallel_attention(q, k, v, mesh, scale: float | None = None,
                                axis: str = "model", local=None):
    """Global-view wrapper: q [B, Tq, H, S] and k/v [B, Tkv, H, S], the same
    on every rank of ``mesh``'s ``axis``; this rank's token blocks go
    through ``ulysses_attention`` and the output's blocks are gathered, so
    every rank returns the whole [B, Tq, H, S].  Requires H and both
    lengths to divide by the axis size."""
    p = mesh.size(axis)
    h = q.shape[2]
    if h % p != 0:
        raise ValueError(
            f"num_heads {h} not divisible by mesh axis {axis!r} size {p}"
        )
    if q.shape[1] % p != 0 or k.shape[1] % p != 0:
        raise ValueError(
            f"sequence lengths {q.shape[1]}/{k.shape[1]} not divisible by "
            f"mesh axis {axis!r} size {p}"
        )
    index, group = mesh.index(axis), mesh.group(axis)
    blocks = [_TakeBlock.apply(t, p, index, group) for t in (q, k, v)]
    out = ulysses_attention(*blocks, scale, mesh=mesh, axis=axis, local=local)
    return _GatherTokens.apply(out, p, index, group)
