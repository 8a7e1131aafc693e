"""Tensor parallelism of the port (the counterpart of ``ldm_tf2_tpu.ops.tp``).

The JAX package composes its kernels with GSPMD through ``shard_map``
wrappers; the port runs the same decomposition by hand.  After
``enable_tensor_parallel(mesh)`` and ``parallel.sharding.shard_params_tp``
each rank of the mesh's ``model`` group holds its block of every sharded
parameter, and the modules run their share:

  * attention: the split projections give this rank's H / n heads, on which
    the unchanged kernels run (the flash kernel, row 1, or the cross kernel,
    row 12); the merge projection is row-parallel.  No collective until it;
  * fused FFN (``tp_fused_ffn``): the kernel's partial-product mode over the
    rank's F / n hidden columns, one all-reduce in x's dtype, then + b2 and
    + x, each rounded, as the JAX ``tp_fused_ffn`` does;
  * a row-parallel layer (merge projection, the text encoder's FFN output,
    the ResBlock's conv2d_2, the vocabulary-split embedding) ends in one
    all-reduce over the group (``all_reduce_model``), after which the bias
    and the residual are added once.

Gradients are Megatron's pair of autograd functions, so that a rank's
backward pass gives the JAX partitioner's gradients: ``all_reduce_model``
is the identity in the backward pass (every rank's loss reads the sum),
and ``copy_to_model``, the identity in the forward pass, all-reduces the
gradient of a replicated tensor where it enters a column-parallel
computation (the split q/k/v projections' input and the context of the
cross-attention's k/v, a column-parallel ``Dense``'s input, the ResBlock's
chain input and GroupNorm 1's affine, the partial FFN's x and LayerNorm
affine), whose gradient on one rank is only that rank's share.  So a
sharded leaf's gradient is its block of one process's, and a replicated
leaf's is the whole gradient, the same on every model peer.

The JAX claims (``tp_attention_claims``, ``tp_ffn_claims``) become the
leaves: the rules' divisibility fallback (``tp_param_shardings``) keeps a
leaf whole where the axis does not divide its heads or hidden width, and a
module runs its TP share exactly when ``shard_params_tp`` split its leaves
(their ``tp``).  The JAX claims' other conditions are the TPU's tile rules
and ``shard_map``'s even batch, which the port does not have.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# (mesh, axis) when a >1-sized model axis is registered, else None.
_TP_STATE = None


def enable_tensor_parallel(mesh, axis: str = "model") -> None:
    """Register ``mesh`` for tensor parallelism (None or a size-1 axis
    disables).  Call alongside ``shard_params_tp``."""
    global _TP_STATE
    if mesh is None or mesh.size(axis) <= 1:
        _TP_STATE = None
    else:
        _TP_STATE = (mesh, axis)


def tp_state():
    return _TP_STATE


def _model_group():
    if _TP_STATE is None:
        raise RuntimeError("tensor-parallel leaves without enable_tensor_parallel(mesh)")
    mesh, axis = _TP_STATE
    return mesh.distributed, mesh.group(axis)


class _AllReduceModel(torch.autograd.Function):
    """The model group's sum; the identity in the backward pass."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyToModel(torch.autograd.Function):
    """The identity; the backward pass sums the gradient over the model
    group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_model(x: torch.Tensor) -> torch.Tensor:
    """The sum of the model group's partials ``x``.  Without autograd it
    reduces in place (``x`` is a temporary of the caller's, reduced in its
    dtype); with it, a copy, and the backward pass passes the gradient on
    unchanged."""
    distributed, group = _model_group()
    if not distributed:
        return x.contiguous()
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllReduceModel.apply(x, group)
    x = x.contiguous()
    dist.all_reduce(x, group=group)
    return x


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """``x``, replicated on the model group, as the input of a
    column-parallel computation: the identity, whose backward pass sums
    the model peers' gradients (each holds only its columns' share)."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x
    distributed, group = _model_group()
    return _CopyToModel.apply(x, group) if distributed else x


@torch.no_grad()
def global_norm(tensors, sharded) -> torch.Tensor:
    """The L2 norm over the whole leaves of which ``tensors`` hold this
    rank's blocks (``sharded[i]``) or all (replicated): the squared norms
    of the blocks summed over the model group, each replicated leaf counted
    once.  optax's ``global_norm`` of the logical arrays, the same on every
    model peer."""
    sq = torch.stack(torch._foreach_norm(list(tensors))).float().square()
    mask = torch.as_tensor(sharded, device=sq.device)
    split = sq[mask].sum().reshape(1)
    distributed, group = _model_group()
    if distributed:
        dist.all_reduce(split, group=group)
    return (split + sq[~mask].sum()).sqrt()[0]


def tp_fused_ffn(x, ln_scale, ln_bias, w1v, b1v, w1g, b1g, w2, b2,
                 eps: float = 1e-5):
    """Megatron column x row fused FFN: this rank's w1v, b1v, w1g, b1g
    columns and w2 rows (b2 whole).  The kernel runs in its partial-product
    mode on x and the LayerNorm affine through ``copy_to_model``, the
    partials are all-reduced in x's dtype, then b2 and x are added once,
    each add rounded."""
    from ldm_tf2_tpu_torch.ops.fused_ffn import fused_ffn

    local = fused_ffn(copy_to_model(x), copy_to_model(ln_scale), copy_to_model(ln_bias),
                      w1v, b1v, w1g, b1g, w2, b2, eps, partial=True)
    out = all_reduce_model(local)
    return out + b2.to(out.dtype) + x.to(out.dtype)
