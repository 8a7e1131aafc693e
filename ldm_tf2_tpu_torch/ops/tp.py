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


def all_reduce_model(x: torch.Tensor) -> torch.Tensor:
    """The sum of the model group's partials ``x`` (a temporary of the
    caller's, reduced in place in its dtype)."""
    if _TP_STATE is None:
        raise RuntimeError("tensor-parallel leaves without enable_tensor_parallel(mesh)")
    mesh, axis = _TP_STATE
    x = x.contiguous()
    if mesh.distributed:
        dist.all_reduce(x, group=mesh.group(axis))
    return x


def tp_fused_ffn(x, ln_scale, ln_bias, w1v, b1v, w1g, b1g, w2, b2,
                 eps: float = 1e-5):
    """Megatron column x row fused FFN: this rank's w1v, b1v, w1g, b1g
    columns and w2 rows (b2 whole).  The kernel runs in its partial-product
    mode, the partials are all-reduced in x's dtype, then b2 and x are
    added once, each add rounded."""
    from ldm_tf2_tpu_torch.ops.fused_ffn import fused_ffn

    local = fused_ffn(x, ln_scale, ln_bias, w1v, b1v, w1g, b1g, w2, b2, eps,
                      partial=True)
    out = all_reduce_model(local)
    return out + b2.to(out.dtype) + x.to(out.dtype)
