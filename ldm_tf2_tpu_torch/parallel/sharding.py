"""Tensor-parallel parameter sharding rules (the counterpart of
``ldm_tf2_tpu.parallel.sharding``).

The JAX package places each parameter with a ``NamedSharding`` and lets
XLA's partitioner insert the collectives.  PyTorch has no partitioner, so
the port does it the Megatron way: ``shard_params_tp`` keeps on each rank
of a ``model`` group only its contiguous block of every sharded parameter,
as a ``NamedSharding`` over that axis splits it, and records the split
dimension on the module that owns it (``tp``, a ``TPShard``); the modules
then run their share of the layer and a row-parallel layer ends in one
all-reduce over the group (``ops/tp.py``).

``DEFAULT_TP_RULES`` are the JAX rules copied as definitions: the same
regexes over the parameter names, ``/`` replaced by ``.`` (the port's
``state_dict`` keys are the flax paths joined with dots), each with the
dimension it splits in the port's layout.  The layouts are the JAX ones
except for convolution kernels, which are OIHW here and HWIO there: the
JAX output-channel axis 3 is dimension 0, the input-channel axis 2 is
dimension 1.  The first matching rule wins; a leaf whose split dimension
does not divide by the axis size stays whole, as in the JAX package.

  split projections  [D, H, S]   -> H (1)
  merge projections  [H, S, D]   -> H (0)
  FFN filter / GEGLU [D, F]      -> F (1, column-parallel), biases [F] (0)
  FFN output         [F, D]      -> F (0, row-parallel)
  ResBlock conv2d_1  [O, I, 3, 3] -> O (0), its bias, the time-embedding
                                    dense and group_norm_2 on the same
                                    channels
  ResBlock conv2d_2  [O, I, 3, 3] -> I (1, row-parallel)
  token embedding    [V, D]      -> V (0)

The ResBlock's GroupNorm 2 runs on the local channels with 32 / n groups:
its 32 groups are contiguous, so a model axis that divides 32 keeps each
group on one rank.  For an n that does not divide 32, ``shard_params_tp``
keeps the whole block on every rank (the JAX partitioner would instead sum
the split groups' statistics across ranks).
"""

from __future__ import annotations

import re
from typing import NamedTuple, Sequence

import torch

from ldm_tf2_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh

# (regex over the dotted parameter name, the dimension split over `model`)
DEFAULT_TP_RULES: Sequence[tuple[str, int]] = (
    # attention head-split projections: [D, H, S]
    (r"(mha|att_layer\d)\.(query|key|value)\.kernel$", 1),
    # attention merge projections: [H, S, D]
    (r"(mha|att_layer\d)\.output\.kernel$", 0),
    # transformer FFN: column-parallel in, row-parallel out
    (r"ffn\.filter\.kernel$", 1),
    (r"ffn\.filter\.bias$", 0),
    (r"ffn\.output\.kernel$", 0),
    # U-Net GEGLU feed-forward: value and gate columns, then the dense rows
    (r"ffn\.geglu\.(value|gate)\.kernel$", 1),
    (r"ffn\.geglu\.(value|gate)\.bias$", 0),
    (r"ffn\.dense\.kernel$", 0),
    # U-Net ResBlock: conv2d_1 column-parallel (OIHW: O), its bias, the
    # time-embedding dense and GN2's affine on the same channels; conv2d_2
    # row-parallel (OIHW: I)
    (r"residual\.conv2d_1\.kernel$", 0),
    (r"residual\.conv2d_1\.bias$", 0),
    (r"residual\.dense\.kernel$", 1),
    (r"residual\.dense\.bias$", 0),
    (r"residual\.group_norm_2\.(scale|bias)$", 0),
    (r"residual\.conv2d_2\.kernel$", 1),
    # token embedding: vocabulary rows
    (r"token_embedding\.embedding$", 0),
)


class TPShard(NamedTuple):
    """What ``shard_params_tp`` records on a module whose ``kernel`` or
    ``embedding`` it split: the dimension, this rank's block and the number
    of blocks."""

    dim: int
    index: int
    size: int


# the ResBlock leaves that shard together, and stay whole together
_RESBLOCK = re.compile(r"residual\.(conv2d_1|dense|group_norm_2|conv2d_2)\.")
GROUPS = 32  # the ResBlock's GroupNorm groups


def tp_param_shardings(module: torch.nn.Module, n: int,
                       rules=DEFAULT_TP_RULES) -> dict[str, int | None]:
    """{parameter name: the dimension split over a ``model`` axis of size
    ``n``, or None (whole)} for ``module``'s parameters (the JAX
    ``tp_param_shardings``, with the port's layouts).  Shapes only: a module
    on the meta device will do."""
    out = {}
    for name, p in module.named_parameters():
        out[name] = None
        if n <= 1:
            continue
        for pattern, dim in rules:
            if re.search(pattern, name):
                if dim < p.dim() and p.shape[dim] % n == 0:
                    out[name] = dim
                break
    return out


@torch.no_grad()
def shard_params_tp(module: torch.nn.Module, mesh: Mesh,
                    rules=DEFAULT_TP_RULES) -> torch.nn.Module:
    """Keep this rank's block of every parameter the rules split over the
    mesh's ``model`` axis (its ``model`` coordinate's contiguous slice, as a
    ``NamedSharding`` splits it), in place, and set ``tp`` (a ``TPShard``)
    on each split parameter and on each module whose ``kernel`` or
    ``embedding`` was split.  Run it
    after the weights are loaded and cast.  Returns ``module``."""
    n, i = mesh.size(MODEL_AXIS), mesh.index(MODEL_AXIS)
    dims = tp_param_shardings(module, n, rules)
    if GROUPS % max(n, 1):
        dims = {k: None if _RESBLOCK.search(k) else d for k, d in dims.items()}
    for name, dim in dims.items():
        if dim is None:
            continue
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        p = getattr(owner, leaf)
        size = p.shape[dim] // n
        p.data = p.data.narrow(dim, i * size, size).clone()
        p.tp = TPShard(dim, i, n)
        if leaf in ("kernel", "embedding"):
            owner.tp = p.tp
    return module


def sharded_leaves(modules) -> dict[str, TPShard]:
    """{"<prefix>.<parameter name>": its ``TPShard``} for the parameters
    ``shard_params_tp`` split, over ``modules`` ({prefix: module}, as
    ``training/ldm_trainer.py::trainable_params`` names them).  What
    ``checkpoints/manager.py`` gathers and reshards."""
    return {f"{prefix}.{name}": p.tp for prefix, module in modules.items()
            if module is not None for name, p in module.named_parameters()
            if getattr(p, "tp", None) is not None}
