"""Rematerialization that replays explicit generators (the port of the JAX
trainer's ``jax.checkpoint`` around the U-Net, ``tpu.remat``).

``torch.utils.checkpoint`` restores only the global RNG states on the
recompute, while the port's dropout draws its masks from an explicit
generator: a plain checkpoint would draw new masks from the advanced
generator, and the gradient would belong to another forward.  So
``checkpoint`` runs the segment on a private generator set to the step
generator's state at the segment's entry, moves the step generator on to
where the private one ended, and the recompute builds a fresh private
generator from the same entry state: the same masks, and the step
generator ends where it would without remat.

Policies (``POLICIES``, the JAX trainer's names):

* ``True`` / ``"full"``: one segment around the U-Net forward; nothing of
  it is saved.
* ``"blocks"``: each input, middle and output block is its own segment
  (``UNet.forward(..., remat_blocks=True)``), so only the block boundaries
  are saved, as JAX's ``save_only_these_names("unet_block")`` keeps the
  tagged block outputs.
* ``"dots"``: JAX's ``dots_with_no_batch_dims_saveable``: one segment whose
  plain dense products (``aten.mm``, ``aten.addmm``: no batch dims) keep
  their outputs and whose other ops are recomputed
  (``create_selective_checkpoint_contexts``).  The kernels are
  ``autograd.Function``s over ``ctypes`` calls that the policy does not
  see, so on the card the flash and FFN forwards are recomputed, on their
  CUDA paths.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint as torch_checkpoint,
    create_selective_checkpoint_contexts,
)

from ldm_tf2_tpu_torch.parallel import rng

POLICIES = (True, "full", "blocks", "dots")
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def check_policy(policy) -> None:
    """A false ``policy`` is no remat; else it must be one of ``POLICIES``."""
    if policy and policy not in POLICIES:
        raise ValueError(
            f"tpu.remat must be one of false|true|full|blocks|dots, got {policy!r}"
        )


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _SAVED_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


dots_context = functools.partial(create_selective_checkpoint_contexts, _dots_policy)


def checkpoint(fn, generator, *args, context_fn=None):
    """``fn(generator, *args)`` as a non-reentrant checkpoint segment whose
    recompute replays ``generator``'s draws (a ``torch.Generator``, a
    ``parallel.RowSlice`` or None)."""
    kw = dict(use_reentrant=False)
    if context_fn is not None:
        kw["context_fn"] = context_fn
    if generator is None:
        return torch_checkpoint(fn, None, *args, **kw)
    start = rng.state_of(generator)
    end = []

    def run(*a):
        private = rng.fork(generator, start)
        out = fn(private, *a)
        end[:] = [rng.state_of(private)]
        return out

    out = torch_checkpoint(run, *args, **kw)
    rng.advance(generator, end[0])
    return out
