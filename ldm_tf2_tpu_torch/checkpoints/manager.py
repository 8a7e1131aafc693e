"""Training-state checkpoints of the port (counterpart of
``ldm_tf2_tpu.checkpoints.manager.CheckpointManager``, in its own format):
one ``torch.save`` file per step, ``<directory>/ckpt-<step>.pt``, written
to a temporary name and renamed, so a file that exists is whole.  The
newest ``max_to_keep`` files are kept; ``restore_latest`` loads the newest.
The Orbax layout of the JAX package is not read or written.  In a
data-parallel run (``mesh``) rank 0 writes, every rank waits for it at a
barrier, and every rank restores the same newest file.

Under tensor parallelism (``shards``: ``parallel.sharding.sharded_leaves``
of the trained modules) a file holds whole leaves, as one process's does:
``save`` gathers every sharded leaf over the ``model`` group along its
split dimension, and ``restore_latest`` keeps this rank's block of it.  A
leaf of the saved tree is sharded when its dotted path ends in one of the
names of ``shards``, so the rules reach the optimizer's moments and the
EMA (``opt_state.mu.unet.<name>``, ``ema.unet.<name>``) as they reach the
parameters, as the JAX package's rules match paths inside its optimizer
tree.  A file so written restores in one process, on another mesh, and
into ``cli/export_pretrained.py``.
"""

from __future__ import annotations

import os
import re

import torch
import torch.distributed as dist

from ldm_tf2_tpu_torch.parallel import barrier
from ldm_tf2_tpu_torch.parallel.mesh import MODEL_AXIS

_NAME = re.compile(r"^ckpt-(\d+)\.pt$")


def _map(tree, fn, path=""):
    """``tree`` with ``fn(dotted path, leaf)`` in place of each leaf."""
    if isinstance(tree, dict):
        return {k: _map(v, fn, f"{path}.{k}" if path else str(k)) for k, v in tree.items()}
    return fn(path, tree)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3, mesh=None, shards=None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.mesh = mesh
        self.shards = dict(shards or {})

    def steps(self) -> list[int]:
        if not os.path.isdir(self.directory):
            return []
        found = (_NAME.match(f) for f in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt-{step}.pt")

    def _shard(self, path: str, leaf):
        """The ``TPShard`` of the leaf at ``path``, or None (whole)."""
        if not self.shards or not isinstance(leaf, torch.Tensor):
            return None
        parts = path.split(".")
        for i in range(len(parts)):
            shard = self.shards.get(".".join(parts[i:]))
            if shard is not None:
                return shard
        return None

    def _gathered(self, state: dict):
        """``state`` with every sharded leaf whole on rank 0 (None on the
        other ranks, which only take part in the gathers)."""
        group = self.mesh.group(MODEL_AXIS)
        keep = self.mesh.rank == 0

        def gather(path, leaf):
            shard = self._shard(path, leaf)
            if shard is None:
                return leaf
            leaf = leaf.contiguous()
            parts = [torch.empty_like(leaf) for _ in range(shard.size)]
            dist.all_gather(parts, leaf, group=group)
            return torch.cat(parts, dim=shard.dim) if keep else None

        return _map(state, gather)

    def save(self, step: int, state: dict) -> str:
        """Write ``state`` (nested dicts of tensors and numbers) as the
        checkpoint of ``step``; drop the oldest beyond ``max_to_keep``.
        Every rank of a mesh calls it (the gathers of sharded leaves are
        collective)."""
        path = self.path(step)
        if self.shards and self.mesh is not None and self.mesh.distributed:
            state = self._gathered(state)
        if self.mesh is None or self.mesh.rank == 0:
            os.makedirs(self.directory, exist_ok=True)
            tmp = f"{path}.tmp{os.getpid()}"
            torch.save(state, tmp)
            os.replace(tmp, path)
            for old in self.steps()[:-self.max_to_keep]:
                os.remove(self.path(old))
        barrier(self.mesh)
        return path

    def restore_latest(self, map_location=None) -> tuple[int, dict] | None:
        """(step, state) of the newest checkpoint, or None when there is
        none; with ``shards``, each sharded leaf cut to this rank's
        block."""
        steps = self.steps()
        if not steps:
            return None
        # mapped, not read: a rank reads only its blocks of the sharded leaves
        state = torch.load(self.path(steps[-1]), map_location=map_location,
                           weights_only=True, mmap=True)

        def block(path, leaf):
            shard = self._shard(path, leaf)
            if shard is None:
                return leaf
            if leaf.shape[shard.dim] % shard.size:
                raise ValueError(f"{path}: {tuple(leaf.shape)} does not split in "
                                 f"{shard.size} along dimension {shard.dim}")
            size = leaf.shape[shard.dim] // shard.size
            return leaf.narrow(shard.dim, shard.index * size, size).clone()

        return steps[-1], _map(state, block)
