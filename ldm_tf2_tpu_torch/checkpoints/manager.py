"""Training-state checkpoints of the port (counterpart of
``ldm_tf2_tpu.checkpoints.manager.CheckpointManager``, in its own format):
one ``torch.save`` file per step, ``<directory>/ckpt-<step>.pt``, written
to a temporary name and renamed, so a file that exists is whole.  The
newest ``max_to_keep`` files are kept; ``restore_latest`` loads the newest.
The Orbax layout of the JAX package is not read or written.  In a
data-parallel run (``mesh``) rank 0 writes, every rank waits for it at a
barrier, and every rank restores the same newest file.
"""

from __future__ import annotations

import os
import re

import torch

from ldm_tf2_tpu_torch.parallel import barrier

_NAME = re.compile(r"^ckpt-(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3, mesh=None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.mesh = mesh

    def steps(self) -> list[int]:
        if not os.path.isdir(self.directory):
            return []
        found = (_NAME.match(f) for f in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt-{step}.pt")

    def save(self, step: int, state: dict) -> str:
        """Write ``state`` (nested dicts of tensors and numbers) as the
        checkpoint of ``step``; drop the oldest beyond ``max_to_keep``."""
        path = self.path(step)
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
        none."""
        steps = self.steps()
        if not steps:
            return None
        state = torch.load(self.path(steps[-1]), map_location=map_location,
                           weights_only=True)
        return steps[-1], state
