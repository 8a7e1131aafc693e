"""The device mesh of the port over ``torch.distributed`` (the counterpart
of ``ldm_tf2_tpu.parallel.mesh``).

One process drives one card.  A run launched by ``torchrun`` (which sets
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``) joins the process group in ``maybe_initialize_distributed``:
NCCL for CUDA devices, gloo for the CPU, rank r on ``cuda:<LOCAL_RANK>``.
``create_mesh`` checks ``tpu.mesh`` against the world size as the JAX
``create_mesh`` checks it against the device count, and places rank r in
the mesh as the JAX package places device r: ``devices.reshape(sizes)``
over the axes in ``tpu.mesh``'s key order, so under ``{"data": 2,
"model": 2}`` rank r sits at data r // 2 and model r % 2.  Each axis has
the process group of the ranks that differ only in it (``Mesh.group``):
the world's where the axis spans it, else one made by ``dist.new_group``;
every rank makes every group, in one fixed order.

The JAX package lets ``jit`` emit the collectives of a sharded step; here
the trainers call them, over the ``data`` axis: ``all_reduce_mean_``
averages gradients (float32), ``all_reduce_sum`` is the differentiable sum
behind the discriminator's global batch statistics, ``gather_rows``
collects a batch in data order, ``shard_batch`` takes this rank's rows.
Ranks that differ only in their ``model`` coordinate take the same rows.
``replicate`` broadcasts over the world.  Each is the identity without a
process group.  With one (at world 1 too) they run the collectives, so the
world-1 path is the data-parallel code.  The ``model`` axis is the tensor-
and sequence-parallel groups' (``ops/tp.py``, ``ops/attention.py``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
# float32 elements per all-reduce: bounds the flattened copy of the
# gradients to 256 MB
_BUCKET = 1 << 26


def distributed() -> bool:
    """Whether this process is in a ``torch.distributed`` process group."""
    return dist.is_available() and dist.is_initialized()


def maybe_initialize_distributed(device="cuda") -> torch.device:
    """Join the process group that ``torchrun``'s environment describes and
    return this rank's device (``cuda:<LOCAL_RANK>`` for a CUDA device).
    Without that environment, or in a process already in a group, return
    ``device`` as given."""
    device = torch.device(device)
    env = os.environ
    if not distributed() and "RANK" in env and "WORLD_SIZE" in env:
        if device.type == "cuda":
            device = torch.device("cuda", int(env.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(device)
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
            rank=int(env["RANK"]), world_size=int(env["WORLD_SIZE"]))
    elif distributed() and device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis sizes (``shape``, e.g. ``{"data": 2, "model": 2}``), this
    process's rank and the world size.  ``distributed`` says whether the
    collectives run; ``groups`` holds, for an axis that does not span the
    world, the process group of this rank's peers along it."""

    shape: Mapping[str, int]
    rank: int = 0
    world: int = 1
    distributed: bool = False
    groups: Mapping[str, object] = dataclasses.field(default_factory=dict, repr=False,
                                                     compare=False)

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (0 off the mesh's axes)."""
        if axis not in self.shape:
            return 0
        coords = np.unravel_index(self.rank, tuple(self.shape.values()))
        return int(coords[list(self.shape).index(axis)])

    def group(self, axis: str):
        """The process group of the ranks that differ from this one only
        along ``axis`` (None: the world's, or none along an axis of one)."""
        return self.groups.get(axis)

    def spans(self, axis: str) -> bool:
        """Whether collectives over ``axis`` run: in a process group, along
        an axis of more than one rank or one that spans the world (at world
        1 too, so that the world-1 path is the data-parallel code)."""
        return self.distributed and (self.size(axis) > 1 or self.size(axis) == self.world)

    @property
    def data_index(self) -> int:
        return self.index(DATA_AXIS)

    @property
    def data_size(self) -> int:
        return self.size(DATA_AXIS)


def create_mesh(mesh_shape: Mapping[str, int] | None = None,
                world: int | None = None, rank: int | None = None) -> Mesh:
    """The mesh of the world (``world`` and ``rank`` default to the process
    group's, else 1 and 0).  Default: every rank on the ``data`` axis.
    Sizes must multiply to the world size; one -1 is inferred."""
    in_group = distributed()
    if world is None:
        world = dist.get_world_size() if in_group else 1
    if rank is None:
        rank = dist.get_rank() if in_group else 0
    if mesh_shape is None:
        mesh_shape = {DATA_AXIS: world}
    names = tuple(mesh_shape.keys())
    sizes = list(mesh_shape.values())
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = world // known
    if int(np.prod(sizes)) != world:
        raise ValueError(
            f"mesh shape {dict(zip(names, sizes))} != {world} devices"
        )
    shape = dict(zip(names, sizes))
    groups = _axis_groups(shape, rank, world) if in_group and world > 1 else {}
    return Mesh(shape, rank, world, in_group, groups)


def _axis_groups(shape: dict, rank: int, world: int) -> dict:
    """{axis: this rank's group along it} for the axes of more than one rank
    that do not span the world.  Every rank creates every group
    (``dist.new_group`` is collective over the world), axis by axis in key
    order, groups in rank order."""
    coords = np.stack(np.unravel_index(np.arange(world), tuple(shape.values())), axis=1)
    groups = {}
    for a, axis in enumerate(shape):
        if shape[axis] in (1, world):
            continue
        others = np.delete(coords, a, axis=1)
        for key in sorted({tuple(c) for c in others}):
            ranks = [r for r in range(world) if tuple(others[r]) == key]
            group = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = group
    return groups


def _in_group(mesh: Mesh | None) -> bool:
    return mesh is not None and mesh.distributed


def _over_data(mesh: Mesh | None) -> bool:
    return mesh is not None and mesh.spans(DATA_AXIS)


def shard_batch(x, mesh: Mesh | None):
    """This rank's rows of a global batch, by its ``data`` coordinate (all
    of it without a group)."""
    if not _in_group(mesh):
        return x
    n = mesh.data_size
    if x.shape[0] % n:
        raise ValueError(
            f"global batch {x.shape[0]} is not divisible by the data axis {n}"
        )
    b = x.shape[0] // n
    return x[mesh.data_index * b:(mesh.data_index + 1) * b]


@torch.no_grad()
def replicate(module: torch.nn.Module, mesh: Mesh | None) -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from rank 0 to the
    world."""
    if _in_group(mesh):
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)
    return module


@torch.no_grad()
def all_reduce_mean_(tensors, mesh: Mesh | None) -> None:
    """Average ``tensors`` over the ``data`` axis in place, summed in
    float32 (in buckets of at most 256 MB of copies)."""
    if not _over_data(mesh):
        return
    tensors = list(tensors)
    start = 0
    while start < len(tensors):
        stop, size = start, 0
        while stop < len(tensors) and (size == 0 or size + tensors[stop].numel() <= _BUCKET):
            size += tensors[stop].numel()
            stop += 1
        bucket = tensors[start:stop]
        flat = torch.cat([t.reshape(-1).float() for t in bucket])
        dist.all_reduce(flat, group=mesh.group(DATA_AXIS))
        flat.div_(mesh.data_size)
        parts = flat.split([t.numel() for t in bucket])
        torch._foreach_copy_(bucket, [p.view_as(t) for p, t in zip(parts, bucket)])
        start = stop


def global_mean(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The mean of a per-rank scalar over the ``data`` axis (``x`` without a
    group)."""
    if not _over_data(mesh):
        return x
    y = x.detach().float().clone()
    dist.all_reduce(y, group=mesh.group(DATA_AXIS))
    return (y / mesh.data_size).to(x.dtype)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        # every rank's loss reads the sum: its gradient is the sum of theirs
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The sum of ``x`` over the ``data`` axis, differentiable (``x``
    without a group)."""
    return _AllReduceSum.apply(x, mesh.group(DATA_AXIS)) if _over_data(mesh) else x


def gather_rows(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """Every ``data`` coordinate's ``x`` concatenated along the first axis
    in data order."""
    if not _over_data(mesh):
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.data_size)]
    dist.all_gather(parts, x, group=mesh.group(DATA_AXIS))
    return torch.cat(parts)


def barrier(mesh: Mesh | None) -> None:
    if not _in_group(mesh):
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()
