"""The data-parallel mesh of the port over ``torch.distributed`` (the
counterpart of ``ldm_tf2_tpu.parallel.mesh``).

One process drives one card.  A run launched by ``torchrun`` (which sets
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``) joins the process group in ``maybe_initialize_distributed``:
NCCL for CUDA devices, gloo for the CPU, rank r on ``cuda:<LOCAL_RANK>``.
``create_mesh`` checks ``tpu.mesh`` against the world size as the JAX
``create_mesh`` checks it against the device count.

The JAX package lets ``jit`` emit the collectives of a sharded step; here
the trainers call them: ``all_reduce_mean_`` averages gradients (float32),
``all_reduce_sum`` is the differentiable sum behind the discriminator's
global batch statistics, ``gather_rows`` collects a batch in rank order.
Each is the identity without a process group.  With one (at world 1 too)
they run the collectives, so the world-1 path is the data-parallel code.

Only the ``data`` axis is ported: a ``model`` axis larger than 1, tensor
and sequence parallelism are ROADMAP queue A item A6b.
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
    """Axis sizes (``shape``, e.g. ``{"data": 2}``), this process's rank and
    the world size.  ``distributed`` says whether the collectives run."""

    shape: Mapping[str, int]
    rank: int = 0
    world: int = 1
    distributed: bool = False


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
    return Mesh(dict(zip(names, sizes)), rank, world, in_group)


def check_data_parallel(config: dict, what: str = "") -> None:
    """Refuse what the port does not run yet: a ``model`` axis larger than 1,
    ``tpu.tensor_parallel`` and ``tpu.sequence_parallel``."""
    tpu = config["tpu"]
    model = (tpu.get("mesh") or {}).get(MODEL_AXIS, 1)
    if tpu["sequence_parallel"] or tpu["tensor_parallel"] or model not in (-1, 1):
        raise NotImplementedError(
            f"not ported yet{what}: a 'model' mesh axis, tensor or sequence "
            "parallelism (ROADMAP queue A item A6b)"
        )


def _in_group(mesh: Mesh | None) -> bool:
    return mesh is not None and mesh.distributed


def shard_batch(x, mesh: Mesh | None):
    """This rank's rows of a global batch (all of it without a group)."""
    if not _in_group(mesh):
        return x
    if x.shape[0] % mesh.world:
        raise ValueError(
            f"global batch {x.shape[0]} is not divisible by the world size "
            f"{mesh.world}"
        )
    b = x.shape[0] // mesh.world
    return x[mesh.rank * b:(mesh.rank + 1) * b]


@torch.no_grad()
def replicate(module: torch.nn.Module, mesh: Mesh | None) -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from rank 0."""
    if _in_group(mesh):
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)
    return module


@torch.no_grad()
def all_reduce_mean_(tensors, mesh: Mesh | None) -> None:
    """Average ``tensors`` across ranks in place, summed in float32 (in
    buckets of at most 256 MB of copies)."""
    if not _in_group(mesh):
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
        dist.all_reduce(flat)
        flat.div_(mesh.world)
        parts = flat.split([t.numel() for t in bucket])
        torch._foreach_copy_(bucket, [p.view_as(t) for p, t in zip(parts, bucket)])
        start = stop


def global_mean(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The mean of a per-rank scalar over the ranks (``x`` without a group)."""
    if not _in_group(mesh):
        return x
    y = x.detach().float().clone()
    dist.all_reduce(y)
    return (y / mesh.world).to(x.dtype)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        # every rank's loss reads the sum: its gradient is the sum of theirs
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiable (``x`` without a
    group)."""
    return _AllReduceSum.apply(x) if _in_group(mesh) else x


def gather_rows(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along the first axis in rank order."""
    if not _in_group(mesh):
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.world)]
    dist.all_gather(parts, x)
    return torch.cat(parts)


def barrier(mesh: Mesh | None) -> None:
    if not _in_group(mesh):
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()
