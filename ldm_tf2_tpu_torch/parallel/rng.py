"""Random draws of the port that a data-parallel rank shares with the
global batch, and that a recomputed segment replays.

Every draw of a train step or a sampling call goes through ``rand``,
``randn`` or ``randint`` here, with a ``torch.Generator`` or a ``RowSlice``:

* a ``torch.Generator`` (or None, the default generator) draws exactly as
  ``torch.rand``/``torch.randn``/``torch.randint`` do;
* a ``RowSlice(generator, rank, world)`` draws the tensor of the global
  batch, ``world`` times the rows asked for, and keeps rows ``[rank * b,
  (rank + 1) * b)``.  So rank r of a data-parallel run sees the rows an
  unbroken one-process run at the global batch would give its slice, every
  dropout mask included; at world 1 the draws are those of the generator;
* ``block=(dim, index, size)`` (tensor parallelism: an activation that
  holds one rank's block of an axis) draws ``size`` times the asked-for
  extent along ``dim`` and keeps block ``index``, so a rank's mask is its
  block of one process's and the generator ends where one process's does.
  With a ``RowSlice`` both slicings apply: the global draw, then the rows,
  then the block.

``fork`` and ``advance`` are the replay of ``models/remat.py``: a segment
draws from a private generator set to its entry state, and the recompute
builds a fresh one from the same state.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class RowSlice:
    """This rank's rows of each draw of ``generator`` at the global batch:
    draws are taken at ``world`` times the asked-for batch (the first
    dimension) and rows ``[rank * b, (rank + 1) * b)`` kept."""

    generator: torch.Generator
    rank: int
    world: int

    def rows(self, full):
        """Rows ``[rank * b, (rank + 1) * b)`` of a global-batch tensor of
        ``world * b`` rows."""
        b = full.shape[0] // self.world
        return full[self.rank * b:(self.rank + 1) * b]


def _parts(generator):
    if isinstance(generator, RowSlice):
        return generator.generator, generator.rank, generator.world
    return generator, 0, 1


def _draw(fn, shape, generator, block=None, **kw):
    gen, rank, world = _parts(generator)
    shape = list(shape)
    if block is not None:
        dim, index, size = block
        extent = shape[dim]
        shape[dim] = size * extent
    b = shape[0]
    if isinstance(generator, RowSlice):
        shape[0] = world * b
    full = fn(tuple(shape), generator=gen, **kw)
    if isinstance(generator, RowSlice):
        full = full[rank * b:(rank + 1) * b]
    if block is not None:
        full = full.narrow(dim, index * extent, extent)
    return full


def rand(shape, generator, *, device, dtype=None, block=None):
    """U[0, 1) of ``shape`` (this rank's rows under a ``RowSlice``, its
    block under ``block``)."""
    return _draw(torch.rand, shape, generator, block, device=device, dtype=dtype)


def randn(shape, generator, *, device, dtype=None):
    """N(0, 1) of ``shape`` (this rank's rows under a ``RowSlice``)."""
    return _draw(torch.randn, shape, generator, device=device, dtype=dtype)


def randint(high: int, shape, generator, *, device):
    """Integers in [0, high) of ``shape`` (this rank's rows under a
    ``RowSlice``)."""
    return _draw(lambda s, **kw: torch.randint(0, high, s, **kw), shape, generator,
                 device=device)


def fork(generator, state: torch.Tensor):
    """A fresh generator of ``generator``'s kind (its device, its rows) set
    to ``state``."""
    gen, rank, world = _parts(generator)
    private = torch.Generator(device=gen.device)
    private.set_state(state)
    return RowSlice(private, rank, world) if isinstance(generator, RowSlice) else private


def state_of(generator) -> torch.Tensor:
    return _parts(generator)[0].get_state()


def advance(generator, state: torch.Tensor) -> None:
    """Set ``generator`` to ``state`` (where a private fork ended)."""
    _parts(generator)[0].set_state(state)
