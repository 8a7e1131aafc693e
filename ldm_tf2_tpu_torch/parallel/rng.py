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

A train step captured as a CUDA graph (``training/graphs.py``) can neither
read a CUDA generator's state nor build a generator inside the capture:
every generator it draws from is registered with the graph before the
capture, and set on the host before each replay.  So its forks run under a
``ForkPlan``: the step's eager warm-up records where each fork starts and
each advance lands, as (which of the step's generators, Philox offset), in
call order (``recording``); the capture hands the k-th fork the plan's
k-th generator, and the j-th advance makes the generator adopt the plan's
j-th (``replaying``); before each replay the plan seeds its generators as
the step's own and sets them to the recorded offsets (``ForkPlan.reset``).
The warm-up draws what every step of the same key draws, from the same
offsets, so the replayed draws are the eager ones.  A CPU generator (a
test's stand-in for a graph, which reruns the step) forks eagerly
throughout.  The plan is a module global while it is active: the
recompute's forks run on the autograd engine's thread.
"""

from __future__ import annotations

import contextlib
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


class ForkPlan:
    """The forks and advances of one captured train step on the card (the
    module docstring): where each starts or lands, and one generator for
    each, to be registered with the graph."""

    def __init__(self):
        self.seeds: list = []  # the step generators' seeds, for this step
        self.starts: list = []  # (step generator, offset) of each fork, in call order
        self.ends: list = []  # the same of each advance
        self.forks: list = []
        self.advances: list = []
        self._swapped: list = []  # (generator, its own state) of each adoption
        self._next = [0, 0]

    def generators(self, device) -> list:
        """The generators of the recorded forks and advances, made at the
        first call (after the warm-up) and set for this step."""
        if len(self.forks) != len(self.starts) or len(self.advances) != len(self.ends):
            self.forks = [torch.Generator(device=device) for _ in self.starts]
            self.advances = [torch.Generator(device=device) for _ in self.ends]
            self.reset(self.seeds)
        return self.forks + self.advances

    def reset(self, seeds) -> None:
        """Set the generators for a step whose generators have ``seeds``:
        each seeded as its step generator and moved to its offset."""
        self.seeds = list(seeds)
        for gen, (i, offset) in zip(self.forks + self.advances, self.starts + self.ends):
            gen.manual_seed(self.seeds[i])
            gen.set_offset(offset)
        self._next = [0, 0]

    def where(self, state: torch.Tensor) -> tuple:
        """A CUDA generator's ``state`` as (step generator, Philox offset)."""
        seed, offset = (int.from_bytes(bytes(state[i:i + 8].tolist()), "little")
                        for i in (0, 8))
        if seed not in self.seeds:
            raise RuntimeError("a captured train step forked a generator that is not "
                               "one of its step generators")
        return self.seeds.index(seed), offset

    def take(self, which: int):
        items = (self.forks, self.advances)[which]
        i = self._next[which]
        if i >= len(items):
            raise RuntimeError("a captured train step forked its generators more often "
                               "than its eager warm-up did")
        self._next[which] = i + 1
        return items[i]

    def adopt(self, gen, planned) -> None:
        """Make ``gen`` draw on from ``planned``'s registered state, which
        the capture tracks."""
        self._swapped.append((gen, gen.graphsafe_get_state()))
        gen.graphsafe_set_state(planned)

    def finish(self) -> None:
        """After a capture: every recorded fork and advance taken, and each
        adopting generator given its own state back."""
        for gen, own in reversed(self._swapped):
            gen.graphsafe_set_state(own)
        self._swapped.clear()
        if self._next != [len(self.forks), len(self.advances)]:
            raise RuntimeError("a captured train step forked its generators less often "
                               "than its eager warm-up did")


# (mode, plan) while a plan records ("record") or replays ("replay")
_PLAN: tuple | None = None


@contextlib.contextmanager
def _planned(mode: str, plan: ForkPlan):
    global _PLAN
    _PLAN = (mode, plan)
    try:
        yield plan
    finally:
        _PLAN = None


def recording(plan: ForkPlan):
    """Forks and advances of CUDA generators inside the block run as usual
    and are recorded."""
    return _planned("record", plan)


@contextlib.contextmanager
def replaying(plan: ForkPlan):
    """Forks and advances of CUDA generators inside the block take the
    plan's generators."""
    plan._next = [0, 0]
    with _planned("replay", plan):
        yield plan
    plan.finish()


def _plan_for(gen):
    """The active plan's (mode, plan) where ``gen`` is a CUDA generator."""
    return _PLAN if _PLAN is not None and gen.device.type == "cuda" else (None, None)


def fork(generator, state: torch.Tensor | None):
    """A fresh generator of ``generator``'s kind (its device, its rows) set
    to ``state``; under ``replaying``, the plan's next one."""
    gen, rank, world = _parts(generator)
    mode, plan = _plan_for(gen)
    if mode == "replay":
        private = plan.take(0)
    else:
        private = torch.Generator(device=gen.device)
        private.set_state(state)
        if mode == "record":
            plan.starts.append(plan.where(state))
    return RowSlice(private, rank, world) if isinstance(generator, RowSlice) else private


def state_of(generator) -> torch.Tensor | None:
    """``generator``'s state (None under ``replaying``: a capture cannot
    read it, and the plan holds it)."""
    gen = _parts(generator)[0]
    if _plan_for(gen)[0] == "replay":
        return None
    return gen.get_state()


def advance(generator, state: torch.Tensor | None) -> None:
    """Set ``generator`` to ``state`` (where a private fork ended); under
    ``replaying``, make it adopt the plan's next generator."""
    gen = _parts(generator)[0]
    mode, plan = _plan_for(gen)
    if mode == "replay":
        plan.adopt(gen, plan.take(1))
        return
    gen.set_state(state)
    if mode == "record":
        plan.ends.append(plan.where(state))
