"""The train steps, each captured once as a CUDA graph and replayed.

Counterpart of the JAX trainers' ``jax.jit(train_step, donate_argnums=(0,))``
(the LDM step; the autoencoder's two steps): one compiled program per step.
Here a step's device part (``StepProgram.body``: the frozen encode, the
condition drop and text encode, ``q_sample``, the forward and backward
passes, the clip, AdamW, the EMA; or both autoencoder phases' forward and
backward passes, the adaptive weight, both Adams and D's BatchNorm
statistics) is captured once per key and replayed, so the host launches
one graph instead of the step's thousands of kernels.  Donation maps to
the graph updating the state's tensors in place at fixed addresses.

``graphed_train_step(step)`` wraps a ``StepProgram``; ``train_step_for``
picks it or the eager step for a trainer, on the rule sampling follows
(``graphs_apply``): graphs on one CUDA card in a process of world 1, eager
on the CPU and on a mesh of more than one rank.

**The machinery is shared** (``ldm_tf2_tpu_torch/graphs.py``): a
``GraphStore`` (this module's ``STORE``, a pool of its own), its
``CUDAGraphRunner``, its launch bookkeeping (``counts``, ``rise``,
``backed_rise``: a capture's counts read off its kernel nodes) and its
rule for the pool.  A train step's capture carries a ``StepSession``.

**A capture's key** is everything that changes the captured work: the
program (its models, compute dtypes, remat policy, ``train_cond_model``,
whether the clip is on, ``encode_chunks``; ``StepProgram.key``), the phase
(``StepProgram.phase``: the accumulation's micro-step or sync step), every
input's and injected draw's shape, dtype and device, and the process's
``switches``.

**The first step of a key runs eagerly** on a side stream, and is that
step: it builds the kernels and makes every plan.  The capture follows; it
runs nothing.  Every later step of the key copies its inputs into the
capture's static inputs and replays.  A capture or replay that fails
raises: there is no eager fallback on the card.

**The host's part stays on the host**, before and after each replay: the
optimizers' learning rate and bias corrections (``AdamW.hyper``, a static
input), the step's generator seeds, and the counters that advance
(``StepProgram.finish``: the optimizers' counts and ``mini_step``, the
step), which never advance during the capture.  Outputs (the loss and
metrics) are cloned out of the graph.

**Generators.**  A capture draws from one set of generators of its own,
registered with its graph; before each replay they are seeded from
``SeedSequence([seed, step])``, so every step draws what
``step_generators(seed, step)`` draws, and a resumed run stays bit-equal.
The remat segments' forks (``models/remat.py``) run under a
``parallel.rng.ForkPlan``: recorded in the warm-up as offsets into the
step's generators, replayed from registered generators that are seeded as
the step's own and set to those offsets before each replay.

**Weights by address.**  A graph reads and writes the state's tensors (the
models' parameters and buffers, both moments, the EMA, the accumulator) at
the addresses they had at its capture.  Each step checks every such
tensor's identity and address; where one was replaced (a restored
checkpoint builds new ones), the program's captures are dropped and the
next step captures anew.  After each replay the tensors the graph updated
get their versions bumped, so that version-keyed caches (the fused conv's
relaid weights, a sampling ``GraphedEps``) see the update.  Under the
opt-in switches the conv's weight relayout runs inside the capture
(``ops.fused_conv.relayout_inside``), so each replay relays the weights it
has just updated.
"""

from __future__ import annotations

import torch

from ldm_tf2_tpu_torch.graphs import GraphStore, Session, describe, graphs_apply, stamp, switches
from ldm_tf2_tpu_torch.ops import fused_conv
from ldm_tf2_tpu_torch.parallel import rng
from ldm_tf2_tpu_torch.training.ldm_trainer import StepProgram, device_scalars, step_seeds

STORE = GraphStore()


class StepSession(Session):
    """What one capture of a train step keeps besides its graph: its
    generators, its remat fork plan and the tensors it writes, whose
    versions each replay bumps.  The capture relays the conv weights inside
    it (``relayouts``)."""

    relayouts = True

    def __init__(self, program: StepProgram, written: list):
        super().__init__()
        self.device = program.device
        self.step_generators = [torch.Generator(device=self.device)
                                for _ in range(program.generators)]
        self.plan = rng.ForkPlan()
        self.written = written

    def seed(self, seeds) -> None:
        """Set the generators for a step: the step's own from its seeds, the
        fork plan's to their recorded states."""
        for gen, s in zip(self.step_generators, seeds):
            gen.manual_seed(s)
        self.plan.reset(seeds)

    def warmup(self, fn):
        def run(*static):
            with rng.recording(self.plan):
                return fn(*static)
        return run

    def prepare(self, runner) -> None:
        """Between the warm-up and the capture: the generators registered
        with the graph, and the warm-up's cached blocks handed back to the
        card, since the capture allocates from its own pool."""
        runner.register_generators(self.step_generators + self.plan.generators(self.device))
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def capture(self, fn):
        def run(*static):
            with rng.replaying(self.plan), fused_conv.relayout_inside():
                return fn(*static)
        return run

    def after_replay(self) -> None:
        """Bump the versions of what the graph updated, so that
        version-keyed caches and other captures see the change."""
        torch.autograd.graph.increment_version(self.written)


class GraphedTrainStep:
    """A ``StepProgram``'s steps through ``store`` (``graphed_train_step``):
    called as the program is, ``(state, *inputs, draws=None) -> (state,
    metrics)``."""

    def __init__(self, program: StepProgram, store: GraphStore):
        self.program, self.store = program, store

    def key(self, state, inputs, draws: dict) -> tuple:
        """The key of this step's capture (the module docstring)."""
        p = self.program
        shapes = lambda vs: tuple((tuple(v.shape), v.dtype, v.device) for v in vs)
        return (id(p), p.phase(state), p.key, shapes(inputs),
                tuple(draws), shapes(draws.values()), switches())

    def __call__(self, state, *args, draws=None):
        p, store = self.program, self.store
        inputs, draws = p.arguments(args, draws)
        draws = dict(sorted((draws or {}).items()))
        # by identity and address: the graph updates these tensors itself
        store.check_weights(p, stamp(p.tensors(state), versions=False))
        phase = p.phase(state)
        key = self.key(state, inputs, draws)
        session = store.session(key) or StepSession(p, p.written(state))
        session.seed(step_seeds(p.seed, state.step, p.generators))
        n = len(inputs)

        def fn(hyper, *static):
            given = dict(zip(draws, static[n:])) or None
            return p.body(state, session.step_generators, hyper, phase, *static[:n],
                          draws=given)

        hyper = device_scalars(p.hyper(state), p.device)
        outputs = store.run(key, fn, (hyper, *inputs, *draws.values()), session)
        return state, p.finish(state, phase, outputs)


def graphed_train_step(program: StepProgram, store: GraphStore | None = None):
    """``program``'s steps captured and replayed through ``store`` (this
    module's ``STORE`` when None): a drop-in for the step."""
    return GraphedTrainStep(program, STORE if store is None else store)


def train_step_for(program: StepProgram):
    """The step a trainer runs: ``graphed_train_step(program)`` where
    ``graphs_apply`` on the program's device, else the eager ``program``
    itself."""
    if graphs_apply(program.device):
        return graphed_train_step(program)
    return program


def describe_steps(device) -> str:
    """How a trainer's steps run, for its log."""
    return describe(device, what="train steps")

