"""Sampling captured as CUDA graphs and replayed: a loop's U-Net eval, or a
server's whole call.

Counterpart of the JAX package's compiled sampling program: its
``jax.jit`` of the pipeline (``cli/run_ldm_sampler.py``, the server's
warm-up compile), the ``lax.scan`` of every loop and the server's
``--aot_cache``.  Both kinds run through the store of
``ldm_tf2_tpu_torch/graphs.py`` (the machinery the train steps' graphs
share: keys, weights by address, cloned outputs, the pool, launch counts
off the graph's kernel nodes), this module's ``STORE``.

**The server's call** (``SamplingProgram``, the JAX server's one jitted
``pipeline(params, token_ids, key, guidance_scale)``): text encode, the
whole sampling loop (DeepCache's included) and the decode
(``cli/run_ldm_sampler.py::txt2img_body``) captured once per key at the
server's warm-up, every later call of the key one replay.  Its static
inputs are the token ids [2B, L] and the per-slot guidance [B, 1, 1, 1];
its draws (the initial latent, the per-step noise at eta > 0) come from
one generator of its own, registered with the graph and seeded with the
call's seed on the host before each replay, so a call draws what a fresh
``torch.Generator(device).manual_seed(seed)`` draws; its outputs, the
images and x0, are cloned out.  Everything the body needs from the host
is a Python number baked into the capture (the schedule's coefficients)
or a static input.

**DDPM's call is a run of steps, replayed in turn**, as the JAX server
compiles one ``lax.scan`` body: a whole-call graph of its T U-Net evals
would hold millions of kernel nodes.  Its graphs: the text encode and the
initial draw (which also sets a device step counter to 0); **one graph of
``DDPM_RUN_STEPS`` steps**, replayed ``T // DDPM_RUN_STEPS`` times, each
step reading its coefficients (in x's dtype) and U-Net timesteps from
device tables at the counter and advancing it (``sampler.ddpm_run``);
a graph of the remaining ``T % DDPM_RUN_STEPS`` steps, where there are
any (``sampler.ddpm_runs``); and the decode.  All register the one
generator, so each replay advances it by what its steps draw and the
call draws what the eager loop draws (every step draws, the t = 0 one
multiplied by 0, as in JAX).  Each graph's key is the call's plus its part
(and a run's length), so each replay counts its own graph's nodes and a
call counts what the eager call counts.  ``SamplingProgram.last_graphs``
says which graphs the last call ran and how often.  Its key: the program, the schedule (its betas,
``num_ddim_steps``, eta, ``v_posterior``, spacing), the latent shape, the
call's settings (sampler, ``guidance_rescale``, ``scale_factor``,
``cache_interval``, ``cache_levels``), the inputs' shapes, dtypes and
device, the autoencoder's type, the text encoder's and the autoencoder's
compute dtypes, the autoencoder's int8-P.V mode and ``modes(unet)``.  A
replaced or updated tensor of any of the three models drops the
program's captures.

**A loop's U-Net eval** (``graphed_eps_model(unet)``, the sampler CLI's):
``(x2 [2B, h, w, c], t [2B], context [2B, S, D]) -> eps``, and the
DeepCache variants of the U-Net's own signature (``return_cache=True`` ->
``(eps, cache)``, ``shallow_cache=cache``, ``cache_levels``), captured
once per shape key at a call's first eval, every later eval with that key
a replay; the loops themselves stay Python (``diffusion/sampler.py``,
``diffusion/solvers.py``) and call the graphed model as they call the
U-Net; the text encode and the decode run eagerly.  ``eps_model_for``
picks it or the eager U-Net for a sampling call.

**An eval's key** is everything that changes the captured work: the
U-Net's identity and compute dtype, the variant and ``cache_levels``, every
input's shape, dtype and device, and the modes in force (``unet``'s int8
serving modes, and the process's ``switches``: ``tpu.attention_impl``,
the opt-in switches of ``ops.group_norm``, ``ops.fused_conv`` and
``ops.attention``, the TF32 flags, cuDNN's benchmark and deterministic
flags).  A key already captured replays; a new key captures.

**Weights are read by address.**  A graph holds the addresses of the
models' parameters and buffers (the int8 weights ``set_serving_modes``
derives among them) and of the copies derived from them on the way (the
fused conv's relaid weights, ``ops.fused_conv.relaid_weight``; the
GroupNorm statistics workspace), and keeps those copies alive.  So a U-Net
whose tensors were replaced, or updated in place, since a capture has
every capture of it **dropped**, never replayed: the next eval captures
anew.  For an eval the full check (every tensor's identity, address and
version) runs when ``graphed_eps_model`` is called, once a sampling call;
every eval checks the versions of the tensors it found then; a program
makes the full check at every call.  An inference tensor (one made under
``torch.inference_mode``) has no version, so only its replacement is seen:
update such a weight by replacing it.  A graphed train step bumps the
versions of what it updates, so a sampling call after it captures anew.

**Outputs** are cloned out of the graph after each replay, so a later
replay never overwrites what a loop keeps (PLMS's eps history,
DPM-Solver++(2M)'s ``x0_last``, DeepCache's cache).  The first call of a
key runs eagerly (counted as an eager call), then the same call is
captured under ``torch.inference_mode``.

On the CPU there is no graph: ``eps_model_for`` returns the U-Net itself,
and the server runs its calls eagerly.  Nor on a mesh of more than one
rank (tensor, sequence or data parallelism over ``torch.distributed``):
those calls run eagerly.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from ldm_tf2_tpu_torch.graphs import (
    GraphStore, Session, graphs_apply, module_tensors, stamp, switches,
)


def modes(unet) -> tuple:
    """The modes in force that change a U-Net eval's captured work: its
    compute dtype and int8 serving modes, and the ``switches``."""
    return (unet.dtype, unet.conv_quant, unet.attention_pv_int8) + switches()


STORE = GraphStore()


class GraphedEps:
    """A U-Net's evals through ``store`` (``graphed_eps_model``)."""

    def __init__(self, unet, store: GraphStore):
        self.unet, self.store = unet, store
        self._tensors = module_tensors(unet)
        self._session = Session(unet)
        store.check_weights(unet, stamp(self._tensors))
        self._tracked = [t for t in self._tensors if not t.is_inference()]
        self._versions = [t._version for t in self._tracked]

    def _check_versions(self) -> None:
        versions = [t._version for t in self._tracked]
        if versions != self._versions:
            self.store.check_weights(self.unet, stamp(self._tensors))
            self._versions = versions

    def key(self, x, t, context, *, return_cache: bool = False, shallow_cache=None,
            cache_levels: int = 1) -> tuple:
        """The key of a capture of this eval (the module docstring)."""
        shallow = shallow_cache is not None
        variant = "shallow" if shallow else "cache" if return_cache else "full"
        inputs = (x, t, context) + ((shallow_cache,) if shallow else ())
        return (id(self.unet), variant, None if variant == "full" else int(cache_levels),
                tuple((tuple(v.shape), v.dtype, v.device) for v in inputs), modes(self.unet))

    def __call__(self, x, t, context, *, return_cache: bool = False,
                 shallow_cache=None, cache_levels: int = 1):
        unet = self.unet
        self._check_versions()
        inputs = (x, t, context) + (() if shallow_cache is None else (shallow_cache,))
        key = self.key(x, t, context, return_cache=return_cache, shallow_cache=shallow_cache,
                       cache_levels=cache_levels)

        def fn(x, t, context, cache=None):
            out = unet(x, t, context, return_cache=return_cache, shallow_cache=cache,
                       cache_levels=cache_levels)
            return out if return_cache else (out,)

        with torch.inference_mode():
            out = self.store.run(key, fn, inputs, self._session)
        return out if return_cache else out[0]


def graphed_eps_model(unet, store: GraphStore | None = None) -> GraphedEps:
    """``unet``'s evals captured and replayed through ``store`` (the
    process's ``STORE`` when None): a drop-in for the U-Net in the sampling
    loops, DeepCache's calls included.  Checks ``unet``'s tensors against
    its captures first (the module docstring)."""
    return GraphedEps(unet, STORE if store is None else store)


def eps_model_for(unet, device, graphs: bool = True):
    """The model a sampling call hands its loop: ``graphed_eps_model(unet)``
    where ``graphs`` and ``graphs_apply(device)``, else ``unet`` itself."""
    if graphs and graphs_apply(device):
        return graphed_eps_model(unet)
    return unet


def schedule_key(schedule) -> tuple:
    """What of a ``DiffusionSchedule`` a sampling call's capture bakes in:
    its betas (by digest), ``num_ddim_steps``, eta, ``v_posterior`` and
    spacing, from which every table the loops read is made."""
    betas = hashlib.sha1(np.ascontiguousarray(schedule.betas).tobytes()).hexdigest()
    return (betas, schedule.num_ddim_steps, float(schedule.eta),
            float(schedule.v_posterior), schedule.timestep_spacing)


class ProgramSession(Session):
    """A server call's capture: the generator its draws come from,
    registered with the graph and seeded on the host before each replay
    (``seed``), the three models' derived copies, and DDPM's device tables
    (``tables``), kept alive."""

    def __init__(self, models, device):
        super().__init__(*models)
        self.generator = torch.Generator(device=device)
        self.tables = None

    def seed(self, seed: int) -> None:
        """Set the generator for a call of ``seed``: it then draws what a
        fresh generator seeded so draws."""
        self.generator.manual_seed(int(seed))

    def prepare(self, runner) -> None:
        """Between the warm-up and the capture: the generator registered
        with the graph, and the warm-up's cached blocks handed back to the
        card, since the capture allocates from the store's pool."""
        runner.register_generators([self.generator])
        if self.generator.device.type == "cuda":
            torch.cuda.empty_cache()


# DDPM steps a server's run graph holds (the module docstring): the
# smallest of 25, 50 and 100 whose replays come within 1% of the largest's
# on the card (`program_probe.py`; PERF.md: at T = 1000, bf16, batch 4 on an
# H100, 65,050 kernel nodes a run graph, a replayed call 14.74 s)
DDPM_RUN_STEPS = 25


class SamplingProgram:
    """A server's call through ``store`` (``graphed_program``): ``(schedule,
    token_ids [2B, L], guidance [B, 1, 1, 1], shape, seed, **settings) ->
    (images, x0)``, the text encode, the loop and the decode captured as
    one graph per key, DDPM's as a run of steps replayed in turn (the module
    docstring).  ``settings``: the sampling keywords of
    ``cli/run_ldm_sampler.py::txt2img_body`` (``sampler``,
    ``guidance_rescale``, ``scale_factor``, ``cache_interval``,
    ``cache_levels``).  ``last_key``: the key of the last call;
    ``last_graphs``: {store key: replays} of the graphs it ran (captures
    included), in order."""

    def __init__(self, models, store: GraphStore):
        self.models, self.store = tuple(models), store
        self.last_key = None
        self.last_graphs: dict = {}

    def key(self, schedule, token_ids, guidance, shape, **settings) -> tuple:
        """The key of a capture of this call (the module docstring)."""
        cond, unet, ae = self.models
        inputs = tuple((tuple(v.shape), v.dtype, v.device) for v in (token_ids, guidance))
        return (id(self), schedule_key(schedule), tuple(shape),
                tuple(sorted(settings.items())), inputs, type(ae).__name__, cond.dtype,
                ae.dtype, ae.attention_pv_int8, modes(unet))

    def __call__(self, schedule, token_ids, guidance, shape, seed, **settings):
        from ldm_tf2_tpu_torch.cli.run_ldm_sampler import txt2img_body

        store = self.store
        store.check_weights(self, stamp(module_tensors(*self.models)))
        key = self.last_key = self.key(schedule, token_ids, guidance, shape, **settings)
        ddpm = settings.get("sampler") == "ddpm"
        first = key + ("encode",) if ddpm else key
        session = store.session(first) or ProgramSession(self.models, token_ids.device)
        session.seed(seed)
        self.last_graphs = {}
        with torch.inference_mode():
            if ddpm:
                return self._ddpm(key, session, schedule, token_ids, guidance, shape,
                                  **settings)

            def fn(ids, g):
                return txt2img_body(*self.models, schedule, ids, session.generator, g, shape,
                                    **settings)

            return self._run(key, fn, (token_ids, guidance), session)

    def call_nodes(self) -> int | None:
        """The kernel nodes the last call launched: each of its graphs'
        nodes times its replays (None for a stand-in's)."""
        held = [(self.store.kernels(k), n) for k, n in self.last_graphs.items()]
        if any(nodes is None for nodes, _ in held):
            return None
        return sum(sum(nodes.values()) * n for nodes, n in held)

    def _run(self, key, fn, inputs, session):
        self.last_graphs[key] = self.last_graphs.get(key, 0) + 1
        return self.store.run(key, fn, inputs, session)

    def _ddpm(self, key, session, schedule, token_ids, guidance, shape, *, sampler,
              guidance_rescale=0.0, scale_factor=0.18215, **_):
        """DDPM's call as its graphs (the module docstring): the encode and
        initial draw, the runs of ``DDPM_RUN_STEPS`` steps and the
        remainder's, the decode."""
        from ldm_tf2_tpu_torch.cli.run_ldm_sampler import decode_latents
        from ldm_tf2_tpu_torch.diffusion import sampler as loops

        cond, unet, ae = self.models
        gen = session.generator

        def encode(ids):
            context = cond(ids)
            step = torch.zeros(1, dtype=torch.long, device=ids.device)
            return context, loops._initial(context, shape, gen, None), step

        context, xt, step = self._run(key + ("encode",), encode, (token_ids,), session)
        if session.tables is None:  # read by address: the session keeps them
            session.tables = loops.ddpm_device_tables(schedule, xt.dtype, xt.device)
        tables = session.tables
        for _, steps in loops.ddpm_runs(schedule.num_steps, DDPM_RUN_STEPS):
            def run(x, c, g, n, steps=steps):
                return loops.ddpm_run(unet, tables, x, c, n, steps, gen, g,
                                      guidance_rescale=guidance_rescale)

            xt, step = self._run(key + ("run", steps), run, (xt, context, guidance, step),
                                 session)
        (images,) = self._run(key + ("decode",),
                              lambda x: (decode_latents(ae, x / scale_factor),), (xt,),
                              session)
        return images, xt


def graphed_program(models, store: GraphStore | None = None) -> SamplingProgram:
    """A server's calls on ``models`` (text encoder, U-Net, autoencoder)
    captured and replayed whole through ``store`` (the process's ``STORE``
    when None)."""
    return SamplingProgram(models, STORE if store is None else store)
