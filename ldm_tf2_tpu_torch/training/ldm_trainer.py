"""Stage-2 training: the text-conditioned epsilon-prediction U-Net on frozen
autoencoder latents (counterpart of ``ldm_tf2_tpu.training.ldm_trainer``).

One train step: encode the images with the frozen autoencoder (no grad)
and sample its posterior (the VQ autoencoder: take its encoder's latents
before quantization, as the JAX package does), drop the caption to the null condition per
example, encode the text (frozen, no grad, unless ``train_cond_model``),
noise the latents at per-example timesteps, predict the noise with the
U-Net in training mode (dropout), take the per-example spatial mean of the
squared error and then the batch mean, backpropagate through the U-Net's
kernels, and apply AdamW, then the EMA.

Semantics kept from the JAX step and optax 0.2.6, not PyTorch's:

* ``make_optimizer`` is ``optax.adamw`` (optionally after
  ``clip_by_global_norm``, inside ``MultiSteps``), written as plain tensor
  functions: the update is ``-lr * (adam + wd * p)``; the first moment is
  updated in float32 from the stored one, the update uses that float32
  moment, and only then is it stored in ``mu_dtype``; the learning rate is
  read at the count before the increment (so a warm-up's first update
  uses lr(0) = 0), and ``decay_steps`` counts the warm-up; clipping keeps
  ``g`` when the global norm is below the limit, else ``g / norm * max``
  (no epsilon), a select on the device; ``MultiSteps`` keeps the running
  mean of the micro-batch gradients, and the inner count, its schedule and
  the EMA advance only on the sync steps.
* The draws of a step (timesteps, posterior noise, condition drop mask,
  noise, dropout) come from generators seeded from ``(seed, step)`` alone,
  as the JAX step folds the step into its key, so a resumed run draws what
  an unbroken one would.  A step also takes any of them injected
  (``draws``), which is how the tests hand both frameworks the same ones.
* Noise is drawn in the latents' dtype, the loss is computed in the
  prediction's dtype, and the frozen models carry no gradient state.

``remat_unet`` (``tpu.remat``) recomputes the U-Net forward in the
backward pass with its dropout draws replayed (``models/remat.py``), and
``mesh`` makes the step one rank's share of a data-parallel step, and of a
tensor-parallel one on models sharded over its ``model`` axis
(``make_ldm_train_step``).

A step is a ``StepProgram``: the host's part (which program the step runs,
the optimizer's scalars for this update, the step's generator seeds, the
counters that advance after it) around a device part, ``body``, that reads
no host state that changes from step to step and syncs nothing, so that
``training/graphs.py`` can capture it once as a CUDA graph and replay it.
The optimizer's learning rate and bias corrections are worked out on the
host and read from a device tensor (``AdamW.hyper``), on the eager path
too, so that the two paths compute the same bits.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ldm_tf2_tpu_torch.diffusion.losses import q_sample
from ldm_tf2_tpu_torch.graphs import module_tensors
from ldm_tf2_tpu_torch.models import AutoencoderVQ, remat
from ldm_tf2_tpu_torch.ops import tp as _tp
from ldm_tf2_tpu_torch.parallel import RowSlice, all_reduce_mean_, global_mean, rng

# Tensors per multi-tensor op in the optimizer: bounds its temporaries to a
# slice of the parameters.
_CHUNK = 64
# The scalars of one AdamW update (``AdamW.hyper``)
HYPER = 4


def device_scalars(values, device) -> torch.Tensor:
    """float32 ``values`` (host numbers) as a tensor on ``device``, copied
    from pinned memory without a sync."""
    host = torch.as_tensor(np.asarray(values, np.float32))
    if torch.device(device).type != "cuda":
        return host
    return host.pin_memory().to(device, non_blocking=True)


def _mu_dtype(name):
    if name not in (None, "float32", "bfloat16"):
        raise ValueError(f"mu_dtype must be null|float32|bfloat16, got {name!r}")
    return torch.bfloat16 if name == "bfloat16" else None


class AdamW:
    """``optax.adamw`` with the JAX package's additive options (warm-up,
    cosine decay, global-norm clipping, bf16 first moment, gradient
    accumulation), applied in place to a dict of parameters.  The state is
    a dict of tensors and ints, so it checkpoints with ``torch.save``."""

    def __init__(self, learning_rate: float = 5e-5, beta_1: float = 0.9,
                 beta_2: float = 0.999, epsilon: float = 1e-8,
                 weight_decay: float = 0.01, warmup_steps: int = 0,
                 decay_steps: int | None = None,
                 end_learning_rate_factor: float = 0.1,
                 clip_grad_norm: float | None = None,
                 mu_dtype: str | None = None, accum_steps: int = 1):
        if not isinstance(accum_steps, int) or accum_steps < 1:
            raise ValueError(f"accum_steps must be an int >= 1, got {accum_steps!r}")
        if decay_steps and decay_steps <= warmup_steps:
            raise ValueError(
                f"decay_steps ({decay_steps}) must exceed warmup_steps "
                f"({warmup_steps}): it counts the warm-up"
            )
        self.lr, self.b1, self.b2, self.eps = learning_rate, beta_1, beta_2, epsilon
        self.weight_decay = weight_decay
        self.warmup_steps, self.decay_steps = warmup_steps, decay_steps
        self.end_factor = end_learning_rate_factor
        self.clip = clip_grad_norm
        self.mu_dtype = _mu_dtype(mu_dtype)
        self.accum_steps = accum_steps

    def learning_rate(self, count: int) -> float:
        """The schedule at ``count`` inner updates: optax's
        ``warmup_cosine_decay_schedule`` when ``decay_steps`` is set, a
        linear warm-up joined to the constant rate when only
        ``warmup_steps`` is, else the constant rate."""
        lr, w = self.lr, self.warmup_steps
        if w and count < w:
            frac = 1.0 - count / w
            return -lr * frac + lr
        if not self.decay_steps:
            return lr
        span = self.decay_steps - w
        c = min(count - w, span)
        alpha = self.end_factor
        return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / span)) + alpha)

    def init(self, params: dict) -> dict:
        state = {
            "count": 0,
            "mu": {n: torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                   for n, p in params.items()},
            "nu": {n: torch.zeros_like(p) for n, p in params.items()},
        }
        if self.accum_steps > 1:
            state["mini_step"] = 0
            state["acc"] = {n: torch.zeros_like(p) for n, p in params.items()}
        return state

    def syncs(self, state: dict) -> bool:
        """Whether the next ``step_`` on ``state`` moves the parameters (not
        a micro-step of gradient accumulation)."""
        return self.accum_steps == 1 or state["mini_step"] == self.accum_steps - 1

    def hyper(self, state: dict) -> np.ndarray:
        """The host's scalars of the next ``step_`` on ``state``, float32:
        -lr at the count before the increment, the bias corrections
        ``1 - b ** (count + 1)`` and the accumulation's divisor
        ``mini_step + 1``."""
        count = state["count"]
        count_inc = np.float32(count + 1)
        return np.array([-self.learning_rate(count),
                         np.float32(1) - np.power(np.float32(self.b1), count_inc),
                         np.float32(1) - np.power(np.float32(self.b2), count_inc),
                         state.get("mini_step", 0) + 1], np.float32)

    def advance(self, state: dict) -> None:
        """Advance the host counters of ``state`` past one ``step_``."""
        if not self.syncs(state):
            state["mini_step"] += 1
            return
        state["count"] += 1
        if self.accum_steps > 1:
            state["mini_step"] = 0

    @torch.no_grad()
    def step_(self, params: dict, grads: dict, state: dict, hyper: torch.Tensor,
              reduce=None, global_norm=None) -> bool:
        """Fold ``grads`` into ``state`` and update ``params`` in place.
        Returns whether the parameters moved (False on the micro-steps of
        gradient accumulation).  ``reduce`` (a data-parallel run's
        ``all_reduce_mean_``) averages, in place, the gradients the update
        uses, before the clip: under accumulation the micro-steps' running
        mean, on the sync step only (the mean is linear).  ``global_norm``
        (a tensor-parallel run's ``ops.tp.global_norm``) takes the list of
        gradients to the clip's norm, else the norm over the list.

        ``hyper``: ``self.hyper(state)`` on the parameters' device.  The
        caller advances the host counters (``advance``); nothing here reads
        the device back.  ``grads`` are left as the data mean made them: the
        clip scales a chunk of them at a time into a temporary."""
        neg_lr, bc1, bc2, n_acc = hyper.unbind()
        names = list(params)
        g = [grads[n] for n in names]
        if self.accum_steps > 1:
            acc = [state["acc"][n] for n in names]
            for i in range(0, len(names), _CHUNK):
                diff = torch._foreach_sub(g[i:i + _CHUNK], acc[i:i + _CHUNK])
                torch._foreach_div_(diff, n_acc)
                torch._foreach_add_(acc[i:i + _CHUNK], diff)
            if not self.syncs(state):
                return False
            g = acc
        if reduce is not None:
            reduce(g)
        if self.clip:
            norm = (global_norm(g) if global_norm is not None else
                    torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g))))
            # optax's select: g where norm < clip, else g / norm * clip; as
            # g / 1 * 1 (exact) or g / norm * clip, without reading norm back
            keep = norm < self.clip
            one = torch.ones_like(norm)
            div, mul = torch.where(keep, one, norm), torch.where(
                keep, one, torch.full_like(norm, self.clip))
        for i in range(0, len(names), _CHUNK):
            chunk = names[i:i + _CHUNK]
            p = [params[n] for n in chunk]
            gc = g[i:i + _CHUNK]
            if self.clip:
                gc = torch._foreach_div(gc, div)
                torch._foreach_mul_(gc, mul)
            mu = [state["mu"][n] for n in chunk]
            nu = [state["nu"][n] for n in chunk]
            # (1 - b1) g + b1 mu, the product b1 mu taken in mu's dtype
            m_new = torch._foreach_mul(gc, 1 - self.b1)
            torch._foreach_add_(m_new, [x.float() for x in torch._foreach_mul(mu, self.b1)])
            v_new = torch._foreach_mul(gc, gc)
            torch._foreach_mul_(v_new, 1 - self.b2)
            torch._foreach_add_(v_new, torch._foreach_mul(nu, self.b2))
            upd = torch._foreach_div(m_new, bc1)
            den = torch._foreach_div(v_new, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self.eps)
            torch._foreach_div_(upd, den)
            if self.weight_decay:
                torch._foreach_add_(upd, p, alpha=self.weight_decay)
            torch._foreach_mul_(upd, neg_lr)
            torch._foreach_add_(p, upd)
            torch._foreach_copy_(mu, m_new)
            torch._foreach_copy_(nu, v_new)
        if self.accum_steps > 1:  # the running mean starts anew
            for i in range(0, len(names), _CHUNK):
                torch._foreach_zero_(acc[i:i + _CHUNK])
        return True


# The JAX package's name: its keywords are the ``latent_diffusion_optimizer``
# section, plus ``accum_steps`` from ``ldm_training.grad_accum_steps``.
make_optimizer = AdamW


@dataclasses.dataclass
class LDMTrainState:
    """What a step carries besides the models' own parameters: the step
    count, the optimizer state and the EMA of the trainable parameters
    (None without ``ema_decay``)."""

    step: int
    opt_state: dict
    ema: dict | None = None


def trainable_params(unet, cond_model=None) -> dict:
    """{"unet.<name>": parameter} (and "cond.<name>" when the condition
    model trains): the tensors the optimizer updates in place."""
    params = {f"unet.{n}": p for n, p in unet.named_parameters()}
    if cond_model is not None:
        params.update({f"cond.{n}": p for n, p in cond_model.named_parameters()})
    return params


def init_ldm_train_state(unet, cond_model, optimizer: AdamW,
                         train_cond_model: bool = False,
                         ema_decay: float | None = None) -> LDMTrainState:
    params = trainable_params(unet, cond_model if train_cond_model else None)
    ema = ({n: p.detach().clone() for n, p in params.items()}
           if ema_decay is not None else None)
    return LDMTrainState(step=0, opt_state=optimizer.init(params), ema=ema)


def step_seeds(seed: int, step: int, count: int) -> list[int]:
    """The seeds of ``step_generators``."""
    return [int(s) for s in np.random.SeedSequence([seed, step]).generate_state(count)]


def step_generators(seed: int, step: int, device, count: int = 5) -> list[torch.Generator]:
    """``count`` generators seeded from ``(seed, step)`` alone; a train step
    of this module takes five (timesteps, posterior noise, condition drop,
    noise, dropout)."""
    return [torch.Generator(device=device).manual_seed(s)
            for s in step_seeds(seed, step, count)]


def opt_tensors(opt_state: dict) -> list:
    """The tensors of an ``AdamW`` state (both moments, the accumulator)."""
    return [t for part in opt_state.values() if isinstance(part, dict)
            for t in part.values()]


@dataclasses.dataclass(eq=False)
class StepProgram:
    """A train step, ``step(state, *inputs, draws=None) -> (state,
    metrics)`` (``inputs``: that many tensors, then ``draws`` by position or
    by name), split where the host's work meets the device's:

    * ``phase(state)``: which program this step runs (the accumulation's
      micro-step or sync step), read on the host;
    * ``hyper(state)``: the optimizers' host scalars for this update
      (float32, ``AdamW.hyper``), which ``body`` reads from a device tensor;
    * ``body(state, generators, hyper, phase, *inputs, draws=None)``: the
      device work, drawing from the ``generators`` of ``step_seeds(seed,
      state.step, generators)``; it updates the state's tensors in place,
      reads no host value that changes from step to step (but ``phase``'s)
      and returns a tuple of tensors;
    * ``finish(state, phase, outputs)``: the host counters advanced, and
      the metrics {name: 0-dim tensor} of ``outputs``.

    ``tensors(state)`` is every tensor the body reads or writes by address
    (the models' and the state's), ``written(state)`` those it updates in
    place, and ``key`` what else fixes the body's work."""

    body: object
    phase: object
    hyper: object
    finish: object
    tensors: object
    written: object
    key: tuple
    seed: int
    device: torch.device
    generators: int
    inputs: int

    def arguments(self, args, draws):
        """A step's (inputs, draws) from its positional arguments."""
        if len(args) not in (self.inputs, self.inputs + 1):
            raise TypeError(f"a train step takes {self.inputs} inputs and draws, "
                            f"got {len(args)} arguments")
        return args[:self.inputs], args[self.inputs] if len(args) > self.inputs else draws

    def __call__(self, state, *args, draws=None):
        """The step, eagerly."""
        inputs, draws = self.arguments(args, draws)
        phase = self.phase(state)
        hyper = device_scalars(self.hyper(state), self.device)
        gens = step_generators(self.seed, state.step, self.device, self.generators)
        outputs = self.body(state, gens, hyper, phase, *inputs, draws=draws)
        return state, self.finish(state, phase, outputs)



def make_ldm_train_step(unet, cond_model, autoencoder, schedule,
                        optimizer: AdamW, *, scale_factor: float = 0.18215,
                        condition_dropout_rate: float = 0.1,
                        train_cond_model: bool = False, null_token_ids=None,
                        remat_unet=False, ema_decay: float | None = None,
                        encode_chunks: int = 1, seed: int = 0, mesh=None):
    """Build ``train_step(state, images, token_ids, draws=None) -> (state,
    {"loss": tensor})``, a ``StepProgram``.

    images [B, H, W, 3] and token_ids [B, L] on the models' device.
    ``draws`` may inject any of: ``t`` [B] int64, ``posterior_noise`` (the
    latents' shape), ``drop`` [B] bool, ``noise`` (the latents' shape);
    the rest are drawn from ``step_generators(seed, state.step)``.
    ``encode_chunks`` encodes the batch in that many sub-batches, one after
    the other, each sampling its share of the posterior noise.
    ``remat_unet`` (``tpu.remat``: False, True, "full", "blocks", "dots";
    ``models/remat.py``) recomputes the U-Net forward in the backward
    pass, its dropout draws replayed: memory, not math, changes.

    ``mesh`` (a ``parallel.Mesh`` in a process group) makes the step one
    rank's share of a data-parallel step: the batch is this rank's rows of
    the global batch, every draw is this rank's rows of the global batch's
    draw (``parallel.RowSlice``; rows by the ``data`` coordinate), the
    gradients are averaged over the ``data`` axis (float32) before the
    clip, and the loss is the global mean, so the ranks' step equals one
    process's at the global batch.

    Tensor parallelism: on models sharded by
    ``parallel.sharding.shard_params_tp`` over the mesh's ``model`` axis,
    with ``ops.tp.enable_tensor_parallel(mesh)`` set, the step runs each
    rank's block of every sharded leaf (its gradient, moments and EMA are
    that block of one process's; model peers take the same rows and
    draws, the dropout on sharded activations their block of the mask),
    and the clip's norm is the norm over the whole leaves
    (``ops.tp.global_norm``)."""
    remat.check_policy(remat_unet)
    device = next(unet.parameters()).device
    in_group = mesh is not None and mesh.distributed
    rank, world = (mesh.data_index, mesh.data_size) if in_group else (0, 1)
    reduce = (lambda g: all_reduce_mean_(g, mesh)) if in_group else None
    sqrt_acp = torch.as_tensor(schedule.sqrt_alphas_cumprod, device=device)
    sqrt_1m_acp = torch.as_tensor(schedule.sqrt_one_minus_alphas_cumprod,
                                  device=device)
    null_ids = (None if null_token_ids is None
                else torch.as_tensor(null_token_ids, device=device))
    trained_cond = cond_model if train_cond_model else None
    vq = isinstance(autoencoder, AutoencoderVQ)

    @torch.no_grad()
    def encode(images, generator, noise):
        """The scaled latents; the KL posterior's noise is ``noise``, else
        the global batch's draw in ``encode_chunks`` chunks (the chunks of
        one process at the global batch), this rank's rows of it."""
        b = images.shape[0]
        if b % encode_chunks:
            raise ValueError(
                f"tpu.encode_chunks={encode_chunks} does not divide the batch "
                f"{b}; pick an encode_chunks that divides it, or 1"
            )
        n = b // encode_chunks
        chunks = [images[i * n:(i + 1) * n] for i in range(encode_chunks)]
        if vq:
            return scale_factor * torch.cat(
                [autoencoder.encode(c, only_encode=True) for c in chunks])
        posteriors = [autoencoder.encode(c) for c in chunks]
        if noise is None:
            mean = posteriors[0].mean
            part = (world * n,) + tuple(mean.shape[1:])
            noise = torch.cat([torch.randn(part, generator=generator, device=device,
                                           dtype=mean.dtype)
                               for _ in range(encode_chunks)])[rank * b:(rank + 1) * b]
        return scale_factor * torch.cat([
            p.sample(noise=noise[i * n:(i + 1) * n]) for i, p in enumerate(posteriors)])

    def unet_forward(generator, xt, t, context):
        if remat_unet == "blocks":
            return unet(xt, t, context, training=True, generator=generator,
                        remat_blocks=True)
        run = lambda g, xt, t, context: unet(xt, t, context, training=True, generator=g)
        if not remat_unet:
            return run(generator, xt, t, context)
        return remat.checkpoint(run, generator, xt, t, context,
                                context_fn=remat.dots_context
                                if remat_unet == "dots" else None)

    def body(state: LDMTrainState, gens, hyper, phase, images, token_ids, draws=None):
        draws = draws or {}
        if in_group:
            gens = [RowSlice(g, rank, world) for g in gens]
        batch = images.shape[0]
        t = draws.get("t")
        if t is None:
            t = rng.randint(schedule.num_steps, (batch,), gens[0], device=device)
        latents = encode(images, gens[1].generator if in_group else gens[1],
                         draws.get("posterior_noise"))
        if null_ids is not None and condition_dropout_rate > 0:
            drop = draws.get("drop")
            if drop is None:
                drop = rng.rand((batch,), gens[2], device=device) < condition_dropout_rate
            token_ids = torch.where(drop[:, None],
                                    null_ids[None].to(token_ids.dtype), token_ids)
        if train_cond_model:
            context = cond_model(token_ids, training=True, generator=gens[4])
        else:
            with torch.no_grad():
                context = cond_model(token_ids)
        noise = draws.get("noise")
        if noise is None:
            noise = rng.randn(latents.shape, gens[3], device=device, dtype=latents.dtype)
        noise = noise.to(latents.dtype)
        xt = q_sample(sqrt_acp, sqrt_1m_acp, latents, t, noise)
        eps = unet_forward(gens[4], xt, t.float(), context)
        loss = ((noise - eps) ** 2).mean(dim=(1, 2, 3)).mean()

        params = trainable_params(unet, trained_cond)
        grads = torch.autograd.grad(loss, list(params.values()))
        sharded = [getattr(p, "tp", None) is not None for p in params.values()]
        norm = (lambda g: _tp.global_norm(g, sharded)) if any(sharded) else None
        applied = optimizer.step_(params, dict(zip(params, grads)), state.opt_state,
                                  hyper, reduce, norm)
        if ema_decay is not None and applied:
            with torch.no_grad():
                ema = [state.ema[n] for n in params]
                torch._foreach_mul_(ema, ema_decay)
                torch._foreach_add_(ema, list(params.values()), alpha=1.0 - ema_decay)
        return (global_mean(loss.detach(), mesh),)

    def finish(state: LDMTrainState, phase, outputs):
        optimizer.advance(state.opt_state)
        state.step += 1
        return {"loss": outputs[0]}

    def state_tensors(state: LDMTrainState) -> list:
        return opt_tensors(state.opt_state) + list((state.ema or {}).values())

    modules = (unet, cond_model, autoencoder)
    return StepProgram(
        body=body, phase=lambda state: optimizer.syncs(state.opt_state),
        hyper=lambda state: optimizer.hyper(state.opt_state), finish=finish,
        tensors=lambda state: module_tensors(*modules) + state_tensors(state),
        written=lambda state: (list(trainable_params(unet, trained_cond).values())
                               + state_tensors(state)),
        key=("ldm", remat_unet, train_cond_model, bool(optimizer.clip), encode_chunks,
             unet.dtype, cond_model.dtype, autoencoder.dtype),
        seed=seed, device=device, generators=5, inputs=2)


def checkpoint_state(state: LDMTrainState, unet, cond_model=None,
                     seed: int = 0) -> dict:
    """What a checkpoint holds: the step, the U-Net's parameters (and the
    condition model's when it trains), the optimizer state, the EMA and the
    data seed."""
    return {
        "step": state.step, "seed": seed,
        "unet": unet.state_dict(),
        "cond": None if cond_model is None else cond_model.state_dict(),
        "opt_state": state.opt_state, "ema": state.ema,
    }


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def restore_state(saved: dict, unet, cond_model=None) -> LDMTrainState:
    """Load a ``checkpoint_state`` dict back into the models (in place) and
    return the train state, its tensors on the U-Net's device."""
    device = next(unet.parameters()).device
    unet.load_state_dict(saved["unet"])
    if cond_model is not None:
        cond_model.load_state_dict(saved["cond"])
    return LDMTrainState(step=int(saved["step"]),
                         opt_state=_to(saved["opt_state"], device),
                         ema=_to(saved["ema"], device))
