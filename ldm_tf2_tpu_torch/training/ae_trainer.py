"""Stage-1 training: the KL- or VQ-regularized autoencoder with L1 + LPIPS
reconstruction loss and a PatchGAN adversarial loss (counterpart of
``ldm_tf2_tpu.training.ae_trainer``).

Two train steps, chosen by the caller's host-side step counter as in the
JAX package:

* phase 1 (step < ``global_step_discriminator``): ``nll + w_reg * reg``,
  where ``nll = sum(|x - x_hat| + w_lpips * LPIPS(x, x_hat)) / B`` and
  ``reg`` is the posterior's mean KL (KL) or the codebook loss (VQ);
* phase 2: adds ``weight * factor * g_loss``, ``g_loss = -mean(D(x_hat))``
  with D's BatchNorm on its running statistics, and the **adaptive
  weight** ``||d nll / d W|| / (||d g_loss / d W|| + 1e-4)``, clipped to
  [0, 1e4], detached and scaled by ``discriminator_weight``, where W is the
  decoder's final conv kernel.  Both gradients are taken on the one
  forward graph (``autograd.grad`` with ``retain_graph``); the JAX package
  re-runs the reconstruction with the same key for each, which draws the
  same numbers and so computes the same thing.  Then D, in training mode,
  runs on the real images and on the detached reconstructions (each call
  updating the running statistics, in that order), and its loss is
  ``D_LOSS_MAP[type](real, fake) * factor``.  Both gradients are taken
  before either optimizer steps; the autoencoder's are taken with respect
  to its own parameters only, so D's parameters collect nothing from the
  generator term.

The optimizers are ``optax.adam`` (``make_adam``: the port's ``AdamW`` with
weight decay 0).  LPIPS is frozen.  A step's draws (posterior noise,
dropout) come from generators seeded from ``(seed, step)`` alone, and the
posterior noise may be injected (``draws``), which is how the tests hand
both frameworks the same numbers.  Compute runs in the models' compute
dtype over float32 parameters.

Data parallelism (``mesh``, a ``parallel.Mesh`` in a process group): the
batch is this rank's rows of the global batch and every draw this rank's
rows of the global batch's draw (rows by the ``data`` coordinate); both
models' gradients are averaged over the ``data`` axis, the adaptive weight's two last-layer gradients before their
norms, and D's BatchNorm takes the global batch's statistics
(``parallel.all_reduce_sum`` of the float32 sums), so the running
statistics, both Adam states and the logged (global-mean) metrics equal
one process's at the global batch.

Both steps are ``StepProgram``s (``training/ldm_trainer.py``), so that
``training/graphs.py`` can capture each once as a CUDA graph.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ldm_tf2_tpu_torch.diffusion.losses import D_LOSS_MAP, nll_loss
from ldm_tf2_tpu_torch.graphs import module_tensors
from ldm_tf2_tpu_torch.models import AutoencoderKL
from ldm_tf2_tpu_torch.parallel import (
    RowSlice, all_reduce_mean_, all_reduce_sum, global_mean,
)
from ldm_tf2_tpu_torch.training.ldm_trainer import (
    HYPER, AdamW, StepProgram, _to, opt_tensors, step_generators,
)


def make_adam(learning_rate: float = 4.5e-6, beta_1: float = 0.5,
              beta_2: float = 0.9, epsilon: float = 1e-8) -> AdamW:
    """``optax.adam`` of ``autoencoder_optimizer`` / ``discriminator_optimizer``."""
    return AdamW(learning_rate, beta_1, beta_2, epsilon, weight_decay=0.0)


@dataclasses.dataclass
class AETrainState:
    """What a step carries besides the models' own parameters and D's
    running statistics: the step count and both Adam states."""

    step: int
    ae_opt_state: dict
    d_opt_state: dict


def _params(module) -> dict:
    return dict(module.named_parameters())


def init_ae_train_state(autoencoder, discriminator, ae_optimizer: AdamW,
                        d_optimizer: AdamW) -> AETrainState:
    return AETrainState(step=0, ae_opt_state=ae_optimizer.init(_params(autoencoder)),
                        d_opt_state=d_optimizer.init(_params(discriminator)))


def make_ae_train_steps(autoencoder, discriminator, lpips, ae_optimizer: AdamW,
                        d_optimizer: AdamW, *, lpips_weight: float = 1.0,
                        regularization_weight: float = 1.0,
                        discriminator_weight: float = 1.0,
                        discriminator_factor: float = 1.0,
                        discriminator_loss_type: str = "hinge", seed: int = 0,
                        mesh=None):
    """Build ``(train_step_autoencoder, train_step_autoencoder_discriminator)``,
    each ``(state, images, draws=None) -> (state, metrics)``, a
    ``StepProgram``.

    images [B, H, W, 3] in [-1, 1] on the models' device.  ``draws`` may
    inject ``posterior_noise`` (the KL latents' shape).  Metrics are
    detached 0-dim tensors: ae_loss, nll_loss, reg_loss, and in phase 2
    g_loss, adaptive_weight and d_loss.  Each step's ``.grads`` computes
    its gradients and metrics without the update."""
    d_loss_fn = D_LOSS_MAP[discriminator_loss_type]
    device = next(autoencoder.parameters()).device
    kl = isinstance(autoencoder, AutoencoderKL)
    in_group = mesh is not None and mesh.distributed
    average = lambda tensors: all_reduce_mean_(tensors, mesh)
    sum_ranks = (lambda x: all_reduce_sum(x, mesh)) if in_group else None

    def recon_losses(gens, images, draws):
        noise_gen, dropout_gen = gens
        if in_group:
            noise_gen = RowSlice(noise_gen, mesh.data_index, mesh.data_size)
            dropout_gen = RowSlice(dropout_gen, mesh.data_index, mesh.data_size)
        if kl:
            posterior = autoencoder.encode(images, generator=dropout_gen)
            z = posterior.sample(noise_gen, (draws or {}).get("posterior_noise"))
            k = posterior.kl()
            reg = torch.sum(k) / k.shape[0]
        else:
            z, reg, _ = autoencoder.encode(images, generator=dropout_gen)
        outputs = autoencoder.decode(z, generator=dropout_gen)
        lp = lpips(images, outputs)
        nll = nll_loss(images, outputs, lp, lpips_weight, reduce_loss=True)
        return outputs, nll, reg

    def apply(optimizer, module, loss_grads, opt_state, hyper):
        params = _params(module)
        optimizer.step_(params, dict(zip(params, loss_grads)), opt_state, hyper,
                        average if in_group else None)

    def global_metrics(metrics):
        return {k: global_mean(v.detach(), mesh) for k, v in metrics.items()}

    def gens_of(state):
        return step_generators(seed, state.step, device, 2)

    def ae_grads(state: AETrainState, images, draws=None, gens=None):
        """Phase 1's loss and gradients (autoencoder parameters, in
        ``named_parameters`` order), no update."""
        _, nll, reg = recon_losses(gens or gens_of(state), images, draws)
        loss = nll + regularization_weight * reg
        grads = torch.autograd.grad(loss, list(_params(autoencoder).values()))
        return grads, global_metrics({"ae_loss": loss, "nll_loss": nll,
                                      "reg_loss": reg})

    def gan_grads(state: AETrainState, images, draws=None, gens=None):
        """Phase 2's gradients (autoencoder, discriminator) and metrics, no
        update: D's running statistics move, as in the step."""
        outputs, nll, reg = recon_losses(gens or gens_of(state), images, draws)
        g_loss = -torch.mean(discriminator(outputs, training=False))
        last = autoencoder.last_layer()
        nll_grad, = torch.autograd.grad(nll, last, retain_graph=True)
        g_grad, = torch.autograd.grad(g_loss, last, retain_graph=True)
        average([nll_grad, g_grad])
        weight = torch.linalg.vector_norm(nll_grad) / (
            torch.linalg.vector_norm(g_grad) + 1e-4)
        weight = torch.clamp(weight, 0.0, 1e4).detach() * discriminator_weight
        ae_loss = (nll + regularization_weight * reg
                   + weight * discriminator_factor * g_loss)
        grads = torch.autograd.grad(ae_loss, list(_params(autoencoder).values()))

        outputs = outputs.detach()
        logits_real = discriminator(images.detach(), training=True, sum_ranks=sum_ranks)
        logits_fake = discriminator(outputs, training=True, sum_ranks=sum_ranks)
        d_loss = d_loss_fn(logits_real, logits_fake) * discriminator_factor
        d_grads = torch.autograd.grad(d_loss, list(_params(discriminator).values()))
        metrics = {"ae_loss": ae_loss, "nll_loss": nll, "reg_loss": reg,
                   "g_loss": g_loss, "adaptive_weight": weight, "d_loss": d_loss}
        return grads, d_grads, global_metrics(metrics)

    def body_ae(state: AETrainState, gens, hyper, phase, images, draws=None):
        grads, metrics = ae_grads(state, images, draws, gens)
        apply(ae_optimizer, autoencoder, grads, state.ae_opt_state, hyper)
        return tuple(metrics.values())

    def body_gan(state: AETrainState, gens, hyper, phase, images, draws=None):
        grads, d_grads, metrics = gan_grads(state, images, draws, gens)
        apply(ae_optimizer, autoencoder, grads, state.ae_opt_state, hyper[:HYPER])
        apply(d_optimizer, discriminator, d_grads, state.d_opt_state, hyper[HYPER:])
        return tuple(metrics.values())

    def finish(names, d_too):
        def finish(state: AETrainState, phase, outputs):
            ae_optimizer.advance(state.ae_opt_state)
            if d_too:
                d_optimizer.advance(state.d_opt_state)
            state.step += 1
            return dict(zip(names, outputs))
        return finish

    written = lambda state: (module_tensors(autoencoder, discriminator)
                             + opt_tensors(state.ae_opt_state) + opt_tensors(state.d_opt_state))

    def program(phase, body, hyper, names, d_too):
        return StepProgram(
            body=body, phase=lambda state: (ae_optimizer.syncs(state.ae_opt_state),
                                            d_optimizer.syncs(state.d_opt_state)),
            hyper=hyper, finish=finish(names, d_too),
            tensors=lambda state: module_tensors(lpips) + written(state), written=written,
            key=(phase, autoencoder.dtype, discriminator_loss_type),
            seed=seed, device=device, generators=2, inputs=1)

    train_step_autoencoder = program(
        "ae", body_ae, lambda state: ae_optimizer.hyper(state.ae_opt_state),
        ("ae_loss", "nll_loss", "reg_loss"), False)
    train_step_autoencoder_discriminator = program(
        "ae_gan", body_gan, lambda state: np.concatenate([
            ae_optimizer.hyper(state.ae_opt_state), d_optimizer.hyper(state.d_opt_state)]),
        ("ae_loss", "nll_loss", "reg_loss", "g_loss", "adaptive_weight", "d_loss"), True)
    train_step_autoencoder.grads = ae_grads
    train_step_autoencoder_discriminator.grads = gan_grads
    return train_step_autoencoder, train_step_autoencoder_discriminator


def checkpoint_state(state: AETrainState, autoencoder, discriminator,
                     seed: int = 0) -> dict:
    """What a checkpoint holds: the step, both models' state (D's running
    statistics included), both optimizer states and the data seed."""
    return {
        "step": state.step, "seed": seed,
        "autoencoder": autoencoder.state_dict(),
        "discriminator": discriminator.state_dict(),
        "ae_opt_state": state.ae_opt_state, "d_opt_state": state.d_opt_state,
    }


def restore_state(saved: dict, autoencoder, discriminator) -> AETrainState:
    """Load a ``checkpoint_state`` dict back into the models (in place) and
    return the train state, its tensors on the autoencoder's device."""
    device = next(autoencoder.parameters()).device
    autoencoder.load_state_dict(saved["autoencoder"])
    discriminator.load_state_dict(saved["discriminator"])
    return AETrainState(step=int(saved["step"]),
                        ae_opt_state=_to(saved["ae_opt_state"], device),
                        d_opt_state=_to(saved["d_opt_state"], device))
