"""Stage-1 autoencoder training CLI of the PyTorch port (counterpart of
``ldm_tf2_tpu.cli.run_autoencoder_trainer``):

    python -m ldm_tf2_tpu_torch.cli.run_autoencoder_trainer \\
        --config_path <yaml> --lpips_blob <path without .bin/.json> \\
        [--seed 0] [--device cuda]

or, data-parallel over N cards, ``torchrun --nproc_per_node N -m
ldm_tf2_tpu_torch.cli.run_autoencoder_trainer ...``.

A fresh KL or VQ autoencoder (``autoencoder_training.autoencoder_type``)
and its PatchGAN discriminator (``ae_{kl,vq}_discriminator``), float32
masters initialized from ``--seed``, computing in ``tpu.compute_dtype``,
are trained against a frozen LPIPS whose weights are the ``lpips``
artifact of the weight blob.  Batches of images come from the
``*.tfrecord`` files under ``autoencoder_training.root_path`` (with
``tpu.deterministic_data``, from the indexed loader at the restored step,
as in the LDM trainer).  A host-side
step counter switches from the reconstruction step to the GAN step at
``autoencoder_{kl,vq}_trainer.global_step_discriminator``.  The state
(step, both models, D's running statistics, both Adam states, seed) is
saved to ``autoencoder_training.ckpt_path`` every
``tpu.persist_per_iterations`` steps (5000 when null) and at the end, and
the newest checkpoint there is restored at start; a null ``ckpt_path``
saves nothing.  Losses, the adaptive weight and images/s are logged every
``tpu.log_per_iterations`` steps.

``tpu.remat`` is accepted and ignored, as the JAX autoencoder trainer
ignores it.  Under ``torchrun`` the ranks are the ``data`` axis of
``tpu.mesh``, as in the LDM trainer: the batch size is per rank, and the
steps average both models' gradients and take D's batch statistics over
the global batch (``training/ae_trainer.py``).  A ``model`` axis, tensor
and sequence parallelism raise ``NotImplementedError`` naming ROADMAP item
A6b.  ``train(config, ..., batches=..., models=...)`` takes in-memory
global batches (each rank takes its rows) and built models instead of the
files and the blob.
"""

from __future__ import annotations

import argparse

import torch

from ldm_tf2_tpu_torch import factory
from ldm_tf2_tpu_torch.cli.run_ldm_trainer import data_parallel_setup, make_batches


def build_models(config: dict, lpips_blob_path: str, device, seed: int):
    """(autoencoder, discriminator, lpips): the first two fresh, from
    ``seed`` and ``seed + 1``, LPIPS from the blob's ``lpips`` artifact."""
    from ldm_tf2_tpu_torch.checkpoints.bridge import load_params, read_blob

    training = config["autoencoder_training"]
    ae_type = training["autoencoder_type"]
    autoencoder = factory.build_autoencoder(
        config, ae_type, device, dtype_key=None,
        resolution=training["params"]["image_size"])
    discriminator = factory.build_discriminator(config, ae_type, device)
    lpips = load_params(factory.build_lpips(config, device),
                        read_blob(lpips_blob_path)["lpips"])
    return (factory.init_params_(autoencoder, seed),
            factory.init_params_(discriminator, seed + 1), lpips)


def train(config: dict, lpips_blob=None, device="cuda", *, seed: int = 0,
          batches=None, models=None):
    """Run the trainer on a validated config.  ``models``: (autoencoder,
    discriminator, lpips) already on this rank's device, else built by
    ``build_models`` (which needs ``lpips_blob``).  ``batches``: an
    iterable of global batches of images [B, H, W, 3] in [-1, 1] of which
    each rank takes its rows, else the TFRecord loader.  Returns (train
    state, the logger's records)."""
    from ldm_tf2_tpu_torch.checkpoints.manager import CheckpointManager
    from ldm_tf2_tpu_torch.parallel import replicate, shard_batch
    from ldm_tf2_tpu_torch.training.ae_trainer import (
        checkpoint_state, init_ae_train_state, make_adam, make_ae_train_steps,
        restore_state,
    )
    from ldm_tf2_tpu_torch.utils.logging import MetricLogger

    device, mesh, params = data_parallel_setup(config, "autoencoder_training", device)
    say = print if mesh.rank == 0 else (lambda *a: None)
    factory.set_float32_precision()
    factory.apply_tpu_settings(config)
    training, tpu = config["autoencoder_training"], config["tpu"]
    ae_type = training["autoencoder_type"]
    trainer = config[f"autoencoder_{ae_type}_trainer"]
    if models is None:
        if lpips_blob is None:
            raise ValueError("the LPIPS weights are needed: pass lpips_blob")
        models = build_models(config, lpips_blob, device, seed)
    autoencoder, discriminator, lpips = models
    replicate(autoencoder, mesh)
    replicate(discriminator, mesh)
    autoencoder.requires_grad_(True).train()
    discriminator.requires_grad_(True).train()
    lpips.requires_grad_(False)

    ae_optimizer = make_adam(**(config.get("autoencoder_optimizer") or {}))
    d_optimizer = make_adam(**(config.get("discriminator_optimizer") or {}))
    step_ae, step_ae_d = make_ae_train_steps(
        autoencoder, discriminator, lpips, ae_optimizer, d_optimizer,
        lpips_weight=trainer["lpips_weight"],
        regularization_weight=trainer["kl_weight" if ae_type == "kl"
                                      else "codebook_weight"],
        discriminator_weight=trainer["discriminator_weight"],
        discriminator_factor=trainer["discriminator_factor"],
        discriminator_loss_type=trainer.get("discriminator_loss_type", "hinge"),
        seed=seed, mesh=mesh,
    )
    state = init_ae_train_state(autoencoder, discriminator, ae_optimizer, d_optimizer)

    manager = (CheckpointManager(training["ckpt_path"], mesh=mesh)
               if training.get("ckpt_path") else None)
    restored = manager.restore_latest(map_location=device) if manager else None
    if restored is not None:
        state = restore_state(restored[1], autoencoder, discriminator)
        say(f"[INFO] Restored checkpoint at step {state.step}...")
    else:
        say(f"[INFO] Training a {ae_type}-regularized autoencoder from scratch...")
    if batches is None:
        batches = make_batches(config, "autoencoder_training",
                               {**params, "keys": ["image"]}, mesh, seed, state.step)
    else:
        batches = (shard_batch(images, mesh) for images in batches)

    gan_from = trainer["global_step_discriminator"]
    persist_every = tpu["persist_per_iterations"] or 5000
    logger = MetricLogger(log_per_iterations=tpu["log_per_iterations"],
                          verbose=mesh.rank == 0)
    num_iterations = training["num_iterations"]
    step = state.step
    for images in batches if step < num_iterations else ():
        images = torch.as_tensor(images).to(device=device, dtype=torch.float32)
        train_step = step_ae_d if step >= gan_from else step_ae
        state, metrics = train_step(state, images)
        step = state.step
        logger.log(step, metrics, batch_size=images.shape[0] * mesh.world)
        if manager and step % persist_every == 0:
            say(f"[INFO] Saving checkpoint at global step {step}...")
            manager.save(step, checkpoint_state(state, autoencoder, discriminator, seed))
        if step >= num_iterations:
            break
    if hasattr(batches, "close"):
        batches.close()  # stops a loader's producer thread
    if manager and step % persist_every != 0:
        say(f"[INFO] Saving final checkpoint at global step {step}...")
        manager.save(step, checkpoint_state(state, autoencoder, discriminator, seed))
    return state, logger.records


def main(argv=None) -> None:
    from ldm_tf2_tpu_torch.configs.loader import load_config

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config_path", required=True)
    parser.add_argument("--lpips_blob", required=True,
                        help="blob path without the .bin/.json suffix; its "
                             "'lpips' artifact holds the LPIPS weights")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    train(load_config(args.config_path), args.lpips_blob, args.device,
          seed=args.seed)


if __name__ == "__main__":
    main()
