"""Stage-2 LDM training CLI of the PyTorch port (counterpart of
``ldm_tf2_tpu.cli.run_ldm_trainer``):

    python -m ldm_tf2_tpu_torch.cli.run_ldm_trainer \\
        --config_path <yaml> --params_blob <path without .bin/.json> \\
        [--seed 0] [--device cuda]

or, data-parallel over N cards, ``torchrun --nproc_per_node N -m
ldm_tf2_tpu_torch.cli.run_ldm_trainer ...``.

A fresh U-Net (float32 masters, ``tpu.compute_dtype`` compute) is trained
against the pretrained text encoder and autoencoder from the weight blob
(KL or VQ, ``ldm_training.autoencoder_type``; the VQ model's latents are
its encoder's, before quantization, as in the JAX CLI), both frozen in
``tpu.frozen_weights_dtype`` (the text encoder
trains, in float32, when ``ldm_training.train_cond_model`` is true).
Batches come from the ``*.tfrecord`` files under
``ldm_training.root_path``: streamed (``data/dataset.py``), or with
``tpu.deterministic_data`` from the indexed loader (``data/indexed.py``),
whose batch at step s is a function of (seed, s), so a resumed run reads
the batches an unbroken one would.  The state (step, U-Net and trained
text-encoder parameters, optimizer state, EMA, seed) is saved to
``ldm_training.ckpt_path`` every ``tpu.persist_per_iterations`` steps
(1000 when null) and at the end, and the newest checkpoint there is
restored at start (the loader is built after it, at the restored step); a
null ``ckpt_path`` saves nothing.  Loss and images/s are logged every
``tpu.log_per_iterations`` steps.  ``tpu.remat`` (true, full, blocks,
dots) recomputes the U-Net forward in the backward pass
(``models/remat.py``).

Under ``torchrun`` the ranks form ``tpu.mesh`` (``parallel/mesh.py``), as
the JAX trainer's devices do: ``ldm_training.params.batch_size`` is per
device, the global batch is that times the ``data`` axis, each ``data``
coordinate reads its rows of it (the indexed loader's shard of the global
permutation, or ``shard_for_process``'s files), ranks that differ only in
their ``model`` coordinate take the same rows, the state is replicated
over the whole mesh, and the step averages the gradients over the ``data``
axis (``training/ldm_trainer.py``).  As in the JAX trainer,
``tpu.tensor_parallel`` and ``tpu.sequence_parallel`` are not read.
``train(config, ..., batches=..., models=...)`` takes in-memory global
batches (each rank takes its rows) and built models instead of the files
and the blob.

On one CUDA card in a process of world 1 each train step replays a CUDA
graph captured once per key (``training/graphs.py``, the JAX CLI's
``jax.jit`` of the step).  The CPU and a mesh of more than one rank run
the steps eagerly.  Checkpoints and the logged losses are read between
steps.
"""

from __future__ import annotations

import argparse

import torch

from ldm_tf2_tpu_torch import factory


def data_parallel_setup(config: dict, section: str, device):
    """Join ``torchrun``'s process group (if any) and check ``tpu.mesh``
    against the world as the JAX CLIs do.  The global batch is the
    per-device batch times the ``data`` axis and each ``data`` coordinate
    loads its share, so a rank loads the per-device batch.  Returns
    (device, mesh, the loader's keywords)."""
    from ldm_tf2_tpu_torch.parallel import create_mesh, maybe_initialize_distributed

    device = factory.resolve_device(maybe_initialize_distributed(device))
    mesh = create_mesh(config["tpu"].get("mesh"))
    return device, mesh, dict(config[section]["params"])


def make_batches(config: dict, section: str, params: dict, mesh, seed: int,
                 start_step: int, **kw):
    """The loader from ``section.root_path`` for this rank: the indexed
    loader from ``start_step`` with ``tpu.deterministic_data`` (this rank's
    shard of the global batch), else the streaming loader on this rank's
    files."""
    from ldm_tf2_tpu_torch.data.dataset import (
        create_dataset, list_tfrecords, shard_for_process,
    )
    from ldm_tf2_tpu_torch.data.indexed import create_indexed_dataset

    files = list_tfrecords(config[section]["root_path"])
    if config["tpu"]["deterministic_data"]:
        return create_indexed_dataset(files, **params, **kw, random_seed=seed,
                                      start_step=start_step, shard_index=mesh.data_index,
                                      shard_count=mesh.data_size)
    return create_dataset(shard_for_process(files, mesh), **params, **kw,
                          random_seed=seed)


def _load_models(config, params_blob_path, device, seed):
    from ldm_tf2_tpu_torch.checkpoints.bridge import load_params, read_blob

    train_cond = config["ldm_training"]["train_cond_model"]
    blob = read_blob(params_blob_path)
    cond_model = load_params(
        factory.build_cond_model(
            config, device, None if train_cond else "frozen_weights_dtype"),
        blob["cond_stage_model"])
    training = config["ldm_training"]
    autoencoder = load_params(
        factory.build_autoencoder(config, training.get("autoencoder_type", "kl"),
                                  device, "frozen_weights_dtype",
                                  resolution=training["params"]["image_size"]),
        blob["autoencoder"])
    return cond_model, factory.build_trainable_unet(config, device, seed), autoencoder


def train(config: dict, params_blob_path: str | None = None, device="cuda", *,
          seed: int = 0, batches=None, models=None):
    """Run the trainer on a validated config.  ``models``: (cond_model,
    unet, autoencoder) already on this rank's device, else they come from
    the blob and a fresh U-Net seeded with ``seed``.  ``batches``: an
    iterable of global batches (images [B, H, W, 3] in [-1, 1], token ids
    [B, L]) of which each rank takes its rows, else the TFRecord loader.
    Returns (train state, the logger's records)."""
    from ldm_tf2_tpu_torch.checkpoints.manager import CheckpointManager
    from ldm_tf2_tpu_torch.configs.loader import compute_dtype
    from ldm_tf2_tpu_torch.data.tokenizer import null_condition_ids
    from ldm_tf2_tpu_torch.parallel import replicate, shard_batch
    from ldm_tf2_tpu_torch.training.graphs import describe_steps, train_step_for
    from ldm_tf2_tpu_torch.training.ldm_trainer import (
        checkpoint_state, init_ldm_train_state, make_ldm_train_step,
        make_optimizer, restore_state,
    )
    from ldm_tf2_tpu_torch.utils.logging import MetricLogger

    device, mesh, params = data_parallel_setup(config, "ldm_training", device)
    say = print if mesh.rank == 0 else (lambda *a: None)
    say(f"[INFO] Mesh: {dict(mesh.shape)}, rank {mesh.rank} of {mesh.world}")
    factory.set_float32_precision()
    factory.apply_tpu_settings(config)
    training, tpu = config["ldm_training"], config["tpu"]
    train_cond = training["train_cond_model"]
    if models is None:
        models = _load_models(config, params_blob_path, device, seed)
    cond_model, unet, autoencoder = models
    replicate(unet, mesh)
    if train_cond:
        replicate(cond_model, mesh)
    unet.requires_grad_(True)
    cond_model.requires_grad_(train_cond)
    autoencoder.requires_grad_(False)

    ema_decay = training.get("ema_decay")
    optimizer = make_optimizer(**(config.get("latent_diffusion_optimizer") or {}),
                               accum_steps=training.get("grad_accum_steps", 1))
    max_seq_len = config["cond_stage_model"]["max_seq_len"]
    train_step = train_step_for(make_ldm_train_step(
        unet, cond_model, autoencoder, factory.build_schedule(config), optimizer,
        scale_factor=config["ldm"]["scale_factor"],
        condition_dropout_rate=training["condition_dropout_rate"],
        train_cond_model=train_cond,
        null_token_ids=null_condition_ids(1, max_seq_len)[0],
        remat_unet=tpu["remat"], ema_decay=ema_decay,
        encode_chunks=tpu["encode_chunks"], seed=seed, mesh=mesh,
    ))
    say(f"[INFO] {describe_steps(device)}")
    state = init_ldm_train_state(unet, cond_model, optimizer, train_cond, ema_decay)
    trained_cond = cond_model if train_cond else None

    manager = (CheckpointManager(training["ckpt_path"], mesh=mesh)
               if training.get("ckpt_path") else None)
    restored = manager.restore_latest(map_location=device) if manager else None
    if restored is not None:
        state = restore_state(restored[1], unet, trained_cond)
        say(f"[INFO] Restored checkpoint at step {state.step}...")
    else:
        say("[INFO] Training from scratch...")
    if batches is None:
        batches = make_batches(config, "ldm_training", params, mesh, seed, state.step,
                               max_seq_len=max_seq_len)
    else:
        batches = ((shard_batch(i, mesh), shard_batch(t, mesh)) for i, t in batches)

    persist_every = tpu["persist_per_iterations"] or 1000
    logger = MetricLogger(log_per_iterations=tpu["log_per_iterations"],
                          verbose=mesh.rank == 0)
    num_iterations = training["num_iterations"]
    img_dtype = compute_dtype(config)
    step = state.step
    for images, token_ids in batches if step < num_iterations else ():
        images = torch.as_tensor(images).to(device=device, dtype=img_dtype)
        token_ids = torch.as_tensor(token_ids).to(device=device, dtype=torch.long)
        state, metrics = train_step(state, images, token_ids)
        step = state.step
        logger.log(step, metrics, batch_size=images.shape[0] * mesh.data_size)
        if manager and step % persist_every == 0:
            say(f"[INFO] Saving checkpoint at global step {step}...")
            manager.save(step, checkpoint_state(state, unet, trained_cond, seed))
        if step >= num_iterations:
            break
    if hasattr(batches, "close"):
        batches.close()  # stops a loader's producer thread
    if manager and step % persist_every != 0:
        say(f"[INFO] Saving final checkpoint at global step {step}...")
        manager.save(step, checkpoint_state(state, unet, trained_cond, seed))
    return state, logger.records


def main(argv=None) -> None:
    from ldm_tf2_tpu_torch.configs.loader import load_config

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config_path", required=True)
    parser.add_argument("--params_blob", required=True,
                        help="blob path without the .bin/.json suffix")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    train(load_config(args.config_path), args.params_blob, args.device,
          seed=args.seed)


if __name__ == "__main__":
    main()
