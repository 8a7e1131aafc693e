"""Text-to-image and image-to-image sampling CLI of the PyTorch port.

One YAML and one weight blob in, ``images.npy`` out ([B, H, W, 3] uint8,
per-image min-max normalized), like ``ldm_tf2_tpu.cli.run_ldm_sampler``:

    python -m ldm_tf2_tpu_torch.cli.run_ldm_sampler \\
        --config_path ldm_tf2_tpu/configs/all_in_one_config.yaml \\
        --params_blob <path without .bin/.json> [--seed 0] [--device cuda]

or, data-parallel over N cards, ``torchrun --nproc_per_node N -m
ldm_tf2_tpu_torch.cli.run_ldm_sampler ...``.

The weights come from the single-blob artifact the JAX package exported
(``checkpoints/blob.py``).  ``ldm_sampling.sampler`` picks the loop, with
the JAX CLI's table and checks: ``ddim`` (default), ``ddpm``, ``plms`` or
``dpm_solver_pp_2m``.  ``ldm_sampling.sample_save_progress`` (DDIM only)
also writes ``sample_prog.npy`` and ``pred_x0_prog.npy`` ([B, records, H,
W, 3] uint8, every 5th step decoded).  ``ldm_sampling.cache_interval`` > 1
samples with DeepCache (``cache_levels`` shallow levels stay fresh; DDIM
or DPM-Solver++(2M), ``CACHE_LOOPS``).  ``ldm_sampling.init_image_path``
(a ``.npy`` [B or 1, H, W, 3], uint8 or in [-1, 1]) samples image to
image from ``strength`` of the DDIM schedule, and ``mask_path`` (a
``.npy`` [H, W] or [B, H, W], 1 = regenerate, 0 = keep, resized to the
latent grid as ``jax.image.resize(..., "nearest")`` does) inpaints; both
with DDIM only (``sample_img2img``).  ``ldm_sampling.autoencoder_type:
vq`` decodes with the VQ autoencoder, quantizing the latents first
(``force_quantize``), as the JAX CLI does.  The configurations the JAX CLI
refuses raise its ``ValueError`` (``check_sampling``).  Under ``torchrun``
the ranks form ``tpu.mesh`` (``parallel/mesh.py``), in the JAX CLI's order:
the serving modes, then ``tpu.sequence_parallel`` (Ulysses attention over
the ``model`` axis, ``ops.attention.enable_sequence_parallel``; weights
whole), then ``tpu.tensor_parallel`` (``ops/tp.py``; each model's leaves
sharded over the ``model`` axis by ``parallel.sharding.shard_params_tp``).
When the latent batch B divides by the ``data`` axis, data coordinate r
samples latent rows ``[r b, (r + 1) b)`` (b = B / data), with the token rows
``r b ...`` of both halves of the CFG batch, the initial latent and every
step's noise drawn at the global shape and sliced (``sample_*(...,
mesh=...)``), and the images are gathered in data order; otherwise every
data coordinate samples every row.  Rank 0 writes them.  The serving modes
``tpu.quantize: int8`` and ``tpu.quantize_attention: int8pv`` apply here as
in the JAX CLI, which honours both (``factory.apply_serving_modes``).  The
text-to-image pipeline is ``sample_txt2img`` (``sample_txt2img_progressive``
with the progress records).  On one card every loop's U-Net eval is
captured once as a CUDA graph and replayed (``diffusion/graphs.py``, the
JAX CLI's ``jax.jit`` of the pipeline); ``graphs=False`` runs them
eagerly, and so does a mesh of more than one rank.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ldm_tf2_tpu_torch import factory
from ldm_tf2_tpu_torch.diffusion.graphs import eps_model_for
from ldm_tf2_tpu_torch.diffusion.sampler import (
    ddim_img2img_loop, ddim_sample_loop, ddim_sample_loop_deepcache,
    ddim_sample_loop_progressive, ddpm_sample_loop,
)
from ldm_tf2_tpu_torch.diffusion.solvers import (
    dpm_solver_pp_2m_sample_loop, dpm_solver_pp_2m_sample_loop_deepcache,
    plms_sample_loop,
)
from ldm_tf2_tpu_torch.graphs import describe
from ldm_tf2_tpu_torch.models import AutoencoderVQ
from ldm_tf2_tpu_torch.parallel import RowSlice

# ldm_sampling.sampler -> loop, the JAX CLIs' table
SAMPLE_LOOPS = {
    "ddim": ddim_sample_loop,
    "ddpm": ddpm_sample_loop,
    "plms": plms_sample_loop,
    "dpm_solver_pp_2m": dpm_solver_pp_2m_sample_loop,
}
# the samplers DeepCache composes with (cache_interval > 1)
CACHE_LOOPS = {
    "ddim": ddim_sample_loop_deepcache,
    "dpm_solver_pp_2m": dpm_solver_pp_2m_sample_loop_deepcache,
}


def tensor_to_image(x) -> np.ndarray:
    """Per-image min-max normalize to uint8."""
    x = np.asarray(x, dtype=np.float32)
    flat = x.reshape(x.shape[0], -1)
    lo = flat.min(axis=1).reshape(-1, *([1] * (x.ndim - 1)))
    hi = flat.max(axis=1).reshape(-1, *([1] * (x.ndim - 1)))
    return ((x - lo) / (hi - lo) * 255).astype(np.uint8)


def sampler_name(sampling: dict) -> str:
    """``ldm_sampling.sampler``, checked against ``SAMPLE_LOOPS`` as the JAX
    CLIs check it."""
    name = sampling.get("sampler", "ddim")
    if name not in SAMPLE_LOOPS:
        raise ValueError(
            f"ldm_sampling.sampler must be one of {sorted(SAMPLE_LOOPS)}, "
            f"got {name!r}"
        )
    return name


def check_sampling(sampling: dict) -> str:
    """The JAX CLI's checks of ``ldm_sampling``, with its wording; returns
    the sampler's name."""
    sampler = sampler_name(sampling)
    save_progress = bool(sampling.get("sample_save_progress", False))
    cache_interval = int(sampling.get("cache_interval", 1))
    init_image_path = sampling.get("init_image_path")
    if save_progress and sampler != "ddim":
        raise ValueError(
            "ldm_sampling.sample_save_progress only supports sampler: ddim"
        )
    if cache_interval > 1 and save_progress:
        raise ValueError(
            "ldm_sampling.cache_interval > 1 does not support "
            "sample_save_progress"
        )
    if init_image_path and (sampler != "ddim" or save_progress
                            or cache_interval > 1):
        raise ValueError(
            "ldm_sampling.init_image_path requires sampler: ddim without "
            "sample_save_progress or cache_interval"
        )
    if sampling.get("mask_path") and not init_image_path:
        raise ValueError("ldm_sampling.mask_path requires init_image_path")
    return sampler


def decode_latents(autoencoder, z):
    """Images from latents (already divided by the scale factor): the VQ
    autoencoder quantizes them first, as the JAX CLIs decode with
    ``force_quantize=True``."""
    if isinstance(autoencoder, AutoencoderVQ):
        return autoencoder.decode(z, force_quantize=True)
    return autoencoder.decode(z)


def txt2img_body(cond_model, unet, autoencoder, schedule, token_ids, generator,
                 guidance_scale, shape, *, sampler: str = "ddim",
                 guidance_rescale: float = 0.0, scale_factor: float = 0.18215,
                 cache_interval: int = 1, cache_levels: int = 1, eps_model=None,
                 init_noise=None, **hooks):
    """The device part of a txt2img call: text encode -> CFG sampling loop
    (``SAMPLE_LOOPS[sampler]``, or with ``cache_interval`` > 1 the
    sampler's DeepCache loop, ``CACHE_LOOPS``, with ``cache_levels``
    shallow levels) -> decode (``decode_latents``), with no copy from the
    host and no read of a device value on the host, so that a server can
    capture it whole (``diffusion/graphs.py::SamplingProgram``).

    token_ids: [2B, L] on the models' device; generator: the call's draws;
    guidance_scale: a number or a per-slot [B, 1, 1, 1] tensor on the
    device; ``eps_model``: what the loop calls (the U-Net when None).
    ``init_noise`` and ``hooks`` (``step_noises``, ``return_trajectory``)
    are the loops' test hooks.  Returns (images, x0), plus the trajectory
    with ``return_trajectory``."""
    loop = SAMPLE_LOOPS[sampler]
    if cache_interval > 1:
        cached = CACHE_LOOPS[sampler]
        loop = lambda model, *args, **kw: cached(
            lambda x, t, c: model(x, t, c, return_cache=True,
                                  cache_levels=cache_levels),
            lambda x, t, c, cache: model(x, t, c, shallow_cache=cache,
                                         cache_levels=cache_levels),
            *args, cache_interval=cache_interval, **kw)
    context = cond_model(token_ids)
    out = loop(unet if eps_model is None else eps_model, schedule, context, shape,
               generator, guidance_scale=guidance_scale,
               guidance_rescale=guidance_rescale, init_noise=init_noise, **hooks)
    x0, traj = out if hooks.get("return_trajectory") else (out, None)
    images = decode_latents(autoencoder, x0 / scale_factor)
    return (images, x0) if traj is None else (images, x0, traj)


def sample_txt2img(cond_model, unet, autoencoder, schedule, token_ids, shape,
                   *, sampler: str = "ddim", guidance_scale: float = 5.0,
                   guidance_rescale: float = 0.0, scale_factor: float = 0.18215,
                   seed: int = 0, init_noise=None, step_noises=None,
                   return_trajectory: bool = False, cache_interval: int = 1,
                   cache_levels: int = 1, device="cuda", mesh=None,
                   graphs: bool = True):
    """Text encode -> CFG sampling loop (``sampler``, a key of
    ``SAMPLE_LOOPS``) -> decode (``decode_latents``): the host's part (the
    device, the generator, the token ids copied to the card) around
    ``txt2img_body``.

    token_ids: [2B, L] (unconditional rows first); shape: latent [B, h, w, c].
    The models must already be on ``device``.  ``cache_interval`` > 1 runs
    the sampler's DeepCache loop (``CACHE_LOOPS``) with ``cache_levels``
    shallow levels.  ``step_noises`` (DDIM and DDPM) and
    ``return_trajectory`` (DDIM, no DeepCache) are the loops' test hooks.
    ``mesh`` (a data-parallel rank's): token_ids and shape are this rank's
    share (``rank_rows``) and every draw is this rank's rows of the global
    batch's draw, by its ``data`` coordinate.  ``graphs``: on a CUDA device
    in one process the loop's U-Net evals replay CUDA graphs
    (``diffusion/graphs.py``); False runs them eagerly, for comparison.  The
    text encode and the decode run eagerly.  Returns (images [B, H, W, 3]
    float, x0 latents), plus the [S, B, h, w, c] trajectory when asked.
    """
    device = factory.resolve_device(device)
    hooks = {}
    if step_noises is not None:
        hooks["step_noises"] = step_noises
    if return_trajectory:
        hooks["return_trajectory"] = True
    with torch.inference_mode():
        return txt2img_body(
            cond_model, unet, autoencoder, schedule,
            torch.as_tensor(token_ids, device=device), _generator(device, seed, mesh),
            guidance_scale, shape, sampler=sampler, guidance_rescale=guidance_rescale,
            scale_factor=scale_factor, cache_interval=cache_interval,
            cache_levels=cache_levels, eps_model=eps_model_for(unet, device, graphs),
            init_noise=init_noise, **hooks)


def sample_img2img(cond_model, unet, autoencoder, schedule, token_ids, init_image, *,
                   mask=None, strength: float = 0.75, guidance_scale: float = 5.0,
                   guidance_rescale: float = 0.0, scale_factor: float = 0.18215,
                   seed: int = 0, enc_noise=None, init_noise=None, step_noises=None,
                   keep_noises=None, device="cuda", mesh=None, graphs: bool = True):
    """Text encode, image encode -> ``ddim_img2img_loop`` -> decode.

    init_image: [B, H, W, 3] in [-1, 1]; mask: None or [B or 1, h, w, 1] at
    the latent grid (1 = regenerate, 0 = keep).  The KL autoencoder's
    posterior is sampled with ``enc_noise`` (else a draw from the seed's
    generator); the VQ autoencoder's latents are taken before quantization,
    as the JAX CLI does.  ``init_noise``, ``step_noises`` and
    ``keep_noises`` are the loop's test hooks.  ``mesh``: as in
    ``sample_txt2img``, init_image and mask this rank's rows; ``graphs`` as
    there (the encode runs eagerly).  Returns (images [B, H, W, 3] float, x0
    latents, the init latents times ``scale_factor``)."""
    device = factory.resolve_device(device)
    with torch.inference_mode():
        generator = _generator(device, seed, mesh)
        context = cond_model(torch.as_tensor(token_ids, device=device))
        x = torch.as_tensor(init_image, device=device)
        if isinstance(autoencoder, AutoencoderVQ):
            z = autoencoder.encode(x, only_encode=True)
        else:
            z = autoencoder.encode(x).sample(generator, noise=enc_noise)
        init_latent = z * scale_factor
        x0 = ddim_img2img_loop(
            eps_model_for(unet, device, graphs), schedule, context, init_latent,
            generator, strength=strength, guidance_scale=guidance_scale, mask=mask,
            init_noise=init_noise, guidance_rescale=guidance_rescale,
            step_noises=step_noises, keep_noises=keep_noises,
        )
        images = decode_latents(autoencoder, x0 / scale_factor)
    return images, x0, init_latent


def sample_txt2img_progressive(cond_model, unet, autoencoder, schedule, token_ids,
                               shape, *, guidance_scale: float = 5.0,
                               guidance_rescale: float = 0.0,
                               scale_factor: float = 0.18215, seed: int = 0,
                               init_noise=None, step_noises=None, device="cuda",
                               mesh=None, graphs: bool = True):
    """``sample_txt2img`` with DDIM's progress records
    (``ddim_sample_loop_progressive``, every 5th step), decoded in one
    autoencoder call; ``graphs`` as there.  Returns (images [B, H, W, 3], x0,
    sample_progress and pred_x0_progress images [B, records, H, W, 3])."""
    device = factory.resolve_device(device)
    with torch.inference_mode():
        generator = _generator(device, seed, mesh)
        context = cond_model(torch.as_tensor(token_ids, device=device))
        x0, sample_prog, pred_x0_prog = ddim_sample_loop_progressive(
            eps_model_for(unet, device, graphs), schedule, context, shape,
            generator, guidance_scale=guidance_scale,
            guidance_rescale=guidance_rescale, init_noise=init_noise,
            step_noises=step_noises,
        )
        records = sample_prog.shape[1]
        flat = torch.cat([x0[:, None], sample_prog, pred_x0_prog], dim=1)
        images = decode_latents(autoencoder,
                                flat.reshape(-1, *shape[1:]) / scale_factor)
        images = images.reshape(shape[0], 1 + 2 * records, *images.shape[1:])
    return (images[:, 0], x0, images[:, 1:1 + records],
            images[:, 1 + records:])


def _generator(device, seed: int, mesh):
    """The call's generator; on a data-parallel rank, its rows of the
    global batch's draws."""
    generator = torch.Generator(device=device).manual_seed(seed)
    if mesh is not None and mesh.distributed:
        return RowSlice(generator, mesh.data_index, mesh.data_size)
    return generator


def rank_rows(token_ids, batch: int, mesh):
    """This rank's share of a CFG call of latent batch ``batch`` (the
    ``[uncond B; cond B]`` token rows): rows ``r b .. (r + 1) b`` of both
    halves, r its ``data`` coordinate, b = batch / data."""
    b = batch // mesh.data_size
    rows = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
    return torch.cat([token_ids[:batch][rows], token_ids[batch:][rows]]), b


def apply_parallelism(config: dict, mesh, models, say=print) -> None:
    """The JAX CLI's order after the serving modes: ``tpu.sequence_parallel``
    (Ulysses over the ``model`` axis, the weights whole), then
    ``tpu.tensor_parallel`` (each of ``models`` sharded over it; none given,
    as by the server, which never shards, as the JAX server does not).  A
    flag that is off clears what an earlier call of the process set."""
    from ldm_tf2_tpu_torch.ops.attention import (
        disable_sequence_parallel, enable_sequence_parallel,
    )
    from ldm_tf2_tpu_torch.ops.tp import enable_tensor_parallel
    from ldm_tf2_tpu_torch.parallel.sharding import shard_params_tp

    tpu = config["tpu"]
    disable_sequence_parallel()
    enable_tensor_parallel(None)
    if tpu["sequence_parallel"]:
        say("[INFO] Ulysses sequence-parallel attention over 'model' axis "
            f"(size {mesh.shape['model']}).")
        enable_sequence_parallel(mesh)
    if tpu["tensor_parallel"] and models:
        say("[INFO] Tensor-parallel params over 'model' axis "
            f"(size {mesh.size('model')}); kernels run per shard (ops/tp.py).")
        enable_tensor_parallel(mesh)
        for model in models:
            shard_params_tp(model, mesh)


def nearest_resize_indices(size_in: int, size_out: int) -> np.ndarray:
    """The source index of each output index of ``jax.image.resize(...,
    "nearest")``: ``floor((i + 0.5) * in / out)`` in float32, half-pixel
    centres (8i + 4 at f8; ``F.interpolate(mode="nearest")`` picks 8i)."""
    centres = np.arange(size_out, dtype=np.float32) + np.float32(0.5)
    return np.floor(centres * np.float32(size_in) / np.float32(size_out)).astype(np.int64)


def load_init_image(path: str, config: dict) -> np.ndarray:
    """The init image ``.npy`` as the JAX CLI loads it: a batch axis added
    to a 3-D array, uint8 mapped to [-1, 1], a batch of 1 tiled to the
    latent batch; a batch or size that does not give
    ``ldm_sampling.latent_shape`` raises.  Returns float32 [B, H, W, 3]."""
    sampling = config["ldm_sampling"]
    shape = tuple(sampling["latent_shape"])
    image = np.load(path)
    if image.ndim == 3:
        image = image[None]
    if image.dtype == np.uint8:
        image = image.astype(np.float32) / 127.5 - 1.0
    if image.shape[0] == 1 and shape[0] > 1:
        image = np.tile(image, (shape[0], 1, 1, 1))
    if image.shape[0] != shape[0]:
        raise ValueError(
            f"init image batch {image.shape[0]} != latent batch {shape[0]}"
        )
    # the AE downsamples by 2^(levels-1); the encoded latent must land
    # exactly on ldm_sampling.latent_shape
    ae_key = ("autoencoder_kl" if sampling.get("autoencoder_type", "kl") == "kl"
              else "autoencoder_vq")
    factor = 2 ** (len(config[ae_key]["multipliers"]) - 1)
    want_hw = (shape[1] * factor, shape[2] * factor)
    if image.shape[1:3] != want_hw:
        raise ValueError(
            f"init image is {image.shape[1:3]}, but latent_shape {shape[1:3]} "
            f"with the f{factor} autoencoder needs {want_hw}"
        )
    return np.asarray(image, np.float32)


def load_mask(path: str, latent_shape) -> np.ndarray:
    """The mask ``.npy`` ([H, W] or [B, H, W], 1 = regenerate) resized to the
    latent grid as the JAX CLI resizes it: float32 [B, h, w, 1]."""
    m = np.load(path).astype(np.float32)
    if m.ndim == 2:
        m = m[None]
    rows = nearest_resize_indices(m.shape[1], latent_shape[1])
    cols = nearest_resize_indices(m.shape[2], latent_shape[2])
    return m[:, rows][:, :, cols][..., None]


def main(argv=None) -> torch.Tensor | None:
    """Run the CLI; returns the decoded images (also saved as uint8 to
    ``images.npy`` in the working directory by rank 0), every data
    coordinate's rows gathered, on every rank."""
    from ldm_tf2_tpu_torch.checkpoints.bridge import load_params, read_blob
    from ldm_tf2_tpu_torch.configs.loader import load_config
    from ldm_tf2_tpu_torch.data.tokenizer import cfg_token_ids, load_tokenizer
    from ldm_tf2_tpu_torch.parallel import (
        create_mesh, gather_rows, maybe_initialize_distributed,
    )

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config_path", required=True)
    parser.add_argument("--params_blob", required=True,
                        help="blob path without the .bin/.json suffix")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    config = load_config(args.config_path)
    sampling = config["ldm_sampling"]
    sampler = check_sampling(sampling)
    save_progress = bool(sampling.get("sample_save_progress", False))
    init_image_path = sampling.get("init_image_path")
    device = factory.resolve_device(maybe_initialize_distributed(args.device))
    mesh = create_mesh(config["tpu"].get("mesh"))
    say = print if mesh.rank == 0 else (lambda *a: None)
    factory.set_float32_precision()
    factory.apply_tpu_settings(config)
    shape = tuple(sampling["latent_shape"])
    n_data = mesh.shape["data"]
    rank = mesh.rank
    if shape[0] % n_data == 0:
        say(f"[INFO] Sampling data-parallel over mesh {dict(mesh.shape)}.")
        rows_mesh = mesh
    else:
        say(f"[INFO] Batch {shape[0]} not divisible by data axis {n_data}; every "
            "data coordinate samples every row.")
        rows_mesh = None
    init_image = mask = None
    if init_image_path:
        init_image = load_init_image(init_image_path, config)
        if sampling.get("mask_path"):
            mask = torch.as_tensor(load_mask(sampling["mask_path"], shape),
                                   device=device)

    say("[INFO] Building models and loading the params blob...")
    blob = read_blob(args.params_blob)
    cond_model = load_params(factory.build_cond_model(config, device),
                             blob["cond_stage_model"])
    unet = load_params(factory.build_unet(config, device), blob["unet"])
    autoencoder = load_params(
        factory.build_autoencoder(config, sampling.get("autoencoder_type", "kl"),
                                  device, resolution=factory.sampling_resolution(config)),
        blob["autoencoder"])
    factory.apply_serving_modes(config, unet, autoencoder)
    apply_parallelism(config, mesh, (cond_model, unet, autoencoder), say)
    schedule = factory.build_schedule(config)

    token_ids = cfg_token_ids(
        load_tokenizer(sampling["vocab_dir"]), sampling["text_prompt"],
        shape[0], config["cond_stage_model"]["max_seq_len"],
        negative_prompt=sampling.get("negative_prompt", ""),
    )
    say(f"[INFO] Sampling: {sampler}, {schedule.num_ddim_steps} steps, eta "
        f"{schedule.eta}, guidance {sampling['guidance_scale']} on {device}...")
    say(f"[INFO] {describe(device)}.")
    kwargs = dict(
        guidance_scale=float(sampling["guidance_scale"]),
        guidance_rescale=float(sampling.get("guidance_rescale", 0.0)),
        scale_factor=config["ldm"]["scale_factor"], seed=args.seed,
        device=device, mesh=rows_mesh,
    )
    token_ids = torch.as_tensor(token_ids, dtype=torch.long)
    if rows_mesh is not None and mesh.distributed:
        token_ids, b = rank_rows(token_ids, shape[0], mesh)
        rows = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
        shape = (b,) + shape[1:]
        if init_image is not None:
            init_image = init_image[rows]
        if mask is not None and mask.shape[0] > 1:
            mask = mask[rows]
    if save_progress:
        images, _, sample_prog, pred_x0_prog = sample_txt2img_progressive(
            cond_model, unet, autoencoder, schedule, token_ids, shape, **kwargs)
    elif init_image is not None:
        images, _, _ = sample_img2img(
            cond_model, unet, autoencoder, schedule, token_ids, init_image,
            mask=mask, strength=float(sampling.get("strength", 0.75)), **kwargs)
    else:
        images, _ = sample_txt2img(
            cond_model, unet, autoencoder, schedule, token_ids, shape,
            sampler=sampler, cache_interval=int(sampling.get("cache_interval", 1)),
            cache_levels=int(sampling.get("cache_levels", 1)), **kwargs)
    images = gather_rows(images, rows_mesh)
    if save_progress:
        sample_prog = gather_rows(sample_prog, rows_mesh)
        pred_x0_prog = gather_rows(pred_x0_prog, rows_mesh)
    if rank:
        return images
    as_uint8 = lambda t: tensor_to_image(t.float().cpu().numpy())
    print("[INFO] Saving generated images to 'images.npy'...")
    np.save("images.npy", as_uint8(images))
    if save_progress:
        print("[INFO] Saving progressive samples to 'sample_prog.npy'...")
        np.save("sample_prog.npy", as_uint8(sample_prog))
        print("[INFO] Saving progressive pred_x0 to 'pred_x0_prog.npy'...")
        np.save("pred_x0_prog.npy", as_uint8(pred_x0_prog))
    return images


if __name__ == "__main__":
    main()
