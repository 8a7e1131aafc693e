"""Text-to-image sampling CLI of the PyTorch port.

One YAML and one weight blob in, ``images.npy`` out ([B, H, W, 3] uint8,
per-image min-max normalized), like ``ldm_tf2_tpu.cli.run_ldm_sampler``:

    python -m ldm_tf2_tpu_torch.cli.run_ldm_sampler \\
        --config_path ldm_tf2_tpu/configs/all_in_one_config.yaml \\
        --params_blob <path without .bin/.json> [--seed 0] [--device cuda]

The weights come from the single-blob artifact the JAX package exported
(``checkpoints/blob.py``).  ``ldm_sampling.sampler`` picks the loop, with
the JAX CLI's table and checks: ``ddim`` (default), ``ddpm``, ``plms`` or
``dpm_solver_pp_2m``.  ``ldm_sampling.sample_save_progress`` (DDIM only)
also writes ``sample_prog.npy`` and ``pred_x0_prog.npy`` ([B, records, H,
W, 3] uint8, every 5th step decoded).  ``ldm_sampling.autoencoder_type:
vq`` decodes with the VQ autoencoder, quantizing the latents first
(``force_quantize``), as the JAX CLI does.  DeepCache, img2img and
inpainting and a device mesh raise ``NotImplementedError`` naming their
ROADMAP item.  The serving modes ``tpu.quantize: int8`` and
``tpu.quantize_attention: int8pv`` apply here as in the JAX CLI, which
honours both (``factory.apply_serving_modes``).  The pipeline itself is
``sample_txt2img`` (``sample_txt2img_progressive`` with the progress
records).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ldm_tf2_tpu_torch import factory
from ldm_tf2_tpu_torch.diffusion.sampler import (
    ddim_sample_loop, ddim_sample_loop_progressive, ddpm_sample_loop,
)
from ldm_tf2_tpu_torch.diffusion.solvers import (
    dpm_solver_pp_2m_sample_loop, plms_sample_loop,
)
from ldm_tf2_tpu_torch.models import AutoencoderVQ

# ldm_sampling.sampler -> loop, the JAX CLIs' table
SAMPLE_LOOPS = {
    "ddim": ddim_sample_loop,
    "ddpm": ddpm_sample_loop,
    "plms": plms_sample_loop,
    "dpm_solver_pp_2m": dpm_solver_pp_2m_sample_loop,
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


def decode_latents(autoencoder, z):
    """Images from latents (already divided by the scale factor): the VQ
    autoencoder quantizes them first, as the JAX CLIs decode with
    ``force_quantize=True``."""
    if isinstance(autoencoder, AutoencoderVQ):
        return autoencoder.decode(z, force_quantize=True)
    return autoencoder.decode(z)


def sample_txt2img(cond_model, unet, autoencoder, schedule, token_ids, shape,
                   *, sampler: str = "ddim", guidance_scale: float = 5.0,
                   guidance_rescale: float = 0.0, scale_factor: float = 0.18215,
                   seed: int = 0, init_noise=None, step_noises=None,
                   return_trajectory: bool = False, device="cuda"):
    """Text encode -> CFG sampling loop (``sampler``, a key of
    ``SAMPLE_LOOPS``) -> decode (``decode_latents``).

    token_ids: [2B, L] (unconditional rows first); shape: latent [B, h, w, c].
    The models must already be on ``device``.  ``step_noises`` (DDIM and
    DDPM) and ``return_trajectory`` (DDIM) are the loops' test hooks.
    Returns (images [B, H, W, 3] float, x0 latents), plus the [S, B, h, w, c]
    trajectory when asked.
    """
    device = factory.resolve_device(device)
    loop = SAMPLE_LOOPS[sampler]
    hooks = {}
    if step_noises is not None:
        hooks["step_noises"] = step_noises
    if return_trajectory:
        hooks["return_trajectory"] = True
    with torch.inference_mode():
        generator = torch.Generator(device=device).manual_seed(seed)
        context = cond_model(torch.as_tensor(token_ids, device=device))
        out = loop(
            unet, schedule, context, shape, generator,
            guidance_scale=guidance_scale, guidance_rescale=guidance_rescale,
            init_noise=init_noise, **hooks,
        )
        x0, traj = out if return_trajectory else (out, None)
        images = decode_latents(autoencoder, x0 / scale_factor)
    if return_trajectory:
        return images, x0, traj
    return images, x0


def sample_txt2img_progressive(cond_model, unet, autoencoder, schedule, token_ids,
                               shape, *, guidance_scale: float = 5.0,
                               guidance_rescale: float = 0.0,
                               scale_factor: float = 0.18215, seed: int = 0,
                               init_noise=None, step_noises=None, device="cuda"):
    """``sample_txt2img`` with DDIM's progress records
    (``ddim_sample_loop_progressive``, every 5th step), decoded in one
    autoencoder call.  Returns (images [B, H, W, 3], x0, sample_progress and
    pred_x0_progress images [B, records, H, W, 3])."""
    device = factory.resolve_device(device)
    with torch.inference_mode():
        generator = torch.Generator(device=device).manual_seed(seed)
        context = cond_model(torch.as_tensor(token_ids, device=device))
        x0, sample_prog, pred_x0_prog = ddim_sample_loop_progressive(
            unet, schedule, context, shape, generator,
            guidance_scale=guidance_scale, guidance_rescale=guidance_rescale,
            init_noise=init_noise, step_noises=step_noises,
        )
        records = sample_prog.shape[1]
        flat = torch.cat([x0[:, None], sample_prog, pred_x0_prog], dim=1)
        images = decode_latents(autoencoder,
                                flat.reshape(-1, *shape[1:]) / scale_factor)
        images = images.reshape(shape[0], 1 + 2 * records, *images.shape[1:])
    return (images[:, 0], x0, images[:, 1:1 + records],
            images[:, 1 + records:])


def _multi_device(config: dict) -> bool:
    mesh = config["tpu"].get("mesh") or {}
    return (config["tpu"]["sequence_parallel"] or config["tpu"]["tensor_parallel"]
            or any(size not in (-1, 1) for size in mesh.values()))


# Branches of the JAX CLIs not ported yet, as (test of (ldm_sampling,
# config), what).  The first two apply to the server too.
UNSUPPORTED_PIPELINE = (
    (lambda s, c: s.get("cache_interval", 1) > 1,
     "DeepCache cache_interval > 1 (ROADMAP queue A item A1)"),
    (lambda s, c: _multi_device(c),
     "a device mesh, sequence or tensor parallelism (ROADMAP queue A item A6)"),
)
_UNSUPPORTED = UNSUPPORTED_PIPELINE + (
    (lambda s, c: s.get("init_image_path") or s.get("mask_path"),
     "img2img / inpainting (ROADMAP queue A item A1)"),
)


def check_supported(config: dict, unsupported=_UNSUPPORTED) -> None:
    sampling = config.get("ldm_sampling") or {}
    for test, what in unsupported:
        if test(sampling, config):
            raise NotImplementedError(f"not ported yet: {what}")


def main(argv=None) -> None:
    from ldm_tf2_tpu_torch.checkpoints.bridge import load_params, read_blob
    from ldm_tf2_tpu_torch.configs.loader import load_config
    from ldm_tf2_tpu_torch.data.tokenizer import cfg_token_ids, load_tokenizer

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config_path", required=True)
    parser.add_argument("--params_blob", required=True,
                        help="blob path without the .bin/.json suffix")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    config = load_config(args.config_path)
    sampling = config["ldm_sampling"]
    sampler = sampler_name(sampling)
    save_progress = bool(sampling.get("sample_save_progress", False))
    if save_progress and sampler != "ddim":
        raise ValueError(
            "ldm_sampling.sample_save_progress only supports sampler: ddim"
        )
    check_supported(config)
    device = factory.resolve_device(args.device)
    factory.set_float32_precision()
    factory.apply_tpu_settings(config)

    print("[INFO] Building models and loading the params blob...")
    blob = read_blob(args.params_blob)
    cond_model = load_params(factory.build_cond_model(config, device),
                             blob["cond_stage_model"])
    unet = load_params(factory.build_unet(config, device), blob["unet"])
    autoencoder = load_params(
        factory.build_autoencoder(config, sampling.get("autoencoder_type", "kl"),
                                  device, resolution=factory.sampling_resolution(config)),
        blob["autoencoder"])
    factory.apply_serving_modes(config, unet, autoencoder)
    schedule = factory.build_schedule(config)

    shape = tuple(sampling["latent_shape"])
    token_ids = cfg_token_ids(
        load_tokenizer(sampling["vocab_dir"]), sampling["text_prompt"],
        shape[0], config["cond_stage_model"]["max_seq_len"],
        negative_prompt=sampling.get("negative_prompt", ""),
    )
    print(f"[INFO] Sampling: {sampler}, {schedule.num_ddim_steps} steps, eta "
          f"{schedule.eta}, guidance {sampling['guidance_scale']} on {device}...")
    kwargs = dict(
        guidance_scale=float(sampling["guidance_scale"]),
        guidance_rescale=float(sampling.get("guidance_rescale", 0.0)),
        scale_factor=config["ldm"]["scale_factor"], seed=args.seed,
        device=device,
    )
    token_ids = torch.as_tensor(token_ids, dtype=torch.long)
    if save_progress:
        images, _, sample_prog, pred_x0_prog = sample_txt2img_progressive(
            cond_model, unet, autoencoder, schedule, token_ids, shape, **kwargs)
    else:
        images, _ = sample_txt2img(cond_model, unet, autoencoder, schedule,
                                   token_ids, shape, sampler=sampler, **kwargs)
    as_uint8 = lambda t: tensor_to_image(t.float().cpu().numpy())
    print("[INFO] Saving generated images to 'images.npy'...")
    np.save("images.npy", as_uint8(images))
    if save_progress:
        print("[INFO] Saving progressive samples to 'sample_prog.npy'...")
        np.save("sample_prog.npy", as_uint8(sample_prog))
        print("[INFO] Saving progressive pred_x0 to 'pred_x0_prog.npy'...")
        np.save("pred_x0_prog.npy", as_uint8(pred_x0_prog))


if __name__ == "__main__":
    main()
