"""Text-to-image sampling CLI of the PyTorch port.

One YAML and one weight blob in, ``images.npy`` out ([B, H, W, 3] uint8,
per-image min-max normalized), like ``ldm_tf2_tpu.cli.run_ldm_sampler``:

    python -m ldm_tf2_tpu_torch.cli.run_ldm_sampler \\
        --config_path ldm_tf2_tpu/configs/all_in_one_config.yaml \\
        --params_blob <path without .bin/.json> [--seed 0] [--device cuda]

The weights come from the single-blob artifact the JAX package exports
(``checkpoints/blob.py``).  Only DDIM txt2img sampling with the KL
autoencoder is ported; every other branch of the JAX CLI raises
``NotImplementedError`` naming its ROADMAP item.  The pipeline itself is
``sample_txt2img``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ldm_tf2_tpu_torch import factory
from ldm_tf2_tpu_torch.diffusion.sampler import ddim_sample_loop


def tensor_to_image(x) -> np.ndarray:
    """Per-image min-max normalize to uint8."""
    x = np.asarray(x, dtype=np.float32)
    flat = x.reshape(x.shape[0], -1)
    lo = flat.min(axis=1).reshape(-1, *([1] * (x.ndim - 1)))
    hi = flat.max(axis=1).reshape(-1, *([1] * (x.ndim - 1)))
    return ((x - lo) / (hi - lo) * 255).astype(np.uint8)


def sample_txt2img(cond_model, unet, autoencoder, schedule, token_ids, shape,
                   *, guidance_scale: float = 5.0,
                   guidance_rescale: float = 0.0, scale_factor: float = 0.18215,
                   seed: int = 0, init_noise=None, step_noises=None,
                   return_trajectory: bool = False, device="cuda"):
    """Text encode -> S-step CFG DDIM loop -> KL decode.

    token_ids: [2B, L] (unconditional rows first); shape: latent [B, h, w, c].
    The models must already be on ``device``.  Returns (images [B, H, W, 3]
    float, x0 latents), plus the [S, B, h, w, c] trajectory when asked.
    """
    device = factory.resolve_device(device)
    with torch.inference_mode():
        generator = torch.Generator(device=device).manual_seed(seed)
        context = cond_model(torch.as_tensor(token_ids, device=device))
        out = ddim_sample_loop(
            unet, schedule, context, shape, generator,
            guidance_scale=guidance_scale, guidance_rescale=guidance_rescale,
            init_noise=init_noise, step_noises=step_noises,
            return_trajectory=return_trajectory,
        )
        x0, traj = out if return_trajectory else (out, None)
        images = autoencoder.decode(x0 / scale_factor)
    if return_trajectory:
        return images, x0, traj
    return images, x0


_UNSUPPORTED = (
    (lambda s, c: s.get("sampler", "ddim") != "ddim",
     "samplers other than ddim (ROADMAP queue A item 8)"),
    (lambda s, c: s.get("sample_save_progress", False),
     "sample_save_progress (ROADMAP queue A item 8)"),
    (lambda s, c: s.get("cache_interval", 1) > 1,
     "DeepCache cache_interval > 1 (ROADMAP queue A item 8)"),
    (lambda s, c: s.get("init_image_path") or s.get("mask_path"),
     "img2img / inpainting (ROADMAP queue A item 8)"),
    (lambda s, c: s.get("autoencoder_type", "kl") != "kl",
     "the VQ autoencoder (ROADMAP queue A item 9)"),
    (lambda s, c: c["tpu"]["quantize"] != "none"
     or c["tpu"]["quantize_attention"] != "none",
     "int8 serving modes (ROADMAP queue A item 10)"),
    (lambda s, c: c["tpu"]["sequence_parallel"] or c["tpu"]["tensor_parallel"],
     "sequence / tensor parallelism (ROADMAP queue A item 13)"),
)


def check_supported(config: dict) -> None:
    sampling = config.get("ldm_sampling") or {}
    for unsupported, what in _UNSUPPORTED:
        if unsupported(sampling, config):
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
    check_supported(config)
    device = factory.resolve_device(args.device)
    factory.set_float32_precision()
    sampling = config["ldm_sampling"]

    print("[INFO] Building models and loading the params blob...")
    blob = read_blob(args.params_blob)
    cond_model = load_params(factory.build_cond_model(config, device),
                             blob["cond_stage_model"])
    unet = load_params(factory.build_unet(config, device), blob["unet"])
    autoencoder = load_params(factory.build_autoencoder(config, "kl", device),
                              blob["autoencoder"])
    schedule = factory.build_schedule(config)

    shape = tuple(sampling["latent_shape"])
    token_ids = cfg_token_ids(
        load_tokenizer(sampling["vocab_dir"]), sampling["text_prompt"],
        shape[0], config["cond_stage_model"]["max_seq_len"],
        negative_prompt=sampling.get("negative_prompt", ""),
    )
    print(f"[INFO] Sampling: ddim, {schedule.num_ddim_steps} steps, eta "
          f"{schedule.eta}, guidance {sampling['guidance_scale']} on {device}...")
    images, _ = sample_txt2img(
        cond_model, unet, autoencoder, schedule,
        torch.as_tensor(token_ids, dtype=torch.long), shape,
        guidance_scale=float(sampling["guidance_scale"]),
        guidance_rescale=float(sampling.get("guidance_rescale", 0.0)),
        scale_factor=config["ldm"]["scale_factor"], seed=args.seed,
        device=device,
    )
    print("[INFO] Saving generated images to 'images.npy'...")
    np.save("images.npy", tensor_to_image(images.float().cpu().numpy()))


if __name__ == "__main__":
    main()
