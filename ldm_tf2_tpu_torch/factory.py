"""Model assembly from the all-in-one config, and device selection.

Entry points run on the card: ``resolve_device("cuda")`` raises when no GPU
is present instead of carrying on on the CPU; the CPU is used only when a
caller asks for it.
"""

from __future__ import annotations

import torch

from ldm_tf2_tpu_torch.configs.loader import compute_dtype, weights_dtype
from ldm_tf2_tpu_torch.diffusion.schedule import DiffusionSchedule, make_schedule
from ldm_tf2_tpu_torch.models import AutoencoderKL, TransformerModel, UNet


def resolve_device(device="cuda") -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return device


def set_float32_precision() -> None:
    """Keep float32 matmuls and convolutions in full float32 (no TF32).
    bfloat16 runs are unaffected by these flags."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _build(cls, kwargs, config, device):
    with torch.device(device):
        model = cls(**kwargs, dtype=compute_dtype(config))
    return model.to(weights_dtype(config)).eval().requires_grad_(False)


def build_cond_model(config: dict, device="cpu") -> TransformerModel:
    return _build(TransformerModel, dict(config["cond_stage_model"]), config,
                  device)


def build_unet(config: dict, device="cpu") -> UNet:
    kwargs = dict(config["unet"])
    kwargs["context_channels"] = config["cond_stage_model"]["hidden_size"]
    return _build(UNet, kwargs, config, device)


def build_autoencoder(config: dict, ae_type: str = "kl", device="cpu"):
    if ae_type != "kl":
        raise NotImplementedError(
            f"autoencoder type {ae_type!r}: only 'kl' is ported "
            "(AutoencoderVQ is ROADMAP queue A item 9)"
        )
    return _build(AutoencoderKL, dict(config["autoencoder_kl"]), config, device)


def build_schedule(config: dict) -> DiffusionSchedule:
    ldm = config["ldm"]
    return make_schedule(
        num_steps=ldm["num_steps"],
        beta_start=ldm["beta_start"],
        beta_end=ldm["beta_end"],
        v_posterior=ldm["v_posterior"],
        eta=ldm["eta"],
        num_ddim_steps=ldm["num_ddim_steps"],
        timestep_spacing=ldm.get("timestep_spacing", "uniform"),
    )


@torch.no_grad()
def randomize_(module: torch.nn.Module, seed: int, scale: float = 0.05):
    """Fill every parameter with N(0, 1) * ``scale`` drawn from a generator
    seeded with ``seed`` on the parameters' device (the seeded-weight
    convention of the JAX package's golden tests, whose ``WEIGHT_SCALE`` is
    0.05, keeps activations finite through full depth)."""
    params = list(module.parameters())
    gen = torch.Generator(device=params[0].device).manual_seed(seed)
    for p in params:
        noise = torch.randn(p.shape, generator=gen, device=p.device,
                            dtype=torch.float32)
        p.copy_(noise.mul_(scale))
    return module
