"""Model assembly from the all-in-one config, and device selection.

Entry points run on the card: ``resolve_device("cuda")`` raises when no GPU
is present instead of carrying on on the CPU; the CPU is used only when a
caller asks for it.
"""

from __future__ import annotations

import torch

from ldm_tf2_tpu_torch.configs.loader import compute_dtype, weights_dtype
from ldm_tf2_tpu_torch.diffusion.schedule import DiffusionSchedule, make_schedule
from ldm_tf2_tpu_torch.models import (
    LPIPS, AutoencoderKL, AutoencoderVQ, Discriminator, TransformerModel, UNet,
)


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


def _build(cls, kwargs, config, device, dtype_key="weights_dtype"):
    with torch.device(device):
        model = cls(**kwargs, dtype=compute_dtype(config))
    dtype = torch.float32 if dtype_key is None else weights_dtype(config, dtype_key)
    return model.to(dtype).eval().requires_grad_(False)


def build_cond_model(config: dict, device="cpu",
                     dtype_key="weights_dtype") -> TransformerModel:
    """The text encoder without grad, its weights stored in
    ``tpu.<dtype_key>`` (``frozen_weights_dtype`` for the trainer's frozen
    copy; None for float32, the trainer's masters when it trains)."""
    return _build(TransformerModel, dict(config["cond_stage_model"]), config,
                  device, dtype_key)


def build_unet(config: dict, device="cpu") -> UNet:
    kwargs = dict(config["unet"])
    kwargs["context_channels"] = config["cond_stage_model"]["hidden_size"]
    return _build(UNet, kwargs, config, device)


def build_trainable_unet(config: dict, device="cpu", seed: int = 0) -> UNet:
    """A fresh U-Net for training: float32 masters that require grad,
    initialized by ``init_params_`` from ``seed``, computing in
    ``tpu.compute_dtype`` (the layers cast the weights to it)."""
    kwargs = dict(config["unet"])
    kwargs["context_channels"] = config["cond_stage_model"]["hidden_size"]
    with torch.device(device):
        unet = UNet(**kwargs, dtype=compute_dtype(config))
    return init_params_(unet, seed).float().requires_grad_(True)


def build_autoencoder(config: dict, ae_type: str = "kl", device="cpu",
                      dtype_key="weights_dtype", resolution: int | None = None):
    """The ``autoencoder_kl`` or ``autoencoder_vq`` section's model, its
    weights stored in ``tpu.<dtype_key>`` (None: float32, the AE trainer's
    masters).  ``resolution``: the image size the VQ model's attention
    blocks are built for (256 when not given, the repo config's)."""
    if ae_type == "kl":
        return _build(AutoencoderKL, dict(config["autoencoder_kl"]), config,
                      device, dtype_key)
    if ae_type == "vq":
        kwargs = dict(config["autoencoder_vq"])
        if resolution is not None:
            kwargs["resolution"] = resolution
        return _build(AutoencoderVQ, kwargs, config, device, dtype_key)
    raise ValueError(f"autoencoder type must be 'kl' or 'vq', got {ae_type!r}")


def sampling_resolution(config: dict) -> int:
    """The image size of the sampling paths: the latent size of
    ``ldm_sampling.latent_shape`` times the autoencoder's downsampling."""
    sampling = config["ldm_sampling"]
    section = ("autoencoder_vq" if sampling.get("autoencoder_type", "kl") == "vq"
               else "autoencoder_kl")
    return sampling["latent_shape"][1] * 2 ** (len(config[section]["multipliers"]) - 1)


def build_discriminator(config: dict, ae_type: str, device="cpu") -> Discriminator:
    """The ``ae_kl_discriminator`` or ``ae_vq_discriminator`` section's
    PatchGAN: float32 parameters that require grad, computing in
    ``tpu.compute_dtype``; fill them with ``init_params_`` or the bridge."""
    key = "ae_kl_discriminator" if ae_type == "kl" else "ae_vq_discriminator"
    with torch.device(device):
        model = Discriminator(**config[key], dtype=compute_dtype(config))
    return model.float()


def build_lpips(config: dict, device="cpu") -> LPIPS:
    """LPIPS without grad (frozen), its weights stored in
    ``tpu.frozen_weights_dtype``, computing in ``tpu.compute_dtype``."""
    return _build(LPIPS, {}, config, device, "frozen_weights_dtype")


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


def apply_tpu_settings(config: dict) -> None:
    """The process-wide settings of the config's ``tpu:`` section, as the
    JAX package's ``apply_tpu_settings``: ``tpu.attention_impl`` (see
    ``ops.attention.set_attention_impl``).  Called by every entry point."""
    from ldm_tf2_tpu_torch.ops.attention import set_attention_impl

    set_attention_impl(config["tpu"]["attention_impl"])


def apply_serving_modes(config: dict, unet: UNet, autoencoder) -> None:
    """Switch the built, loaded models into the serving modes the config
    asks for: ``tpu.quantize: int8`` (W8A8 U-Net ResBlock chains) and
    ``tpu.quantize_attention: int8pv`` (int8 P.V in the U-Net's and the
    autoencoder's self-attentions of 1024 or more tokens).  The only place
    that reads these two keys."""
    tpu = config["tpu"]
    pv_int8 = tpu["quantize_attention"] == "int8pv"
    unet.set_serving_modes(conv_quant=tpu["quantize"] == "int8",
                           attention_pv_int8=pv_int8)
    autoencoder.set_serving_modes(attention_pv_int8=pv_int8)


@torch.no_grad()
def init_params_(module: torch.nn.Module, seed: int):
    """flax's default initializers, by leaf name: norm ``scale`` ones,
    ``bias`` zeros, the VQ codebook glorot-uniform, every other ``kernel``
    lecun-normal (a normal truncated at
    two standard deviations, std sqrt(1 / fan_in) / 0.8796), fan_in being
    all input dims (Dense [in, out]: in; conv OIHW: I*H*W; projection
    split [D, H, S]: D; merge [H, S, D]: H*S).  Draws come from a generator
    seeded with ``seed`` on the parameters' device."""
    params = list(module.named_parameters())
    gen = torch.Generator(device=params[0][1].device).manual_seed(seed)
    for name, p in params:
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale":
            p.fill_(1.0)
        elif leaf == "bias":
            p.zero_()
        elif name.endswith("quantize.kernel"):  # the codebook: glorot uniform
            limit = (6.0 / (p.shape[0] + p.shape[1])) ** 0.5
            noise = torch.rand(p.shape, generator=gen, device=p.device)
            p.copy_(noise.mul_(2 * limit).sub_(limit))
        else:
            if p.dim() == 4:
                fan_in = p[0].numel()
            elif p.dim() == 3 and name.rsplit(".", 2)[-2] == "output":
                fan_in = p.shape[0] * p.shape[1]
            else:
                fan_in = p.shape[0]
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            noise = torch.empty(p.shape, device=p.device)
            torch.nn.init.trunc_normal_(noise, 0.0, std, -2 * std, 2 * std,
                                        generator=gen)
            p.copy_(noise)
    return module


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
