"""Models of the PyTorch port (NHWC activations, flax-mirroring names)."""

from ldm_tf2_tpu_torch.models.autoencoder import AutoencoderKL, AutoencoderVQ
from ldm_tf2_tpu_torch.models.discriminator import Discriminator
from ldm_tf2_tpu_torch.models.distribution import DiagonalGaussian
from ldm_tf2_tpu_torch.models.lpips import LPIPS
from ldm_tf2_tpu_torch.models.quantize import VectorQuantizer
from ldm_tf2_tpu_torch.models.transformer import TransformerModel
from ldm_tf2_tpu_torch.models.unet import UNet

__all__ = ["AutoencoderKL", "AutoencoderVQ", "DiagonalGaussian", "Discriminator",
           "LPIPS", "TransformerModel", "UNet", "VectorQuantizer"]
