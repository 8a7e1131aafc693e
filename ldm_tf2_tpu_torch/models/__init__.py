"""Models of the PyTorch port (NHWC activations, flax-mirroring names)."""

from ldm_tf2_tpu_torch.models.autoencoder import AutoencoderKL
from ldm_tf2_tpu_torch.models.distribution import DiagonalGaussian
from ldm_tf2_tpu_torch.models.transformer import TransformerModel
from ldm_tf2_tpu_torch.models.unet import UNet

__all__ = ["AutoencoderKL", "DiagonalGaussian", "TransformerModel", "UNet"]
