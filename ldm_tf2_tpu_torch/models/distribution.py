"""Diagonal Gaussian posterior over latents (counterpart of
``ldm_tf2_tpu.models.distribution.DiagonalGaussian``); sampling takes an
explicit ``torch.Generator`` (or a ``parallel.RowSlice``)."""

from __future__ import annotations

import dataclasses

import torch

from ldm_tf2_tpu_torch.parallel import rng


@dataclasses.dataclass(frozen=True)
class DiagonalGaussian:
    """q(z|x) = N(mean, diag(exp(logvar))); build it with ``create``, which
    clips logvar to [-30, 20]."""

    mean: torch.Tensor
    logvar: torch.Tensor

    @classmethod
    def create(cls, mean, logvar) -> "DiagonalGaussian":
        return cls(mean=mean, logvar=torch.clamp(logvar, -30.0, 20.0))

    @property
    def std(self):
        return torch.exp(0.5 * self.logvar)

    def sample(self, generator: torch.Generator | None = None, noise=None):
        """mean + std * N(0, 1): the given ``noise`` (cast to the mean's
        dtype), or noise drawn from ``generator`` in the mean's dtype."""
        if noise is None:
            noise = rng.randn(self.mean.shape, generator, device=self.mean.device,
                              dtype=self.mean.dtype)
        return self.mean + self.std * noise.to(self.mean.dtype)

    def kl(self):
        """KL(q || N(0, I)) summed over [1, 2, 3]: [B], in the mean's
        dtype."""
        var = torch.exp(self.logvar)
        return 0.5 * torch.sum(self.mean**2 + var - 1.0 - self.logvar,
                               dim=(1, 2, 3))

    def mode(self):
        return self.mean
