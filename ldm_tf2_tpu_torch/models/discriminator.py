"""PatchGAN discriminator for adversarial autoencoder training (counterpart
of ``ldm_tf2_tpu.models.discriminator.Discriminator``).

4x4 convs on a zero pad of 1 (the JAX package's explicit pad, then VALID): ``conv_0`` stride 2 with a bias,
then ``num_layers - 1`` stride-2 and one stride-1 conv without bias, each
followed by BatchNorm, all by LeakyReLU(0.2); a final 1-channel
``conv_out`` with a bias.

The BatchNorm is flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``, not
``nn.BatchNorm2d``, and is written out because the two differ: the batch
statistics are float32 whatever the compute dtype; the variance is the
fast one, E[x^2] - mean^2, clamped at 0; the running variance takes that
*biased* batch variance; and momentum weights the old value,
``ra = 0.9 * ra + 0.1 * batch``.  The running statistics are the buffers
``mean`` and ``var`` (flax's ``batch_stats`` collection), updated in place
by each training-mode call.  Data-parallel training passes ``sum_ranks``
(``parallel.all_reduce_sum``): the float32 sums of x and x^2 and the count
are summed over the ranks before the statistics are taken, so they are the
global batch's on every rank, differentiably.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ldm_tf2_tpu_torch.models.layers import Conv, Norm


class BatchNorm(Norm):
    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__(features)
        self.momentum, self.eps = momentum, eps
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x, training: bool = False, sum_ranks=None):
        xf = x.float()
        if training:
            c = xf.shape[-1]
            count = torch.full((1,), float(xf[..., 0].numel()), device=xf.device)
            sums = torch.cat([xf.sum(dim=(0, 1, 2)), (xf * xf).sum(dim=(0, 1, 2)), count])
            if sum_ranks is not None:
                sums = sum_ranks(sums)
            mean = sums[:c] / sums[2 * c]
            var = torch.clamp(sums[c:2 * c] / sums[2 * c] - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean.detach())
                self.var.copy_(m * self.var + (1 - m) * var.detach())
        else:
            mean, var = self.mean.float(), self.var.float()
        mul = torch.rsqrt(var + self.eps) * self.scale.float()
        y = (xf - mean) * mul + self.bias.float()
        return y.to(x.dtype)


class Discriminator(nn.Module):
    def __init__(self, channels: int = 64, num_layers: int = 3,
                 dtype=torch.float32):
        super().__init__()
        self.dtype, self.num_layers = dtype, num_layers
        self.conv_0 = Conv(3, channels, 4)
        ch = channels
        for n in range(1, num_layers + 1):
            out = min(2**n, 8) * channels
            self.add_module(f"conv_{n}", Conv(ch, out, 4, bias=False))
            self.add_module(f"bn_{n}", BatchNorm(out))
            ch = out
        self.conv_out = Conv(ch, 1, 4)

    def forward(self, x, training: bool = False, sum_ranks=None):
        """Patch logits [B, H', W', 1]; ``training`` normalizes with the
        batch's statistics (the global batch's under ``sum_ranks``) and
        updates the running ones."""
        x = F.leaky_relu(self.conv_0(x.to(self.dtype), stride=2, padding=1), 0.2)
        for n in range(1, self.num_layers + 1):
            stride = 2 if n < self.num_layers else 1
            x = getattr(self, f"conv_{n}")(x, stride=stride, padding=1)
            x = F.leaky_relu(getattr(self, f"bn_{n}")(x, training, sum_ranks), 0.2)
        return self.conv_out(x, stride=1, padding=1)
