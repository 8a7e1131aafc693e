"""LPIPS perceptual loss (Zhang et al., arXiv:1801.03924), counterpart of
``ldm_tf2_tpu.models.lpips.LPIPS``.

A VGG16 feature extractor (five stages of explicit pad-1 + VALID 3x3 convs
with ReLU, a 2x2 max-pool between stages), the input shifted and scaled by
the constants below; each stage's features unit-normalized along channels
(``x / (||x|| + 1e-10)``: eps added to the norm, outside the square root),
squared difference, a per-stage Dense(1, no bias), the mean over H and W,
summed over the five stages: [B, 1, 1, 1].

LPIPS is frozen in training: its parameters take no gradient (the trainer
sets ``requires_grad_(False)``), while gradients flow through it to the
reconstruction.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ldm_tf2_tpu_torch.models.layers import Conv, Dense

# The JAX package's constants (models/lpips.py), kept as a copy.
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)

_STAGE_CHANNELS = (64, 128, 256, 512, 512)
_STAGE_DEPTHS = (2, 2, 3, 3, 3)


def _normalize(x, eps: float = 1e-10):
    return x / (torch.sqrt(torch.sum(x**2, dim=-1, keepdim=True)) + eps)


class VGG16(nn.Module):
    def __init__(self):
        super().__init__()
        cin = 3
        for i, (ch, depth) in enumerate(zip(_STAGE_CHANNELS, _STAGE_DEPTHS)):
            for j in range(depth):
                self.add_module(f"conv{i}_{j}", Conv(cin, ch))
                cin = ch

    def forward(self, x):
        """The five stages' feature maps (NHWC)."""
        features = []
        for i, depth in enumerate(_STAGE_DEPTHS):
            if i > 0:
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
            for j in range(depth):
                x = F.relu(getattr(self, f"conv{i}_{j}")(x, padding=1))
            features.append(x)
        return features


class LPIPS(nn.Module):
    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.vgg16 = VGG16()
        for i, ch in enumerate(_STAGE_CHANNELS):
            self.add_module(f"proj_{i}", Dense(ch, 1, bias=False))

    def forward(self, images1, images2):
        """Perceptual dissimilarity [B, 1, 1, 1] of two NHWC image batches
        in [-1, 1]; computed in ``dtype``."""
        dt = images1.dtype
        shift = torch.tensor(SHIFT, dtype=dt, device=images1.device)
        scale = torch.tensor(SCALE, dtype=dt, device=images1.device)
        feats1 = self.vgg16(((images1 - shift) / scale).to(self.dtype))
        feats2 = self.vgg16(((images2 - shift) / scale).to(self.dtype))
        total = 0.0
        for i in range(5):
            diff = (_normalize(feats1[i]) - _normalize(feats2[i])) ** 2
            proj = getattr(self, f"proj_{i}")(diff)
            total = total + proj.mean(dim=(1, 2), keepdim=True)
        return total
