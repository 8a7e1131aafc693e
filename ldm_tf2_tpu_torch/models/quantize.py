"""Vector quantization (VQ-GAN codebook), counterpart of
``ldm_tf2_tpu.models.quantize.VectorQuantizer``.

The nearest-code search is the float32 squared-L2 distance
``x^2 + e^2 - 2 x e^T`` over a [vocab_size, hidden_size] codebook, the
product in float32 (no TF32 on the card: ``factory.set_float32_precision``);
``argmin`` takes the first index on ties.  The codebook loss keeps the JAX
package's (and its reference's) placement of beta, the reverse of the
VQ-VAE paper, as a definition:

    loss = mean((sg(q) - z)^2) + beta * mean((q - sg(z))^2)

and the straight-through estimator passes the decoder's gradient to the
encoder unchanged: ``z + sg(q - z)``.
"""

from __future__ import annotations

import torch
from torch import nn


class VectorQuantizer(nn.Module):
    """Codebook ``kernel`` [vocab_size, hidden_size]; ``forward(latents)``
    returns (quantized, codebook_loss, indices)."""

    def __init__(self, vocab_size: int, hidden_size: int, beta: float):
        super().__init__()
        self.hidden_size, self.beta = hidden_size, beta
        self.kernel = nn.Parameter(torch.empty(vocab_size, hidden_size))

    def forward(self, latents):
        codebook = self.kernel.float()
        flat = latents.reshape(-1, self.hidden_size).float()
        with torch.no_grad():
            distances = ((flat**2).sum(dim=1, keepdim=True)
                         + (codebook**2).sum(dim=1)
                         - 2.0 * (flat @ codebook.T))
            indices = torch.argmin(distances, dim=1)
        quantized = codebook[indices].reshape(latents.shape).to(latents.dtype)
        loss = (torch.mean((quantized.detach() - latents) ** 2)
                + self.beta * torch.mean((quantized - latents.detach()) ** 2))
        return latents + (quantized - latents).detach(), loss, indices
