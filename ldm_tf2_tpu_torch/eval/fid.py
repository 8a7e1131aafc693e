"""Fréchet distance sample-quality metric (the port's copy of
``ldm_tf2_tpu.eval.fid``).

The Fréchet distance between the Gaussians of deep features of a generated
set and a real set (Heusel et al., arXiv:1706.08500), with a pluggable
feature extractor:

* ``vgg_feature_extractor``: the spatially pooled stage-4 and stage-5
  features of the LPIPS checkpoint's VGG16 trunk (``models/lpips.py``), a
  perceptual "VGG-FID" that needs no download.  With random weights the
  distance is still a valid two-sample discrepancy, useful for smoke tests
  and regression tracking, not comparable across papers.
* ``eval/inception.py::inception_feature_extractor``: InceptionV3 pool3,
  the published FID, when its weights are on disk.

The statistics and the distance are float64 numpy, as in the JAX package.
``clip_score`` needs pretrained CLIP weights and raises without them.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


def compute_statistics(features: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(mean [D], covariance [D, D]) of a feature matrix [N, D]."""
    features = np.asarray(features, dtype=np.float64)
    if features.ndim != 2:
        raise ValueError(f"expected [N, D] features, got {features.shape}")
    mu = features.mean(axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, np.atleast_2d(sigma)


def frechet_distance(
    mu1: np.ndarray, sigma1: np.ndarray,
    mu2: np.ndarray, sigma2: np.ndarray,
    eps: float = 1e-6,
) -> float:
    """d^2 = |mu1-mu2|^2 + Tr(s1 + s2 - 2 sqrt(s1 s2)).

    The matrix square root is taken on the symmetrized product via an
    eigendecomposition of s1^(1/2) s2 s1^(1/2) (numerically stabler than
    scipy.linalg.sqrtm on near-singular covariances; small negative
    eigenvalues from float error are clipped).
    """
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    sigma1 = np.asarray(sigma1, np.float64)
    sigma2 = np.asarray(sigma2, np.float64)

    diff = mu1 - mu2
    w1, v1 = np.linalg.eigh(sigma1)
    sqrt_s1 = (v1 * np.sqrt(np.clip(w1, 0.0, None))) @ v1.T
    inner = sqrt_s1 @ sigma2 @ sqrt_s1
    w = np.linalg.eigvalsh((inner + inner.T) / 2.0)
    tr_sqrt = np.sum(np.sqrt(np.clip(w, 0.0, None)))
    d2 = float(
        diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2.0 * tr_sqrt
    )
    return max(d2, 0.0)


def fid_from_features(
    real_features: np.ndarray, generated_features: np.ndarray
) -> float:
    m1, s1 = compute_statistics(real_features)
    m2, s2 = compute_statistics(generated_features)
    return frechet_distance(m1, s1, m2, s2)


def vgg_feature_extractor(
    lpips_state, device="cuda", batch_size: int = 16
) -> Callable[[np.ndarray], np.ndarray]:
    """features(images [N,H,W,3] in [-1,1]) -> [N, 1024] float32: the
    global average pools of VGG16's last two stages (512 + 512 channels).
    ``lpips_state``: the ``lpips`` artifact of a blob (a param tree with a
    ``vgg16`` subtree).  The trunk runs in float32 with TF32 off."""
    import torch

    from ldm_tf2_tpu_torch import factory
    from ldm_tf2_tpu_torch.checkpoints.bridge import load_params
    from ldm_tf2_tpu_torch.models.lpips import SCALE, SHIFT, VGG16

    device = factory.resolve_device(device)
    factory.set_float32_precision()
    with torch.device(device):
        vgg = VGG16().float().eval().requires_grad_(False)
    load_params(vgg, lpips_state["vgg16"])
    shift = torch.tensor(SHIFT, dtype=torch.float32, device=device)
    scale = torch.tensor(SCALE, dtype=torch.float32, device=device)

    @torch.no_grad()
    def features(images: np.ndarray) -> np.ndarray:
        images = np.asarray(images, np.float32)
        out = []
        for i in range(0, len(images), batch_size):
            x = torch.as_tensor(images[i:i + batch_size], device=device)
            feats = vgg((x - shift) / scale)
            pooled = [f.mean(dim=(1, 2)) for f in feats[-2:]]
            out.append(torch.cat(pooled, dim=-1).cpu().numpy())
        return np.concatenate(out, axis=0)

    return features


def clip_score(
    images: np.ndarray,
    prompts: list[str],
    clip_weights_path: str | None = None,
    batch_size: int = 16,
    device="cuda",
) -> float:
    """Mean CLIP text-image cosine similarity (the standard CLIP score,
    Hessel et al. arXiv:2104.08718, without the 2.5x rescale).

    Requires a local transformers-format CLIP checkpoint (e.g.
    openai/clip-vit-base-patch32 downloaded into a directory): a random
    text/image encoder measures nothing about alignment, so there is no
    offline fallback.

    Args:
      images: [N, H, W, 3] uint8 (or float in [0, 255]).
      prompts: N strings (or 1 string, tiled).
    """
    if clip_weights_path is None:
        raise RuntimeError(
            "CLIP score needs pretrained weights. Download "
            "openai/clip-vit-base-patch32 (transformers format) and pass "
            "clip_weights_path=<dir>."
        )
    import torch
    from transformers import CLIPModel, CLIPProcessor

    from ldm_tf2_tpu_torch import factory

    device = factory.resolve_device(device)
    images = np.asarray(images)
    if images.dtype != np.uint8:
        images = np.clip(images, 0, 255).astype(np.uint8)
    if isinstance(prompts, str):
        prompts = [prompts]
    if len(prompts) == 1:
        prompts = prompts * len(images)
    if len(prompts) != len(images):
        raise ValueError(
            f"{len(prompts)} prompts for {len(images)} images"
        )

    model = CLIPModel.from_pretrained(clip_weights_path).to(device).eval()
    processor = CLIPProcessor.from_pretrained(clip_weights_path)
    sims = []
    with torch.no_grad():
        for i in range(0, len(images), batch_size):
            inputs = processor(
                text=prompts[i:i + batch_size],
                images=list(images[i:i + batch_size]),
                return_tensors="pt",
                padding=True,
                truncation=True,
            ).to(device)
            out = model(**inputs)
            img = out.image_embeds / out.image_embeds.norm(
                dim=-1, keepdim=True
            )
            txt = out.text_embeds / out.text_embeds.norm(
                dim=-1, keepdim=True
            )
            sims.append((img * txt).sum(dim=-1).cpu().numpy())
    return float(np.mean(np.concatenate(sims)))
