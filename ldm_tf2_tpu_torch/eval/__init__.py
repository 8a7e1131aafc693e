"""Sample-quality evaluation: FID (Fréchet distance over deep features)
and CLIP score (weights-gated)."""

from ldm_tf2_tpu_torch.eval.fid import (
    clip_score, compute_statistics, fid_from_features, frechet_distance,
    vgg_feature_extractor,
)
from ldm_tf2_tpu_torch.eval.inception import inception_feature_extractor

__all__ = ["clip_score", "compute_statistics", "fid_from_features",
           "frechet_distance", "inception_feature_extractor",
           "vgg_feature_extractor"]
