"""VGG-FID between a generated and a real image set (counterpart of
``ldm_tf2_tpu.cli.run_quality_eval``):

    python -m ldm_tf2_tpu_torch.cli.run_quality_eval --config_path cfg.yaml \\
        --lpips_blob lpips --real images_real.npy --generated images.npy

Inputs are [N,H,W,3] uint8 (0..255) or float (-1..1) .npy stacks, e.g. the
sampler CLI's ``images.npy``.  The features are the VGG16 trunk of the
``lpips`` artifact of ``--lpips_blob``; for the published Inception FID use
``cli/run_eval.py --extractor inception``.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> float:
    from ldm_tf2_tpu_torch import factory
    from ldm_tf2_tpu_torch.checkpoints.blob import read_blob
    from ldm_tf2_tpu_torch.cli.run_eval import load_images
    from ldm_tf2_tpu_torch.configs.loader import load_config
    from ldm_tf2_tpu_torch.eval import fid_from_features, vgg_feature_extractor

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config_path", required=True)
    parser.add_argument("--lpips_blob", required=True,
                        help="blob (without .bin/.json) with an lpips artifact")
    parser.add_argument("--real", required=True,
                        help="the real image set (.npy [N,H,W,3])")
    parser.add_argument("--generated", required=True,
                        help="the generated image set (.npy [N,H,W,3])")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    factory.apply_tpu_settings(load_config(args.config_path))
    features = vgg_feature_extractor(read_blob(args.lpips_blob)["lpips"], args.device)
    real = load_images(args.real)
    generated = load_images(args.generated)
    print(f"[INFO] real {real.shape}, generated {generated.shape}")
    fid = fid_from_features(features(real), features(generated))
    print(f"[INFO] VGG-FID: {fid:.4f}")
    return fid


if __name__ == "__main__":
    main()
