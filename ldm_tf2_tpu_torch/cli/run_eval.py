"""Sample-quality evaluation CLI of the port: FID (and optional CLIP
score), counterpart of ``ldm_tf2_tpu.cli.run_eval``:

    python -m ldm_tf2_tpu_torch.cli.run_eval \\
        --generated images.npy --real real_images.npy --lpips_blob lpips \\
        [--clip_weights_path <dir> --prompts_path prompts.txt] [--device cuda]

Inputs are .npy image stacks ([N, H, W, 3], uint8 or float in [-1, 1])
or directories of .npy stacks (concatenated).  ``--extractor vgg`` (the
default) uses the VGG16 trunk of the ``lpips`` artifact of
``--lpips_blob``: a perceptual "VGG-FID" that needs no download but is not
comparable to published numbers; ``--extractor inception
--inception_weights_path <pth>`` computes the standard InceptionV3 pool3
FID (``eval/inception.py``).  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np


def _as_batch(arr: np.ndarray, src: str) -> np.ndarray:
    """Promote one loaded array to [N, H, W, 3]."""
    if arr.ndim == 3:
        arr = arr[None]
    if arr.ndim != 4 or arr.shape[-1] != 3:
        raise ValueError(f"{src}: expected [N, H, W, 3], got {arr.shape}")
    return arr


def load_images(path: str) -> np.ndarray:
    """[N, H, W, 3] float32 in [-1, 1] from a .npy stack or a directory."""
    if os.path.isdir(path):
        files = sorted(glob.glob(os.path.join(path, "*.npy")))
        if not files:
            raise ValueError(f"no .npy files under {path}")
        # promote each file before concatenating: single-image [H, W, 3]
        # files would otherwise concatenate along H into one image
        stack = np.concatenate(
            [_as_batch(np.load(f), f) for f in files], axis=0
        )
    else:
        stack = _as_batch(np.load(path), path)
    if stack.dtype == np.uint8:
        stack = stack.astype(np.float32) / 127.5 - 1.0
    return np.asarray(stack, np.float32)


def evaluate(generated: np.ndarray, real: np.ndarray, extractor: str = "vgg",
             lpips_state=None, inception_weights_path: str | None = None,
             clip_weights_path: str | None = None, prompts=None,
             device="cuda") -> dict:
    """The CLI's result dict for two image stacks in [-1, 1]:
    ``lpips_state`` is the blob's ``lpips`` artifact (``--extractor
    vgg``)."""
    from ldm_tf2_tpu_torch.eval import (
        clip_score, fid_from_features, inception_feature_extractor,
        vgg_feature_extractor,
    )

    if clip_weights_path and not prompts:
        raise ValueError("--clip_weights_path requires --prompts_path")
    if extractor not in ("vgg", "inception"):
        raise ValueError(f"--extractor must be vgg|inception, got {extractor!r}")
    if generated.shape[1:] != real.shape[1:]:
        raise ValueError(
            f"shape mismatch: generated {generated.shape[1:]} vs real "
            f"{real.shape[1:]}"
        )
    if extractor == "inception":
        # raises with download instructions when the weights are absent
        features = inception_feature_extractor(inception_weights_path,
                                               device=device)
    else:
        if lpips_state is None:
            raise ValueError("--extractor vgg requires --lpips_blob")
        features = vgg_feature_extractor(lpips_state, device)
    fid = fid_from_features(features(real), features(generated))
    result = {
        "metric": "vgg_fid" if extractor == "vgg" else "inception_fid",
        "fid": round(fid, 6),
        "num_generated": int(generated.shape[0]),
        "num_real": int(real.shape[0]),
    }
    if clip_weights_path:
        result["clip_score"] = round(
            clip_score((generated + 1.0) * 127.5, prompts,
                       clip_weights_path=clip_weights_path, device=device),
            6,
        )
    return result


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--generated", required=True,
                        help=".npy stack (or dir of stacks) of generated images")
    parser.add_argument("--real", required=True,
                        help=".npy stack (or dir of stacks) of real images")
    parser.add_argument("--lpips_blob", default=None,
                        help="blob (without .bin/.json) whose lpips artifact "
                             "holds the VGG16 trunk")
    parser.add_argument("--clip_weights_path", default=None,
                        help="local transformers-format CLIP dir for CLIP score")
    parser.add_argument("--prompts_path", default=None,
                        help="text file, one prompt per line (for CLIP score)")
    parser.add_argument("--extractor", default="vgg",
                        help="vgg (LPIPS-trunk VGG-FID, not comparable to "
                             "published numbers) or inception (InceptionV3 "
                             "pool3; needs --inception_weights_path)")
    parser.add_argument("--inception_weights_path", default=None,
                        help="torchvision inception_v3 / pytorch-fid "
                             "state_dict (.pth)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    if args.clip_weights_path and not args.prompts_path:
        # checked before the FID pass, which it would otherwise waste
        raise ValueError("--clip_weights_path requires --prompts_path")
    prompts = None
    if args.prompts_path:
        with open(args.prompts_path) as f:
            prompts = [line.strip() for line in f if line.strip()]
    lpips_state = None
    if args.extractor == "vgg" and args.lpips_blob:
        from ldm_tf2_tpu_torch.checkpoints.blob import read_blob

        lpips_state = read_blob(args.lpips_blob)["lpips"]
    result = evaluate(
        load_images(args.generated), load_images(args.real), args.extractor,
        lpips_state, args.inception_weights_path, args.clip_weights_path,
        prompts, args.device,
    )
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
