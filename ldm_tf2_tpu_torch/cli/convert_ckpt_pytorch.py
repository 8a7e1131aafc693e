"""CompVis txt2img-f8-large PyTorch checkpoint -> the port's weight blob
(counterpart of ``ldm_tf2_tpu.cli.convert_ckpt_pytorch_to_jax``):

    python -m ldm_tf2_tpu_torch.cli.convert_ckpt_pytorch \\
        --pytorch_ckpt_path model.ckpt --config_path config.yaml --out_dir .
    python -m ldm_tf2_tpu_torch.cli.convert_ckpt_pytorch \\
        --pytorch_ckpt_path model.ckpt --validate_only

The JAX CLI writes three Orbax artifacts.  The port reads no Orbax
(``checkpoints/manager.py``), so this CLI writes one blob
(``<out_dir>/params.bin/.json``) with the artifacts
``cond_stage_model``, ``unet`` and ``autoencoder`` (KL or VQ, by
``ldm_sampling.autoencoder_type``), in the JAX package's tree layout: the
blob the port's sampler, server and LDM trainer take as ``--params_blob``,
and that ``ldm_tf2_tpu.checkpoints.blob.load_blob`` reads as well.  Beside
it, ``conversion_manifest.json`` holds each tensor's shape, dtype, a
sha256 prefix and its sum.  Coverage is verified against the port's own
models, built on the meta device (``--no-verify`` skips it).
``--validate_only`` diffs the checkpoint's keys and shapes against the key
manifest and prints a go/no-go verdict without converting (exit 0 = go).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os

import numpy as np


def default_manifest_path() -> str:
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, "tests", "goldens", "compvis_key_manifest.json")


def validate_state_dict(sd, manifest: dict):
    """Diff ``sd`` (key -> array-like with .shape) against the key manifest.

    Returns (ok, report_lines): ok is True when every model key the
    conversion reads is present at the expected shape.  Keys the conversion
    ignores (schedule buffers, EMA shadows) and unknown extras are reported
    but do not block.
    """
    expected = manifest["model_keys"]
    ignored = set(manifest["ignored_keys"])
    lines = []

    def shape_of(v):
        return list(getattr(v, "shape", np.shape(v)))

    missing = sorted(k for k in expected if k not in sd)
    mismatched = sorted(
        k for k in expected
        if k in sd and shape_of(sd[k]) != list(expected[k])
    )
    extra = sorted(k for k in sd if k not in expected and k not in ignored)

    for k in missing:
        lines.append(f"MISSING  {k}  expected shape {expected[k]}")
    for k in mismatched:
        lines.append(
            f"SHAPE    {k}  expected {expected[k]}, "
            f"got {shape_of(sd[k])}"
        )
    for k in extra:
        lines.append(f"EXTRA    {k}  (unknown key; conversion ignores it)")

    ok = not missing and not mismatched
    lines.append(
        f"{len(expected) - len(missing) - len(mismatched)}/{len(expected)} "
        f"model keys match; {len(missing)} missing, {len(mismatched)} "
        f"shape mismatches, {len(extra)} unknown extras"
    )
    lines.append("GO: state_dict matches the CompVis manifest — run the "
                 "conversion" if ok else
                 "NO-GO: state_dict does not match the CompVis manifest")
    return ok, lines


def get_state_dict(path: str) -> dict:
    """torch.load -> {key: np.ndarray}.  The CompVis checkpoint pickles
    Lightning objects beside the weights, so this needs
    ``weights_only=False``: load only checkpoints you trust."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=False)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
            for k, v in sd.items()}


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _flatten(tree[key], prefix + (key,))
    else:
        yield prefix, tree


def _checksum(arr: np.ndarray) -> dict:
    return {
        "shape": list(arr.shape),
        "dtype": str(arr.dtype),
        "sha256": hashlib.sha256(arr.tobytes()).hexdigest()[:16],
        "sum": float(arr.sum()),
    }


def _checksum_manifest(params) -> dict:
    """{leaf path: shape, dtype, sha256 prefix, sum}; the leaves are hashed
    on a thread pool (hashlib and numpy release the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    leaves = list(_flatten(params))
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        sums = pool.map(lambda leaf: _checksum(np.asarray(leaf)), [v for _, v in leaves])
        return {"/".join(path): entry for (path, _), entry in zip(leaves, sums)}


def reference_trees(config: dict, ae_type: str) -> dict:
    """The port's models' param trees in the JAX layout, on the meta device
    (shapes only, nothing allocated)."""
    from ldm_tf2_tpu_torch import factory
    from ldm_tf2_tpu_torch.checkpoints.bridge import params_to_jax

    return {
        "cond_stage_model": params_to_jax(factory.build_cond_model(config, "meta")),
        "unet": params_to_jax(factory.build_unet(config, "meta")),
        "autoencoder": params_to_jax(factory.build_autoencoder(config, ae_type, "meta")),
    }


def convert_state_dict(sd, config: dict, verify: bool = True) -> dict:
    """CompVis state_dict -> {"cond_stage_model", "unet", "autoencoder"}
    trees of numpy arrays, each verified against the port's model when
    ``verify``."""
    from ldm_tf2_tpu_torch.checkpoints.convert_pytorch import (
        convert_autoencoder_kl, convert_autoencoder_vq, convert_transformer,
        convert_unet,
    )

    cond_cfg, unet_cfg = config["cond_stage_model"], config["unet"]
    ae_type = (config.get("ldm_sampling") or {}).get("autoencoder_type", "kl")
    refs = reference_trees(config, ae_type) if verify else {}
    print("[INFO] Converting transformer...")
    cond = convert_transformer(
        sd, num_layers=cond_cfg["encoder_stack_size"],
        num_heads=cond_cfg["num_heads"],
        reference_params=refs.get("cond_stage_model"),
    )
    print("[INFO] Converting unet...")
    unet = convert_unet(
        sd, num_blocks=unet_cfg["num_blocks"],
        channel_mult=tuple(unet_cfg["channel_mult"]),
        num_heads=unet_cfg["num_heads"], reference_params=refs.get("unet"),
    )
    print(f"[INFO] Converting autoencoder ({ae_type})...")
    ae_cfg = config["autoencoder_kl" if ae_type == "kl" else "autoencoder_vq"]
    convert_ae = convert_autoencoder_kl if ae_type == "kl" else convert_autoencoder_vq
    ae = convert_ae(
        sd, num_blocks=ae_cfg["num_blocks"],
        multipliers=tuple(ae_cfg["multipliers"]),
        reference_params=refs.get("autoencoder"),
    )
    return {"cond_stage_model": cond, "unet": unet, "autoencoder": ae}


def convert_checkpoint(ckpt_path: str, config: dict, out_dir: str,
                       verify: bool = True, sd: dict | None = None) -> dict:
    """The conversion the CLI runs: the checkpoint (``sd``, when already
    loaded from ``ckpt_path``) -> ``<out_dir>/params`` and
    ``conversion_manifest.json``; returns the converted trees."""
    from ldm_tf2_tpu_torch.checkpoints.blob import export_blob

    if sd is None:
        sd = get_state_dict(ckpt_path)
        print(f"[INFO] Loaded state_dict with {len(sd)} tensors.")
    artifacts = convert_state_dict(sd, config, verify=verify)
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "params")
    print(f"[INFO] Saving {out}.bin/.json ...")
    export_blob(out, artifacts)
    manifest = {name: _checksum_manifest(tree) for name, tree in artifacts.items()}
    manifest_path = os.path.join(out_dir, "conversion_manifest.json")
    with open(manifest_path, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    print(f"[INFO] Wrote per-tensor checksum manifest to {manifest_path}")
    return artifacts


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--pytorch_ckpt_path", required=True)
    parser.add_argument("--config_path", help="all-in-one YAML config")
    parser.add_argument("--out_dir", default=".")
    parser.add_argument("--verify", action=argparse.BooleanOptionalAction,
                        default=True,
                        help="check every leaf against the port's models")
    parser.add_argument("--validate_only", action="store_true",
                        help="diff keys and shapes against the key manifest, "
                             "print go/no-go, convert nothing (exit 0 = go)")
    parser.add_argument("--key_manifest_path", default="",
                        help="key manifest for --validate_only (default: "
                             "tests/goldens/compvis_key_manifest.json)")
    args = parser.parse_args(argv)
    if not args.validate_only and not args.config_path:
        parser.error("--config_path is required unless --validate_only")

    sd = get_state_dict(args.pytorch_ckpt_path)
    print(f"[INFO] Loaded state_dict with {len(sd)} tensors.")
    if args.validate_only:
        with open(args.key_manifest_path or default_manifest_path()) as f:
            manifest = json.load(f)
        ok, lines = validate_state_dict(sd, manifest)
        for line in lines:
            print(f"[VALIDATE] {line}")
        return 0 if ok else 1

    from ldm_tf2_tpu_torch.configs.loader import load_config

    convert_checkpoint(args.pytorch_ckpt_path, load_config(args.config_path),
                       args.out_dir, args.verify, sd=sd)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
