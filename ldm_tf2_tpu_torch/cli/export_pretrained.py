"""Export sampling weights from the port's training checkpoints as a weight
blob (counterpart of ``ldm_tf2_tpu.cli.export_pretrained``):

    python -m ldm_tf2_tpu_torch.cli.export_pretrained --config_path cfg.yaml \\
        --which ldm --params_blob pretrained --out_dir exported [--no-use_ema]
    python -m ldm_tf2_tpu_torch.cli.export_pretrained --config_path cfg.yaml \\
        --which autoencoder --out_dir exported
    python -m ldm_tf2_tpu_torch.cli.export_pretrained --config_path cfg.yaml \\
        --which serving --params_blob exported/params --dtype bfloat16 \\
        --out_dir serving

* ``--which ldm`` reads the newest ``ckpt-<step>.pt`` under
  ``ldm_training.ckpt_path`` and exports the U-Net (and the text encoder
  when the run trained it): the EMA weights when the checkpoint has them
  and ``--use_ema`` is on (the default), the live weights otherwise.  A run
  whose text encoder was frozen saved none (``"cond": None``): its
  ``cond_stage_model`` is taken unchanged from ``--params_blob``, the blob
  the run trained from, which must then be given.
* ``--which autoencoder`` exports the ``autoencoder`` of the newest
  checkpoint under ``autoencoder_training.ckpt_path``.
* ``--which serving`` re-writes the ``--params_blob`` blob.

Artifacts of ``--params_blob`` that the export does not produce are
carried over, so the output is a whole sampling blob whenever one is
given.  ``--dtype bfloat16`` casts float32 leaves (and only those): the
bf16 blob halves the bytes to read and samples bit for bit as the float32
blob under ``tpu.weights_dtype: bfloat16``, which rounds the same way at
load.  The output is ``<out_dir>/params.bin/.json``, the leaves in
the JAX package's layout (``checkpoints/bridge.py::params_to_jax``).
"""

from __future__ import annotations

import argparse
import os

import torch

_DTYPES = {"": None, "bfloat16": torch.bfloat16, "float32": torch.float32}


def cast_tree(tree, dtype: torch.dtype | None):
    """Cast the float32 leaves of a tree of tensors to ``dtype``."""
    if dtype is None:
        return tree
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.dtype == torch.float32 else tree


def _restore_latest(ckpt_dir: str) -> dict:
    from ldm_tf2_tpu_torch.checkpoints.manager import CheckpointManager

    restored = CheckpointManager(ckpt_dir).restore_latest(map_location="cpu")
    if restored is None:
        raise SystemExit(f"no checkpoints under {ckpt_dir}")
    print(f"[INFO] Restored training checkpoint at step {restored[0]}.")
    return restored[1]


def _with_ema(state: dict, ema: dict | None, prefix: str) -> dict:
    """``state`` with every entry the EMA holds under ``prefix`` replaced."""
    if ema is None:
        return state
    out = dict(state)
    for name, value in ema.items():
        if name.startswith(prefix):
            out[name[len(prefix):]] = value
    return out


def ldm_artifacts(saved: dict, use_ema: bool, base: dict | None) -> dict:
    """The U-Net's (and a trained text encoder's) trees from an LDM
    checkpoint dict; a frozen encoder's from ``base`` (a read blob)."""
    from ldm_tf2_tpu_torch.checkpoints.bridge import params_to_jax

    ema = saved.get("ema") if use_ema else None
    if use_ema and ema is None:
        print("[INFO] No EMA in checkpoint; exporting live weights.")
    elif ema is not None:
        print("[INFO] Exporting EMA weights.")
    out = {"unet": params_to_jax(_with_ema(saved["unet"], ema, "unet."))}
    if saved["cond"] is not None:
        out["cond_stage_model"] = params_to_jax(_with_ema(saved["cond"], ema, "cond."))
    elif base is None or "cond_stage_model" not in base:
        raise SystemExit(
            "the checkpoint holds no text encoder (ldm_training.train_cond_model "
            "was false): pass --params_blob, the blob the run trained from, "
            "for its cond_stage_model"
        )
    else:
        out["cond_stage_model"] = base["cond_stage_model"]
    return out


def main(argv=None) -> None:
    from ldm_tf2_tpu_torch.checkpoints.blob import export_blob, read_blob
    from ldm_tf2_tpu_torch.checkpoints.bridge import params_to_jax
    from ldm_tf2_tpu_torch.configs.loader import load_config

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config_path", required=True)
    parser.add_argument("--which", default="ldm",
                        choices=("ldm", "autoencoder", "serving"))
    parser.add_argument("--use_ema", action=argparse.BooleanOptionalAction,
                        default=True,
                        help="prefer EMA weights when the checkpoint has them")
    parser.add_argument("--dtype", default="", choices=tuple(_DTYPES),
                        help="cast float32 leaves on export ('' keeps them)")
    parser.add_argument("--params_blob", default=None,
                        help="blob whose other artifacts are carried over "
                             "(required for --which serving, and for ldm "
                             "when the text encoder was frozen)")
    parser.add_argument("--out_dir", default="exported")
    args = parser.parse_args(argv)

    config = load_config(args.config_path)
    base = read_blob(args.params_blob) if args.params_blob else None
    if args.which == "serving":
        if base is None:
            raise SystemExit("--which serving re-writes --params_blob: pass it")
        exported = {}
    elif args.which == "autoencoder":
        saved = _restore_latest(config["autoencoder_training"]["ckpt_path"])
        exported = {"autoencoder": params_to_jax(saved["autoencoder"])}
    else:
        saved = _restore_latest(config["ldm_training"]["ckpt_path"])
        exported = ldm_artifacts(saved, args.use_ema, base)
    artifacts = {**(base or {}), **exported}
    artifacts = {k: cast_tree(v, _DTYPES[args.dtype]) for k, v in artifacts.items()}

    os.makedirs(args.out_dir, exist_ok=True)
    out = os.path.join(args.out_dir, "params")
    print(f"[INFO] Saving {sorted(artifacts)} to {out}.bin/.json "
          f"(dtype={args.dtype or 'as-is'})...")
    export_blob(out, artifacts)
    print("[INFO] Done. Pass it to the sampler or the server as --params_blob.")


if __name__ == "__main__":
    main()
