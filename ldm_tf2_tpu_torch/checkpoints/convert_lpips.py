"""LPIPS weight conversion: the TF ``lpips.ckpt-1`` object checkpoint ->
the LPIPS param tree (the port's copy of
``ldm_tf2_tpu.checkpoints.convert_lpips``).

The checkpoint's variable names are clean object paths:

    lpips/_vgg16/_conv_layers/{stage}/{idx}/{kernel,bias}/.ATTRIBUTES/...
    lpips/_projs/{stage}/kernel/.ATTRIBUTES/...

They map onto ``vgg16/conv{stage}_{idx}`` and ``proj_{stage}``, the
layouts unchanged (HWIO convs, [in, 1] dense kernels).  The tree goes into
a weight blob under the artifact name ``lpips`` (``export_lpips_blob``),
which the AE trainer's ``--lpips_blob`` reads.  Reading the TF checkpoint
itself needs ``tensorflow``, imported only by
``convert_lpips_tf_checkpoint``.
"""

from __future__ import annotations

import re
from typing import Callable, Iterable

import numpy as np

_SUFFIX = "/.ATTRIBUTES/VARIABLE_VALUE"
_CONV_RE = re.compile(
    r"^lpips/_vgg16/_conv_layers/(\d+)/(\d+)/(kernel|bias)$"
)
_PROJ_RE = re.compile(r"^lpips/_projs/(\d+)/kernel$")


def convert_lpips_from_reader(
    names: Iterable[str], get_tensor: Callable[[str], np.ndarray]
) -> dict:
    """Build the LPIPS param tree from (variable name -> tensor) access."""
    params: dict = {"vgg16": {}}
    for full_name in names:
        if not full_name.endswith(_SUFFIX):
            continue
        name = full_name[: -len(_SUFFIX)]
        m = _CONV_RE.match(name)
        if m:
            stage, idx, kind = int(m.group(1)), int(m.group(2)), m.group(3)
            params["vgg16"].setdefault(f"conv{stage}_{idx}", {})[kind] = (
                np.asarray(get_tensor(full_name))
            )
            continue
        m = _PROJ_RE.match(name)
        if m:
            params[f"proj_{int(m.group(1))}"] = {
                "kernel": np.asarray(get_tensor(full_name))
            }

    # completeness: 13 convs (2+2+3+3+3) with kernel+bias, 5 projections
    depths = (2, 2, 3, 3, 3)
    for i, depth in enumerate(depths):
        for j in range(depth):
            conv = params["vgg16"].get(f"conv{i}_{j}", {})
            if "kernel" not in conv or "bias" not in conv:
                raise ValueError(f"lpips checkpoint missing conv{i}_{j}")
    for i in range(5):
        if f"proj_{i}" not in params:
            raise ValueError(f"lpips checkpoint missing proj_{i}")
    return params


def convert_lpips_tf_checkpoint(ckpt_prefix: str) -> dict:
    """Read a `tf.train.Checkpoint(lpips=...)` checkpoint (e.g. lpips.ckpt-1)
    and return the param tree."""
    try:
        import tensorflow as tf  # only needed for this one-time conversion
    except ImportError as e:
        raise ImportError(
            "reading the LPIPS TF checkpoint needs the 'tensorflow' package, "
            "which is not installed; convert on a machine that has it and "
            "copy the blob (export_lpips_blob) over"
        ) from e

    reader = tf.train.load_checkpoint(ckpt_prefix)
    names = list(reader.get_variable_to_shape_map())
    return convert_lpips_from_reader(names, reader.get_tensor)


def export_lpips_blob(path: str, params: dict) -> None:
    """Write the converted tree as the ``lpips`` artifact of a blob."""
    from ldm_tf2_tpu_torch.checkpoints.blob import export_blob

    export_blob(path, {"lpips": params})


def main(argv=None) -> None:
    """Convert an LPIPS TF checkpoint into a blob:

        python -m ldm_tf2_tpu_torch.checkpoints.convert_lpips \\
            --tf_ckpt lpips.ckpt-1 --out lpips_blob
    """
    import argparse

    parser = argparse.ArgumentParser(description=main.__doc__.splitlines()[0])
    parser.add_argument("--tf_ckpt", required=True,
                        help="prefix of the TF object checkpoint")
    parser.add_argument("--out", required=True,
                        help="blob path without the .bin/.json suffix")
    args = parser.parse_args(argv)
    export_lpips_blob(args.out, convert_lpips_tf_checkpoint(args.tf_ckpt))
    print(f"[INFO] Wrote the lpips artifact to {args.out}.bin/.json")


if __name__ == "__main__":
    main()
