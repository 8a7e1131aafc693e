"""The single-blob weight artifact, written and read by the port (numpy
only, the same bytes as ``ldm_tf2_tpu.checkpoints.blob``):

  <path>.bin    raw little-endian leaf bytes, one section per dtype, the
                sections in dtype-name order, each 64-byte aligned
  <path>.json   {"sections": {dtype: [byte_offset, byte_len]},
                 "artifacts": {name: [[treepath..., dtype, shape,
                                      elem_offset], ...]}}

Inside a section the leaves follow the artifacts' order, and each
artifact's leaves their sorted tree paths.  Both files are written under
temporary names and renamed, so a blob that exists is whole.  bfloat16 has
no numpy dtype: a bfloat16 tensor is written as its uint16 bits under the
dtype name ``"bfloat16"``, and read back as ``torch.bfloat16``.  A blob
either package writes loads in the other.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

_ALIGN = 64


def _flatten_with_paths(tree, prefix=()):
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out.extend(_flatten_with_paths(tree[key], prefix + (key,)))
        return out
    return [(prefix, tree)]


def _as_array(leaf) -> tuple[np.ndarray, str]:
    """(contiguous array, dtype name) of a numpy or torch leaf."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu().contiguous()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = leaf.numpy()
    else:
        arr = np.asarray(leaf)
        if not arr.flags.c_contiguous:
            arr = arr.copy(order="C")  # (ascontiguousarray makes 0-d 1-d)
    return arr, str(arr.dtype)


def export_blob(path: str, artifacts: dict) -> None:
    """Write ``artifacts`` (name -> nested dict of arrays or tensors) as
    ``<path>.bin`` / ``<path>.json``."""
    leaves: dict[str, list] = {}  # dtype -> [(name, path, arr)]
    for name, tree in artifacts.items():
        for treepath, leaf in _flatten_with_paths(tree):
            arr, dtype = _as_array(leaf)
            leaves.setdefault(dtype, []).append((name, treepath, arr))

    sections: dict[str, list[int]] = {}
    manifest: dict[str, list] = {name: [] for name in artifacts}
    offset = 0
    tmp_bin = f"{path}.bin.tmp.{os.getpid()}"
    with open(tmp_bin, "wb") as f:
        for dtype, items in sorted(leaves.items()):
            pad = (-offset) % _ALIGN
            f.write(b"\0" * pad)
            offset += pad
            start = offset
            elem = 0
            for name, treepath, arr in items:
                data = arr.reshape(-1).view(np.uint8)
                f.write(data.data)
                manifest[name].append(
                    [list(treepath), dtype, list(arr.shape), elem]
                )
                elem += arr.size
                offset += data.size
            sections[dtype] = [start, offset - start]
    tmp_json = f"{path}.json.tmp.{os.getpid()}"
    with open(tmp_json, "w") as f:
        json.dump({"sections": sections, "artifacts": manifest}, f)
    os.replace(tmp_bin, f"{path}.bin")
    os.replace(tmp_json, f"{path}.json")


def blob_exists(path: str) -> bool:
    return os.path.exists(f"{path}.bin") and os.path.exists(f"{path}.json")


def read_blob(path: str) -> dict[str, dict]:
    """Read ``<path>.bin``/``<path>.json`` into {artifact: nested dict of
    CPU tensors}, bit for bit.  The file is read once; the leaves are views
    of it, so it stays in memory while any leaf does."""
    with open(f"{path}.json") as f:
        meta = json.load(f)
    raw = np.fromfile(f"{path}.bin", dtype=np.uint8)
    sections = {}
    for dtype, (start, length) in meta["sections"].items():
        chunk = raw[start:start + length]
        if dtype == "bfloat16":
            sections[dtype] = torch.from_numpy(chunk.view(np.int16)).view(
                torch.bfloat16
            )
        else:
            sections[dtype] = torch.from_numpy(chunk.view(np.dtype(dtype)))
    out = {}
    for name, leaves in meta["artifacts"].items():
        tree: dict = {}
        for treepath, dtype, shape, elem in leaves:
            size = int(np.prod(shape)) if shape else 1
            leaf = sections[dtype][elem:elem + size].reshape(shape)
            node = tree
            for key in treepath[:-1]:
                node = node.setdefault(key, {})
            node[treepath[-1]] = leaf
        out[name] = tree
    return out
