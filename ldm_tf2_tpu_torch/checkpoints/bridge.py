"""Weights from the JAX package into the PyTorch port.

* ``params_from_jax``: a flax param tree (nested dicts of numpy arrays or
  tensors) -> a ``state_dict``.  Keys are the tree path joined with dots,
  which is the port's module path by construction (``models/layers.py``).
  4-D leaves are convolution kernels: HWIO is transposed to PyTorch's OIHW.
  A variables dict of ``params`` and ``batch_stats`` (the discriminator's
  BatchNorm) merges both: the running statistics land in the buffers of
  the same path (``bn_1.mean``, ``bn_1.var``).
* ``load_params``: loads such a tree into a module; a missing or an extra
  leaf, or a shape mismatch, raises.
* ``read_blob``: a numpy-only reader of the single-blob artifact that
  ``ldm_tf2_tpu.checkpoints.blob.export_blob`` writes (``<path>.bin`` plus
  a ``<path>.json`` manifest; artifact names ``cond_stage_model``, ``unet``
  and ``autoencoder``, and ``lpips`` for the perceptual loss's weights).
  bfloat16 sections have no numpy dtype: they are read as uint16 and
  viewed as ``torch.bfloat16``.
"""

from __future__ import annotations

import json

import numpy as np
import torch

ARTIFACTS = ("cond_stage_model", "unet", "autoencoder", "lpips")


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _flatten(tree[key], prefix + (str(key),))
    else:
        yield prefix, tree


def _to_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf
    return torch.from_numpy(np.array(leaf))


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """Flax param tree -> state_dict (a top-level ``params`` collection is
    unwrapped; ``params`` with ``batch_stats`` are merged)."""
    if isinstance(tree, dict) and set(tree) in ({"params"}, {"params", "batch_stats"}):
        leaves = list(_flatten(tree["params"]))
        leaves += list(_flatten(tree.get("batch_stats", {})))
    else:
        leaves = list(_flatten(tree))
    state = {}
    for path, leaf in leaves:
        t = _to_tensor(leaf)
        if t.dim() == 4:
            t = t.permute(3, 2, 0, 1)  # HWIO -> OIHW
        state[".".join(path)] = t.contiguous()
    return state


def load_params(module: torch.nn.Module, tree) -> torch.nn.Module:
    """Copy every leaf of ``tree`` into ``module``'s parameters (keeping the
    module's device and dtype).  Every leaf must be consumed."""
    state = params_from_jax(tree)
    own = module.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(
            f"param tree does not match {type(module).__name__}: "
            f"missing {missing[:10]}, extra {extra[:10]}"
        )
    for key, value in state.items():
        if tuple(value.shape) != tuple(own[key].shape):
            raise ValueError(
                f"{key}: tree shape {tuple(value.shape)} != module shape "
                f"{tuple(own[key].shape)}"
            )
    with torch.no_grad():
        for key, param in module.state_dict(keep_vars=True).items():
            param.copy_(state[key])
    return module


def read_blob(path: str) -> dict[str, dict]:
    """Read ``<path>.bin``/``<path>.json`` into {artifact: nested dict of
    CPU tensors}, bit for bit."""
    with open(f"{path}.json") as f:
        meta = json.load(f)
    raw = np.fromfile(f"{path}.bin", dtype=np.uint8)
    sections = {}
    for dtype, (start, length) in meta["sections"].items():
        chunk = raw[start:start + length]
        if dtype == "bfloat16":
            sections[dtype] = torch.from_numpy(chunk.view(np.uint16)).view(
                torch.bfloat16
            )
        else:
            sections[dtype] = torch.from_numpy(chunk.view(np.dtype(dtype)))
    out = {}
    for name, leaves in meta["artifacts"].items():
        tree: dict = {}
        for treepath, dtype, shape, elem in leaves:
            size = int(np.prod(shape)) if shape else 1
            leaf = sections[dtype][elem:elem + size].reshape(shape).clone()
            node = tree
            for key in treepath[:-1]:
                node = node.setdefault(key, {})
            node[treepath[-1]] = leaf
        out[name] = tree
    return out
