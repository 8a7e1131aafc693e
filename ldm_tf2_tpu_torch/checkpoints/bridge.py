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
* ``params_to_jax``: the inverse, a ``state_dict`` (or a module) -> a
  flax param tree: dotted keys become nested dicts, 4-D leaves go from OIHW
  back to HWIO, and a module's buffers (the discriminator's BatchNorm
  ``bn_*.mean`` / ``bn_*.var``) go to ``batch_stats`` beside ``params``.
  Every other leaf keeps its layout, so GEGLU's value and gate halves and
  the attention projections' ``[D, H, S]`` kernels come out as the JAX
  package stores them.
* ``read_blob`` (from ``checkpoints/blob.py``, re-exported here): the
  single-blob artifact either package writes; artifact names
  ``cond_stage_model``, ``unet`` and ``autoencoder``, and ``lpips`` for the
  perceptual loss's weights.
"""

from __future__ import annotations

import numpy as np
import torch

from ldm_tf2_tpu_torch.checkpoints.blob import read_blob  # noqa: F401

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


def _named_leaves(tree) -> dict:
    """{dotted path: leaf} of a param tree (a top-level ``params``
    collection unwrapped; ``params`` with ``batch_stats`` merged)."""
    if isinstance(tree, dict) and set(tree) in ({"params"}, {"params", "batch_stats"}):
        leaves = list(_flatten(tree["params"]))
        leaves += list(_flatten(tree.get("batch_stats", {})))
    else:
        leaves = list(_flatten(tree))
    return {".".join(path): leaf for path, leaf in leaves}


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """Flax param tree -> state_dict (a top-level ``params`` collection is
    unwrapped; ``params`` with ``batch_stats`` are merged)."""
    state = {}
    for key, leaf in _named_leaves(tree).items():
        t = _to_tensor(leaf)
        if t.dim() == 4:
            t = t.permute(3, 2, 0, 1)  # HWIO -> OIHW
        state[key] = t.contiguous()
    return state


def load_params(module: torch.nn.Module, tree) -> torch.nn.Module:
    """Copy every leaf of ``tree`` into ``module``'s parameters (keeping the
    module's device and dtype).  Every leaf must be consumed.  Each leaf
    goes to the module's device as it is, and is transposed and cast
    there."""
    leaves = _named_leaves(tree)
    own = module.state_dict(keep_vars=True)
    missing = sorted(set(own) - set(leaves))
    extra = sorted(set(leaves) - set(own))
    if missing or extra:
        raise KeyError(
            f"param tree does not match {type(module).__name__}: "
            f"missing {missing[:10]}, extra {extra[:10]}"
        )
    for key, leaf in leaves.items():
        shape = tuple(leaf.shape)
        if len(shape) == 4:
            shape = (shape[3], shape[2], shape[0], shape[1])
        if shape != tuple(own[key].shape):
            raise ValueError(
                f"{key}: tree shape {shape} != module shape "
                f"{tuple(own[key].shape)}"
            )
    with torch.no_grad():
        for key, param in own.items():
            t = _to_tensor(leaves[key]).to(param.device)
            param.copy_(t.permute(3, 2, 0, 1) if t.dim() == 4 else t)
    return module


def _batch_stat(key: str) -> bool:
    """A BatchNorm running statistic (``bn_<n>.mean`` / ``.var``)."""
    parts = key.split(".")
    return len(parts) >= 2 and parts[-2].startswith("bn_") and parts[-1] in ("mean", "var")


def params_to_jax(state) -> dict:
    """``state_dict`` or module -> flax param tree of CPU tensors (meta
    tensors stay on meta); with BatchNorm buffers, ``{"params": ...,
    "batch_stats": ...}``.  ``params_from_jax`` of the result gives the
    ``state_dict`` back bit for bit."""
    if isinstance(state, torch.nn.Module):
        state = state.state_dict()
    params: dict = {}
    stats: dict = {}
    for key, value in state.items():
        t = value.detach()
        if t.device.type != "meta":
            t = t.cpu()
        if t.dim() == 4:
            t = t.permute(2, 3, 1, 0)  # OIHW -> HWIO
        node = stats if _batch_stat(key) else params
        *parents, leaf = key.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = t.contiguous()
    return {"params": params, "batch_stats": stats} if stats else params
