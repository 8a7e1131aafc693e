"""Config loading and validation for the port's DDIM sampling path.

The key surface is the JAX package's ``all_in_one_config.yaml``; the
``tpu:`` section's ``compute_dtype`` and ``weights_dtype`` choose the
port's activation and weight dtypes.  ``yaml`` is imported only when a
file is loaded, so a config built as a dict needs no yaml package.
"""

from __future__ import annotations

from typing import Any

import torch

_REQUIRED_SECTIONS = ("cond_stage_model", "unet", "autoencoder_kl", "ldm")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

_TPU_DEFAULTS: dict[str, Any] = {
    "compute_dtype": "bfloat16",
    "weights_dtype": None,
    "quantize": "none",
    "quantize_attention": "none",
    "sequence_parallel": False,
    "tensor_parallel": False,
}


def _is_int(x: Any) -> bool:
    return isinstance(x, int) and not isinstance(x, bool)


def _is_number(x: Any) -> bool:
    return _is_int(x) or isinstance(x, float)


def validate(config: dict) -> dict:
    """Check the sections and values the DDIM path reads; fill the
    ``tpu:`` defaults.  Returns the config."""
    missing = [s for s in _REQUIRED_SECTIONS if s not in config]
    if missing:
        raise ValueError(f"missing config sections {missing}")
    sampling = config.get("ldm_sampling") or {}
    ae_type = sampling.get("autoencoder_type")
    if ae_type is not None and ae_type not in ("kl", "vq"):
        raise ValueError(
            f"ldm_sampling.autoencoder_type must be 'kl' or 'vq', got {ae_type!r}"
        )
    for key in ("cache_interval", "cache_levels"):
        value = sampling.get(key, 1)
        if not _is_int(value) or value < 1:
            raise ValueError(f"ldm_sampling.{key} must be an int >= 1, got {value!r}")
    rescale = sampling.get("guidance_rescale", 0.0)
    if not _is_number(rescale) or not 0.0 <= rescale <= 1.0:
        raise ValueError(
            f"ldm_sampling.guidance_rescale must be in [0, 1], got {rescale!r}"
        )
    spacing = config["ldm"].get("timestep_spacing", "uniform")
    if spacing not in ("uniform", "trailing", "karras"):
        raise ValueError(
            f"ldm.timestep_spacing must be uniform|trailing|karras, got {spacing!r}"
        )
    tpu = dict(_TPU_DEFAULTS)
    tpu.update(config.get("tpu") or {})
    if tpu["compute_dtype"] not in _DTYPES:
        raise ValueError(
            f"tpu.compute_dtype must be one of {sorted(_DTYPES)}, got "
            f"{tpu['compute_dtype']!r}"
        )
    if tpu["weights_dtype"] is not None and tpu["weights_dtype"] not in _DTYPES:
        raise ValueError(
            f"tpu.weights_dtype must be null or one of {sorted(_DTYPES)}, got "
            f"{tpu['weights_dtype']!r}"
        )
    config["tpu"] = tpu
    return config


def load_config(path: str) -> dict:
    """Load and validate the all-in-one YAML."""
    import yaml

    with open(path) as f:
        return validate(yaml.safe_load(f))


def compute_dtype(config: dict) -> torch.dtype:
    return _DTYPES[config["tpu"]["compute_dtype"]]


def weights_dtype(config: dict) -> torch.dtype:
    """Parameter storage dtype: float32 unless ``tpu.weights_dtype`` says
    otherwise."""
    name = config["tpu"].get("weights_dtype")
    return torch.float32 if name is None else _DTYPES[name]
