"""Config loading and validation for the port's sampling, serving and
LDM-training paths.

The key surface is the JAX package's ``all_in_one_config.yaml``; the
``tpu:`` section's ``compute_dtype`` and ``weights_dtype`` choose the
port's activation and weight dtypes, and ``quantize`` (none | int8) and
``quantize_attention`` (none | int8pv) its serving modes.  The trainer
reads ``ldm_training``, ``latent_diffusion_optimizer`` and the ``tpu:``
keys ``frozen_weights_dtype``, ``remat``, ``encode_chunks``,
``persist_per_iterations``, ``log_per_iterations`` and
``deterministic_data``; they are checked when present.  The autoencoder
trainer reads ``autoencoder_training``, its type's
``autoencoder_{kl,vq}_trainer`` section, ``autoencoder_optimizer`` and
``discriminator_optimizer``, checked when ``autoencoder_training`` is
there.  ``yaml`` is
imported only when a file is loaded, so a config built as a dict needs no
yaml package.
"""

from __future__ import annotations

from typing import Any

import torch

_REQUIRED_SECTIONS = ("cond_stage_model", "unet", "autoencoder_kl", "ldm")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

_TPU_DEFAULTS: dict[str, Any] = {
    "compute_dtype": "bfloat16",
    "weights_dtype": None,
    "frozen_weights_dtype": None,
    "quantize": "none",
    "quantize_attention": "none",
    "attention_impl": "auto",
    "sequence_parallel": False,
    "tensor_parallel": False,
    "remat": False,
    "deterministic_data": False,
    "encode_chunks": 1,
    "persist_per_iterations": None,
    "log_per_iterations": 100,
}

# make_optimizer's keywords (the JAX package's latent_diffusion_optimizer)
OPTIMIZER_KEYS = (
    "learning_rate", "beta_1", "beta_2", "epsilon", "weight_decay",
    "warmup_steps", "decay_steps", "end_learning_rate_factor",
    "clip_grad_norm", "mu_dtype",
)


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
    for key in ("weights_dtype", "frozen_weights_dtype"):
        if tpu[key] is not None and tpu[key] not in _DTYPES:
            raise ValueError(
                f"tpu.{key} must be null or one of {sorted(_DTYPES)}, got "
                f"{tpu[key]!r}"
            )
    for key in ("encode_chunks", "log_per_iterations"):
        if not _is_int(tpu[key]) or tpu[key] < 1:
            raise ValueError(f"tpu.{key} must be an int >= 1, got {tpu[key]!r}")
    persist = tpu["persist_per_iterations"]
    if persist is not None and (not _is_int(persist) or persist < 1):
        raise ValueError(
            f"tpu.persist_per_iterations must be null or an int >= 1, got {persist!r}"
        )
    if tpu["remat"] not in (False, True, "full", "blocks", "dots"):
        raise ValueError(
            f"tpu.remat must be one of false|true|full|blocks|dots, got {tpu['remat']!r}"
        )
    if not isinstance(tpu["deterministic_data"], bool):
        raise ValueError(
            f"tpu.deterministic_data must be a bool, got {tpu['deterministic_data']!r}"
        )
    if tpu["quantize"] not in ("none", "int8"):
        raise ValueError(
            f"tpu.quantize must be 'none' or 'int8', got {tpu['quantize']!r}"
        )
    if tpu["quantize_attention"] not in ("none", "int8pv"):
        raise ValueError(
            "tpu.quantize_attention must be 'none' or 'int8pv', got "
            f"{tpu['quantize_attention']!r}"
        )
    if tpu["attention_impl"] not in ("auto", "xla", "flash"):
        raise ValueError(
            f"tpu.attention_impl must be auto|xla|flash, got "
            f"{tpu['attention_impl']!r}"
        )
    if tpu["tensor_parallel"] and tpu["quantize"] != "none":
        raise ValueError(
            "tpu.quantize int8 is a single-device serving mode: the int8 conv "
            "chains are not decomposed over the model axis; disable one of "
            "tpu.tensor_parallel / tpu.quantize"
        )
    config["tpu"] = tpu
    if "ldm_training" in config:
        _validate_training(config)
    if "autoencoder_training" in config:
        _validate_ae_training(config)
    return config


# make_adam's keywords (the JAX package's autoencoder_optimizer and
# discriminator_optimizer)
ADAM_KEYS = ("learning_rate", "beta_1", "beta_2", "epsilon")
_AE_TRAINER_NUMBERS = ("lpips_weight", "discriminator_weight",
                       "discriminator_factor")


def _validate_ae_training(config: dict) -> None:
    training = config["autoencoder_training"]
    ae_type = training.get("autoencoder_type")
    if ae_type not in ("kl", "vq"):
        raise ValueError(
            f"autoencoder_training.autoencoder_type must be 'kl' or 'vq', got {ae_type!r}"
        )
    for section in (f"autoencoder_{ae_type}", f"ae_{ae_type}_discriminator",
                    f"autoencoder_{ae_type}_trainer"):
        if section not in config:
            raise ValueError(f"autoencoder_type {ae_type!r} needs the {section} section")
    params = training.get("params") or {}
    for key in ("batch_size", "image_size"):
        if not _is_int(params.get(key)) or params[key] < 1:
            raise ValueError(
                f"autoencoder_training.params.{key} must be an int >= 1, got "
                f"{params.get(key)!r}"
            )
    iters = training.get("num_iterations")
    if not _is_int(iters) or iters < 1:
        raise ValueError(
            f"autoencoder_training.num_iterations must be an int >= 1, got {iters!r}"
        )
    trainer = config[f"autoencoder_{ae_type}_trainer"]
    step = trainer.get("global_step_discriminator")
    if not _is_int(step) or step < 0:
        raise ValueError(
            f"autoencoder_{ae_type}_trainer.global_step_discriminator must be an "
            f"int >= 0, got {step!r}"
        )
    reg = "kl_weight" if ae_type == "kl" else "codebook_weight"
    for key in (*_AE_TRAINER_NUMBERS, reg):
        if not _is_number(trainer.get(key)):
            raise ValueError(
                f"autoencoder_{ae_type}_trainer.{key} must be a number, got "
                f"{trainer.get(key)!r}"
            )
    loss = trainer.get("discriminator_loss_type", "hinge")
    if loss not in ("hinge", "vanilla"):
        raise ValueError(
            f"autoencoder_{ae_type}_trainer.discriminator_loss_type must be "
            f"hinge|vanilla, got {loss!r}"
        )
    for section in ("autoencoder_optimizer", "discriminator_optimizer"):
        opt = config.get(section) or {}
        unknown = set(opt) - set(ADAM_KEYS)
        if unknown:
            raise ValueError(f"unknown {section} keys {sorted(unknown)}")
        bad = [k for k, v in opt.items() if not _is_number(v)]
        if bad:
            raise ValueError(f"{section} keys {bad} must be numbers")


def _validate_training(config: dict) -> None:
    training = config["ldm_training"]
    if training.get("autoencoder_type", "kl") not in ("kl", "vq"):
        raise ValueError(
            "ldm_training.autoencoder_type must be 'kl' or 'vq', got "
            f"{training['autoencoder_type']!r}"
        )
    accum = training.get("grad_accum_steps", 1)
    if not _is_int(accum) or accum < 1:
        raise ValueError(
            f"ldm_training.grad_accum_steps must be an int >= 1, got {accum!r}"
        )
    rate = training.get("condition_dropout_rate", 0.1)
    if not _is_number(rate) or not 0.0 <= rate <= 1.0:
        raise ValueError(
            f"ldm_training.condition_dropout_rate must be in [0, 1], got {rate!r}"
        )
    if not isinstance(training.get("train_cond_model", False), bool):
        raise ValueError("ldm_training.train_cond_model must be a bool")
    ema = training.get("ema_decay")
    if ema is not None and (not _is_number(ema) or not 0.0 <= ema < 1.0):
        raise ValueError(f"ldm_training.ema_decay must be null or in [0, 1), got {ema!r}")
    params = training.get("params") or {}
    for key in ("batch_size", "image_size"):
        if not _is_int(params.get(key)) or params[key] < 1:
            raise ValueError(
                f"ldm_training.params.{key} must be an int >= 1, got {params.get(key)!r}"
            )
    unknown = set(config.get("latent_diffusion_optimizer") or {}) - set(OPTIMIZER_KEYS)
    if unknown:
        raise ValueError(f"unknown latent_diffusion_optimizer keys {sorted(unknown)}")


def load_config(path: str) -> dict:
    """Load and validate the all-in-one YAML."""
    import yaml

    with open(path) as f:
        return validate(yaml.safe_load(f))


def compute_dtype(config: dict) -> torch.dtype:
    return _DTYPES[config["tpu"]["compute_dtype"]]


def weights_dtype(config: dict, key: str = "weights_dtype") -> torch.dtype:
    """Parameter storage dtype: float32 unless ``tpu.<key>`` says otherwise
    (``weights_dtype`` for sampling, ``frozen_weights_dtype`` for the
    trainer's frozen models)."""
    name = config["tpu"].get(key)
    return torch.float32 if name is None else _DTYPES[name]
