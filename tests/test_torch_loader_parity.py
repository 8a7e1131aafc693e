"""The port's config loader rejects what the JAX package's rejects.

Each bad config is the repository's ``all_in_one_config.yaml`` with one
section changed, written as YAML and loaded by both
``ldm_tf2_tpu.configs.loader.load_config`` and
``ldm_tf2_tpu_torch.configs.loader.load_config``: both raise ``ValueError``
with the same message."""

import copy
import os

import pytest
import yaml

from ldm_tf2_tpu.configs import loader as jax_loader
from ldm_tf2_tpu_torch.configs import loader as torch_loader

_CONFIG = os.path.join(os.path.dirname(jax_loader.__file__), "all_in_one_config.yaml")

_BAD = {
    "strength above 1": ("ldm_sampling", {"strength": 1.5}),
    "strength below 0": ("ldm_sampling", {"strength": -0.25}),
    "strength not a number": ("ldm_sampling", {"strength": "high"}),
    "mask without init image": ("ldm_sampling", {"mask_path": "mask.png"}),
    "cache_interval with plms": ("ldm_sampling", {"cache_interval": 2, "sampler": "plms"}),
    "cache_interval with ddpm": ("ldm_sampling", {"cache_interval": 3, "sampler": "ddpm"}),
    "sequence_parallel not a bool": ("tpu", {"sequence_parallel": 1}),
    "tensor_parallel not a bool": ("tpu", {"tensor_parallel": "yes"}),
    "sequence_parallel without a model axis": ("tpu", {"sequence_parallel": True}),
    "tensor_parallel with a model axis of 1": (
        "tpu", {"tensor_parallel": True, "mesh": {"data": -1, "model": 1}}),
    "sequence and tensor parallel together": (
        "tpu", {"sequence_parallel": True, "tensor_parallel": True,
                "mesh": {"data": 1, "model": 2}}),
    "compile_cache_dir not a path": ("tpu", {"compile_cache_dir": 3}),
}


def _write(tmp_path, section=None, update=None):
    with open(_CONFIG) as f:
        config = yaml.safe_load(f)
    if section is not None:
        config[section] = {**copy.deepcopy(config.get(section) or {}), **update}
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(config))
    return str(path)


@pytest.mark.parametrize("case", sorted(_BAD))
def test_both_loaders_reject(case, tmp_path):
    path = _write(tmp_path, *_BAD[case])
    with pytest.raises(ValueError) as jax_err:
        jax_loader.load_config(path)
    with pytest.raises(ValueError) as torch_err:
        torch_loader.load_config(path)
    assert str(torch_err.value) == str(jax_err.value)


def test_both_loaders_accept_the_repository_config(tmp_path):
    path = _write(tmp_path)
    jax_loader.load_config(path)
    torch_loader.load_config(path)
