"""The port's CompVis converter, its CLI, the LPIPS converter and the blob
writer, held to the JAX package on the same numpy inputs.

The tiny CompVis state dicts are the JAX tests' own
(``tests/test_checkpoints.py``).  Trees are compared bit for bit: same
leaves, same dtypes, equal bytes (tolerance 0).
"""

import json
import os
import types

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
from test_checkpoints import _make_ae_sd, _make_transformer_sd, _make_unet_sd
from test_convert_lpips import _fake_reader

from ldm_tf2_tpu.checkpoints import convert_lpips as jax_lpips
from ldm_tf2_tpu.checkpoints import convert_pytorch as jax_convert
from ldm_tf2_tpu.checkpoints.blob import export_blob as jax_export_blob
from ldm_tf2_tpu.checkpoints.blob import load_blob
from ldm_tf2_tpu_torch.checkpoints import convert_lpips, convert_pytorch
from ldm_tf2_tpu_torch.checkpoints.blob import blob_exists, export_blob, read_blob
from ldm_tf2_tpu_torch.cli import convert_ckpt_pytorch as cli

AE = dict(latent_channels=4, channels=32, num_blocks=1, dropout_rate=0.0,
          multipliers=[1, 2], resample_with_conv=True)
TINY = {
    "cond_stage_model": dict(vocab_size=64, encoder_stack_size=2, hidden_size=32,
                             num_heads=2, size_per_head=16, max_seq_len=8,
                             filter_size=64, dropout_rate=0.0),
    "unet": dict(model_channels=64, out_channels=4, num_blocks=1,
                 attention_resolutions=[4, 2, 1], dropout_rate=0.0,
                 channel_mult=[1, 2], num_heads=2),
    "autoencoder_kl": dict(AE, attention_resolutions=[]),
    # built for 256 (the CLI's size): level 1 is 128, where _make_ae_sd's
    # attn_levels=(1,) puts the VQ attention
    "autoencoder_vq": dict(AE, attention_resolutions=[128], vocab_size=32, beta=0.25),
    "ldm": dict(num_steps=10, beta_start=0.00085, beta_end=0.012,
                v_posterior=0.0, scale_factor=0.18215, eta=0.0, num_ddim_steps=5),
    "ldm_sampling": {"autoencoder_type": "kl"},
    "tpu": {"compute_dtype": "float32"},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny shapes gain nothing from torch's thread pool, and on a host
    busy with other test workers the pool slows this file down."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(ae_type="kl"):
    from ldm_tf2_tpu_torch.configs.loader import validate

    config = json.loads(json.dumps(TINY))
    config["ldm_sampling"]["autoencoder_type"] = ae_type
    return validate(config)


def _compvis_sd(ae_type="kl", seed=0):
    rng = np.random.RandomState(seed)
    sd = {}
    sd.update(_make_transformer_sd(rng, layers=2, hidden=32, heads=2, size=16,
                                   vocab=64, seq=8, filters=64))
    sd.update(_make_unet_sd(rng, C=64, mult=(1, 2), blocks=1, heads=2, ctx=32))
    sd.update(_make_ae_sd(rng, C=32, mult=(1, 2), blocks=1, zc=4,
                          vq=ae_type == "vq",
                          attn_levels=(1,) if ae_type == "vq" else ()))
    return sd


def _jax_trees(sd, ae_type):
    convert_ae = (jax_convert.convert_autoencoder_kl if ae_type == "kl"
                  else jax_convert.convert_autoencoder_vq)
    return {
        "cond_stage_model": jax_convert.convert_transformer(sd, num_layers=2, num_heads=2),
        "unet": jax_convert.convert_unet(sd, num_blocks=1, channel_mult=(1, 2),
                                         num_heads=2),
        "autoencoder": convert_ae(sd, num_blocks=1, multipliers=(1, 2)),
    }


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for key, child in tree.items():
            out.update(_leaves(child, prefix + (key,)))
        return out
    if isinstance(tree, torch.Tensor):
        tree = (tree.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
                if tree.dtype == torch.bfloat16 else tree.numpy())
    return {"/".join(prefix): np.asarray(tree)}


def assert_trees_bit_equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert got[key].shape == want[key].shape, key
        assert got[key].tobytes() == want[key].tobytes(), key


@pytest.mark.parametrize("ae_type", ["kl", "vq"])
def test_converter_trees_equal_jax_bit_for_bit(ae_type):
    """Every artifact, verified against the port's own models (meta
    device), equals the JAX converter's tree."""
    sd = _compvis_sd(ae_type)
    got = cli.convert_state_dict(sd, _config(ae_type))
    assert_trees_bit_equal(got, _jax_trees(sd, ae_type))


def test_converter_missing_key_raises():
    sd = _compvis_sd("kl")
    del sd["model.diffusion_model.middle_block.1.proj_in.weight"]
    with pytest.raises(KeyError, match="middle_block.1.proj_in.weight"):
        cli.convert_state_dict(sd, _config("kl"))


def test_converter_extra_leaf_raises():
    """An attention block the KL model (no attention_resolutions) does not
    have becomes a leaf the reference lacks: the coverage check refuses."""
    sd = _compvis_sd("kl")
    sd.update({k: v for k, v in _compvis_sd("vq").items() if ".down.1.attn.0." in k})
    with pytest.raises(ValueError, match="extra=.*down_2/attention"):
        cli.convert_state_dict(sd, _config("kl"))


def test_reference_tree_is_the_models_layout():
    """The meta-device reference has the converted tree's leaves and
    shapes (the coverage check compares against it)."""
    refs = cli.reference_trees(_config("kl"), "kl")
    assert all(leaf.device.type == "meta" for leaf in _leaves_meta(refs))
    sd = _compvis_sd("kl")
    got = cli.convert_state_dict(sd, _config("kl"), verify=False)
    for name in got:
        convert_pytorch._verify_against(refs[name], got[name], name)


def _leaves_meta(tree):
    if isinstance(tree, dict):
        for child in tree.values():
            yield from _leaves_meta(child)
    else:
        yield tree


def _write_yaml(path, config):
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(config, f)


def test_cli_blob_loads_equal_in_both_packages(tmp_path):
    """The CLI's one blob: the three artifacts equal the JAX converter's
    trees in the JAX ``load_blob`` and in the port's ``read_blob``; the
    checksum manifest covers every leaf."""
    sd = _compvis_sd("kl")
    ckpt = str(tmp_path / "model.ckpt")
    torch.save({"state_dict": {k: torch.tensor(v) for k, v in sd.items()},
                "global_step": 7}, ckpt)
    config_path = str(tmp_path / "config.yaml")
    _write_yaml(config_path, TINY)
    rc = cli.main(["--pytorch_ckpt_path", ckpt, "--config_path", config_path,
                   "--out_dir", str(tmp_path / "out")])
    assert rc == 0
    blob = str(tmp_path / "out" / "params")
    assert blob_exists(blob)
    want = _jax_trees(sd, "kl")
    assert_trees_bit_equal(read_blob(blob), want)
    loaded = jax.tree.map(np.asarray, load_blob(blob))
    assert_trees_bit_equal(loaded, want)
    with open(tmp_path / "out" / "conversion_manifest.json") as f:
        manifest = json.load(f)
    for name, tree in want.items():
        leaves = _leaves(tree)
        assert sorted(manifest[name]) == sorted(leaves)
        key = sorted(leaves)[0]
        assert manifest[name][key]["shape"] == list(leaves[key].shape)
        assert manifest[name][key]["sum"] == float(leaves[key].sum())


def test_cli_validate_only_go_and_no_go(tmp_path, capsys):
    """--validate_only on a checkpoint with every manifest key (shapes
    only matter: zero-stride views keep it small) says GO; with one key
    dropped, NO-GO naming it."""
    with open(cli.default_manifest_path()) as f:
        manifest = json.load(f)
    assert manifest["total_model_params"] == 1_498_849_707
    zero = torch.zeros(1)
    sd = {k: zero.expand(*shape) if shape else zero[0]
          for k, shape in {**manifest["model_keys"], **manifest["ignored_keys"]}.items()}
    ckpt = str(tmp_path / "full.ckpt")
    torch.save({"state_dict": sd}, ckpt)
    assert cli.main(["--pytorch_ckpt_path", ckpt, "--validate_only"]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("[VALIDATE] GO")
    victim = sorted(manifest["model_keys"])[0]
    del sd[victim]
    torch.save({"state_dict": sd}, ckpt)
    assert cli.main(["--pytorch_ckpt_path", ckpt, "--validate_only"]) == 1
    out = capsys.readouterr().out
    assert f"MISSING  {victim}" in out
    assert out.strip().splitlines()[-1].startswith("[VALIDATE] NO-GO")


def test_validate_state_dict_equals_jax_report():
    from ldm_tf2_tpu.cli.convert_ckpt_pytorch_to_jax import validate_state_dict

    with open(cli.default_manifest_path()) as f:
        manifest = json.load(f)
    sd = {k: types.SimpleNamespace(shape=tuple(s)) for k, s in manifest["model_keys"].items()}
    victims = sorted(manifest["model_keys"])[:2]
    del sd[victims[0]]
    sd[victims[1]] = types.SimpleNamespace(shape=(1, 2))
    sd["unknown.key"] = types.SimpleNamespace(shape=(3,))
    assert cli.validate_state_dict(sd, manifest) == validate_state_dict(sd, manifest)


def test_lpips_converter_equals_jax(tmp_path):
    tensors = _fake_reader(np.random.RandomState(0))
    got = convert_lpips.convert_lpips_from_reader(tensors.keys(), tensors.__getitem__)
    want = jax_lpips.convert_lpips_from_reader(tensors.keys(), tensors.__getitem__)
    assert_trees_bit_equal(got, want)
    convert_lpips.export_lpips_blob(str(tmp_path / "lpips"), got)
    assert_trees_bit_equal(read_blob(str(tmp_path / "lpips"))["lpips"], want)


@pytest.mark.parametrize("victim", ["lpips/_projs/3/kernel", "lpips/_vgg16/_conv_layers/2/1/bias"])
def test_lpips_converter_missing_raises_as_jax(victim):
    tensors = _fake_reader(np.random.RandomState(1))
    del tensors[f"{victim}/.ATTRIBUTES/VARIABLE_VALUE"]
    with pytest.raises(ValueError) as want:
        jax_lpips.convert_lpips_from_reader(tensors.keys(), tensors.__getitem__)
    with pytest.raises(ValueError) as got:
        convert_lpips.convert_lpips_from_reader(tensors.keys(), tensors.__getitem__)
    assert str(got.value) == str(want.value)


def test_lpips_tf_checkpoint_without_tensorflow_names_it(monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_tf(name, *args, **kwargs):
        if name == "tensorflow" or name.startswith("tensorflow."):
            raise ImportError("No module named 'tensorflow'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tf)
    with pytest.raises(ImportError, match="'tensorflow' package"):
        convert_lpips.convert_lpips_tf_checkpoint("lpips.ckpt-1")


def _mixed_artifacts(rng):
    return {
        "cond_stage_model": {
            "emb": rng.standard_normal((7, 5)).astype(np.float32),
            "layer": {"w": rng.standard_normal((5, 3)).astype(ml_dtypes.bfloat16),
                      "b": np.zeros((3,), np.float32)},
        },
        "unet": {"conv": {"kernel": rng.standard_normal((3, 3, 2, 4)).astype(ml_dtypes.bfloat16),
                          "bias": rng.standard_normal((4,)).astype(np.float32)},
                 "steps": np.arange(5, dtype=np.int32)},
        "autoencoder": {"scale": np.asarray(0.18215, np.float32)},
    }


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if tree.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(tree.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(tree))


@pytest.mark.parametrize("leaves", ["numpy", "torch"])
def test_export_blob_bytes_equal_jax(tmp_path, leaves):
    """float32, bfloat16 (torch bf16 written as its uint16 bits), int32 and
    0-d leaves: the port's .bin and .json equal the JAX writer's byte for
    byte, and load equal in the JAX ``load_blob``."""
    artifacts = _mixed_artifacts(np.random.default_rng(0))
    jax_export_blob(str(tmp_path / "jax"), artifacts)
    ours = artifacts if leaves == "numpy" else _as_torch(artifacts)
    path = str(tmp_path / "port")
    assert not blob_exists(path)
    export_blob(path, ours)
    for suffix in (".bin", ".json"):
        with open(str(tmp_path / "jax") + suffix, "rb") as f:
            want = f.read()
        with open(path + suffix, "rb") as f:
            assert f.read() == want, suffix
    assert_trees_bit_equal(jax.tree.map(np.asarray, load_blob(path)), artifacts)
    assert_trees_bit_equal(read_blob(path), artifacts)
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]
