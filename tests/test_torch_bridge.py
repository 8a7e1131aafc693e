"""The port's weight bridge and numpy-only blob reader against the JAX
package's ``export_blob`` artifact and param trees."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm_tf2_tpu.checkpoints.blob import export_blob
from ldm_tf2_tpu_torch.checkpoints.bridge import (
    load_params, params_from_jax, read_blob,
)
from ldm_tf2_tpu_torch.models.layers import Conv, Dense


def test_blob_reads_back_bit_identical(tmp_path):
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    bf16 = np.asarray(jnp.asarray(rng.standard_normal((4, 6)), jnp.bfloat16))
    i32 = np.arange(7, dtype=np.int32)
    trees = {
        "cond_stage_model": {"a": {"kernel": f32, "bias": f32[0]}},
        "unet": {"b": {"kernel": bf16}, "steps": i32},
        "autoencoder": {"c": {"scale": np.float32(2.5).reshape(())}},
    }
    export_blob(str(tmp_path / "w"), trees)
    got = read_blob(str(tmp_path / "w"))
    assert set(got) == set(trees)
    np.testing.assert_array_equal(got["cond_stage_model"]["a"]["kernel"].numpy(), f32)
    np.testing.assert_array_equal(got["cond_stage_model"]["a"]["bias"].numpy(), f32[0])
    np.testing.assert_array_equal(got["unet"]["steps"].numpy(), i32)
    leaf = got["unet"]["b"]["kernel"]
    assert leaf.dtype == torch.bfloat16 and leaf.shape == (4, 6)
    np.testing.assert_array_equal(leaf.view(torch.uint16).numpy(),
                                  bf16.view(np.uint16))
    assert got["autoencoder"]["c"]["scale"].shape == ()


class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.dense = Dense(3, 4)
        self.conv = Conv(2, 5)


def _tiny_tree(rng):
    return {"params": {
        "dense": {"kernel": rng.standard_normal((3, 4)).astype(np.float32),
                  "bias": rng.standard_normal(4).astype(np.float32)},
        "conv": {"kernel": rng.standard_normal((3, 3, 2, 5)).astype(np.float32),
                 "bias": rng.standard_normal(5).astype(np.float32)},
    }}


def test_bridge_maps_names_and_transposes_conv_kernels():
    tree = _tiny_tree(np.random.default_rng(1))
    state = params_from_jax(tree)
    assert set(state) == {"dense.kernel", "dense.bias", "conv.kernel", "conv.bias"}
    model = load_params(_Tiny(), tree)
    np.testing.assert_array_equal(model.conv.kernel.detach().numpy(),
                                  tree["params"]["conv"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(model.dense.kernel.detach().numpy(),
                                  tree["params"]["dense"]["kernel"])


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_bridge_raises_on_mismatched_tree(fault):
    tree = _tiny_tree(np.random.default_rng(2))
    params = tree["params"]
    if fault == "missing":
        del params["dense"]["bias"]
    elif fault == "extra":
        params["dense"]["scale"] = np.ones(4, np.float32)
    else:
        params["dense"]["kernel"] = np.ones((4, 3), np.float32)
    with pytest.raises(KeyError if fault != "shape" else ValueError):
        load_params(_Tiny(), tree)
