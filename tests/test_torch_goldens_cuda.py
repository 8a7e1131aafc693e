"""The production goldens on the card: the port's full-size models in
float32 (TF32 off for matmuls and cuDNN) against ``tests/goldens/`` at the
JAX tests' CPU tolerances (``test_golden_parity.py``,
``test_pipeline_parity.py``).

The weights are the goldens' own: ``materialize`` below is a numpy-only
copy of ``golden_utils.materialize`` that walks a tree built from the
port's ``state_dict`` shapes (PyTorch's OIHW kernels as flax's HWIO), in
the draw order of ``golden_utils``' numpy ``*_order`` functions.  Neither
JAX nor the JAX package is imported, so the file runs on the card's
machine:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_goldens_cuda.py
"""

import functools
import os

import numpy as np
import pytest
import torch

import golden_utils as gu
from ldm_tf2_tpu_torch import factory
from ldm_tf2_tpu_torch import models as tm
from ldm_tf2_tpu_torch.checkpoints.bridge import load_params
from ldm_tf2_tpu_torch.cli.run_ldm_sampler import sample_txt2img
from ldm_tf2_tpu_torch.diffusion.schedule import make_schedule

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
TRANSFORMER = dict(vocab_size=30522, encoder_stack_size=32, hidden_size=1280,
                   num_heads=8, size_per_head=64, max_seq_len=77,
                   filter_size=5120, dropout_rate=0.0)
UNET = dict(model_channels=320, out_channels=4, num_blocks=2,
            channel_mult=(1, 2, 4, 4), num_heads=8, context_channels=1280,
            dropout_rate=0.0)
AE_KL = dict(channels=128, num_blocks=2, multipliers=(1, 2, 4, 4))
AE_VQ = dict(channels=128, num_blocks=2, multipliers=(1, 2, 2, 4),
             attention_resolutions=(32,), vocab_size=16384)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    factory.set_float32_precision()
    return torch.device("cuda")


def _golden(name):
    return np.load(os.path.join(GOLDENS, f"{name}.npz"))


def _tree(module):
    """The flax variables tree of ``module``'s parameters as zeros: the
    port's state_dict keys are flax paths joined by dots, 4-D kernels OIHW
    where flax keeps HWIO."""
    tree: dict = {}
    for key, value in module.state_dict().items():
        shape = tuple(value.shape)
        if len(shape) == 4:
            shape = (shape[2], shape[3], shape[1], shape[0])
        node = tree
        *parents, leaf = key.split(".")
        for name in parents:
            node = node.setdefault(name, {})
        node[leaf] = np.zeros(shape, np.float32)
    return {"params": tree}


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,)


def materialize(variables, order, seed=gu.SEED):
    """``golden_utils.materialize`` without JAX: the same draws from the
    same generator, in ``order``, into the same leaves; every leaf drawn."""
    gen = np.random.Generator(np.random.Philox(seed))
    seen = set()
    for entry in order:
        if len(entry) == 3:  # geglu(): one fused draw split into two leaves
            collection, path, kind = entry
            leaf_name = "kernel" if kind == "geglu_kernel" else "bias"
            v_path, g_path = path + ("value", leaf_name), path + ("gate", leaf_name)
            half = gu._get(variables[collection], v_path).shape[-1]
            shape = gu._get(variables[collection], v_path).shape[:-1] + (2 * half,)
            fused = gen.standard_normal(shape).astype(np.float32) * gu.WEIGHT_SCALE
            gu._set(variables[collection], v_path, fused[..., :half])
            gu._set(variables[collection], g_path, fused[..., half:])
            seen.update({(collection, v_path), (collection, g_path)})
            continue
        collection, path = entry
        leaf = gu._get(variables[collection], path)
        value = gen.standard_normal(leaf.shape).astype(np.float32) * gu.WEIGHT_SCALE
        if collection == "batch_stats" and path[-1] == "var":
            value = np.abs(value)
        gu._set(variables[collection], path, value)
        seen.add((collection, path))
    every = {(c, p) for c, tree in variables.items() for p in _leaves(tree)}
    assert not every - seen, f"unmaterialized leaves: {sorted(every - seen)[:10]}"
    assert not seen - every, f"order names unknown leaves: {sorted(seen - every)[:10]}"
    return variables


def _model(module, order, seed, device):
    return load_params(module, materialize(_tree(module), order, seed)).to(device).eval()


@functools.lru_cache(maxsize=1)
def _pipeline_models():
    """The production pipeline's three models (``test_pipeline_parity``'s
    seeds), built once for both pipeline goldens."""
    device = _card()
    return (_model(tm.TransformerModel(**TRANSFORMER), gu.transformer_order(32),
                   gu.SEED + 13, device),
            _model(tm.UNet(**UNET), gu.unet_order(2, (1, 2, 4, 4)), gu.SEED + 14, device),
            _model(tm.AutoencoderKL(**AE_KL), gu.autoencoder_kl_order(2, (1, 2, 4, 4), 64),
                   gu.SEED + 15, device))


def _np(t):
    return t.detach().float().cpu().numpy()


@pytest.mark.cuda
def test_transformer_full_depth_matches_golden():
    device = _card()
    g = _golden("transformer_full")
    model = _model(tm.TransformerModel(**TRANSFORMER), gu.transformer_order(32), gu.SEED,
                   device)
    with torch.no_grad():
        out = _np(model(torch.as_tensor(g["ids"]).to(device)))
    np.testing.assert_allclose(out, g["out"], rtol=1e-3, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("name,seed", [("unet_prod", 11), ("unet_prod512", 16)])
def test_unet_production_matches_golden(name, seed):
    device = _card()
    g = _golden(name)
    model = _model(tm.UNet(**UNET), gu.unet_order(2, (1, 2, 4, 4)), gu.SEED + seed, device)
    with torch.no_grad():
        out = _np(model(*(torch.as_tensor(g[k]).to(device) for k in ("x", "t", "ctx"))))
    err = float(np.abs(out - g["out"]).max())
    assert err < 1e-2, f"{name}: max abs err {err:.3e}"
    np.testing.assert_allclose(out, g["out"], rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("name,seed,size", [("autoencoder_kl_prod", 12, 256),
                                            ("autoencoder_kl_prod512", 17, 512)])
def test_autoencoder_kl_production_matches_golden(name, seed, size):
    device = _card()
    g = _golden(name)
    model = _model(tm.AutoencoderKL(**AE_KL), gu.autoencoder_kl_order(2, (1, 2, 4, 4), size),
                   gu.SEED + seed, device)
    with torch.no_grad():
        posterior = model.encode(torch.as_tensor(g["x"]).to(device))
        recon = _np(model.decode(posterior.mode()))
    np.testing.assert_allclose(_np(posterior.mean), g["mean"], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(_np(posterior.logvar), g["logvar"], rtol=1e-3, atol=1e-4)
    err = float(np.abs(recon - g["recon"]).max())
    assert err < 1e-2, f"{name}: recon max abs err {err:.3e}"
    np.testing.assert_allclose(recon, g["recon"], rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
def test_autoencoder_vq_production_matches_golden():
    device = _card()
    g = _golden("autoencoder_vq_prod")
    model = _model(tm.AutoencoderVQ(**AE_VQ, resolution=256),
                   gu.autoencoder_vq_order(2, (1, 2, 2, 4), 256, (32,)), gu.SEED + 18, device)
    x = torch.as_tensor(g["x"]).to(device)
    with torch.no_grad():
        latents = _np(model.encode(x, only_encode=True))
        quantized, loss, indices = model.encode(x)
        recon = _np(model.decode(torch.as_tensor(g["quantized"]).to(device)))
    np.testing.assert_allclose(latents, g["latents"], rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(indices.cpu().numpy(), g["indices"])
    np.testing.assert_allclose(_np(quantized), g["quantized"], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(float(loss), float(g["codebook_loss"]), rtol=1e-3, atol=1e-5)
    err = float(np.abs(recon - g["recon"]).max())
    assert err < 1e-2, f"VQ recon max abs err {err:.3e}"
    np.testing.assert_allclose(recon, g["recon"], rtol=1e-3, atol=1e-3)


def _pipeline(g, steps, trajectory):
    device = _card()
    schedule = make_schedule(num_steps=1000, beta_start=0.00085, beta_end=0.012, eta=0.0,
                             num_ddim_steps=steps)
    with torch.no_grad():
        return sample_txt2img(*_pipeline_models(), schedule,
                              torch.as_tensor(g["token_ids"]).to(device), g["xt0"].shape,
                              guidance_scale=5.0, init_noise=torch.as_tensor(g["xt0"]),
                              return_trajectory=trajectory, device=device)


@pytest.mark.cuda
def test_txt2img_production_5step_matches_golden():
    g = _golden("txt2img_pipeline_prod")
    images, x0 = _pipeline(g, 5, False)
    np.testing.assert_allclose(_np(x0), g["x_final"], rtol=1e-3, atol=1e-3)
    px = float(np.abs(_np(images) - g["images"]).max())
    assert px < 1e-2, f"pixel err {px:.3e}"


@pytest.mark.cuda
def test_txt2img_production_50step_matches_golden():
    """The north star: every step of the 50-step trajectory within 1e-2,
    the final latent at the CPU tolerance, pixels within 1e-2."""
    g = _golden("txt2img_pipeline_prod50")
    images, x0, traj = _pipeline(g, 50, True)
    drift = np.abs(_np(traj) - g["traj"]).max(axis=(1, 2, 3, 4))
    print("\n[drift] per-step max abs latent error: " + " ".join(f"{d:.2e}" for d in drift))
    assert float(drift.max()) < 1e-2, f"drift {drift.max():.3e} at step {drift.argmax() + 1}"
    np.testing.assert_allclose(_np(x0), g["x_final"], rtol=1e-3, atol=1e-3)
    px = float(np.abs(_np(images) - g["images"]).max())
    assert px < 1e-2, f"pixel err {px:.3e}"
