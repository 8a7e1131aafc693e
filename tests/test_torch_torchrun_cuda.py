"""The three CLIs of the port under ``torchrun`` on two cards (NCCL)
against one process at the global batch, on the card.

Skipped without two CUDA devices.  The file imports neither JAX nor the
JAX package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_torchrun_cuda.py

Tiny models (``tests/test_torch_parallel.py``'s configs, float32) from
seeded blobs; 16 JPEG records through the indexed loader.  Two ranks at
batch 2 each and one process at batch 4: the LDM trainer's and the KL
autoencoder trainer's logged losses over 3 steps (GAN from step 1) within
rel 1e-4 (they are printed to 6 digits), and the sampler's ``images.npy``
(DDIM, eta 1) within one uint8 step.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from ldm_tf2_tpu_torch import factory
from ldm_tf2_tpu_torch.checkpoints.blob import export_blob
from ldm_tf2_tpu_torch.checkpoints.bridge import params_to_jax
from ldm_tf2_tpu_torch.models import LPIPS
from test_torch_parallel import ROOT, ldm_config, write_records


def _run(cmd, cwd):
    out = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-6000:]
    return out.stdout


def _losses(text, key):
    return {int(m.group(1)): float(m.group(2))
            for m in re.finditer(rf"step (\d+) \| {key}: ([-0-9.e+]+)", text)}


def _config(tmp, world, batch):
    import yaml

    config = ldm_config(os.path.join(tmp, "records"), os.path.join(tmp, f"ckpt{world}"),
                        batch, 3, deterministic_data=True)
    config["autoencoder_kl_trainer"] = dict(
        global_step_discriminator=1, lpips_weight=1.0, kl_weight=1e-6,
        discriminator_weight=0.5, discriminator_factor=1.0,
        discriminator_loss_type="hinge")
    config["ae_kl_discriminator"] = dict(channels=16, num_layers=2)
    config["autoencoder_training"] = dict(
        root_path=os.path.join(tmp, "records"), autoencoder_type="kl", ckpt_path=None,
        params=dict(batch_size=batch, image_size=16, keys=["image"]), num_iterations=3)
    config["autoencoder_optimizer"] = dict(learning_rate=1e-4)
    config["discriminator_optimizer"] = dict(learning_rate=1e-4)
    path = os.path.join(tmp, f"config{world}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(json.loads(json.dumps(config, default=list)), f)
    return path


@pytest.mark.cuda
def test_torchrun_two_cards_equal_one_process(tmp_path):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    tmp = str(tmp_path)
    write_records(os.path.join(tmp, "records"), n=16)
    config = ldm_config(os.path.join(tmp, "records"))
    export_blob(os.path.join(tmp, "params"), {
        "cond_stage_model": params_to_jax(factory.randomize_(
            factory.build_cond_model(config), 1)),
        "unet": params_to_jax(factory.randomize_(factory.build_unet(config), 6)),
        "autoencoder": params_to_jax(factory.randomize_(
            factory.build_autoencoder(config, "kl"), 2))})
    export_blob(os.path.join(tmp, "lpips"),
                {"lpips": params_to_jax(factory.randomize_(LPIPS(), 3))})
    launchers = {2: [sys.executable, "-m", "torch.distributed.run", "--standalone",
                     "--nproc_per_node", "2", "-m"],
                 1: [sys.executable, "-m"]}
    got = {}
    for world, batch in ((2, 2), (1, 4)):
        path = _config(tmp, world, batch)
        work = os.path.join(tmp, f"work{world}")
        os.makedirs(work)
        run = lambda cli, *args: _run(launchers[world] + [
            f"ldm_tf2_tpu_torch.cli.{cli}", "--config_path", path, *args], work)
        ldm = run("run_ldm_trainer", "--params_blob", os.path.join(tmp, "params"),
                  "--seed", "5")
        ae = run("run_autoencoder_trainer", "--lpips_blob", os.path.join(tmp, "lpips"),
                 "--seed", "5")
        run("run_ldm_sampler", "--params_blob", os.path.join(tmp, "params"), "--seed", "9")
        assert f"'data': {world}}}, rank 0 of {world}" in ldm
        got[world] = (_losses(ldm, "loss"), _losses(ae, "ae_loss"),
                      np.load(os.path.join(work, "images.npy")))
    for i, what in ((0, "LDM"), (1, "AE")):
        two, one = got[2][i], got[1][i]
        assert sorted(two) == sorted(one) == [1, 2, 3], what
        np.testing.assert_allclose([two[s] for s in one], list(one.values()),
                                   rtol=1e-4, err_msg=what)
    images_two, images_one = got[2][2], got[1][2]
    assert images_two.shape == images_one.shape == (4, 16, 16, 3)
    assert np.abs(images_two.astype(int) - images_one.astype(int)).max() <= 1
