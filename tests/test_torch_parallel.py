"""Data parallelism of the port over ``torch.distributed`` (``parallel/``)
on the CPU, with the gloo backend.

* ``create_mesh`` accepts and refuses the meshes the JAX ``create_mesh``
  does, with its message; ``shard_for_process`` equals the JAX one under
  the same process count and index.
* In this process, a one-rank process group runs the data-parallel code
  (the all-reduces, the global batch statistics, the gather): the LDM step,
  the AE GAN step and a CFG sampler call equal the plain runs bit for bit.
* Two spawned ranks at half the batch against one process at the global
  batch: the tiny LDM step with dropout on (loss rtol 1e-5, parameters
  atol 1e-5, as ``tests/test_trainers.py``'s data-parallel step); the tiny
  KL AE GAN step at ``test_trainers.py``'s per-key and per-tree tolerances,
  D's running statistics and the adaptive weight included; a CFG sampler
  call through ``run_ldm_sampler.main``, its gathered images equal to the
  one-process call's; and the LDM trainer on the indexed loader, 2 steps on
  2 ranks and then 2 more on fresh ranks restored from the checkpoint,
  against 4 one-process steps.

The rank workers are this module's functions; the module imports no JAX
at the top, so a spawned rank starts quickly (the JAX checks import it
inside the test).
"""

import json
import os
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ldm_tf2_tpu_torch import factory
from ldm_tf2_tpu_torch.configs.loader import validate
from ldm_tf2_tpu_torch.parallel import Mesh, create_mesh, shard_batch
from ldm_tf2_tpu_torch.training import ae_trainer as tat
from ldm_tf2_tpu_torch.training import ldm_trainer as tt

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
VOCAB = os.path.join(ROOT, "bert_model")
IMG = 16
GLOBAL = 4  # the global batch; two ranks take 2 rows each
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------- configs --

def ldm_config(root, ckpt=None, batch=GLOBAL, num_iterations=1, **tpu):
    return validate({
        "cond_stage_model": dict(vocab_size=30522, encoder_stack_size=1, hidden_size=32,
                                 num_heads=2, size_per_head=8, max_seq_len=8,
                                 filter_size=64, dropout_rate=0.1),
        "unet": dict(model_channels=64, out_channels=4, num_blocks=1,
                     attention_resolutions=[1], dropout_rate=0.1, channel_mult=[1, 2],
                     num_heads=2),
        "autoencoder_kl": dict(latent_channels=4, channels=32, num_blocks=1,
                               attention_resolutions=[], dropout_rate=0.0,
                               multipliers=[1, 2], resample_with_conv=True),
        "ldm": dict(num_steps=100, beta_start=0.00085, beta_end=0.012, v_posterior=0.0,
                    scale_factor=0.18215, eta=1.0, num_ddim_steps=5),
        "ldm_training": dict(
            root_path=str(root), autoencoder_type="kl", ckpt_path=ckpt,
            params=dict(batch_size=batch, image_size=IMG, flip=True,
                        keys=["image", "caption"]),
            num_iterations=num_iterations, train_cond_model=False,
            condition_dropout_rate=0.5, ema_decay=0.99),
        "latent_diffusion_optimizer": dict(learning_rate=LR, epsilon=1e-3,
                                           clip_grad_norm=1.0),
        "ldm_sampling": dict(guidance_scale=5.0, latent_shape=[GLOBAL, 8, 8, 4],
                             text_prompt="a red fox", vocab_dir=VOCAB,
                             autoencoder_type="kl"),
        "tpu": dict(compute_dtype="float32", persist_per_iterations=2,
                    log_per_iterations=1, **tpu),
    })


def ldm_models(config):
    return (factory.randomize_(factory.build_cond_model(config, "cpu"), 1),
            factory.build_trainable_unet(config, "cpu", seed=5),
            factory.randomize_(factory.build_autoencoder(config, "kl", "cpu"), 2))


def ldm_batch():
    rng = np.random.default_rng(1)
    images = rng.uniform(-1, 1, (GLOBAL, IMG, IMG, 3)).astype(np.float32)
    ids = rng.integers(4, 1000, (GLOBAL, 8)).astype(np.int64)
    return torch.as_tensor(images), torch.as_tensor(ids)


def ldm_steps(mesh, steps=2):
    """``steps`` LDM train steps on this rank's rows of the global batch:
    (losses, U-Net parameters, the train state)."""
    config = ldm_config("unused")
    cond, unet, ae = ldm_models(config)
    unet.requires_grad_(True)
    opt = tt.make_optimizer(**config["latent_diffusion_optimizer"])
    step = tt.make_ldm_train_step(
        unet, cond, ae, factory.build_schedule(config), opt,
        condition_dropout_rate=0.5, null_token_ids=np.array([101, 102] + [0] * 6),
        ema_decay=0.99, seed=3, mesh=mesh)
    state = tt.init_ldm_train_state(unet, cond, opt, ema_decay=0.99)
    images, ids = (shard_batch(x, mesh) for x in ldm_batch())
    losses = []
    for _ in range(steps):
        state, m = step(state, images, ids)
        losses.append(float(m["loss"]))
    return losses, {n: p.detach().clone() for n, p in unet.named_parameters()}, state


def ae_gan_step(mesh):
    """One KL AE GAN step (``test_trainers.py``'s tiny setup) on this rank's
    rows: (metrics, AE params, D params, D buffers, both Adam states)."""
    from ldm_tf2_tpu_torch import models as tm

    ae = factory.init_params_(tm.AutoencoderKL(channels=32, num_blocks=1,
                                               multipliers=(1, 2)), 1)
    disc = factory.init_params_(tm.Discriminator(channels=16, num_layers=2), 2)
    lpips = factory.randomize_(tm.LPIPS(), 3).requires_grad_(False)
    ae_opt, d_opt = tat.make_adam(1e-4), tat.make_adam(1e-4)
    _, step2 = tat.make_ae_train_steps(ae, disc, lpips, ae_opt, d_opt,
                                       regularization_weight=1e-6,
                                       discriminator_weight=0.5, seed=4, mesh=mesh)
    state = tat.init_ae_train_state(ae, disc, ae_opt, d_opt)
    rng = np.random.default_rng(3)
    images = torch.as_tensor(0.5 * rng.standard_normal((GLOBAL, IMG, IMG, 3)),
                             dtype=torch.float32)
    state, metrics = step2(state, shard_batch(images, mesh))
    clone = lambda m: {n: t.detach().clone() for n, t in m}
    return ({k: float(v) for k, v in metrics.items()}, clone(ae.named_parameters()),
            clone(disc.named_parameters()), clone(disc.named_buffers()),
            state.ae_opt_state, state.d_opt_state)


def write_sampler_inputs(directory) -> str:
    """A blob of seeded weights and a JSON config for the sampler CLI;
    returns the config's path."""
    from ldm_tf2_tpu_torch.checkpoints.blob import export_blob
    from ldm_tf2_tpu_torch.checkpoints.bridge import params_to_jax

    config = ldm_config("unused")
    cond = factory.randomize_(factory.build_cond_model(config), 1)
    unet = factory.randomize_(factory.build_unet(config), 6)
    ae = factory.randomize_(factory.build_autoencoder(config, "kl"), 2)
    export_blob(os.path.join(directory, "params"), {
        "cond_stage_model": params_to_jax(cond), "unet": params_to_jax(unet),
        "autoencoder": params_to_jax(ae)})
    raw = {k: v for k, v in config.items()}
    path = os.path.join(directory, "config.json")
    with open(path, "w") as f:
        json.dump(raw, f, default=list)
    return path


def sample(directory, out_dir):
    """``run_ldm_sampler.main`` (DDIM, eta 1: noise at every step) from
    ``out_dir``; returns the images it returned."""
    from ldm_tf2_tpu_torch.cli import run_ldm_sampler

    cwd = os.getcwd()
    os.makedirs(out_dir, exist_ok=True)
    os.chdir(out_dir)
    try:
        return run_ldm_sampler.main([
            "--config_path", os.path.join(directory, "config.json"), "--params_blob",
            os.path.join(directory, "params"), "--seed", "9", "--device", "cpu"])
    finally:
        os.chdir(cwd)


def train_ldm(root, ckpt, batch, num_iterations):
    """``run_ldm_trainer.train`` on the indexed loader; {step: loss}."""
    from ldm_tf2_tpu_torch.cli.run_ldm_trainer import train

    config = ldm_config(root, ckpt, batch, num_iterations, deterministic_data=True)
    _, records = train(config, device="cpu", seed=5, models=ldm_models(config))
    return {r["step"]: r["loss"] for r in records}


def write_records(directory, n=8):
    import io

    from PIL import Image

    from ldm_tf2_tpu_torch.data.example_proto import encode_example
    from ldm_tf2_tpu_torch.data.tfrecord import TFRecordWriter

    rng = np.random.default_rng(0)
    os.makedirs(directory, exist_ok=True)
    with TFRecordWriter(os.path.join(directory, "part_0.tfrecord")) as w:
        for _ in range(n):
            buf = io.BytesIO()
            h, w_ = (int(x) for x in rng.integers(12, 40, 2))
            Image.fromarray(rng.integers(0, 256, (h, w_, 3), dtype=np.uint8)).save(
                buf, "JPEG")
            ids = [101] + [int(x) for x in rng.integers(1000, 2000, 5)] + [102]
            w.write(encode_example({"image": buf.getvalue(), "caption": ids}))


# ------------------------------------------------------------- the ranks --

def _rank_main(rank, world, port, directory, phase):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = create_mesh()
        if phase == "first":
            out = {"ldm": ldm_steps(mesh), "ae": ae_gan_step(mesh),
                   "images": sample(directory, os.path.join(directory, f"dp{rank}")),
                   "train": train_ldm(os.path.join(directory, "records"),
                                      os.path.join(directory, "ckpt_dp"), GLOBAL // world, 2)}
        else:
            out = {"train": train_ldm(os.path.join(directory, "records"),
                                      os.path.join(directory, "ckpt_dp"), GLOBAL // world, 4)}
        torch.save(out, os.path.join(directory, f"{phase}_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spawn(directory, phase, world=2):
    mp.start_processes(_rank_main, args=(world, _free_port(), str(directory), phase),
                       nprocs=world, join=True, start_method="spawn")
    return [torch.load(os.path.join(directory, f"{phase}_rank{r}.pt"), weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    directory = tmp_path_factory.mktemp("dp")
    write_records(str(directory / "records"))
    write_sampler_inputs(str(directory))
    first = _spawn(directory, "first")
    second = _spawn(directory, "second")
    return directory, first, second


# ------------------------------------------------------------------ mesh --

@pytest.mark.parametrize("shape,world", [
    (None, 8), ({"data": -1}, 8), ({"data": 8}, 8), ({"data": 2, "model": 4}, 8),
    ({"data": -1, "model": 2}, 8), ({"data": 4}, 8), ({"data": -1, "model": 3}, 8),
    ({"data": 2}, 1), ({"data": -1}, 1), ({"data": 1, "model": 1}, 1),
])
def test_create_mesh_accepts_and_refuses_as_jax(shape, world):
    import jax

    from ldm_tf2_tpu.parallel.mesh import create_mesh as jax_create_mesh

    try:
        want = dict(jax_create_mesh(shape, devices=jax.devices()[:world]).shape)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).replace("{", r"\{").replace("}", r"\}")):
            create_mesh(shape, world=world, rank=0)
        return
    mesh = create_mesh(shape, world=world, rank=world - 1)
    assert dict(mesh.shape) == want and mesh.world == world and mesh.rank == world - 1
    assert not mesh.distributed  # no process group here


@pytest.mark.parametrize("n_files,count", [(5, 2), (8, 4), (1, 2), (3, 1), (6, 3)])
def test_shard_for_process_matches_jax(monkeypatch, n_files, count):
    import jax

    from ldm_tf2_tpu.data.dataset import shard_for_process as jax_shard
    from ldm_tf2_tpu_torch.data.dataset import shard_for_process

    files = [f"f{i}.tfrecord" for i in range(n_files)]
    monkeypatch.setattr(jax, "process_count", lambda: count)
    for index in range(count):
        monkeypatch.setattr(jax, "process_index", lambda index=index: index)
        assert shard_for_process(files, Mesh({"data": count}, index, count)) == \
            jax_shard(files)


# ------------------------------------------------ one rank, bit for bit --

def test_world_one_group_equals_the_plain_runs(tmp_path):
    """The all-reduce, batch-statistics and gather code at world 1 (a gloo
    group in this process) against the plain runs: bit-equal."""
    plain_ldm, plain_ae = ldm_steps(None), ae_gan_step(None)
    write_sampler_inputs(str(tmp_path))
    plain_images = sample(str(tmp_path), str(tmp_path / "plain"))
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = create_mesh()
        assert mesh.distributed and mesh.world == 1
        ldm, ae = ldm_steps(mesh), ae_gan_step(mesh)
        images = sample(str(tmp_path), str(tmp_path / "group"))
    finally:
        dist.destroy_process_group()
    assert ldm[0] == plain_ldm[0]
    for name, p in plain_ldm[1].items():
        assert torch.equal(ldm[1][name], p), name
    assert ae[0] == plain_ae[0]
    for got, want in zip(ae[1:4], plain_ae[1:4]):
        for name, t in want.items():
            assert torch.equal(got[name], t), name
    assert torch.equal(images, plain_images)


# -------------------------------------------------------------- two ranks --

def test_two_rank_ldm_step_equals_one_process(two_ranks):
    _, first, _ = two_ranks
    want_losses, want, want_state = ldm_steps(None)
    for r, out in enumerate(first):
        losses, params, state = out["ldm"]
        np.testing.assert_allclose(losses, want_losses, rtol=1e-5, err_msg=f"rank {r}")
        for name, p in want.items():
            np.testing.assert_allclose(params[name].numpy(), p.numpy(), rtol=0,
                                       atol=1e-5, err_msg=f"rank {r} {name}")
        for name, e in want_state.ema.items():
            np.testing.assert_allclose(state.ema[name].numpy(), e.numpy(), rtol=0,
                                       atol=1e-5, err_msg=f"rank {r} ema {name}")
    moved = max(float((first[0]["ldm"][1][n] - p).abs().max())
                for n, p in ldm_steps(None, steps=0)[1].items())
    assert moved > 1e-4, moved
    # the ranks' states are identical: params, EMA and both moments
    (_, p0, s0), (_, p1, s1) = first[0]["ldm"], first[1]["ldm"]
    for tree0, tree1 in ((p0, p1), (s0.ema, s1.ema), (s0.opt_state["mu"], s1.opt_state["mu"]),
                         (s0.opt_state["nu"], s1.opt_state["nu"])):
        for name, t in tree0.items():
            assert torch.equal(t, tree1[name]), name


def _leaf_scale_check(what, got: dict, want: dict, tol):
    assert set(got) == set(want), what
    for name, w in want.items():
        a, b = got[name].double(), w.double()
        scale = max(float(a.abs().max()), float(b.abs().max()), 1e-6)
        rel = float((a - b).abs().max()) / scale
        assert rel < tol, f"{what} {name}: leaf-scale rel err {rel:.3e}"


def test_two_rank_ae_gan_step_equals_one_process(two_ranks):
    """``test_trainers.py::test_ae_gan_train_step_data_parallel_matches``'s
    tolerances: metrics per key; D's parameters, running statistics (1e-4)
    and Adam state (1e-3) leaf-scale; the autoencoder's parameters within
    3 lr (Adam's first-step update bound)."""
    _, first, _ = two_ranks
    metrics, ae_p, d_p, d_buf, ae_opt, d_opt = ae_gan_step(None)
    for r, out in enumerate(first):
        m, g_ae, g_d, g_buf, g_ae_opt, g_d_opt = out["ae"]
        for k, rtol in (("ae_loss", 1e-3), ("nll_loss", 1e-4), ("reg_loss", 1e-4),
                        ("d_loss", 1e-4), ("g_loss", 1e-4), ("adaptive_weight", 5e-3)):
            np.testing.assert_allclose(m[k], metrics[k], rtol=rtol, err_msg=f"rank {r} {k}")
        _leaf_scale_check(f"rank {r} d params", g_d, d_p, 1e-4)
        _leaf_scale_check(f"rank {r} d batch stats", g_buf, d_buf, 1e-4)
        _leaf_scale_check(f"rank {r} d mu", g_d_opt["mu"], d_opt["mu"], 1e-3)
        _leaf_scale_check(f"rank {r} d nu", g_d_opt["nu"], d_opt["nu"], 1e-3)
        for name, p in ae_p.items():
            d = float((g_ae[name].double() - p.double()).abs().max())
            assert d <= 3e-4, f"rank {r} ae {name}: {d:.3e}"
    assert float(d_buf["bn_1.var"].sub(1.0).abs().max()) > 0  # the statistics moved


def test_two_rank_cfg_sampler_call_equals_one_process(two_ranks, tmp_path):
    directory, first, _ = two_ranks
    want = sample(str(directory), str(tmp_path))
    for r, out in enumerate(first):
        torch.testing.assert_close(out["images"], want, rtol=0, atol=0,
                                   msg=f"rank {r}")
    np.testing.assert_array_equal(np.load(directory / "dp0" / "images.npy"),
                                  np.load(tmp_path / "images.npy"))
    assert not (directory / "dp1" / "images.npy").exists()  # rank 0 writes


def test_two_rank_resume_equals_four_one_process_steps(two_ranks, tmp_path):
    """2 ranks x 2 steps, then fresh ranks restored from the checkpoint x 2
    more, on the indexed loader, against 4 steps of one process at the
    global batch."""
    directory, first, second = two_ranks
    want = train_ldm(str(directory / "records"), str(tmp_path / "ckpt"), GLOBAL, 4)
    for r in range(2):
        got = {**first[r]["train"], **second[r]["train"]}
        assert sorted(got) == [1, 2, 3, 4] and sorted(second[r]["train"]) == [3, 4]
        np.testing.assert_allclose([got[s] for s in range(1, 5)],
                                   [want[s] for s in range(1, 5)], rtol=1e-5,
                                   err_msg=f"rank {r}")
