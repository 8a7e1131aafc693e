"""The port's stage-1 autoencoder trainer against the JAX package's
``make_ae_train_steps``, and its CLI, on the CPU.

One phase-1 step and one phase-2 step, for the KL and the VQ autoencoder,
near the tiny size of ``tests/test_trainers.py`` (16^2 images, LPIPS
VGG16, a 2-layer PatchGAN), on the same materialized weights and images.
The autoencoders have 64 channels, not 32, so that each GroupNorm group
holds two: with one, a per-channel shift before a GroupNorm cannot change
the loss, and the gradients of the decoder's last-level biases are exactly
0, which both frameworks return as rounding noise (rel-L2 up to 0.43 of
each other).  The KL posterior noise is the JAX step's own draw, made from
its folded key and handed to the port.  The VQ model runs with dropout on at
1e-9: the keep probability rounds to 1 in float32, so every dropout site
runs its own code (the split ResidualBlock chain) and keeps every element.

The gradients carry the check: the JAX steps run with optimizers that keep
the gradients they were given, and each step's autoencoder and
discriminator gradients are held to the port's ``.grads`` on the same
weights, per leaf at 1e-4 rel-L2 of the leaf's norm (measured at most
1.9e-5; the attention's key bias, whose gradient softmax cancels exactly,
is held to 1e-4 of a floor at 1e-6 of the whole gradient's norm).  The
metrics are held at rtol 1e-4 (the adaptive weight, a ratio of two
gradient norms, at 5e-3); the discriminator's parameters and running
statistics after the update at 1e-4 of each leaf's scale; the
autoencoder's parameters within Adam's elementwise bound, about lr a step
(Adam's first steps turn a near-zero gradient element's sign into a whole
+-lr, so summation order alone can move an element by 2 lr).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import golden_utils as gu
from ldm_tf2_tpu import models as jm
from ldm_tf2_tpu.training import ae_trainer as jat
from ldm_tf2_tpu_torch import models as tm
from ldm_tf2_tpu_torch.checkpoints.bridge import load_params, params_from_jax
from ldm_tf2_tpu_torch.checkpoints.manager import CheckpointManager
from ldm_tf2_tpu_torch.training import ae_trainer as tat

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
IMG, LR = 16, 1e-4
AE_KW = {"kl": dict(channels=64, num_blocks=1, multipliers=(1, 2)),
         "vq": dict(channels=64, num_blocks=1, multipliers=(1, 2),
                    attention_resolutions=(8,), vocab_size=32, dropout_rate=1e-9)}
WEIGHTS = {"kl": dict(regularization_weight=1e-6, discriminator_weight=0.5),
           "vq": dict(regularization_weight=1.0, discriminator_weight=0.6)}


def _variables(init, order, seed):
    shapes = jax.eval_shape(init)
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    return gu.materialize(zeros, order, seed)


def _keeping_grads(optimizer):
    """``optimizer`` with the gradients of its last update kept in its
    state, as ``(grads, inner_state)``."""
    def init(params):
        return jax.tree.map(jnp.zeros_like, params), optimizer.init(params)

    def update(grads, state, params=None):
        updates, inner = optimizer.update(grads, state[1], params)
        return updates, (grads, inner)

    return optax.GradientTransformation(init, update)


def _jax_run(ae_type, images, ae_vars, lpips_vars, d_vars):
    """Phase 1 then phase 2 of the JAX package's steps, as its CLI builds
    them (the VQ model given a dropout key); returns the two (state,
    metrics) and the KL noise of each step.  Each state's optimizer states
    hold that step's gradients."""
    ae = (jm.AutoencoderKL if ae_type == "kl" else jm.AutoencoderVQ)(**AE_KW[ae_type])
    lpips, disc = jm.LPIPS(), jm.Discriminator(channels=16, num_layers=2)

    if ae_type == "kl":
        def reconstruct(params, x, key, training):
            posterior = ae.apply({"params": params}, x, method=jm.AutoencoderKL.encode,
                                 training=training)
            out = ae.apply({"params": params}, posterior.sample(key),
                           method=jm.AutoencoderKL.decode, training=training)
            return out, posterior, {}

        def reg_loss(posterior):
            kl = posterior.kl()
            return jnp.sum(kl) / kl.shape[0]
    else:
        def reconstruct(params, x, key, training):
            rngs = {"dropout": key}
            z, codebook_loss, _ = ae.apply({"params": params}, x, rngs=rngs,
                                           method=jm.AutoencoderVQ.encode, training=training)
            out = ae.apply({"params": params}, z, method=jm.AutoencoderVQ.decode,
                           training=training, rngs=rngs)
            return out, codebook_loss, {}

        def reg_loss(codebook_loss):
            return codebook_loss

    ae_opt, d_opt = (_keeping_grads(jat.make_adam(LR)) for _ in range(2))
    step1, step2 = jat.make_ae_train_steps(
        reconstruct, reg_loss,
        lambda p, a, b: lpips.apply({"params": p}, a, b),
        lambda v, x, training=False, mutable=False: disc.apply(
            v, x, training=training, mutable=mutable),
        ae_opt, d_opt, type(ae).last_layer_path(), lpips_vars["params"],
        **WEIGHTS[ae_type])
    rng = jax.random.PRNGKey(7)
    state = jat.init_ae_train_state(ae_vars["params"], d_vars, ae_opt, d_opt)
    s1, m1 = jax.jit(step1)(state, images, rng)
    s2, m2 = jax.jit(step2)(s1, images, rng)
    noises = None
    if ae_type == "kl":  # what posterior.sample(fold_in(rng, step)) drew
        shape = (images.shape[0], IMG // 2, IMG // 2, 4)
        noises = [np.asarray(jax.random.normal(jax.random.fold_in(rng, s), shape))
                  for s in (0, 1)]
    return (s1, m1), (s2, m2), noises


@pytest.fixture(scope="module", params=["kl", "vq"])
def ae_case(request):
    ae_type = request.param
    images = (np.random.default_rng(3).standard_normal((2, IMG, IMG, 3)) * 0.5).astype(np.float32)
    jae = (jm.AutoencoderKL if ae_type == "kl" else jm.AutoencoderVQ)(**AE_KW[ae_type])
    key = jax.random.PRNGKey(0)
    if ae_type == "kl":
        ae_vars = _variables(lambda: jae.init({"params": key, "sample": key}, images),
                             gu.autoencoder_kl_order(1, (1, 2), IMG), gu.SEED)
    else:
        ae_vars = _variables(lambda: jae.init(key, images),
                             gu.autoencoder_vq_order(1, (1, 2), IMG, (8,)), gu.SEED)
    lpips_vars = _variables(lambda: jm.LPIPS().init(key, images, images),
                            gu.lpips_order(), gu.SEED + 1)
    d_vars = _variables(lambda: jm.Discriminator(16, 2).init(key, images),
                        gu.discriminator_order(2), gu.SEED + 2)
    jax_out = _jax_run(ae_type, jnp.asarray(images), ae_vars, lpips_vars, d_vars)

    def port(ae_tree, d_tree):
        tae = (tm.AutoencoderKL(**AE_KW["kl"]) if ae_type == "kl"
               else tm.AutoencoderVQ(**AE_KW["vq"], resolution=IMG))
        ae = load_params(tae, ae_tree).requires_grad_(True)
        disc = load_params(tm.Discriminator(16, 2), d_tree).requires_grad_(True)
        lpips = load_params(tm.LPIPS(), lpips_vars).requires_grad_(False)
        ae_opt, d_opt = tat.make_adam(LR), tat.make_adam(LR)
        steps = tat.make_ae_train_steps(ae, disc, lpips, ae_opt, d_opt,
                                        **WEIGHTS[ae_type])
        return ae, disc, steps, tat.init_ae_train_state(ae, disc, ae_opt, d_opt)

    noises = jax_out[2]
    draws = [None if noises is None else {"posterior_noise": torch.as_tensor(np.array(n))}
             for n in (noises or (None, None))]
    x = torch.as_tensor(images)
    ae, disc, (step1, step2), state = port(ae_vars, d_vars)
    grads1, _ = step1.grads(state, x, draws[0])
    state, m1 = step1(state, x, draws[0])
    ae1 = {k: v.detach().clone() for k, v in ae.state_dict().items()}
    state, m2 = step2(state, x, draws[1])

    # phase 2's gradients on the JAX step's own weights after step 1
    s1 = jax_out[0][0]
    ae_s1, disc_s1, (_, gan_step), state_s1 = port(
        {"params": s1.ae_params}, {"params": s1.d_params, "batch_stats": s1.d_batch_stats})
    state_s1.step = 1
    grads2, d_grads2, _ = gan_step.grads(state_s1, x, draws[1])
    names = lambda module: [n for n, _ in module.named_parameters()]
    return dict(ae_type=ae_type, jax=jax_out, m1=m1, m2=m2, ae1=ae1, ae=ae, disc=disc,
                state=state, grads1=dict(zip(names(ae), grads1)),
                grads2=dict(zip(names(ae_s1), grads2)),
                d_grads2=dict(zip(names(disc_s1), d_grads2)))


def _close(got, want, rtol, name):
    np.testing.assert_allclose(float(got), float(want), rtol=rtol, err_msg=name)


def test_phase1_step_matches_jax(ae_case):
    (s1, m1), _, _ = ae_case["jax"]
    for k in ("ae_loss", "nll_loss", "reg_loss"):
        _close(ae_case["m1"][k], m1[k], 1e-4, k)
    want = params_from_jax(jax.tree.map(np.asarray, s1.ae_params))
    for name, got in ae_case["ae1"].items():
        diff = float((got - want[name]).abs().max())
        assert diff <= 3 * LR, f"{name}: {diff:.3e}"


def test_phase2_step_matches_jax(ae_case):
    _, (s2, m2), _ = ae_case["jax"]
    assert set(ae_case["m2"]) == set(m2)
    for k in ("ae_loss", "nll_loss", "reg_loss", "g_loss", "d_loss"):
        _close(ae_case["m2"][k], m2[k], 1e-4, k)
    _close(ae_case["m2"]["adaptive_weight"], m2["adaptive_weight"], 5e-3, "adaptive_weight")
    assert ae_case["state"].step == 2
    assert ae_case["state"].d_opt_state["count"] == 1
    assert ae_case["state"].ae_opt_state["count"] == 2

    disc = params_from_jax({"params": jax.tree.map(np.asarray, s2.d_params),
                            "batch_stats": jax.tree.map(np.asarray, s2.d_batch_stats)})
    for name, got in ae_case["disc"].state_dict().items():
        want = disc[name]
        scale = max(float(want.abs().max()), float(got.abs().max()), 1e-6)
        rel = float((got - want).abs().max()) / scale
        assert rel < 1e-4, f"discriminator {name}: leaf-scale rel err {rel:.3e}"
    want = params_from_jax(jax.tree.map(np.asarray, s2.ae_params))
    for name, got in ae_case["ae"].state_dict().items():
        diff = float((got - want[name]).abs().max())
        assert diff <= 2 * 3 * LR, f"{name}: {diff:.3e}"


def _grads_match(got: dict, tree, what: str):
    """Each leaf of the port's gradients within 1e-4 rel-L2 of the JAX
    step's, on the leaf's own norm; a leaf whose JAX gradient is zero up to
    rounding (below 1e-6 of the whole gradient's norm) is held to that."""
    want = params_from_jax(jax.tree.map(np.asarray, tree))
    assert set(got) == set(want), what
    total = float(torch.sqrt(sum(torch.sum(w.double() ** 2) for w in want.values())))
    worst = []
    for name, w in want.items():
        err = float((got[name].double() - w.double()).norm())
        scale = max(float(w.double().norm()), 1e-6 * total)
        worst.append((err / scale, name))
    worst.sort(reverse=True)
    assert worst[0][0] <= 1e-4, f"{what}: worst leaves {worst[:5]}"


def test_phase1_gradients_match_jax(ae_case):
    (s1, _), _, _ = ae_case["jax"]
    _grads_match(ae_case["grads1"], s1.ae_opt_state[0], "autoencoder, phase 1")


def test_phase2_gradients_match_jax(ae_case):
    """On the JAX state after step 1: the autoencoder's gradients (through
    LPIPS, the generator term with its adaptive weight, the VQ
    straight-through path, attention and dropout) and the discriminator's."""
    _, (s2, _), _ = ae_case["jax"]
    _grads_match(ae_case["grads2"], s2.ae_opt_state[0], "autoencoder, phase 2")
    _grads_match(ae_case["d_grads2"], {"params": s2.d_opt_state[0]}, "discriminator")


def test_generator_term_leaves_discriminator_grads_alone():
    """The phase-2 step takes the autoencoder's gradients with respect to
    its own parameters only: D's ``.grad`` collects nothing, and D's
    parameters move by its own loss alone."""
    torch.manual_seed(0)
    from ldm_tf2_tpu_torch import factory

    ae = factory.init_params_(tm.AutoencoderKL(**AE_KW["kl"]), 0).requires_grad_(True)
    disc = factory.init_params_(tm.Discriminator(16, 2), 1).requires_grad_(True)
    lpips = factory.randomize_(tm.LPIPS(), 2).requires_grad_(False)
    _, step2 = tat.make_ae_train_steps(ae, disc, lpips, tat.make_adam(LR),
                                       tat.make_adam(LR))
    state = tat.init_ae_train_state(ae, disc, tat.make_adam(LR), tat.make_adam(LR))
    x = torch.randn(2, IMG, IMG, 3, generator=torch.Generator().manual_seed(1)) * 0.5
    state, metrics = step2(state, x)
    assert all(p.grad is None for p in disc.parameters())
    assert all(p.grad is None for p in ae.parameters())
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert 0.0 <= float(metrics["adaptive_weight"]) <= 1e4 * 0.5


# ------------------------------------------------------------------- CLI --

def _records(directory, n=6, seed=0):
    from PIL import Image
    import io

    from ldm_tf2_tpu_torch.data import example_proto as tex
    from ldm_tf2_tpu_torch.data import tfrecord as ttf

    rng = np.random.default_rng(seed)
    os.makedirs(directory, exist_ok=True)
    with ttf.TFRecordWriter(os.path.join(directory, "part_0.tfrecord")) as w:
        for _ in range(n):
            buf = io.BytesIO()
            pixels = rng.integers(0, 256, (int(rng.integers(16, 30)), 20, 3), dtype=np.uint8)
            Image.fromarray(pixels).save(buf, format="JPEG")
            w.write(tex.encode_example({"image": buf.getvalue()}))


def _config(tmp_path, num_iterations):
    return {
        "cond_stage_model": dict(vocab_size=100, encoder_stack_size=1, hidden_size=64,
                                 num_heads=2, size_per_head=32, max_seq_len=8,
                                 filter_size=128, dropout_rate=0.0),
        "unet": dict(model_channels=32, out_channels=4, num_blocks=1,
                     attention_resolutions=[1], dropout_rate=0.0, channel_mult=[1, 2],
                     num_heads=2),
        "autoencoder_kl": dict(latent_channels=4, channels=32, num_blocks=1,
                               attention_resolutions=[], dropout_rate=0.0,
                               multipliers=[1, 2], resample_with_conv=True),
        "autoencoder_vq": dict(latent_channels=4, channels=32, num_blocks=1,
                               attention_resolutions=[8], dropout_rate=0.0,
                               multipliers=[1, 2], resample_with_conv=True,
                               vocab_size=32, beta=0.25),
        "ae_vq_discriminator": dict(channels=16, num_layers=2),
        "ldm": dict(num_steps=100, beta_start=0.00085, beta_end=0.012, v_posterior=0.0,
                    scale_factor=0.18215, eta=0.0, num_ddim_steps=2),
        "autoencoder_training": dict(
            root_path=str(tmp_path / "records"),
            params=dict(batch_size=2, image_size=IMG, keys=["image"]),
            autoencoder_type="vq", ckpt_path=str(tmp_path / "ckpt"),
            num_iterations=num_iterations),
        "autoencoder_vq_trainer": dict(global_step_discriminator=1, codebook_weight=1.0,
                                       lpips_weight=1.0, kl_weight=1.0,
                                       discriminator_weight=0.6, discriminator_factor=1.0,
                                       discriminator_loss_type="hinge"),
        "autoencoder_optimizer": dict(learning_rate=1e-4, beta_1=0.5, beta_2=0.9,
                                      epsilon=1e-8),
        "discriminator_optimizer": dict(learning_rate=1e-4, beta_1=0.5, beta_2=0.9,
                                        epsilon=1e-8),
        "tpu": dict(compute_dtype="float32", persist_per_iterations=1,
                    log_per_iterations=1),
    }


def _run_cli(tmp_path, num_iterations):
    import yaml

    path = tmp_path / f"config_{num_iterations}.yaml"
    path.write_text(yaml.safe_dump(_config(tmp_path, num_iterations)))
    out = subprocess.run(
        [sys.executable, "-m", "ldm_tf2_tpu_torch.cli.run_autoencoder_trainer",
         "--config_path", str(path), "--lpips_blob", str(tmp_path / "lpips"),
         "--device", "cpu", "--seed", "5"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"},
    )
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def test_ae_trainer_cli_saves_resumes_and_switches_phase(tmp_path):
    from ldm_tf2_tpu.checkpoints.blob import export_blob
    from ldm_tf2_tpu_torch import factory
    from ldm_tf2_tpu_torch.configs.loader import validate

    _records(str(tmp_path / "records"))
    shapes = jax.eval_shape(lambda: jm.LPIPS().init(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), jnp.zeros((1, IMG, IMG, 3))))
    rng = np.random.default_rng(0)
    export_blob(str(tmp_path / "lpips"), {"lpips": jax.tree.map(
        lambda s: (0.05 * rng.standard_normal(s.shape)).astype(np.float32),
        shapes["params"])})

    first = _run_cli(tmp_path, 2)
    lines = {int(line.split()[1]): line for line in first.splitlines()
             if line.startswith("step ")}
    assert "from scratch" in first
    assert "ae_loss" in lines[1] and "d_loss" not in lines[1]  # phase 1 at step 0
    assert "adaptive_weight" in lines[2] and "d_loss" in lines[2]  # GAN from step 1
    manager = CheckpointManager(str(tmp_path / "ckpt"))
    assert manager.steps() == [1, 2]
    step, saved = manager.restore_latest()
    assert step == 2 and saved["seed"] == 5
    assert saved["ae_opt_state"]["count"] == 2 and saved["d_opt_state"]["count"] == 1

    config = validate(_config(tmp_path, 2))
    ae = factory.build_autoencoder(config, "vq", "cpu", None, resolution=IMG)
    disc = factory.build_discriminator(config, "vq")
    state = tat.restore_state(saved, ae, disc)
    assert state.step == 2
    for name, p in disc.state_dict().items():
        assert torch.equal(p, saved["discriminator"][name]), name
    assert float(disc.bn_1.var.sub(1.0).abs().max()) > 0  # the running stats moved

    second = _run_cli(tmp_path, 3)
    assert "Restored checkpoint at step 2" in second
    assert "step 1 |" not in second and "step 3 |" in second
    assert manager.steps() == [1, 2, 3]
    _, last = manager.restore_latest()
    assert last["d_opt_state"]["count"] == 2


def test_ae_config_checks():
    from ldm_tf2_tpu_torch.cli.run_autoencoder_trainer import train
    from ldm_tf2_tpu_torch.configs.loader import validate

    base = _config(__import__("pathlib").Path("/nonexistent"), 1)
    for section, key, value, error in (
            ("autoencoder_training", "autoencoder_type", "vae", ValueError),
            ("autoencoder_vq_trainer", "global_step_discriminator", -1, ValueError),
            ("autoencoder_vq_trainer", "discriminator_loss_type", "wgan", ValueError),
            ("autoencoder_optimizer", "weight_decay", 0.1, ValueError)):
        bad = {**base, section: {**base[section], key: value}}
        with pytest.raises(error):
            validate(bad)
    # tpu.remat and tpu.deterministic_data are accepted (tests/test_torch_remat.py,
    # tests/test_torch_indexed.py); a mesh the world does not fill raises the
    # JAX create_mesh's ValueError, a model axis names the unported item
    for tpu, error, what in (
            ({"mesh": {"data": 2}}, ValueError, r"mesh shape \{'data': 2\} != 1 devices"),
            ({"mesh": {"data": -1, "model": 2}, "tensor_parallel": True},
             NotImplementedError, "item A6b")):
        config = validate({**base, "tpu": {**base["tpu"], **tpu}})
        with pytest.raises(error, match=what):
            train(config, device="cpu", models=(None, None, None))
