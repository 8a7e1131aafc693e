"""The port's data layer and trainer CLI, on the CPU.

The port keeps its own copies of the TFRecord codec, the Example codec and
the Python input pipeline; they are held to the JAX package's functions on
the same records: byte-identical files and messages, equal decoded images
(the same PIL decode and transform) and the same batches in the same
order.  The JAX package's native C++ decoder is switched off for the
comparison: the port does not use it.  The trainer CLI runs as a user
would run it, on tiny TFRecords and a tiny weight blob written here.
"""

import io
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm_tf2_tpu.checkpoints.blob import export_blob
from ldm_tf2_tpu.data import dataset as jds
from ldm_tf2_tpu.data import example_proto as jex
from ldm_tf2_tpu.data import native as jnative
from ldm_tf2_tpu.data import tfrecord as jtf
from ldm_tf2_tpu.models import AutoencoderKL, TransformerModel
from ldm_tf2_tpu_torch.checkpoints.manager import CheckpointManager
from ldm_tf2_tpu_torch.data import dataset as tds
from ldm_tf2_tpu_torch.data import example_proto as tex
from ldm_tf2_tpu_torch.data import tfrecord as ttf

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))


def _jpeg(rng, h, w):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(buf, "JPEG")
    return buf.getvalue()


def _write_records(directory, n_files=2, per_file=6, seed=0, caption_len=5):
    rng = np.random.default_rng(seed)
    os.makedirs(directory, exist_ok=True)
    for i in range(n_files):
        with ttf.TFRecordWriter(os.path.join(directory, f"part_{i}.tfrecord")) as w:
            for _ in range(per_file):
                h, w_ = (int(x) for x in rng.integers(12, 40, 2))
                ids = [101] + [int(x) for x in rng.integers(1000, 2000, caption_len)] + [102]
                w.write(tex.encode_example({"image": _jpeg(rng, h, w_), "caption": ids}))


def test_tfrecord_and_example_codecs_match_jax(tmp_path):
    feats = {"image": b"\x00\xffjpeg", "caption": [101, 7, -3, 2**40, 102],
             "score": [0.5, -1.25], "tags": [b"a", b"bc"]}
    msg = tex.encode_example(feats)
    assert msg == jex.encode_example(feats)
    assert tex.decode_example(msg) == jex.decode_example(msg)
    assert tex.decode_example(msg)["caption"] == feats["caption"]
    records = [msg, b"", b"x" * 1000]
    paths = [str(tmp_path / "port.tfrecord"), str(tmp_path / "jax.tfrecord")]
    for cls, path in zip((ttf.TFRecordWriter, jtf.TFRecordWriter), paths):
        with cls(path) as w:
            for r in records:
                w.write(r)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    assert list(ttf.TFRecordReader(paths[1], verify_crc=True)) == records
    assert list(jtf.TFRecordReader(paths[0], verify_crc=True)) == records


@pytest.mark.parametrize("shape", [(30, 17, 3), (17, 30, 3), (24, 24, 3)])
def test_process_image_matches_jax(shape):
    img = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    np.testing.assert_array_equal(tds.process_image(img, 16),
                                  jds.process_image(img, 16))


def test_batches_match_jax_python_path(tmp_path, monkeypatch):
    """Two files of six records, batch 4 over 3+ epochs: the record stream
    (file shuffle, shuffle buffer, repeat) and each decoded example."""
    _write_records(str(tmp_path))
    files = tds.list_tfrecords(str(tmp_path))
    assert files == jds.list_tfrecords(str(tmp_path)) and len(files) == 2
    monkeypatch.setattr(jnative, "available", lambda: False)
    kw = dict(batch_size=4, image_size=16, max_seq_len=8, random_seed=3)
    ours, theirs = tds.create_dataset(files, **kw), jds.create_dataset(files, **kw)
    for _ in range(10):
        (a_img, a_ids), (b_img, b_ids) = next(ours), next(theirs)
        assert a_img.shape == (4, 16, 16, 3) and a_ids.shape == (4, 8)
        np.testing.assert_array_equal(a_img, b_img)
        np.testing.assert_array_equal(a_ids, b_ids)


# -------------------------------------------------------------- the CLI --

COND = dict(vocab_size=30522, encoder_stack_size=1, hidden_size=32, num_heads=2,
            size_per_head=8, max_seq_len=8, filter_size=64, dropout_rate=0.1)
AE = dict(latent_channels=4, channels=32, num_blocks=1, attention_resolutions=[],
          dropout_rate=0.0, multipliers=[1, 2], resample_with_conv=True)


def _blob(path):
    key = jax.random.PRNGKey(0)
    cond = TransformerModel(**COND)
    ae = AutoencoderKL(**{k: AE[k] for k in ("latent_channels", "channels",
                                              "num_blocks", "multipliers")})
    shapes = {
        "cond_stage_model": jax.eval_shape(
            lambda: cond.init(key, jnp.zeros((1, 8), jnp.int32)))["params"],
        "autoencoder": jax.eval_shape(lambda: ae.init(
            {"params": key, "sample": key}, jnp.zeros((1, 16, 16, 3))))["params"],
    }
    rng = np.random.default_rng(0)
    trees = jax.tree.map(
        lambda s: (0.05 * rng.standard_normal(s.shape)).astype(np.float32), shapes)
    export_blob(path, trees)


def _config(tmp_path, num_iterations):
    return {
        "cond_stage_model": COND,
        "unet": dict(model_channels=64, out_channels=4, num_blocks=1,
                     attention_resolutions=[1], dropout_rate=0.1, channel_mult=[1, 2],
                     num_heads=2),
        "autoencoder_kl": AE,
        "ldm": dict(num_steps=100, beta_start=0.00085, beta_end=0.012,
                    v_posterior=0.0, scale_factor=0.18215, eta=0.0, num_ddim_steps=2),
        "ldm_training": dict(
            root_path=str(tmp_path / "records"),
            params=dict(batch_size=2, image_size=16, flip=True,
                        keys=["image", "caption"]),
            autoencoder_type="kl", ckpt_path=str(tmp_path / "ckpt"),
            num_iterations=num_iterations, train_cond_model=False,
            condition_dropout_rate=0.5, ema_decay=0.99),
        "latent_diffusion_optimizer": dict(learning_rate=1e-4, warmup_steps=1),
        "tpu": dict(compute_dtype="float32", frozen_weights_dtype="bfloat16",
                    persist_per_iterations=1, log_per_iterations=1),
    }


def _run_cli(tmp_path, num_iterations):
    import yaml

    path = tmp_path / f"config_{num_iterations}.yaml"
    path.write_text(yaml.safe_dump(_config(tmp_path, num_iterations)))
    # One intra-op thread: the tiny models gain nothing from more, and on a
    # host busy with other test workers the default pool is 4x slower.
    out = subprocess.run(
        [sys.executable, "-m", "ldm_tf2_tpu_torch.cli.run_ldm_trainer",
         "--config_path", str(path), "--params_blob", str(tmp_path / "params"),
         "--device", "cpu", "--seed", "5"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"},
    )
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def test_trainer_cli_saves_and_resumes(tmp_path):
    from ldm_tf2_tpu_torch import factory
    from ldm_tf2_tpu_torch.configs.loader import validate
    from ldm_tf2_tpu_torch.training.ldm_trainer import restore_state

    _write_records(str(tmp_path / "records"), per_file=3)
    _blob(str(tmp_path / "params"))
    first = _run_cli(tmp_path, 2)
    assert "Training from scratch" in first and "step 2 | loss" in first
    manager = CheckpointManager(str(tmp_path / "ckpt"))
    assert manager.steps() == [1, 2]
    step, saved = manager.restore_latest()
    assert step == 2 and saved["step"] == 2 and saved["seed"] == 5
    assert saved["cond"] is None and saved["opt_state"]["count"] == 2

    # the restored state is the saved one
    config = validate(_config(tmp_path, 2))
    unet = factory.build_trainable_unet(config, "cpu", seed=99)
    state = restore_state(saved, unet)
    assert state.step == 2 and state.opt_state["count"] == 2
    for name, p in unet.state_dict().items():
        assert torch.equal(p, saved["unet"][name]), name
    for name, e in state.ema.items():
        assert torch.equal(e, saved["ema"][name]), name
    fresh = factory.build_trainable_unet(config, "cpu", seed=5)
    moved = [n for n, p in fresh.state_dict().items()
             if not torch.equal(p, saved["unet"][n])]
    assert moved  # two steps of training changed the seed-5 U-Net

    second = _run_cli(tmp_path, 3)
    assert "Restored checkpoint at step 2" in second and "step 3 | loss" in second
    assert "step 1 |" not in second
    assert manager.steps() == [1, 2, 3]
    _, last = manager.restore_latest()
    assert last["opt_state"]["count"] == 3
