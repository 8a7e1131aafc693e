"""The port's indexed deterministic loader (``data/indexed.py``,
``tpu.deterministic_data``) against ``ldm_tf2_tpu.data.indexed`` on the
same records, built as ``tests/test_data.py`` builds them: the index and
the captions bit-equal, the images within 1e-6 (the JAX loader may take its
C++ decoder, which ``tests/test_native_loader.py`` holds to its Python path
at that tolerance).  Then resume, shards and epochs as the JAX test checks
them, and the LDM trainer resuming from its checkpoint to the losses of an
unbroken run.
"""

import numpy as np
import pytest
import torch

from ldm_tf2_tpu.data import indexed as jax_indexed
from ldm_tf2_tpu.data.example_proto import encode_example
from ldm_tf2_tpu.data.tfrecord import TFRecordWriter
from ldm_tf2_tpu_torch.data.indexed import build_index, create_indexed_dataset
from test_data import _write_jpeg

N = 8
KWARGS = dict(batch_size=2, image_size=16, keys=("image", "caption"), flip=True,
              max_seq_len=3, random_seed=7)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Two files of 4 records each, record i with caption [100 + i, 0, 0]
    and an image of its own size and colour."""
    tmp = tmp_path_factory.mktemp("indexed")
    img_dir, rec_dir = tmp / "imgs", tmp / "records"
    img_dir.mkdir()
    rec_dir.mkdir()
    with TFRecordWriter(str(rec_dir / "a.tfrecord")) as wa, \
            TFRecordWriter(str(rec_dir / "b.tfrecord")) as wb:
        for i in range(N):
            p = str(img_dir / f"{i}.jpg")
            _write_jpeg(p, size=(18 + i, 24), color=(i * 30 % 256, 10, 10))
            with open(p, "rb") as f:
                rec = encode_example({"image": f.read(), "caption": [100 + i, 0, 0]})
            (wa if i % 2 == 0 else wb).write(rec)
    return sorted(str(p) for p in rec_dir.glob("*.tfrecord"))


def _take(it, n):
    batches = [next(it) for _ in range(n)]
    it.close()
    return batches


@pytest.fixture(scope="module")
def run_a(files):
    return _take(create_indexed_dataset(files, **KWARGS), 8)  # two epochs


def test_index_matches_jax(files):
    got = build_index(files)
    np.testing.assert_array_equal(got, jax_indexed.build_index(files))
    assert got.dtype == np.int64 and got.shape == (N, 3)


def test_batches_match_jax_with_flips(files, run_a):
    want = jax_indexed.create_indexed_dataset(files, **KWARGS)
    flipped = 0
    for s, (images, caps) in enumerate(run_a):
        w_images, w_caps = next(want)
        np.testing.assert_array_equal(caps, w_caps, err_msg=f"step {s}")
        np.testing.assert_allclose(images, w_images, rtol=0, atol=1e-6,
                                   err_msg=f"step {s}")
        assert images.dtype == np.float32 and caps.dtype == np.int64
        flipped += sum(not np.array_equal(im, im[:, ::-1]) for im in images)
    want.close()
    assert flipped  # the images are not all mirror-symmetric


def test_resume_at_step_3(files, run_a):
    for s, (images, caps) in enumerate(
            _take(create_indexed_dataset(files, start_step=3, **KWARGS), 5), start=3):
        np.testing.assert_array_equal(images, run_a[s][0])
        np.testing.assert_array_equal(caps, run_a[s][1])


def test_shards_concatenate_to_the_global_batch(files, run_a):
    shards = [_take(create_indexed_dataset(files, shard_index=k, shard_count=2,
                                           **{**KWARGS, "batch_size": 1}), 8)
              for k in (0, 1)]
    for s in range(8):
        np.testing.assert_array_equal(
            np.concatenate([shards[0][s][0], shards[1][s][0]]), run_a[s][0])
        np.testing.assert_array_equal(
            np.concatenate([shards[0][s][1], shards[1][s][1]]), run_a[s][1])
    with pytest.raises(ValueError, match="shard 2 not in"):
        create_indexed_dataset(files, shard_index=2, shard_count=2)


def test_each_record_once_per_epoch(run_a):
    epochs = [np.concatenate([run_a[e * 4 + s][1][:, 0] for s in range(4)])
              for e in range(2)]
    for ids in epochs:
        assert sorted(ids.tolist()) == [100 + i for i in range(N)]
    assert not np.array_equal(epochs[0], epochs[1])


def test_trainer_resumes_to_the_unbroken_losses(tmp_path):
    """``run_ldm_trainer.train`` with ``tpu.deterministic_data``: 2 steps,
    then a fresh call on the same checkpoint directory that resumes at step
    2, take steps 3 and 4 to the losses of 4 unbroken steps, bit for bit."""
    from ldm_tf2_tpu_torch import factory
    from ldm_tf2_tpu_torch.cli.run_ldm_trainer import train
    from ldm_tf2_tpu_torch.configs.loader import validate
    from test_torch_data import _config, _write_records

    _write_records(str(tmp_path / "records"), per_file=3)

    def run(ckpt, num_iterations):
        config = _config(tmp_path, num_iterations)
        config["ldm_training"]["ckpt_path"] = str(tmp_path / ckpt)
        config["tpu"].update(deterministic_data=True, persist_per_iterations=2)
        config = validate(config)
        models = (factory.randomize_(factory.build_cond_model(
                      config, "cpu", "frozen_weights_dtype"), 1),
                  factory.build_trainable_unet(config, "cpu", seed=5),
                  factory.randomize_(factory.build_autoencoder(
                      config, "kl", "cpu", "frozen_weights_dtype"), 2))
        _, records = train(config, device="cpu", seed=5, models=models)
        return {r["step"]: r["loss"] for r in records}

    unbroken = run("a", 4)
    assert sorted(unbroken) == [1, 2, 3, 4]
    first = run("b", 2)
    assert first == {1: unbroken[1], 2: unbroken[2]}
    resumed = run("b", 4)
    assert resumed == {3: unbroken[3], 4: unbroken[4]}
