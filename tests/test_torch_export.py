"""Weight export and data preparation of the port, held to the JAX
package on the same inputs.

* ``params_to_jax`` inverts ``params_from_jax`` bit for bit for every model
  family, the discriminator's BatchNorm statistics going to
  ``batch_stats`` as in the JAX discriminator's variables.
* The trainers run one or two tiny CPU steps with a ``ckpt_path``;
  ``cli/export_pretrained.py`` turns the checkpoints into blobs (LDM EMA
  and live weights, the autoencoder, a bf16 serving blob) whose leaves the
  JAX ``load_blob`` reads equal to the models' weights (tolerance 0), and
  the sampler CLI samples from them exactly what the in-memory models
  sample (tolerance 0).
* The TFRecord writers write files byte-equal to the JAX writers', the
  COCO captions tokenized by the port's tokenizer against the JAX path's
  ``BertTokenizerFast``.
"""

import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from test_torch_convert import assert_trees_bit_equal

from ldm_tf2_tpu.checkpoints.blob import load_blob
from ldm_tf2_tpu_torch import factory
from ldm_tf2_tpu_torch.checkpoints.blob import export_blob, read_blob
from ldm_tf2_tpu_torch.checkpoints.bridge import params_from_jax, params_to_jax
from ldm_tf2_tpu_torch.cli import export_pretrained
from ldm_tf2_tpu_torch.configs.loader import validate

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
AE = dict(latent_channels=4, channels=32, num_blocks=1, dropout_rate=0.0,
          multipliers=[1, 2], resample_with_conv=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny shapes gain nothing from torch's thread pool, and on a host
    busy with other test workers the pool slows this file down."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(tmp_path, compute="float32", weights=None, iterations=2):
    return {
        "cond_stage_model": dict(vocab_size=30522, encoder_stack_size=1, hidden_size=32,
                                 num_heads=2, size_per_head=16, max_seq_len=8,
                                 filter_size=64, dropout_rate=0.0),
        "unet": dict(model_channels=32, out_channels=4, num_blocks=1,
                     attention_resolutions=[1], dropout_rate=0.0, channel_mult=[1, 2],
                     num_heads=2),
        "autoencoder_kl": dict(AE, attention_resolutions=[]),
        "autoencoder_vq": dict(AE, attention_resolutions=[8], vocab_size=32, beta=0.25),
        "ae_kl_discriminator": dict(channels=16, num_layers=2),
        "ae_vq_discriminator": dict(channels=16, num_layers=2),
        "ldm": dict(num_steps=100, beta_start=0.00085, beta_end=0.012,
                    v_posterior=0.0, scale_factor=0.18215, eta=0.0, num_ddim_steps=2),
        "ldm_sampling": dict(guidance_scale=5.0, latent_shape=[1, 8, 8, 4],
                             text_prompt="a red fox", autoencoder_type="kl",
                             vocab_dir=os.path.join(ROOT, "bert_model")),
        "ldm_training": dict(
            root_path=str(tmp_path / "records"),
            params=dict(batch_size=2, image_size=16, flip=False, keys=["image", "caption"]),
            autoencoder_type="kl", ckpt_path=str(tmp_path / "ldm_ckpt"),
            num_iterations=iterations, train_cond_model=False,
            condition_dropout_rate=0.5, ema_decay=0.9),
        "latent_diffusion_optimizer": dict(learning_rate=1e-3, warmup_steps=1),
        "autoencoder_training": dict(
            root_path=str(tmp_path / "images"),
            params=dict(batch_size=2, image_size=16, keys=["image"]),
            autoencoder_type="kl", ckpt_path=str(tmp_path / "ae_ckpt"),
            num_iterations=1),
        "autoencoder_kl_trainer": dict(global_step_discriminator=1, lpips_weight=1.0,
                                       kl_weight=1e-6, discriminator_weight=0.5,
                                       discriminator_factor=1.0,
                                       discriminator_loss_type="hinge"),
        "autoencoder_optimizer": dict(learning_rate=1e-3, beta_1=0.5, beta_2=0.9),
        "discriminator_optimizer": dict(learning_rate=1e-3, beta_1=0.5, beta_2=0.9),
        "tpu": dict(compute_dtype=compute, weights_dtype=weights,
                    persist_per_iterations=1, log_per_iterations=1),
    }


def _write(tmp_path, config, name="config.yaml"):
    import yaml

    path = str(tmp_path / name)
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return path


def _models(config, seed=0):
    built = (factory.build_cond_model(config, "cpu"), factory.build_unet(config, "cpu"),
             factory.build_autoencoder(config, "kl", "cpu"))
    return [factory.randomize_(m, seed + i) for i, m in enumerate(built)]


def _family(name, config):
    if name == "cond":
        return factory.build_cond_model(config, "cpu")
    if name == "unet":
        return factory.build_unet(config, "cpu")
    if name in ("kl", "vq"):
        return factory.build_autoencoder(config, name, "cpu", resolution=16)
    if name == "discriminator":
        return factory.build_discriminator(config, "kl", "cpu")
    return factory.build_lpips(config, "cpu")


@pytest.mark.parametrize("name", ["cond", "unet", "kl", "vq", "discriminator", "lpips"])
def test_params_to_jax_round_trips_bit_for_bit(tmp_path, name):
    config = validate(_config(tmp_path))
    model = factory.randomize_(_family(name, config), 3)
    if name == "discriminator":  # running statistics that are not 0 and 1
        for i, buf in enumerate(model.buffers()):
            buf.copy_(torch.randn(buf.shape, generator=torch.Generator().manual_seed(i)))
    state = model.state_dict()
    tree = params_to_jax(model)
    back = params_from_jax(tree)
    assert sorted(back) == sorted(state)
    for key, value in state.items():
        assert back[key].dtype == value.dtype and torch.equal(back[key], value), key
    for conv in [k for k, v in state.items() if v.dim() == 4][:1]:  # none in cond
        *path, leaf = conv.split(".")
        node = tree["params"] if name == "discriminator" else tree
        for part in path:
            node = node[part]
        assert torch.equal(node[leaf], state[conv].permute(2, 3, 1, 0))  # HWIO


def test_discriminator_tree_is_the_jax_variables_layout(tmp_path):
    """params and batch_stats leaves and shapes as the JAX discriminator's
    ``init`` makes them; the tree loads back into the port's module."""
    from ldm_tf2_tpu.models.discriminator import Discriminator

    config = validate(_config(tmp_path))
    model = factory.randomize_(factory.build_discriminator(config, "kl", "cpu"), 1)
    tree = params_to_jax(model)
    assert set(tree) == {"params", "batch_stats"}
    want = jax.eval_shape(lambda: Discriminator(channels=16, num_layers=2).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3))))
    shapes = lambda t: jax.tree.map(lambda x: tuple(x.shape), t)
    assert shapes(dict(want)) == shapes(tree)
    from ldm_tf2_tpu_torch.checkpoints.bridge import load_params

    again = load_params(factory.build_discriminator(config, "kl", "cpu"), tree)
    for key, value in model.state_dict().items():
        assert torch.equal(again.state_dict()[key], value), key


def _ldm_batches(n, seed=0):
    gen = torch.Generator().manual_seed(seed)
    for _ in range(n):
        yield (torch.rand(2, 16, 16, 3, generator=gen) * 2 - 1,
               torch.randint(1000, 2000, (2, 8), generator=gen))


def _sample_in_memory(config, cond, unet, ae, seed=0):
    from ldm_tf2_tpu_torch.cli.run_ldm_sampler import sample_txt2img
    from ldm_tf2_tpu_torch.data.tokenizer import cfg_token_ids, load_tokenizer

    sampling = config["ldm_sampling"]
    shape = tuple(sampling["latent_shape"])
    ids = cfg_token_ids(load_tokenizer(sampling["vocab_dir"]), sampling["text_prompt"],
                        shape[0], config["cond_stage_model"]["max_seq_len"])
    images, _ = sample_txt2img(
        cond, unet, ae, factory.build_schedule(config), torch.as_tensor(ids), shape,
        guidance_scale=float(sampling["guidance_scale"]),
        scale_factor=config["ldm"]["scale_factor"], seed=seed, device="cpu")
    return images


def _sample_cli(tmp_path, monkeypatch, config_path, blob):
    from ldm_tf2_tpu_torch.cli import run_ldm_sampler

    monkeypatch.chdir(tmp_path)
    images = run_ldm_sampler.main(["--config_path", config_path, "--params_blob", blob,
                                   "--device", "cpu"])
    saved = np.load(tmp_path / "images.npy")
    assert saved.shape == (1, 16, 16, 3) and saved.dtype == np.uint8
    return images


@pytest.fixture(scope="module")
def trained_ldm(tmp_path_factory):
    """Two LDM train steps with EMA from a port-written base blob (frozen
    text encoder and autoencoder); the trained U-Net and its EMA."""
    from ldm_tf2_tpu_torch.cli.run_ldm_trainer import train

    tmp_path = tmp_path_factory.mktemp("ldm")
    raw = _config(tmp_path)
    config = validate(json.loads(json.dumps(raw)))
    cond, _, ae = _models(config)
    base = str(tmp_path / "base")
    export_blob(base, {"cond_stage_model": params_to_jax(cond),
                       "autoencoder": params_to_jax(ae)})
    unet = factory.build_trainable_unet(config, "cpu", seed=7)
    state, _ = train(config, device="cpu", batches=_ldm_batches(2), models=(cond, unet, ae))
    assert state.step == 2
    ema = {k[len("unet."):]: v for k, v in state.ema.items()}
    return tmp_path, raw, base, cond, unet, ae, ema


@pytest.mark.parametrize("use_ema", [True, False])
def test_ldm_export_loads_in_jax_and_samples_as_in_memory(trained_ldm, monkeypatch, use_ema):
    tmp_path, raw, base, cond, unet, ae, ema = trained_ldm
    config_path = _write(tmp_path, raw)
    out_dir = str(tmp_path / ("ema" if use_ema else "live"))
    export_pretrained.main(["--config_path", config_path, "--which", "ldm",
                            "--params_blob", base, "--out_dir", out_dir]
                           + ([] if use_ema else ["--no-use_ema"]))
    blob = os.path.join(out_dir, "params")
    weights = ema if use_ema else {k: v.detach() for k, v in unet.state_dict().items()}
    assert any(not torch.equal(weights[k], v) for k, v in unet.state_dict().items()) == use_ema
    want = {"cond_stage_model": params_to_jax(cond), "unet": params_to_jax(weights),
            "autoencoder": params_to_jax(ae)}
    assert_trees_bit_equal(jax.tree.map(np.asarray, load_blob(blob)), want)

    config = validate(json.loads(json.dumps(raw)))
    sampled_unet = factory.build_unet(config, "cpu")
    sampled_unet.load_state_dict(weights)
    got = _sample_cli(tmp_path, monkeypatch, config_path, blob)
    assert torch.equal(got, _sample_in_memory(config, cond, sampled_unet, ae))


def test_ldm_export_of_a_frozen_encoder_needs_the_base_blob(trained_ldm):
    tmp_path, raw, *_ = trained_ldm
    with pytest.raises(SystemExit, match="pass --params_blob"):
        export_pretrained.main(["--config_path", _write(tmp_path, raw), "--which", "ldm",
                                "--out_dir", str(tmp_path / "none")])


def test_ldm_export_of_a_trained_encoder_takes_its_ema(tmp_path):
    """train_cond_model: the checkpoint holds the encoder; its EMA is
    exported, and the base blob is not needed for it."""
    from ldm_tf2_tpu_torch.cli.run_ldm_trainer import train

    raw = _config(tmp_path, iterations=1)
    raw["ldm_training"]["train_cond_model"] = True
    config = validate(json.loads(json.dumps(raw)))
    cond, _, ae = _models(config)
    cond = cond.float()
    unet = factory.build_trainable_unet(config, "cpu", seed=7)
    state, _ = train(config, device="cpu", batches=_ldm_batches(1), models=(cond, unet, ae))
    export_pretrained.main(["--config_path", _write(tmp_path, raw), "--which", "ldm",
                            "--out_dir", str(tmp_path / "out")])
    got = read_blob(str(tmp_path / "out" / "params"))
    assert sorted(got) == ["cond_stage_model", "unet"]
    cond_ema = {k[len("cond."):]: v for k, v in state.ema.items() if k.startswith("cond.")}
    assert_trees_bit_equal(got["cond_stage_model"], params_to_jax(cond_ema))


def test_autoencoder_export_after_ae_training(tmp_path):
    """One KL AE train step (phase 2, with the discriminator); the
    exported ``autoencoder`` equals the trained weights in the JAX
    ``load_blob``; the discriminator is not exported."""
    from ldm_tf2_tpu_torch.cli.run_autoencoder_trainer import train

    raw = _config(tmp_path)
    config = validate(json.loads(json.dumps(raw)))
    ae = factory.init_params_(factory.build_autoencoder(config, "kl", "cpu", dtype_key=None,
                                                        resolution=16), 0)
    disc = factory.init_params_(factory.build_discriminator(config, "kl", "cpu"), 1)
    lpips = factory.randomize_(factory.build_lpips(config, "cpu"), 2)
    gen = torch.Generator().manual_seed(0)
    batches = [torch.rand(2, 16, 16, 3, generator=gen) * 2 - 1]
    state, _ = train(config, device="cpu", batches=batches, models=(ae, disc, lpips))
    assert state.step == 1
    export_pretrained.main(["--config_path", _write(tmp_path, raw), "--which",
                            "autoencoder", "--out_dir", str(tmp_path / "out")])
    blob = str(tmp_path / "out" / "params")
    want = {"autoencoder": params_to_jax(ae)}
    assert_trees_bit_equal(jax.tree.map(np.asarray, load_blob(blob)), want)
    assert_trees_bit_equal(read_blob(blob), want)


def test_serving_bf16_blob_samples_as_f32_with_bf16_weights(tmp_path, monkeypatch):
    """``--which serving --dtype bfloat16``: float32 leaves become bf16
    (round to nearest even, as ml_dtypes and the load-time cast round),
    int leaves stay; in the JAX ``load_blob`` they are bfloat16.  Sampling
    from it equals sampling from the float32 blob with
    ``tpu.weights_dtype: bfloat16`` bit for bit."""
    raw = _config(tmp_path, compute="bfloat16")
    config = validate(json.loads(json.dumps(raw)))
    cond, unet, ae = _models(config)
    f32 = str(tmp_path / "f32")
    trees = {"cond_stage_model": params_to_jax(cond), "unet": params_to_jax(unet),
             "autoencoder": params_to_jax(ae), "extra": {"steps": torch.arange(3, dtype=torch.int32)}}
    export_blob(f32, trees)
    config_path = _write(tmp_path, raw)
    export_pretrained.main(["--config_path", config_path, "--which", "serving",
                            "--params_blob", f32, "--dtype", "bfloat16",
                            "--out_dir", str(tmp_path / "bf16")])
    bf16 = str(tmp_path / "bf16" / "params")
    assert os.path.getsize(bf16 + ".bin") < 0.51 * os.path.getsize(f32 + ".bin")
    loaded = jax.tree.map(np.asarray, load_blob(bf16))
    want = jax.tree.map(lambda t: t.numpy().astype(ml_dtypes.bfloat16)
                        if t.dtype == torch.float32 else t.numpy(), trees)
    assert_trees_bit_equal(loaded, want)

    from_bf16 = _sample_cli(tmp_path, monkeypatch, config_path, bf16)
    with_bf16_weights = _write(tmp_path, _config(tmp_path, "bfloat16", "bfloat16"), "w.yaml")
    from_f32 = _sample_cli(tmp_path, monkeypatch, with_bf16_weights, f32)
    assert from_bf16.dtype == torch.bfloat16
    assert torch.equal(from_bf16, from_f32)


def _jpegs(directory, n, seed=0):
    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(directory, exist_ok=True)
    paths = []
    for i in range(n):
        h, w = (int(x) for x in rng.integers(8, 24, 2))
        path = os.path.join(directory, f"img_{i:03d}.jpg")
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(path)
        paths.append(path)
    return paths


def _same_files(dir_a, dir_b):
    names = sorted(os.listdir(dir_a))
    assert names == sorted(os.listdir(dir_b)) and names
    for name in names:
        with open(os.path.join(dir_a, name), "rb") as a, \
                open(os.path.join(dir_b, name), "rb") as b:
            assert a.read() == b.read(), name
    return names


def test_image_writer_bytes_equal_jax(tmp_path):
    from ldm_tf2_tpu.data import dataset as jds
    from ldm_tf2_tpu_torch.cli import run_tfrecord_converters
    from ldm_tf2_tpu_torch.data import dataset as tds

    paths = _jpegs(str(tmp_path / "jpg"), 7)
    jds.convert_images_to_tfrecord(paths, str(tmp_path / "jax"), num_shards=3)
    tds.convert_images_to_tfrecord(paths, str(tmp_path / "port"), num_shards=3)
    names = _same_files(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert names == [f"images_{i:02d}-03.tfrecord" for i in range(3)]
    run_tfrecord_converters.main(["--images_glob", str(tmp_path / "jpg" / "*.jpg"),
                                  "--images_out", str(tmp_path / "cli"),
                                  "--image_shards", "3"])
    _same_files(str(tmp_path / "jax"), str(tmp_path / "cli"))


CAPTIONS = [
    "A man riding a wave on top of a surfboard.",
    "Crème brûlée, café au lait & naïve résumé!",
    "two dogs... playing (happily) in the snow?!",
    "一只猫 sitting on a 键盘 keyboard",
    "an extremely long caption that keeps going and going well past the "
    "maximum length so that the tokenizer has to truncate it",
    "",
    "MiXeD CaSe\tTABS\nand newlines  ",
]


def test_coco_writer_bytes_equal_jax(tmp_path):
    """Captions through the port's tokenizer, truncated and padded to
    max_length as BertTokenizerFast(truncation=True, max_length=16,
    padding="max_length") does on the JAX path: equal ids, equal files."""
    from ldm_tf2_tpu.data import dataset as jds
    from ldm_tf2_tpu.data.tokenizer import load_tokenizer as jax_tokenizer
    from ldm_tf2_tpu_torch.cli import run_tfrecord_converters
    from ldm_tf2_tpu_torch.data import dataset as tds
    from ldm_tf2_tpu_torch.data.tokenizer import load_tokenizer

    root = tmp_path / "coco"
    paths = _jpegs(str(root / "val2017"), 4, seed=1)
    images = [{"id": 10 + i, "file_name": os.path.basename(p)} for i, p in enumerate(paths)]
    anns = [{"image_id": 10 + i % 4, "id": i, "caption": c} for i, c in enumerate(CAPTIONS)]
    os.makedirs(root / "annotations")
    with open(root / "annotations" / "captions.json", "w") as f:
        json.dump({"images": images, "annotations": anns}, f)
    vocab = os.path.join(ROOT, "bert_model")
    hf, port = jax_tokenizer(vocab), load_tokenizer(vocab)
    for caption in CAPTIONS:
        want = hf(caption, truncation=True, max_length=16, padding="max_length")["input_ids"]
        assert port.encode(caption, 16) == want, caption
    jds.convert_coco_captions_to_tfrecord(str(root), "val2017", "captions.json", hf,
                                          str(tmp_path / "jax"), 16, 3)
    tds.convert_coco_captions_to_tfrecord(str(root), "val2017", "captions.json", port,
                                          str(tmp_path / "port"), 16, 3)
    names = _same_files(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert names == [f"coco_caption_{i:02d}-03.tfrecord" for i in range(3)]
    run_tfrecord_converters.main(["--coco_root", str(root), "--coco_part", "val2017",
                                  "--coco_annotations", "captions.json",
                                  "--captions_out", str(tmp_path / "cli"),
                                  "--caption_shards", "3", "--vocab_dir", vocab,
                                  "--max_length", "16"])
    _same_files(str(tmp_path / "jax"), str(tmp_path / "cli"))


def test_converter_cli_needs_a_task():
    from ldm_tf2_tpu_torch.cli import run_tfrecord_converters

    with pytest.raises(SystemExit):
        run_tfrecord_converters.main([])
