"""The port's JSONL server (``ldm_tf2_tpu_torch/cli/serve_ldm.py``) on the CPU.

The requests of the JAX server's own test (``tests/test_cli_end_to_end.py``
``test_serve_ldm_loop``), same-seed requests packed into one pipeline call
and held to the direct pipeline, the request parser and the wave reader
against the JAX functions on the same lines, and ``main`` on a blob the
JAX package exported, in the int8 serving mode.
"""

import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden_utils as gu
from ldm_tf2_tpu import models as jm
from ldm_tf2_tpu.checkpoints.blob import export_blob
from ldm_tf2_tpu_torch import factory
from ldm_tf2_tpu_torch.cli import serve_ldm
from ldm_tf2_tpu_torch.cli.run_ldm_sampler import sample_txt2img, tensor_to_image
from ldm_tf2_tpu_torch.configs.loader import validate
from ldm_tf2_tpu_torch.data.tokenizer import load_tokenizer, packed_cfg_token_ids

VOCAB = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                     "bert_model")
TR = dict(vocab_size=30522, encoder_stack_size=1, hidden_size=64, num_heads=2,
          size_per_head=32, max_seq_len=8, filter_size=128, dropout_rate=0.0)
UNET = dict(model_channels=32, out_channels=4, num_blocks=1,
            attention_resolutions=[1], dropout_rate=0.0, channel_mult=[1, 2],
            num_heads=2)
AE = dict(latent_channels=4, channels=32, num_blocks=1, attention_resolutions=[],
          dropout_rate=0.0, multipliers=[1, 2], resample_with_conv=True)


def _config(**tpu):
    return validate({
        "cond_stage_model": dict(TR), "unet": dict(UNET),
        "autoencoder_kl": dict(AE),
        "ldm": dict(num_steps=50, beta_start=0.00085, beta_end=0.012,
                    v_posterior=0.0, scale_factor=0.18215, eta=0.0,
                    num_ddim_steps=2),
        "ldm_sampling": dict(guidance_scale=5.0, latent_shape=[2, 8, 8, 4],
                             text_prompt="a red fox", vocab_dir=VOCAB,
                             autoencoder_type="kl"),
        "tpu": {"compute_dtype": "float32", **tpu},
    })


def _models(config):
    return tuple(
        factory.randomize_(build(config, device="cpu"), seed)
        for seed, build in ((1, factory.build_cond_model),
                            (2, factory.build_unet),
                            (3, factory.build_autoencoder)))


def _serve(config, requests, tmp_path, models=None, **kwargs):
    out = io.StringIO()
    serve_ldm.serve(config, io.StringIO(requests), out, output_dir=str(tmp_path),
                    device="cpu", models=models or _models(config), **kwargs)
    return [json.loads(line) for line in out.getvalue().splitlines()]


def test_serve_answers_the_jax_servers_requests(tmp_path):
    requests = "\n".join([
        '{"prompt": "a virus monster", "seed": 1, "out": "r1"}',
        '{"prompt": ["guitar", "canvas oil"], "seed": 2,'
        ' "guidance_scale": 2.5, "out": "r2"}',
        "this is not json",
        '{"cmd": "exit"}',
        '{"prompt": "never reached", "out": "r3"}',
    ])
    resps = _serve(_config(), requests, tmp_path)
    assert len(resps) == 3
    assert resps[0]["ok"] and resps[1]["ok"]
    assert not resps[2]["ok"] and "error" in resps[2]
    for r in resps[:2]:
        images = np.load(r["out"])
        assert images.shape == (2, 16, 16, 3) and images.dtype == np.uint8
    assert not (tmp_path / "r3.npy").exists()


def test_same_seed_requests_share_one_call_equal_to_the_pipeline(tmp_path,
                                                                 monkeypatch):
    """Two one-slot requests with one seed pack into one call (besides the
    warm-up); each slot's pixels equal the direct pipeline's on the same
    packed prompts, negatives, per-slot guidance and seed."""
    calls = []

    def counting(*args, **kwargs):
        calls.append(kwargs["seed"])
        return sample_txt2img(*args, **kwargs)

    monkeypatch.setattr(serve_ldm, "sample_txt2img", counting)
    config = _config()
    models = _models(config)
    requests = "\n".join([
        '{"prompt": "a red fox", "n": 1, "seed": 4, "guidance_scale": 2.0,'
        ' "out": "a"}',
        '{"prompt": ["a blue sky"], "seed": 4, "guidance_scale": 7.5,'
        ' "negative_prompt": "blurry", "out": "b"}',
    ])
    resps = _serve(config, requests, tmp_path, models=models)
    assert [r["ok"] for r in resps] == [True, True]
    assert calls == [0, 4]  # the warm-up, then one packed call
    assert resps[0]["batched_requests"] == 2

    ids = packed_cfg_token_ids(load_tokenizer(VOCAB), ["a red fox", "a blue sky"],
                               ["", "blurry"], 8)
    guidance = torch.tensor([2.0, 7.5]).reshape(2, 1, 1, 1)
    images, _ = sample_txt2img(*models, factory.build_schedule(config),
                               torch.as_tensor(ids), (2, 8, 8, 4),
                               guidance_scale=guidance, seed=4, device="cpu")
    want = tensor_to_image(images.numpy())
    np.testing.assert_array_equal(np.load(tmp_path / "a.npy"), want[:1])
    np.testing.assert_array_equal(np.load(tmp_path / "b.npy"), want[1:])


def test_request_parser_and_wave_reader_match_jax():
    # imported here: the JAX server defines absl flags when imported, which
    # must not happen at collection, before another CLI's tests define them
    from ldm_tf2_tpu.cli import serve_ldm as jserve

    sampling = {"text_prompt": "default", "guidance_scale": 5.0,
                "negative_prompt": "neg"}
    requests = [
        {}, {"prompt": "x", "n": 3, "seed": 7, "out": "o"},
        {"prompt": ["a", "b"], "guidance_scale": 2.5, "negative_prompt": ""},
        {"prompt": ["a", "b"], "n": 3}, {"prompt": "x", "n": 0}, ["not", "a dict"],
    ]
    for req in requests:
        try:
            want = jserve._expand_request(req, sampling, 4)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)[:20]):
                serve_ldm._expand_request(req, sampling, 4)
            continue
        assert serve_ldm._expand_request(req, sampling, 4) == want
    text = '{"prompt": "a"}\n\n  bad line \n"exit"\n{"prompt": "b"}\n{"cmd": "exit"}\n'
    mine, theirs = io.StringIO(text), io.StringIO(text)
    for _ in range(3):
        assert serve_ldm._read_wave(mine, 0.0) == jserve._read_wave(theirs, 0.0)


def test_per_slot_guidance_matches_jax():
    """A per-slot [B, 1, 1, 1] guidance is cast to bf16 eps's dtype (no
    float32 upcast), as the JAX package does."""
    from ldm_tf2_tpu.diffusion import sampler as jsampler
    from ldm_tf2_tpu_torch.diffusion import sampler as tsampler

    eps2 = np.random.default_rng(0).standard_normal((4, 4, 4, 4)).astype(np.float32)
    guidance = np.array([2.0, 7.5], np.float32).reshape(2, 1, 1, 1)
    got = tsampler.apply_cfg(torch.as_tensor(eps2).bfloat16(),
                             torch.as_tensor(guidance))
    want = jsampler.apply_cfg(jnp.asarray(eps2, jnp.bfloat16), jnp.asarray(guidance))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_server_refuses_unported_branches():
    for sampling, tpu, what in (({"sampler": "plms", "cache_interval": 3}, {}, "item A1"),
                                ({"cache_interval": 2}, {}, "DeepCache"),
                                ({}, {"mesh": {"data": -1, "model": 2}}, "mesh")):
        config = _config(**tpu)
        config["ldm_sampling"].update(sampling)
        with pytest.raises(NotImplementedError, match=what):
            serve_ldm.build_server(config, device="cpu", models=())


def test_loader_validates_serving_modes():
    assert _config(quantize="int8", quantize_attention="int8pv")["tpu"]["quantize"] \
        == "int8"
    for tpu in ({"quantize": "int4"}, {"quantize_attention": "int8"},
                {"quantize": "int8", "tensor_parallel": True}):
        with pytest.raises(ValueError):
            _config(**tpu)


def test_main_serves_a_jax_blob_in_int8_mode(tmp_path, monkeypatch):
    """``main`` end to end: a config file, a blob the JAX package exported,
    requests on stdin.  The 8x8 latent's level-0 chains take the int8
    route (two-stage class)."""
    key = jax.random.PRNGKey(0)

    def variables(init, order, seed):
        shapes = jax.eval_shape(init)
        zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
        return gu.materialize(zeros, order, seed)["params"]

    unet_kw = {k: v for k, v in UNET.items() if k != "attention_resolutions"}
    ae_kw = {k: AE[k] for k in ("channels", "num_blocks", "multipliers")}
    tr, un, ae = jm.TransformerModel(**TR), jm.UNet(**unet_kw, context_channels=64), \
        jm.AutoencoderKL(**ae_kw)
    export_blob(str(tmp_path / "params"), {
        "cond_stage_model": variables(lambda: tr.init(key, jnp.zeros((2, 8), jnp.int32)),
                                      gu.transformer_order(1), gu.SEED + 41),
        "unet": variables(lambda: un.init(key, jnp.zeros((2, 8, 8, 4)), jnp.zeros((2,)),
                                          jnp.zeros((2, 8, 64))),
                          gu.unet_order(1, (1, 2)), gu.SEED + 42),
        "autoencoder": variables(lambda: ae.init({"params": key, "sample": key},
                                                 jnp.zeros((1, 16, 16, 3))),
                                 gu.autoencoder_kl_order(1, (1, 2), 16), gu.SEED + 43),
    })
    config = _config(quantize="int8")
    path = tmp_path / "config.json"  # JSON is YAML
    path.write_text(json.dumps(config))
    monkeypatch.setattr("sys.stdin", io.StringIO(
        '{"prompt": "a red fox", "seed": 3, "out": "m"}\n'))
    out = io.StringIO()
    monkeypatch.setattr("sys.stdout", out)
    serve_ldm.main(["--config_path", str(path), "--params_blob",
                    str(tmp_path / "params"), "--output_dir", str(tmp_path),
                    "--device", "cpu"])
    resp = json.loads(out.getvalue().splitlines()[-1])
    assert resp["ok"] and resp["shape"] == [2, 16, 16, 3]
    assert np.load(tmp_path / "m.npy").dtype == np.uint8
