"""The PyTorch port stands alone: no JAX, flax or ``ldm_tf2_tpu`` import,
no library attention or ``torch.compile``, and no silent CPU fallback."""

import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
PKG = os.path.join(ROOT, "ldm_tf2_tpu_torch")

_RUN_TINY_PIPELINE = r"""
import sys
import torch
from ldm_tf2_tpu_torch import factory
from ldm_tf2_tpu_torch.cli.run_ldm_sampler import sample_txt2img, tensor_to_image
from ldm_tf2_tpu_torch.data.tokenizer import cfg_token_ids, load_tokenizer

config = {
    "cond_stage_model": dict(vocab_size=30522, encoder_stack_size=1,
        hidden_size=32, num_heads=2, size_per_head=8, max_seq_len=77,
        filter_size=64, dropout_rate=0.0),
    "unet": dict(model_channels=32, out_channels=4, num_blocks=1,
        attention_resolutions=[1], dropout_rate=0.0, channel_mult=[1, 2],
        num_heads=2),
    "autoencoder_kl": dict(latent_channels=4, channels=32, num_blocks=1,
        attention_resolutions=[], dropout_rate=0.0, multipliers=[1, 2],
        resample_with_conv=True),
    "ldm": dict(num_steps=50, beta_start=0.00085, beta_end=0.012,
        v_posterior=0.0, scale_factor=0.18215, eta=0.0, num_ddim_steps=2),
    "tpu": {"compute_dtype": "float32"},
}
from ldm_tf2_tpu_torch.configs.loader import validate
validate(config)
models = [factory.randomize_(build(config, device="cpu"), seed)
          for seed, build in enumerate((factory.build_cond_model,
                                        factory.build_unet,
                                        factory.build_autoencoder))]
ids = cfg_token_ids(load_tokenizer(sys.argv[1]), "a red fox", 1)
images, _ = sample_txt2img(*models, factory.build_schedule(config),
                           torch.as_tensor(ids), (1, 8, 8, 4), device="cpu")
assert tensor_to_image(images.numpy()).shape == (1, 16, 16, 3)
import ldm_tf2_tpu_torch.checkpoints.blob
import ldm_tf2_tpu_torch.checkpoints.convert_lpips
import ldm_tf2_tpu_torch.checkpoints.convert_pytorch
import ldm_tf2_tpu_torch.checkpoints.manager
import ldm_tf2_tpu_torch.cli.convert_ckpt_pytorch
import ldm_tf2_tpu_torch.cli.export_pretrained
import ldm_tf2_tpu_torch.cli.run_eval
import ldm_tf2_tpu_torch.cli.run_quality_eval
import ldm_tf2_tpu_torch.cli.run_tfrecord_converters
import ldm_tf2_tpu_torch.eval.fid
import ldm_tf2_tpu_torch.eval.inception
import ldm_tf2_tpu_torch.utils.profiling
import ldm_tf2_tpu_torch.cli.run_autoencoder_trainer
import ldm_tf2_tpu_torch.cli.run_ldm_trainer
import ldm_tf2_tpu_torch.cli.serve_ldm
import ldm_tf2_tpu_torch.data.dataset
import ldm_tf2_tpu_torch.diffusion.losses
import ldm_tf2_tpu_torch.models.discriminator
import ldm_tf2_tpu_torch.models.lpips
import ldm_tf2_tpu_torch.models.quantize
import ldm_tf2_tpu_torch.training.ae_trainer
import ldm_tf2_tpu_torch.training.ldm_trainer
import ldm_tf2_tpu_torch.utils.logging
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "ldm_tf2_tpu"))
print("FOREIGN", bad)
"""


def test_port_runs_without_jax_or_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _RUN_TINY_PIPELINE,
         os.path.join(ROOT, "bert_model")],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT},
    )
    assert out.returncode == 0, out.stderr
    assert "FOREIGN []" in out.stdout, out.stdout


def test_entry_point_refuses_to_fall_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from ldm_tf2_tpu_torch.cli.run_ldm_sampler import sample_txt2img

    with pytest.raises(RuntimeError, match="device='cpu'"):
        sample_txt2img(None, None, None, None, torch.zeros(2, 77), (1, 8, 8, 4))


def _sources():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        paths += [os.path.join(dirpath, f) for f in files
                  if f.endswith((".py", ".cu"))]
    return paths


# The tokenizer table's generator asks BertTokenizerFast itself how it
# treats each character, so it alone may import transformers and
# tokenizers; no module of the port imports the generator (checked below).
TABLE_GENERATOR = os.path.join(PKG, "data", "make_bert_chars.py")
# The CLIP score needs pretrained CLIP weights in transformers' format: it
# imports transformers inside clip_score, after its weights gate, and
# nothing else in the module does (checked below).
CLIP_SCORE = os.path.join(PKG, "eval", "fid.py")


def test_sources_import_nothing_foreign_and_use_no_library_attention():
    foreign = re.compile(
        r"^\s*(import|from)\s+(jax|flax|orbax|absl|transformers|ldm_tf2_tpu)\b"
    )
    generator_only = re.compile(r"^\s*(import|from)\s+(transformers|tokenizers)\b")
    banned = ("scaled_dot_product_attention", "torch.compile")
    for path in _sources():
        with open(path, encoding="utf-8") as f:
            text = f.read()
        for line in text.splitlines():
            if path == TABLE_GENERATOR and generator_only.match(line):
                continue
            if path == CLIP_SCORE and line == "    from transformers import CLIPModel, CLIPProcessor":
                continue
            assert not foreign.match(line), f"{path}: {line}"
        if path != TABLE_GENERATOR:
            assert not re.search(r"^\s*(import|from)\s.*make_bert_chars", text, re.M), (
                f"{path} imports the table generator")
        if path == CLIP_SCORE:
            body = text[text.index("def clip_score("):]
            assert body.index("clip_weights_path is None") < body.index("from transformers")
        if path.endswith("chip_smoke.py"):
            continue  # times SDPA as a yardstick only, never on the path
        for word in banned:
            assert word not in text, f"{path} mentions {word}"
