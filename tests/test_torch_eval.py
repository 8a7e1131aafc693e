"""The port's FID harness, Inception pool3, eval CLIs and profiling helpers,
held to the JAX package on the same numpy inputs (on the CPU).

Tolerances: the Fréchet distance and the statistics are the same float64
numpy code (equal to 1e-12 relative); the VGG and Inception features are
float32 convolutions in another order (rel-L2 1e-5); the resize to 299 is
``F.interpolate(bilinear, align_corners=False)``, antialiased only when it
shrinks, against ``jax.image.resize(..., "linear")``: max abs 1e-6 on
values in [-1, 1] when it enlarges (1.2e-7 measured), 1e-5 when it
shrinks (2.9e-6 measured at 512; plain bilinear is 1.05 off there).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm_tf2_tpu.eval import fid as jax_fid
from ldm_tf2_tpu.eval import inception as jax_inception
from ldm_tf2_tpu_torch import factory
from ldm_tf2_tpu_torch.checkpoints.blob import export_blob
from ldm_tf2_tpu_torch.checkpoints.bridge import params_to_jax
from ldm_tf2_tpu_torch.eval import fid, inception

FEATURE_TOL = 1e-5  # rel L2, float32 features
RESIZE_TOL = {"enlarge": 1e-6, "shrink": 1e-5}  # max abs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny shapes gain nothing from torch's thread pool, and on a host
    busy with other test workers the pool slows this file down."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("case", ["random", "shifted", "rank_deficient"])
def test_frechet_matches_jax(case):
    rng = np.random.RandomState(0)
    a = rng.randn(40, 12)
    b = {"random": rng.randn(40, 12), "shifted": rng.randn(40, 12) * 1.5 + 0.3,
         "rank_deficient": rng.randn(5, 12)}[case]
    for f in ("compute_statistics",):
        for x in (a, b):
            for got, want in zip(getattr(fid, f)(x), getattr(jax_fid, f)(x)):
                np.testing.assert_array_equal(got, want)
    got, want = fid.fid_from_features(a, b), jax_fid.fid_from_features(a, b)
    assert got == pytest.approx(want, rel=1e-12, abs=1e-12)
    m1, s1 = fid.compute_statistics(a)
    m2, s2 = fid.compute_statistics(b)
    assert fid.frechet_distance(m1, s1, m2, s2) == pytest.approx(
        jax_fid.frechet_distance(m1, s1, m2, s2), rel=1e-12, abs=1e-12)
    assert fid.fid_from_features(a, a) < 1e-6


@pytest.fixture(scope="module")
def lpips_tree():
    """Seeded LPIPS weights as the blob's ``lpips`` tree (CPU tensors)."""
    model = factory.build_lpips({"tpu": {"compute_dtype": "float32"}}, "cpu")
    return params_to_jax(factory.randomize_(model, 0))


def test_vgg_features_match_jax(lpips_tree):
    """32^2, in batches of 2 (one JAX compile): [N, 1024] pooled stage 4 + 5
    features."""
    images = np.random.RandomState(1).randn(4, 32, 32, 3).astype(np.float32) * 0.5
    got = fid.vgg_feature_extractor(lpips_tree, "cpu", batch_size=2)(images)
    jax_tree = jax.tree.map(lambda t: t.numpy(), lpips_tree)
    want = jax_fid.vgg_feature_extractor(jax_tree, batch_size=2)(images)
    assert got.shape == (4, 1024) and got.dtype == np.float32
    assert _rel_l2(got, want) < FEATURE_TOL
    assert fid.fid_from_features(got, got) < 1e-6


def test_synthetic_inception_state_dict_equals_jax():
    got = inception.make_synthetic_inception_state_dict(seed=3)
    want = jax_inception.make_synthetic_inception_state_dict(seed=3)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


def test_inception_pool3_matches_jax_at_75():
    """The smallest input the graph takes, synthetic weights: every block,
    the padding-excluding average pools and Mixed_7c's max pool."""
    sd = inception.make_synthetic_inception_state_dict(seed=3)
    model = inception.load_torchvision_state_dict(inception.InceptionV3().eval(), sd)
    images = np.random.RandomState(4).uniform(-1, 1, (2, 75, 75, 3)).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(images)).numpy()
    params = jax_inception.convert_torchvision_inception(sd)
    want = np.asarray(jax.jit(jax_inception.inception_pool3)(params, jnp.asarray(images)))
    assert got.shape == (2, 2048)
    assert _rel_l2(got, want) < FEATURE_TOL


@pytest.mark.parametrize("size", [256, 512, 75])
def test_resize_to_299_matches_jax_image_resize(size):
    """Upsampling (256, 75) is plain half-pixel bilinear; shrinking (512)
    is antialiased (a triangle kernel widened by the scale) in both."""
    images = np.random.RandomState(size).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    got = inception.resize_to_299(torch.from_numpy(images)).numpy()
    want = np.asarray(jax.image.resize(jnp.asarray(images), (2, 299, 299, 3), "linear"))
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) < RESIZE_TOL["shrink" if size > 299 else "enlarge"]


def test_inception_extractor_loads_a_torch_pth(tmp_path):
    """The --inception_weights_path route: a torch-saved torchvision-layout
    state_dict (with the fc head the graph ignores), resized to 299."""
    sd = inception.make_synthetic_inception_state_dict(seed=1)
    path = str(tmp_path / "inception.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    features = inception.inception_feature_extractor(path, batch_size=1, device="cpu")
    out = features(np.zeros((2, 32, 32, 3), np.float32))
    assert out.shape == (2, 2048) and np.all(np.isfinite(out))
    np.testing.assert_array_equal(out[0], out[1])
    del sd["Mixed_7c.branch_pool.bn.running_var"]
    with pytest.raises(KeyError, match="Mixed_7c.branch_pool.bn.running_var"):
        inception.extractor_from_state_dict(sd, device="cpu")


def test_gates_raise_with_the_jax_messages():
    with pytest.raises(RuntimeError) as want:
        jax_inception.inception_feature_extractor(None)
    with pytest.raises(RuntimeError) as got:
        inception.inception_feature_extractor(None)
    assert str(got.value) == str(want.value)
    images = np.zeros((1, 8, 8, 3), np.uint8)
    with pytest.raises(RuntimeError) as want:
        jax_fid.clip_score(images, ["a"])
    with pytest.raises(RuntimeError) as got:
        fid.clip_score(images, ["a"])
    assert str(got.value) == str(want.value)


def test_entry_points_refuse_to_fall_back_to_cpu(lpips_tree):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fid.vgg_feature_extractor(lpips_tree)


def _image_sets(tmp_path):
    rng = np.random.RandomState(5)
    gen = rng.randint(0, 256, (4, 32, 32, 3)).astype(np.uint8)
    real_dir = tmp_path / "real"
    real_dir.mkdir()
    for i in range(2):  # a directory of stacks, one a single [H, W, 3] image
        arr = rng.uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
        np.save(real_dir / f"part{i}.npy", arr if i == 0 else arr[0])
    np.save(tmp_path / "gen.npy", gen)
    return str(tmp_path / "gen.npy"), str(real_dir)


def test_load_images_matches_jax(tmp_path):
    from ldm_tf2_tpu.cli.run_eval import load_images as jax_load
    from ldm_tf2_tpu_torch.cli.run_eval import load_images

    for path in _image_sets(tmp_path):
        got, want = load_images(path), jax_load(path)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_run_eval_json_line_matches_the_jax_cli(tmp_path, lpips_tree, capsys, monkeypatch):
    """The same .npy files and LPIPS weights (a port blob; an Orbax
    checkpoint for the JAX CLI): the same keys and counts, the FID to
    rel 1e-4 (features differ by float32 rounding)."""
    import sys

    from absl import flags as absl_flags

    from ldm_tf2_tpu.checkpoints.manager import save_params
    from ldm_tf2_tpu.cli import run_eval as jax_cli
    from ldm_tf2_tpu_torch.cli import run_eval

    gen, real = _image_sets(tmp_path)
    export_blob(str(tmp_path / "lpips"), {"lpips": lpips_tree})
    got = run_eval.main(["--generated", gen, "--real", real, "--lpips_blob",
                         str(tmp_path / "lpips"), "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == got

    monkeypatch.setenv("HOME", str(tmp_path / "home"))  # the JAX CLI's compile cache
    save_params(str(tmp_path / "lpips_orbax"), jax.tree.map(lambda t: t.numpy(), lpips_tree))
    argv = ["run_eval", f"--generated={gen}", f"--real={real}",
            f"--lpips_ckpt_path={tmp_path / 'lpips_orbax'}"]
    monkeypatch.setattr(sys, "argv", argv)
    try:
        absl_flags.FLAGS.unparse_flags()
        absl_flags.FLAGS(argv)
        jax_cli.main([])
    finally:
        absl_flags.FLAGS.unparse_flags()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(got) == sorted(want)
    assert {k: got[k] for k in got if k != "fid"} == {k: want[k] for k in want if k != "fid"}
    assert got["fid"] == pytest.approx(want["fid"], rel=1e-4)
    assert got["metric"] == "vgg_fid" and got["num_generated"] == 4 and got["num_real"] == 4


@pytest.mark.parametrize("argv, message", [
    (["--extractor", "clip"], "--extractor must be vgg|inception"),
    (["--clip_weights_path", "x"], "--clip_weights_path requires --prompts_path"),
    ([], "--extractor vgg requires --lpips_blob"),
    (["--extractor", "inception"], "pt_inception"),
])
def test_run_eval_refusals(tmp_path, argv, message):
    from ldm_tf2_tpu_torch.cli import run_eval

    gen, real = _image_sets(tmp_path)
    with pytest.raises((ValueError, RuntimeError), match=message):
        run_eval.main(["--generated", gen, "--real", real, "--device", "cpu", *argv])


def test_run_quality_eval_prints_the_vgg_fid(tmp_path, lpips_tree, capsys):
    import yaml

    from ldm_tf2_tpu_torch.cli import run_eval, run_quality_eval

    gen, real = _image_sets(tmp_path)
    export_blob(str(tmp_path / "lpips"), {"lpips": lpips_tree})
    config = {k: {} for k in ("cond_stage_model", "unet", "autoencoder_kl")}
    config["ldm"] = {}
    config_path = tmp_path / "config.yaml"
    config_path.write_text(yaml.safe_dump(config))
    value = run_quality_eval.main(["--config_path", str(config_path), "--lpips_blob",
                                   str(tmp_path / "lpips"), "--real", real,
                                   "--generated", gen, "--device", "cpu"])
    assert f"[INFO] VGG-FID: {value:.4f}" in capsys.readouterr().out
    result = run_eval.evaluate(run_eval.load_images(gen), run_eval.load_images(real),
                               lpips_state=lpips_tree, device="cpu")
    assert round(value, 6) == result["fid"]


def test_profiling_trace_and_timer(tmp_path):
    from ldm_tf2_tpu_torch.utils.profiling import Timer, trace

    x = torch.randn(64, 64)
    with trace(str(tmp_path / "trace")) as prof:
        (x @ x).sum()
    assert prof is not None
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    with Timer() as timer:
        (x @ x).sum()
    assert timer.elapsed > 0
    calls = []
    median = Timer.time_fn(lambda a: calls.append(a), 1, iters=3, warmup=2)
    assert median >= 0 and calls == [1] * 5
    assert os.listdir(tmp_path / "trace") == ["trace.json"]
