"""Tensor parallelism of the port (``parallel/sharding.py``, ``ops/tp.py``,
the TP-aware layers) against the JAX package on the CPU, with gloo ranks.

* The rules: per parameter, the dimension ``tp_param_shardings`` splits
  equals the JAX ``tp_param_shardings``'s (its conv axes mapped from HWIO to
  OIHW) for the full-width U-Net, text encoder and KL autoencoder at model
  2, 4 and 8, the port on the meta device and the JAX side through
  ``jax.eval_shape`` on the 8-device CPU mesh.  The JAX fallback on
  indivisible dimensions holds, and a model axis that does not divide the
  32 GroupNorm groups keeps the ResBlocks whole.
* The partial FFN: the partial-product ``_plain_ffn`` on one rank's hidden
  columns equals the JAX ``tp_fused_ffn`` body (``_pallas_ffn`` with a zero
  b2 and ``residual=False``, interpret mode), and the ranks' partials,
  summed, + b2, + x, equal the whole FFN.
* Spawned ranks on ``{"model": 2}`` and ``{"data": 2, "model": 2}``: the
  TP text encoder, U-Net and CFG DDIM pipeline (eta 0, the initial noise
  injected) against the JAX modules on the same weights, at
  ``tests/test_tp_sharding.py``'s tolerances; on ``{"model": 2}`` also the
  sampler CLI with ``tpu.tensor_parallel`` against the one-process CLI, and
  the LDM trainer on ``{"data": 1, "model": 2}`` against one process.

The ranks are this module's functions and import no JAX; the JAX
references are computed in the test process.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ldm_tf2_tpu_torch import factory
from ldm_tf2_tpu_torch import models as tm
from ldm_tf2_tpu_torch.checkpoints.bridge import params_to_jax
from ldm_tf2_tpu_torch.diffusion.schedule import make_schedule
from ldm_tf2_tpu_torch.ops import fused_ffn as tff
from ldm_tf2_tpu_torch.ops import tp as ttp
from ldm_tf2_tpu_torch.parallel import Mesh, create_mesh, gather_rows, shard_batch
from ldm_tf2_tpu_torch.parallel.sharding import shard_params_tp, tp_param_shardings
from test_torch_parallel import (
    _free_port, ldm_config, sample, train_ldm, write_records, write_sampler_inputs,
)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
CONFIG = os.path.join(ROOT, "ldm_tf2_tpu", "configs", "all_in_one_config.yaml")
TRANSFORMER = dict(vocab_size=64, encoder_stack_size=2, hidden_size=32, num_heads=4,
                   size_per_head=8, max_seq_len=8, filter_size=64, dropout_rate=0.0)
UNET = dict(model_channels=32, out_channels=4, num_blocks=1, channel_mult=(1, 2),
            num_heads=4, context_channels=32, dropout_rate=0.0)
AE = dict(channels=32, num_blocks=1, multipliers=(1, 2))
B = 4  # the latent batch; the CFG token batch is 2B
MESHES = {2: {"data": 1, "model": 2}, 4: {"data": 2, "model": 2}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _weights(module, seed):
    """Seeded weights with every bias nonzero and norm scales near 1."""
    factory.randomize_(module, seed, scale=0.1)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("scale"):
                p.add_(1.0)
    return module.eval().requires_grad_(False)


def _models():
    return (_weights(tm.TransformerModel(**TRANSFORMER), 1), _weights(tm.UNet(**UNET), 2),
            _weights(tm.AutoencoderKL(**AE), 3))


def _inputs():
    rng = np.random.default_rng(0)
    f = lambda *s: torch.as_tensor(rng.standard_normal(s).astype(np.float32))
    ids = torch.as_tensor(rng.integers(0, 64, (2 * B, 8)), dtype=torch.long)
    return ids, f(B, 8, 8, 4), torch.arange(1, B + 1, dtype=torch.float32) * 97, \
        f(B, 7, 32), f(B, 8, 8, 4)


def _schedule():
    return make_schedule(num_steps=50, beta_start=0.00085, beta_end=0.012, eta=0.0,
                         num_ddim_steps=5)


# ------------------------------------------------------------- the ranks --

def _tp_calls(mesh):
    """The TP text encoder, U-Net and pipeline on this rank's rows."""
    from ldm_tf2_tpu_torch.cli.run_ldm_sampler import rank_rows, sample_txt2img

    ttp.enable_tensor_parallel(mesh)
    cond, unet, ae = _models()
    for model in (cond, unet, ae):
        shard_params_tp(model, mesh)
    ids, x, t, ctx, xt0 = _inputs()
    with torch.no_grad():
        out = {"cond": gather_rows(cond(shard_batch(ids, mesh)), mesh),
               "unet": gather_rows(unet(*(shard_batch(a, mesh) for a in (x, t, ctx))), mesh)}
    tokens, b = rank_rows(ids, B, mesh)
    images, x0 = sample_txt2img(cond, unet, ae, _schedule(), tokens, (b, 8, 8, 4),
                                guidance_scale=5.0, init_noise=shard_batch(xt0, mesh),
                                device="cpu", mesh=mesh)
    out["pipeline"] = gather_rows(images, mesh), gather_rows(x0, mesh)
    out["shapes"] = {n: tuple(p.shape) for n, p in unet.named_parameters()}
    ttp.enable_tensor_parallel(None)
    return out


def _rank_main(rank, world, port, directory):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        out = _tp_calls(create_mesh(MESHES[world]))
        if world == 2:
            out["cli"] = sample(directory, os.path.join(directory, f"tp{rank}"),
                                config="config_tp.json")
            out["train"] = train_ldm(os.path.join(directory, "records"),
                                     os.path.join(directory, f"ckpt{rank}"), 4, 2,
                                     mesh={"data": 1, "model": 2})
        torch.save(out, os.path.join(directory, f"w{world}_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import json

    directory = tmp_path_factory.mktemp("tp")
    write_records(str(directory / "records"))
    path = write_sampler_inputs(str(directory))
    with open(path) as f:
        config = json.load(f)
    config["tpu"].update(mesh={"data": 1, "model": 2}, tensor_parallel=True)
    with open(directory / "config_tp.json", "w") as f:
        json.dump(config, f)
    out = {}
    for world in MESHES:
        mp.start_processes(_rank_main, args=(world, _free_port(), str(directory)),
                           nprocs=world, join=True, start_method="spawn")
        out[world] = [torch.load(directory / f"w{world}_rank{r}.pt", weights_only=False)
                      for r in range(world)]
    return directory, out


# ------------------------------------------------------ JAX references --

def _to_jax(module):
    return {"params": __import__("jax").tree.map(np.asarray, params_to_jax(module))}


@pytest.fixture(scope="module")
def jax_refs():
    import jax
    import jax.numpy as jnp

    from ldm_tf2_tpu import models as jm
    from ldm_tf2_tpu.diffusion import make_schedule as jax_make_schedule
    from ldm_tf2_tpu.diffusion import sampler as jsampler

    cond, unet, ae = _models()
    pc, pu, pa = (_to_jax(m) for m in (cond, unet, ae))
    jc, ju, ja = jm.TransformerModel(**TRANSFORMER), jm.UNet(**UNET), jm.AutoencoderKL(**AE)
    ids, x, t, ctx, xt0 = (a.numpy() for a in _inputs())
    jschedule = jax_make_schedule(num_steps=50, beta_start=0.00085, beta_end=0.012,
                                  eta=0.0, num_ddim_steps=5)

    @jax.jit
    def pipeline(ids, xt0):
        context = jc.apply(pc, ids)
        x0 = jsampler.ddim_sample_loop(lambda x, t, c: ju.apply(pu, x, t, c), jschedule,
                                       context, tuple(xt0.shape), jax.random.PRNGKey(0),
                                       guidance_scale=5.0, init_noise=xt0)
        return ja.apply(pa, x0 / 0.18215, method=jm.AutoencoderKL.decode), x0

    images, x0 = pipeline(jnp.asarray(ids, jnp.int32), jnp.asarray(xt0))
    return {"cond": np.asarray(jax.jit(jc.apply)(pc, jnp.asarray(ids, jnp.int32))),
            "unet": np.asarray(jax.jit(ju.apply)(pu, x, t, ctx)),
            "pipeline": (np.asarray(images), np.asarray(x0))}


# ----------------------------------------------------------------- rules --

def _jax_dims(shapes, n):
    """{dotted name: the port-layout dimension the JAX rules split}."""
    import jax

    from ldm_tf2_tpu.parallel import create_mesh as jax_create_mesh
    from ldm_tf2_tpu.parallel.sharding import tp_param_shardings as jax_rules

    def flat(tree):
        return {".".join(str(getattr(k, "key", k)) for k in path): leaf
                for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}

    specs = flat(jax_rules(shapes, jax_create_mesh({"data": 8 // n, "model": n})))
    leaves = flat(shapes)
    hwio_to_oihw = {0: 2, 1: 3, 2: 1, 3: 0}
    out = {}
    for name, sharding in specs.items():
        dims = [i for i, a in enumerate(sharding.spec) if a == "model"]
        dim = dims[0] if dims else None
        out[name] = hwio_to_oihw[dim] if dim is not None and leaves[name].ndim == 4 else dim
    return out


@pytest.fixture(scope="module")
def full_width():
    """The full-width models: the port's on the meta device, the JAX
    parameter shapes from ``jax.eval_shape``."""
    import jax
    import jax.numpy as jnp

    from ldm_tf2_tpu import factory as jfactory
    from ldm_tf2_tpu_torch.configs.loader import load_config

    config = load_config(CONFIG)
    key = jax.random.PRNGKey(0)
    width = config["cond_stage_model"]["hidden_size"]
    port = {"unet": factory.build_unet(config, "meta"),
            "cond": factory.build_cond_model(config, "meta"),
            "ae": factory.build_autoencoder(config, "kl", "meta")}
    unet, cond, ae = (jfactory.build_unet(config), jfactory.build_cond_model(config),
                      jfactory.build_autoencoder(config, "kl"))
    shapes = {
        "unet": jax.eval_shape(lambda: unet.init(
            key, jnp.zeros((1, 16, 16, 4)), jnp.zeros((1,)), jnp.zeros((1, 77, width))))["params"],
        "cond": jax.eval_shape(lambda: cond.init(key, jnp.zeros((1, 77), jnp.int32)))["params"],
        "ae": jax.eval_shape(lambda: ae.init({"params": key, "sample": key},
                                             jnp.zeros((1, 32, 32, 3))))["params"],
    }
    return port, shapes


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("which", ["unet", "cond", "ae"])
def test_rules_match_jax_at_full_width(full_width, which, n):
    port, shapes = full_width
    want = _jax_dims(shapes[which], n)
    got = tp_param_shardings(port[which], n)
    assert got == want
    split = sum(d is not None for d in got.values())
    assert (split == 0) if which == "ae" else (split > 0)


def test_rules_fall_back_on_indivisible_dims():
    """As the JAX test: 2 heads and a 63-wide filter on a model axis of 4
    stay whole; the 64-row vocabulary splits."""
    with torch.device("meta"):
        model = tm.TransformerModel(vocab_size=64, encoder_stack_size=1, hidden_size=32,
                                    num_heads=2, size_per_head=16, max_seq_len=8,
                                    filter_size=63, dropout_rate=0.0)
    dims = tp_param_shardings(model, 4)
    assert dims["layer_0.mha.query.kernel"] is None
    assert dims["layer_0.ffn.filter.kernel"] is None
    assert dims["token_embedding.embedding"] == 0


@pytest.mark.parametrize("n,resblock_split", [(2, True), (3, False)])
def test_resblock_stays_whole_when_the_axis_does_not_divide_32(n, resblock_split):
    """96 channels divide by 2 and 3; the rules split conv2d_1 for both, but
    3 does not divide the 32 groups, so ``shard_params_tp`` keeps every
    ResBlock whole (GEGLU and attention still split)."""
    unet = tm.UNet(model_channels=96, num_blocks=1, channel_mult=(1, 2), num_heads=6,
                   context_channels=32)
    assert tp_param_shardings(unet, n)["input_block_0.residual.conv2d_1.kernel"] == 0
    shard_params_tp(unet, Mesh({"model": n}, rank=n - 1, world=n))
    res = unet.input_block_0.residual
    assert (res.conv2d_2.tp is not None) == resblock_split
    assert res.conv2d_1.kernel.shape[0] == (96 // n if resblock_split else 96)
    assert res.group_norm_2.scale.shape[0] == (96 // n if resblock_split else 96)
    ffn = unet.input_block_0.spatial_transformer.block.ffn
    assert ffn.dense.kernel.shape[0] == 4 * 96 // n and ffn.dense.tp.index == n - 1


# ------------------------------------------------------------ partial FFN --

@pytest.mark.parametrize("n", [2, 4])
def test_partial_ffn_equals_the_jax_tp_body(n):
    from ldm_tf2_tpu.ops import fused_ffn as jff

    rng = np.random.default_rng(n)
    d, f = 64, 512
    r = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    x = r(2, 128, d)
    lns, lnb = 1.0 + r(d, scale=0.1), r(d, scale=0.1)
    wv, bv = r(d, f, scale=d**-0.5), r(f, scale=0.1)
    wg, bg = r(d, f, scale=d**-0.5), r(f, scale=0.1)
    w2, b2 = r(f, d, scale=f**-0.5), r(d, scale=0.1)
    t = torch.as_tensor
    total = 0
    for i in range(n):
        cols = slice(i * f // n, (i + 1) * f // n)
        local = (wv[:, cols], bv[cols], wg[:, cols], bg[cols], w2[cols])
        got = tff.fused_ffn(t(x), t(lns), t(lnb), *map(t, local[:4]), t(local[4]), t(b2),
                            partial=True)
        want = np.asarray(jff._pallas_ffn(x, lns, lnb, *local, np.zeros_like(b2), 1e-5,
                                          residual=False))
        # the Pallas kernel's polynomial GELU is within 2.3e-5 of the erf one
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
        total = total + got
    whole = tff._plain_ffn(*map(t, (x, lns, lnb, wv, bv, wg, bg, w2, b2)))
    np.testing.assert_allclose((total + t(b2) + t(x)).numpy(), whole.numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(whole.numpy(), np.asarray(jff._xla_ffn(
        x, lns, lnb, wv, bv, wg, bg, w2, b2, 1e-5)), rtol=1e-5, atol=1e-5)


# -------------------------------------------------------------- the ranks --

@pytest.mark.parametrize("world", sorted(MESHES))
def test_tp_text_encoder_matches_jax(ranks, jax_refs, world):
    for r, out in enumerate(ranks[1][world]):
        np.testing.assert_allclose(out["cond"].numpy(), jax_refs["cond"], rtol=2e-5,
                                   atol=1e-5, err_msg=f"rank {r}")


@pytest.mark.parametrize("world", sorted(MESHES))
def test_tp_unet_matches_jax(ranks, jax_refs, world):
    for r, out in enumerate(ranks[1][world]):
        np.testing.assert_allclose(out["unet"].numpy(), jax_refs["unet"], rtol=2e-4,
                                   atol=2e-5, err_msg=f"rank {r}")
        # the leaves really are this rank's blocks
        shapes = out["shapes"]
        assert shapes["input_block_0.residual.conv2d_1.kernel"][0] == 16
        assert shapes["input_block_0.residual.conv2d_2.kernel"][1] == 16
        assert shapes["input_block_0.spatial_transformer.block.att_layer1.query.kernel"][1] == 2


@pytest.mark.parametrize("world", sorted(MESHES))
def test_tp_pipeline_matches_jax(ranks, jax_refs, world):
    want_images, want_x0 = jax_refs["pipeline"]
    for r, out in enumerate(ranks[1][world]):
        images, x0 = out["pipeline"]
        np.testing.assert_allclose(x0.numpy(), want_x0, rtol=5e-4, atol=5e-5,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(images.numpy(), want_images, rtol=5e-4, atol=5e-5,
                                   err_msg=f"rank {r}")


def test_tp_sampler_cli_matches_one_process(ranks, tmp_path):
    """``tpu.tensor_parallel`` on ``{"model": 2}`` through
    ``run_ldm_sampler.main`` against the one-process CLI on the same blob
    and seed (float32: summation order only)."""
    directory, out = ranks
    want = sample(str(directory), str(tmp_path))
    for r, rank in enumerate(out[2]):
        np.testing.assert_allclose(rank["cli"].numpy(), want.numpy(), rtol=5e-4, atol=5e-5,
                                   err_msg=f"rank {r}")
    assert (directory / "tp0" / "images.npy").exists()
    assert not (directory / "tp1" / "images.npy").exists()  # rank 0 writes


def test_trainer_on_a_model_axis_equals_one_process(ranks, tmp_path):
    """The LDM trainer on ``{"data": 1, "model": 2}``: both model peers take
    the whole batch and average their gradients over a data axis of one, so
    each step equals the one-process step."""
    directory, out = ranks
    want = train_ldm(str(directory / "records"), str(tmp_path / "ckpt"), 4, 2)
    for r, rank in enumerate(out[2]):
        assert sorted(rank["train"]) == [1, 2]
        np.testing.assert_allclose([rank["train"][s] for s in (1, 2)],
                                   [want[s] for s in (1, 2)], rtol=1e-6, err_msg=f"rank {r}")


def test_sharded_leaves_need_enable_tensor_parallel():
    """Without ``enable_tensor_parallel`` (or after a size-1 axis turned it
    off) a sharded leaf refuses to run rather than return a partial sum."""
    ttp.enable_tensor_parallel(Mesh({"data": 2, "model": 1}, 0, 2))
    assert ttp.tp_state() is None
    with torch.device("meta"):
        unet = tm.UNet(**UNET)
    shard_params_tp(unet, Mesh({"model": 2}, 0, 2))
    with pytest.raises(RuntimeError, match="enable_tensor_parallel"):
        unet.input_block_0.residual(torch.zeros(1, 8, 8, 32, device="meta"),
                                    torch.zeros(1, 128, device="meta"))
