"""Tensor-parallel training of the port (``ops/tp.py``'s autograd
collectives, ``parallel/rng.py``'s sharded draws, the TP clip of
``training/ldm_trainer.py`` and ``checkpoints/manager.py``'s gather and
reshard) on the CPU, with spawned gloo ranks, one spawn per mesh.

* The fault the collectives repair: a column-parallel ``Dense``, ReLU and a
  row-parallel ``Dense`` at model 2; the replicated input's gradient equals
  the whole layers' (1e-6).  Without ``copy_to_model`` each rank gets only
  its share of it.
* The LDM train step on ``{"model": 2}`` and ``{"data": 2, "model": 2}``
  with the text encoder trained, dropout 0.1 in both models (the ResBlock's
  and the text FFN's masks drawn on sharded activations), a clip that
  binds and EMA on, against one process at the global batch: every leaf's
  gradient, its model blocks put together (data peers hold the same mean),
  within 1e-5 rel L2 of one process's at each of two steps; replicated
  leaves' gradients and values bit-equal on the model peers; the losses
  (rtol 1e-5) and the parameters and EMA after two steps (rtol 1e-5, atol
  1e-6, ``tests/test_torch_train.py``'s).
* The port's TP step on ``{"model": 2}`` against the JAX step with its
  state placed by the JAX ``tp_param_shardings`` on two of the CPU
  devices, dropout 0, the draws the JAX step takes injected into the
  port's: losses and updated parameters and EMA at
  ``tests/test_torch_train.py``'s tolerances.
* The checkpoint: saved at model 2 (the file holds whole leaves), restored
  at model 2 bit-equal to each rank's state, and in one process bit-equal
  to the ranks' blocks put together; the export's EMA trees from it too.
* The partial FFN's gradient (the TP FFN's per-rank body) against the JAX
  ``tp_fused_ffn`` body, its kernel in interpret mode.

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
from ldm_tf2_tpu_torch.checkpoints.manager import CheckpointManager
from ldm_tf2_tpu_torch.diffusion.schedule import make_schedule
from ldm_tf2_tpu_torch.models.layers import Dense
from ldm_tf2_tpu_torch.ops import tp as ttp
from ldm_tf2_tpu_torch.parallel import create_mesh, shard_batch
from ldm_tf2_tpu_torch.parallel.sharding import shard_params_tp, sharded_leaves
from ldm_tf2_tpu_torch.training import ldm_trainer as tt
from test_torch_parallel import _free_port

IMG = 16
LATENT = (IMG // 2, IMG // 2, 4)
# tests/test_torch_train.py's models: model_channels 64 keeps two channels
# in each GroupNorm group, and every head count and width divides by 2
UNET = dict(model_channels=64, out_channels=4, num_blocks=1, channel_mult=(1, 2),
            num_heads=2, context_channels=32)
COND = dict(vocab_size=64, encoder_stack_size=1, hidden_size=32, num_heads=2,
            size_per_head=8, max_seq_len=8, filter_size=64)
AE = dict(channels=32, num_blocks=1, multipliers=(1, 2))
NULL_IDS = np.array([2, 3] + [0] * 6, np.int32)
SEED = 7
B = 4  # the global batch
RATE = 0.1
EMA = 0.9
# the gradients' global norm is 7.6-8.8 at these weights: the clip binds
CLIP = 1.0
OPT = dict(learning_rate=1e-3, epsilon=1e-3, clip_grad_norm=CLIP)
MESHES = {2: {"model": 2}, 4: {"data": 2, "model": 2}}
STEPS = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _models(rate, seed=0):
    """Seeded weights, norm scales near 1, every bias nonzero."""
    out = []
    for i, module in enumerate((tm.TransformerModel(**COND, dropout_rate=rate),
                                tm.UNet(**UNET, dropout_rate=rate), tm.AutoencoderKL(**AE))):
        factory.randomize_(module, seed + i + 1, scale=0.1)
        with torch.no_grad():
            for name, p in module.named_parameters():
                if name.endswith("scale"):
                    p.add_(1.0)
        out.append(module.requires_grad_(False))
    return out


def _batch():
    rng = np.random.default_rng(1)
    images = rng.uniform(-1, 1, (B, IMG, IMG, 3)).astype(np.float32)
    ids = rng.integers(4, 64, (B, 8))
    return torch.as_tensor(images), torch.as_tensor(ids)


def _steps(mesh, rate, draws=None):
    """``STEPS`` LDM train steps, the text encoder trained, on this rank's
    rows and blocks (one process at the global batch without ``mesh``):
    the losses, the gradients each step's AdamW received (after the data
    mean, before the clip), the checkpoint state and the sharded leaves."""
    cond, unet, ae = _models(rate)
    if mesh is not None:
        for model in (cond, unet):
            shard_params_tp(model, mesh)
    unet.requires_grad_(True)
    cond.requires_grad_(True)
    opt = tt.make_optimizer(**OPT)
    grads, apply = [], opt.step_

    def step_(params, g, state, *args):
        moved = apply(params, g, state, *args)  # the data mean is taken in place
        grads.append({k: v.clone() for k, v in g.items()})
        return moved

    opt.step_ = step_
    step = tt.make_ldm_train_step(
        unet, cond, ae, make_schedule(num_steps=100, num_ddim_steps=10), opt,
        condition_dropout_rate=0.1, train_cond_model=True, null_token_ids=NULL_IDS,
        ema_decay=EMA, seed=SEED, mesh=mesh)
    state = tt.init_ldm_train_state(unet, cond, opt, True, EMA)
    images, ids = (shard_batch(x, mesh) for x in _batch())
    losses = []
    for s in range(STEPS):
        d = None if draws is None else {k: shard_batch(v, mesh) for k, v in draws[s].items()}
        state, m = step(state, images, ids, d)
        losses.append(float(m["loss"]))
    return dict(losses=losses, grads=grads, state=tt.checkpoint_state(state, unet, cond),
                shards=sharded_leaves({"unet": unet, "cond": cond}))


# ------------------------------------------------------------- the ranks --

def _repro_layers():
    """The C6 repro's whole layers: Dense 8 -> 16, ReLU, Dense 16 -> 8, an
    input and a cotangent."""
    rng = np.random.default_rng(11)
    f = lambda *s: torch.as_tensor(rng.standard_normal(s).astype(np.float32))
    holder = torch.nn.Module()
    holder.col, holder.row = Dense(8, 16), Dense(16, 8)
    with torch.no_grad():
        for p in holder.parameters():
            p.copy_(f(*p.shape))
    return holder, f(3, 8), f(3, 8)


def _repro_input_grad(mesh=None):
    holder, x, cot = _repro_layers()
    if mesh is not None:
        shard_params_tp(holder, mesh, rules=((r"col\.kernel$", 1), (r"col\.bias$", 0),
                                             (r"row\.kernel$", 0)))
    x.requires_grad_(True)
    out = holder.row(torch.relu(holder.col(x)))
    (out * cot).sum().backward()
    return x.grad, out.detach()


def _checkpoint(mesh, directory, run):
    """Save this rank's state of ``run`` at model 2, restore it into fresh
    models (other weights) sharded the same way: whether every leaf came
    back bit for bit."""
    ckpt = os.path.join(directory, "ckpt")
    CheckpointManager(ckpt, mesh=mesh, shards=run["shards"]).save(STEPS, run["state"])
    cond, unet, _ = _models(RATE, seed=10)
    for model in (cond, unet):
        shard_params_tp(model, mesh)
    manager = CheckpointManager(ckpt, mesh=mesh, shards=sharded_leaves({"unet": unet,
                                                                        "cond": cond}))
    step, saved = manager.restore_latest()
    state = tt.restore_state(saved, unet, cond)
    got = tt.checkpoint_state(state, unet, cond)
    want = run["state"]
    same = {"step": step == STEPS == state.step}
    for part in ("unet", "cond", "ema"):
        same[part] = all(torch.equal(got[part][k], v) for k, v in want[part].items())
    for part in ("mu", "nu"):
        same[part] = all(torch.equal(got["opt_state"][part][k], v)
                         for k, v in want["opt_state"][part].items())
    return same


def _rank_main(rank, world, port, directory):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = create_mesh(MESHES[world])
        ttp.enable_tensor_parallel(mesh)
        out = {"index": (mesh.index("data"), mesh.index("model")),
               "train": _steps(mesh, RATE)}
        if world == 2:
            out["repro"] = _repro_input_grad(mesh)
            out["jax"] = _steps(mesh, 0.0, torch.load(os.path.join(directory, "draws.pt")))
            out["restored"] = _checkpoint(mesh, directory, out["train"])
        torch.save(out, os.path.join(directory, f"w{world}_rank{rank}.pt"))
    finally:
        ttp.enable_tensor_parallel(None)
        dist.destroy_process_group()


def _jax_step_draws():
    """The draws the JAX step takes at steps 0 and 1
    (``tests/test_torch_train.py::_jax_draws``)."""
    import jax.numpy as jnp
    from test_torch_train import _jax_draws

    return [_jax_draws(s, B, (B,) + LATENT, 1, jnp.float32) for s in range(STEPS)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    directory = tmp_path_factory.mktemp("tp_train")
    torch.save(_jax_step_draws(), directory / "draws.pt")
    out = {}
    for world in MESHES:
        mp.start_processes(_rank_main, args=(world, _free_port(), str(directory)),
                           nprocs=world, join=True, start_method="spawn")
        out[world] = [torch.load(directory / f"w{world}_rank{r}.pt", weights_only=False)
                      for r in range(world)]
    return directory, out


@pytest.fixture(scope="module")
def one_process():
    return _steps(None, RATE)


def _whole(ranks, tree_of, shards, data=0):
    """{name: the whole leaf} from the ranks at data coordinate ``data``:
    a sharded leaf's model blocks concatenated along its dimension, a
    replicated one model coordinate 0's."""
    peers = sorted((r for r in ranks if r["index"][0] == data), key=lambda r: r["index"][1])
    trees = [tree_of(r) for r in peers]
    return {k: torch.cat([t[k] for t in trees], dim=shards[k].dim) if k in shards else v
            for k, v in trees[0].items()}


def _prefixed(shards, prefix):
    """The shards of ``prefix``'s leaves, by their names inside it."""
    return {k[len(prefix) + 1:]: v for k, v in shards.items() if k.startswith(prefix + ".")}


def _rel_l2(got, want):
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


# ----------------------------------------------------------------- tests --

def test_column_then_row_dense_input_gradient_equals_the_whole_layers(ranks):
    """C6: the replicated input of a column-parallel ``Dense`` gets the
    model group's sum of the gradients, not its own share."""
    want_grad, want_out = _repro_input_grad()
    for r, rank in enumerate(ranks[1][2]):
        grad, out = rank["repro"]
        np.testing.assert_allclose(out.numpy(), want_out.numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(grad.numpy(), want_grad.numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=f"rank {r}")


@pytest.mark.parametrize("world", sorted(MESHES))
def test_tp_step_gradients_equal_one_process(ranks, one_process, world):
    out = ranks[1][world]
    shards = out[0]["train"]["shards"]
    assert sorted(shards) == sorted(out[-1]["train"]["shards"])
    assert any(k.startswith("cond.") for k in shards) and any(
        k.startswith("unet.") for k in shards)
    for s, want in enumerate(one_process["grads"]):
        norm = torch.stack([g.norm() for g in want.values()]).norm()
        assert norm > CLIP, norm  # the clip binds
        for data in range(MESHES[world].get("data", 1)):
            got = _whole(out, lambda r: r["train"]["grads"][s], shards, data)
            assert set(got) == set(want)
            for name, w in want.items():
                assert got[name].shape == w.shape, name
                rel = _rel_l2(got[name], w)
                assert rel < 1e-5, (world, s, data, name, rel)


@pytest.mark.parametrize("world", sorted(MESHES))
def test_tp_step_replicated_leaves_bit_equal_on_model_peers(ranks, world):
    out = ranks[1][world]
    shards = out[0]["train"]["shards"]
    for data in range(MESHES[world].get("data", 1)):
        peers = [r for r in out if r["index"][0] == data]
        assert len(peers) == 2
        a, b = (p["train"] for p in peers)
        replicated = [k for k in a["grads"][0] if k not in shards]
        assert replicated
        for s in range(STEPS):
            for k in replicated:
                assert torch.equal(a["grads"][s][k], b["grads"][s][k]), (s, k)
        for part in ("unet", "cond"):
            for k, v in a["state"][part].items():
                if f"{part}.{k}" not in shards:
                    assert torch.equal(v, b["state"][part][k]), (part, k)


@pytest.mark.parametrize("world", sorted(MESHES))
def test_tp_steps_losses_and_parameters_equal_one_process(ranks, one_process, world):
    out = ranks[1][world]
    shards = out[0]["train"]["shards"]
    for r, rank in enumerate(out):
        np.testing.assert_allclose(rank["train"]["losses"], one_process["losses"], rtol=1e-5,
                                   err_msg=f"rank {r}")
    want = one_process["state"]
    for part in ("unet", "cond"):
        got = _whole(out, lambda r: r["train"]["state"][part], _prefixed(shards, part))
        for name, w in want[part].items():
            np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=f"{part} {name}")
    got = _whole(out, lambda r: r["train"]["state"]["ema"], shards)
    for name, w in want["ema"].items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=f"ema {name}")
    # the moments and EMA are held at the shard shapes
    for rank in out:
        st = rank["train"]["state"]
        for name, shard in shards.items():
            local = st["opt_state"]["mu"][name].shape
            assert local == st["ema"][name].shape == st["opt_state"]["nu"][name].shape
            assert local[shard.dim] * shard.size == want["ema"][name].shape[shard.dim]


@pytest.fixture(scope="module")
def jax_tp_steps():
    """Two JAX train steps (dropout 0, text encoder trained, the clip, EMA)
    on the port's seeded weights, the state placed by the JAX
    ``tp_param_shardings`` on a ``{"data": 1, "model": 2}`` mesh of two CPU
    devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JaxMesh
    from jax.sharding import NamedSharding, PartitionSpec

    from ldm_tf2_tpu.diffusion import make_schedule as jax_make_schedule
    from ldm_tf2_tpu.models import AutoencoderKL, TransformerModel, UNet
    from ldm_tf2_tpu.parallel.sharding import tp_param_shardings
    from ldm_tf2_tpu.training.ldm_trainer import (
        init_ldm_train_state, make_ldm_train_step, make_optimizer,
    )
    from ldm_tf2_tpu_torch.checkpoints.bridge import params_to_jax

    cond_m, unet_m, ae_m = _models(0.0)
    cp, up, ap = (jax.tree.map(np.asarray, params_to_jax(m)) for m in (cond_m, unet_m, ae_m))
    unet, cond, ae = (UNet(**UNET, dropout_rate=0.0), TransformerModel(**COND, dropout_rate=0.0),
                      AutoencoderKL(**AE))

    def unet_apply(params, xt, t, ctx, rngs, training):
        return unet.apply({"params": params}, xt, t, ctx, training=training, rngs=rngs)

    def cond_apply(params, ids, rngs, training):
        return cond.apply({"params": params}, ids, training=training, rngs=rngs)

    def encode_latents(params, images, key):
        return ae.apply({"params": params}, images, method=AutoencoderKL.encode).sample(key)

    jopt = make_optimizer(**OPT)
    step = jax.jit(make_ldm_train_step(
        unet_apply, cond_apply, encode_latents,
        jax_make_schedule(num_steps=100, num_ddim_steps=10), jopt,
        condition_dropout_rate=0.1, train_cond_model=True,
        null_token_ids=jnp.asarray(NULL_IDS), ema_decay=EMA))
    mesh = JaxMesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "model"))
    state = init_ldm_train_state(up, cp, jopt, train_cond_model=True, ema_decay=EMA)
    state = jax.tree.map(jax.device_put, state, tp_param_shardings(state, mesh))
    q = state.unet_params["input_block_0"]["spatial_transformer"]["block"]["att_layer1"][
        "query"]["kernel"]
    assert "model" in str(q.sharding.spec)
    whole = NamedSharding(mesh, PartitionSpec())
    images, ids = _batch()
    args = [jax.device_put(a, whole) for a in (ap, images.numpy(), ids.numpy().astype(np.int32))]
    losses = []
    for _ in range(STEPS):
        state, m = step(state, args[0], args[1], args[2], jax.random.PRNGKey(SEED))
        losses.append(float(m["loss"]))
    return losses, state


def test_tp_step_matches_the_jax_tp_step(ranks, jax_tp_steps):
    import jax

    from ldm_tf2_tpu_torch.checkpoints.bridge import params_from_jax

    jlosses, jstate = jax_tp_steps
    out = ranks[1][2]
    shards = out[0]["jax"]["shards"]
    for r, rank in enumerate(out):
        np.testing.assert_allclose(rank["jax"]["losses"], jlosses, rtol=1e-5,
                                   err_msg=f"rank {r}")
    host = lambda tree: params_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32), tree))
    wants = {"unet": host(jstate.unet_params), "cond": host(jstate.cond_params),
             "ema unet": host(jstate.ema_params["unet"]),
             "ema cond": host(jstate.ema_params["cond"])}
    for what, want in wants.items():
        part = what.split()[-1]
        if what.startswith("ema"):
            tree_of = lambda r: {k[len(part) + 1:]: v for k, v in r["jax"]["state"]["ema"].items()
                                 if k.startswith(part + ".")}
        else:
            tree_of = lambda r: r["jax"]["state"][part]
        got = _whole(out, tree_of, _prefixed(shards, part))
        assert set(got) == set(want), what
        for name, w in want.items():
            np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=f"{what} {name}")


def test_tp_checkpoint_restores_at_model_2_and_in_one_process(ranks):
    directory, out = ranks
    for r, rank in enumerate(out[2]):
        assert all(rank["restored"].values()), (r, rank["restored"])
    restored = CheckpointManager(str(directory / "ckpt")).restore_latest()
    assert restored is not None and restored[0] == STEPS
    saved = restored[1]
    shards = out[2][0]["train"]["shards"]
    for part in ("unet", "cond"):
        got = _whole(out[2], lambda r: r["train"]["state"][part], _prefixed(shards, part))
        assert set(got) == set(saved[part])
        for k, v in got.items():
            assert torch.equal(saved[part][k], v), (part, k)
    for part in ("mu", "nu"):
        got = _whole(out[2], lambda r: r["train"]["state"]["opt_state"][part], shards)
        for k, v in got.items():
            assert torch.equal(saved["opt_state"][part][k], v), (part, k)
    got = _whole(out[2], lambda r: r["train"]["state"]["ema"], shards)
    for k, v in got.items():
        assert torch.equal(saved["ema"][k], v), ("ema", k)
    # the export takes its EMA weights as they are
    from ldm_tf2_tpu_torch.checkpoints.bridge import params_from_jax
    from ldm_tf2_tpu_torch.cli.export_pretrained import ldm_artifacts

    exported = ldm_artifacts(saved, True, None)
    for part, tree in (("unet", exported["unet"]), ("cond", exported["cond_stage_model"])):
        for k, v in params_from_jax(tree).items():
            assert torch.equal(v, got[f"{part}.{k}"]), ("export", part, k)
    # and a one-process model takes it
    cond, unet, _ = _models(RATE, seed=20)
    state = tt.restore_state(saved, unet, cond)
    assert state.step == STEPS and torch.equal(
        unet.input_block_0.residual.conv2d_1.kernel, saved["unet"][
            "input_block_0.residual.conv2d_1.kernel"])


@pytest.mark.parametrize("n", [2, 4])
def test_partial_ffn_gradient_equals_the_jax_tp_body(n):
    """The per-rank body of the TP FFN, the kernel's partial-product mode
    on one rank's hidden columns: its value against the JAX
    ``tp_fused_ffn`` body (``_pallas_ffn`` with a zero b2 and
    ``residual=False``, interpret mode) and its gradients against
    ``jax.grad`` of that body.  jax.grad cannot differentiate a
    ``pallas_call``, so the body's kernel takes the JAX package's own rule
    for it (``_fused_bwd``: the vjp of ``_xla_ffn``, here with a zero b2
    and without the residual)."""
    import jax
    import jax.numpy as jnp

    from ldm_tf2_tpu.ops import fused_ffn as jff
    from ldm_tf2_tpu_torch.ops import fused_ffn as tff

    rng = np.random.default_rng(n)
    d, f = 64, 512
    r = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    x, cot = r(2, 128, d), r(2, 128, d)
    lns, lnb = 1.0 + r(d, scale=0.1), r(d, scale=0.1)
    wv, bv = r(d, f, scale=d**-0.5), r(f, scale=0.1)
    wg, bg = r(d, f, scale=d**-0.5), r(f, scale=0.1)
    w2, b2 = r(f, d, scale=f**-0.5), r(d, scale=0.1)
    zero = jnp.zeros((d,), jnp.float32)

    @jax.custom_vjp
    def body(*a):
        return jff._pallas_ffn(*a, zero, 1e-5, residual=False)

    def body_fwd(*a):
        return body(*a), a

    def body_bwd(a, g):
        return jax.vjp(lambda *a: jff._xla_ffn(*a, zero, 1e-5) - a[0], *a)[1](g)

    body.defvjp(body_fwd, body_bwd)
    cols = slice(0, f // n)
    local = (x, lns, lnb, wv[:, cols], bv[cols], wg[:, cols], bg[cols], w2[cols])
    want_out = np.asarray(body(*local))
    want = jax.grad(lambda *a: jnp.sum(body(*a) * cot), argnums=tuple(range(8)))(*local)
    args = [torch.as_tensor(a).requires_grad_(True) for a in local]
    out = tff.fused_ffn(*args, torch.as_tensor(b2), partial=True)
    got = torch.autograd.grad((out * torch.as_tensor(cot)).sum(), args)
    # the Pallas kernel's polynomial GELU is within 2.3e-5 of the erf one
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=1e-4, atol=1e-4)
    names = ("x", "ln_scale", "ln_bias", "w1v", "b1v", "w1g", "b1g", "w2")
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5 * float(np.abs(np.asarray(w)).max()),
                                   err_msg=name)
