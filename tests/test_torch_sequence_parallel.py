"""Ulysses sequence-parallel attention of the port
(``ops/sequence_parallel.py``, the dispatch in ``ops/attention.py``) on
gloo ranks, against the JAX package on the CPU: the cases of
``tests/test_sequence_parallel.py``, on a ``model`` axis of 4.

* ``sequence_parallel_attention`` equals local attention (the JAX
  ``dot_product_attention``) for a U-Net level-0 head dim and for more heads
  than ranks, and returns the whole output on every rank;
* 2 heads on 4 ranks raise the JAX ``ValueError``, with its message;
* ``enable_sequence_parallel(mesh, min_seq_len=64)`` routes a whole U-Net
  forward's self-attentions through Ulysses (the 77-token cross-attention
  falls through) and the result equals the JAX U-Net's;
* gradients flow through both all-to-alls and the token split and gather:
  dq, dk, dv equal the JAX gradients of local attention;
* the sampler CLI with ``tpu.sequence_parallel`` on ``{"data": 1, "model":
  2}`` (the claim lowered to 64 tokens) equals the one-process CLI.

The ranks are this module's functions and import no JAX.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ldm_tf2_tpu_torch import models as tm
from ldm_tf2_tpu_torch.checkpoints.bridge import params_to_jax
from ldm_tf2_tpu_torch.ops import attention as tattn
from ldm_tf2_tpu_torch.ops import sequence_parallel as tsp
from ldm_tf2_tpu_torch.parallel import create_mesh
from test_torch_parallel import _free_port, sample, write_sampler_inputs
from test_torch_tp import _weights

WORLD = 4
CASES = [(2, 256, 256, 8, 40), (1, 512, 512, 16, 64)]
UNET = dict(model_channels=32, out_channels=4, num_blocks=1, attention_resolutions=(1, 2),
            channel_mult=(1, 2), num_heads=8, context_channels=24)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(shape).astype(np.float32)) for _ in range(3)]


def _unet_inputs():
    rng = np.random.default_rng(5)
    return (torch.as_tensor(rng.standard_normal((2, 16, 16, 4)).astype(np.float32)),
            torch.tensor([3.0, 7.0]),
            torch.as_tensor(rng.standard_normal((2, 77, 24)).astype(np.float32)))


# ------------------------------------------------------------- the ranks --

def _rank_main(rank, world, port, directory):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = create_mesh({"model": world})
        out = {"cases": []}
        for i, (b, tq, tkv, h, s) in enumerate(CASES):
            q, k, v = _qkv((b, tq, h, s), i)
            out["cases"].append(tsp.sequence_parallel_attention(q, k, v, mesh, s**-0.5))
        try:
            x = torch.zeros(1, 64, 2, 16)
            tsp.sequence_parallel_attention(x, x, x, mesh)
        except ValueError as e:
            out["refusal"] = str(e)
        # model-level dispatch, with the all-to-alls counted
        exchanges = []
        exchange = tsp._exchange
        tsp._exchange = lambda *a: exchanges.append(1) or exchange(*a)
        unet = _weights(tm.UNet(**UNET), 4)
        tattn.enable_sequence_parallel(mesh, min_seq_len=64)
        try:
            with torch.no_grad():
                out["unet"] = unet(*_unet_inputs())
        finally:
            tattn.disable_sequence_parallel()
            tsp._exchange = exchange
        out["exchanges"] = len(exchanges)
        # gradients
        q, k, v = (t.requires_grad_(True) for t in _qkv((1, 64, 8, 16), 9))
        loss = (tsp.sequence_parallel_attention(q, k, v, mesh) ** 2).sum()
        loss.backward()
        out["grads"] = [t.grad for t in (q, k, v)]
        torch.save(out, os.path.join(directory, f"sp_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _cli_rank(rank, world, port, directory):
    """The sampler CLI with ``tpu.sequence_parallel``; the claim lowered to
    64 tokens so that the 8 x 8 latent's self-attention is claimed."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    enable = tattn.enable_sequence_parallel
    tattn.enable_sequence_parallel = functools.partial(enable, min_seq_len=64)
    calls = []
    attention = tsp.sequence_parallel_attention
    tsp.sequence_parallel_attention = lambda *a, **k: calls.append(1) or attention(*a, **k)
    try:
        images = sample(directory, os.path.join(directory, f"sp{rank}"), config="config_sp.json")
        torch.save({"images": images, "calls": len(calls)},
                   os.path.join(directory, f"cli_rank{rank}.pt"))
    finally:
        tattn.enable_sequence_parallel = enable
        tsp.sequence_parallel_attention = attention
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    directory = tmp_path_factory.mktemp("sp")
    mp.start_processes(_rank_main, args=(WORLD, _free_port(), str(directory)),
                       nprocs=WORLD, join=True, start_method="spawn")
    return [torch.load(directory / f"sp_rank{r}.pt", weights_only=False) for r in range(WORLD)]


@pytest.fixture(scope="module")
def cli_ranks(tmp_path_factory):
    directory = tmp_path_factory.mktemp("sp_cli")
    path = write_sampler_inputs(str(directory))
    with open(path) as f:
        config = json.load(f)
    config["tpu"].update(mesh={"data": 1, "model": 2}, sequence_parallel=True)
    with open(directory / "config_sp.json", "w") as f:
        json.dump(config, f)
    mp.start_processes(_cli_rank, args=(2, _free_port(), str(directory)),
                       nprocs=2, join=True, start_method="spawn")
    return directory, [torch.load(directory / f"cli_rank{r}.pt", weights_only=False)
                       for r in range(2)]


# ----------------------------------------------------------------- tests --

@pytest.mark.parametrize("case", range(len(CASES)))
def test_matches_single_device(ranks, case):
    from ldm_tf2_tpu.ops.attention import dot_product_attention

    b, tq, tkv, h, s = CASES[case]
    q, k, v = (t.numpy() for t in _qkv((b, tq, h, s), case))
    expected = np.asarray(dot_product_attention(q, k, v))
    for r, out in enumerate(ranks):
        got = out["cases"][case]
        assert tuple(got.shape) == (b, tq, h, s)  # every rank holds the whole output
        np.testing.assert_allclose(got.numpy(), expected, rtol=2e-5, atol=2e-5,
                                   err_msg=f"rank {r}")


def test_rejects_indivisible_heads(ranks):
    import jax
    import jax.numpy as jnp

    from ldm_tf2_tpu.ops.sequence_parallel import sequence_parallel_attention
    from ldm_tf2_tpu.parallel import create_mesh as jax_create_mesh

    mesh = jax_create_mesh({"model": WORLD}, devices=jax.devices()[:WORLD])
    x = jnp.zeros((1, 64, 2, 16))
    with pytest.raises(ValueError) as jax_error:
        sequence_parallel_attention(x, x, x, mesh)
    for out in ranks:
        assert out["refusal"] == str(jax_error.value)


def test_model_level_dispatch_matches_jax(ranks):
    """Every self-attention (256 and 64 tokens, 8 heads) goes through
    Ulysses, four all-to-alls a call (q, k and v in, the output back); the
    output equals the JAX U-Net's."""
    import jax

    from ldm_tf2_tpu import models as jm

    unet = _weights(tm.UNet(**UNET), 4)
    params = {"params": jax.tree.map(np.asarray, params_to_jax(unet))}
    x, t, ctx = (a.numpy() for a in _unet_inputs())
    expected = np.asarray(jax.jit(jm.UNet(**UNET).apply)(params, x, t.astype(np.int32), ctx))
    calls = sum(isinstance(m, tm.unet.CrossAttention) for m in unet.modules()) // 2
    for r, out in enumerate(ranks):
        assert out["exchanges"] == 4 * calls, out["exchanges"]
        np.testing.assert_allclose(out["unet"].numpy(), expected, rtol=2e-5, atol=2e-5,
                                   err_msg=f"rank {r}")


def test_gradients_flow(ranks):
    import jax
    import jax.numpy as jnp

    from ldm_tf2_tpu.ops.attention import dot_product_attention

    q, k, v = (jnp.asarray(t.numpy()) for t in _qkv((1, 64, 8, 16), 9))
    want = jax.grad(lambda q, k, v: jnp.sum(dot_product_attention(q, k, v) ** 2),
                    argnums=(0, 1, 2))(q, k, v)
    for r, out in enumerate(ranks):
        for got, w in zip(out["grads"], want):
            np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=2e-5, atol=2e-5,
                                       err_msg=f"rank {r}")


def test_sampler_cli_under_sp_matches_one_process(cli_ranks, tmp_path):
    directory, out = cli_ranks
    with open(directory / "config_sp.json") as f:
        config = json.load(f)
    config["tpu"].update(mesh={"data": -1}, sequence_parallel=False)
    with open(directory / "config_one.json", "w") as f:
        json.dump(config, f)
    want = sample(str(directory), str(tmp_path), config="config_one.json")
    for r, rank in enumerate(out):
        assert rank["calls"] > 0
        np.testing.assert_allclose(rank["images"].numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=f"rank {r}")
