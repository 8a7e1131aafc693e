"""The port's JSONL server on a mesh (``cli/serve_ldm.py``): two gloo ranks
on ``{"data": 2}`` against one process.

Rank 0 reads the waves and broadcasts them; each rank samples its row of
every slot batch of 2 (its token rows and guidance, its rows of every
draw: DDIM with eta 1 draws noise at each step), and the images are
gathered to rank 0, which writes them.  The responses equal the
one-process server's, and every image within one uint8 level (a rank's
U-Net runs at batch 1 against the one process's 2, and the CPU's sums then
round differently in a few pixels); a malformed line gets its error on rank 0
while the other requests run; the exit command stops both ranks (the spawn
returns), and rank 1 writes nothing.

The ranks are this module's functions and import no JAX.
"""

import io
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ldm_tf2_tpu_torch import factory
from ldm_tf2_tpu_torch.cli import serve_ldm
from ldm_tf2_tpu_torch.configs.loader import validate
from test_torch_parallel import _free_port

VOCAB = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, "bert_model")
REQUESTS = "\n".join([
    '{"prompt": "a virus monster", "seed": 1, "out": "r1"}',
    '{"prompt": ["guitar", "canvas oil"], "seed": 2, "guidance_scale": 2.5, "out": "r2"}',
    "this is not json",
    '{"prompt": "one more", "n": 1, "seed": 1, "guidance_scale": 7.0, "out": "r4"}',
    '{"cmd": "exit"}',
    '{"prompt": "never reached", "out": "r5"}',
])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(mesh):
    return validate({
        "cond_stage_model": dict(vocab_size=30522, encoder_stack_size=1, hidden_size=64,
                                 num_heads=2, size_per_head=32, max_seq_len=8,
                                 filter_size=128, dropout_rate=0.0),
        "unet": dict(model_channels=32, out_channels=4, num_blocks=1,
                     attention_resolutions=[1], dropout_rate=0.0, channel_mult=[1, 2],
                     num_heads=2),
        "autoencoder_kl": dict(latent_channels=4, channels=32, num_blocks=1,
                               attention_resolutions=[], dropout_rate=0.0,
                               multipliers=[1, 2], resample_with_conv=True),
        "ldm": dict(num_steps=50, beta_start=0.00085, beta_end=0.012, v_posterior=0.0,
                    scale_factor=0.18215, eta=1.0, num_ddim_steps=2),
        "ldm_sampling": dict(guidance_scale=5.0, latent_shape=[2, 8, 8, 4],
                             text_prompt="a red fox", vocab_dir=VOCAB, autoencoder_type="kl"),
        "tpu": {"compute_dtype": "float32", "mesh": mesh},
    })


def _models(config):
    return tuple(factory.randomize_(build(config, device="cpu"), seed)
                 for seed, build in ((1, factory.build_cond_model), (2, factory.build_unet),
                                     (3, factory.build_autoencoder)))


def _serve(config, requests, output_dir):
    """(responses, the latent rows of each pipeline call)."""
    rows = []
    sample = serve_ldm.sample_txt2img

    def counted(*args, **kw):
        rows.append(args[5][0])
        return sample(*args, **kw)

    serve_ldm.sample_txt2img = counted
    try:
        out = io.StringIO()
        serve_ldm.serve(config, io.StringIO(requests), out, output_dir=output_dir,
                        device="cpu", models=_models(config))
    finally:
        serve_ldm.sample_txt2img = sample
    return [json.loads(line) for line in out.getvalue().splitlines()], rows


def _rank_main(rank, world, port, directory):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        out_dir = os.path.join(directory, f"rank{rank}")
        os.makedirs(out_dir)
        # only rank 0 reads its stream: the other's is empty
        resps, rows = _serve(_config({"data": 2}), REQUESTS if rank == 0 else "", out_dir)
        with open(os.path.join(directory, f"rank{rank}.json"), "w") as f:
            json.dump({"responses": resps, "rows": rows}, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    directory = tmp_path_factory.mktemp("serve_mesh")
    mp.start_processes(_rank_main, args=(2, _free_port(), str(directory)), nprocs=2,
                       join=True, start_method="spawn")
    out = []
    for r in range(2):
        with open(directory / f"rank{r}.json") as f:
            out.append(json.load(f))
    return directory, out


def test_mesh_server_answers_as_one_process(two_ranks, tmp_path):
    directory, (rank0, _) = two_ranks
    want, want_rows = _serve(_config({"data": -1}), REQUESTS, str(tmp_path))
    got = rank0["responses"]
    assert [r["ok"] for r in got] == [True, True, False, True] == [r["ok"] for r in want]
    assert got[2] == want[2]  # the malformed line's error
    for g, w in zip(got, want):
        if not w["ok"]:
            continue
        assert g["shape"] == w["shape"] and g["batched_requests"] == w["batched_requests"]
        assert os.path.dirname(g["out"]) == str(directory / "rank0")
        a, b = np.load(g["out"]).astype(int), np.load(w["out"]).astype(int)
        assert a.shape == b.shape and int(np.abs(a - b).max()) <= 1
        assert float(np.mean(a != b)) < 0.01
    # the warm-up and three slot batches of 2, one latent row on each rank
    assert want_rows == [2, 2, 2, 2] and rank0["rows"] == [1, 1, 1, 1]


def test_exit_stops_every_rank_and_only_rank_0_writes(two_ranks):
    directory, (_, rank1) = two_ranks
    assert rank1["responses"] == []
    assert rank1["rows"] == [1, 1, 1, 1]  # it ran every call of the wave, then stopped
    assert os.listdir(directory / "rank1") == []
    assert sorted(os.listdir(directory / "rank0")) == ["r1.npy", "r2.npy", "r4.npy"]
