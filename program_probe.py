"""DDPM's server program (``diffusion/graphs.py::SamplingProgram``: the
encode, a graph of k DDPM steps replayed in turn, the decode) on the north
star's whole 1000-step timeline, bf16, batch 4, 256^2, on the seeded
north-star models, for each k of ``RUN_STEPS`` (``DDPM_RUN_STEPS`` set in
turn): the run graph's kernel nodes and every graph's, the seconds of the
call's captures (each with its eager warm-up and its instantiation), the
warm-up call's seconds and what it took over a replay (a capture's seconds
also hold the wait for the work queued before it: the decode's for the
runs'), a replayed call's seconds and its images bit-equal
to the warm-up call's (and to the first k's), and the host's resident set
(``VmRSS``) before the capture, after it and after ``STORE.clear()``.  The
module constant is the smallest k whose replay comes within 1% of the
largest k's.  Needs a CUDA card.  Run from the root of a checkout:

    python3 program_probe.py [k ...]

It prints one JSON line per k, then the card's name and power limit."""

import contextlib
import gc
import io
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke  # noqa: E402

# The run lengths tried, and the DDPM timeline's length
RUN_STEPS, NUM_STEPS = (25, 50, 100), 1000


def rss_gb() -> float:
    """This process's resident set, from /proc/self/status."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1e6
    return float("nan")


def probe(run_steps, num_steps: int):
    import numpy as np
    import torch

    from ldm_tf2_tpu_torch import factory
    from ldm_tf2_tpu_torch.cli import serve_ldm
    from ldm_tf2_tpu_torch.configs.loader import validate
    from ldm_tf2_tpu_torch.diffusion import graphs
    from ldm_tf2_tpu_torch.ops import _build

    _build.build(chip_smoke.SOURCES)
    factory.set_float32_precision()
    models = chip_smoke._north_star_models(validate(json.loads(json.dumps(
        chip_smoke.NORTH_STAR))))
    config = chip_smoke._program_config({}, dict(sampler="ddpm"), dict(num_steps=num_steps))
    with contextlib.redirect_stderr(io.StringIO()):
        run_batch, _, batch = serve_ldm.build_server(config, device="cuda", models=models)
    program, store = run_batch.program, graphs.STORE
    prompts = chip_smoke.SERVE_PROGRAM_PROMPTS[:batch]
    call = lambda: run_batch(prompts, [""] * batch, [5.0] * batch, 1)
    first = None
    for k in run_steps:
        graphs.DDPM_RUN_STEPS = k
        gc.collect()
        before = rss_gb()
        made = len(store.capture_seconds)
        warm_s, warm = chip_smoke._timed(call)
        captures = store.capture_seconds[made:]
        assert len(captures) == len(program.last_graphs), "the call did not capture"
        nodes = {"/".join(str(p) for p in key[len(program.last_key):]):
                 sum(store.kernels(key).values()) for key in program.last_graphs}
        call_nodes = program.call_nodes()
        captured = rss_gb()
        replay_s, replay = chip_smoke._timed(call)
        assert np.array_equal(replay, warm), "the replay differs from the warm-up call"
        assert first is None or np.array_equal(warm, first), "another k gave other images"
        first = warm
        store.clear()
        gc.collect()
        torch.cuda.empty_cache()
        yield dict(run_steps=k, evals=num_steps, run_graph_nodes=nodes.get(f"run/{k}"),
                   graph_nodes=nodes, replays=list(program.last_graphs.values()),
                   call_nodes=call_nodes, capture_s=sum(captures),
                   captures_s=captures, warm_up_call_s=warm_s, replay_s=replay_s,
                   warm_up_over_replay_s=warm_s - replay_s,
                   rss_gb_before=before, rss_gb_captured=captured,
                   rss_gb_dropped=rss_gb(), replay_equal_to_warm_up=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("program_probe.py needs a CUDA card", file=sys.stderr)
        return 1
    run_steps = [int(a) for a in sys.argv[1:]] or RUN_STEPS
    rows = []
    for row in probe(run_steps, NUM_STEPS):
        rows.append(row)
        print(json.dumps(row), flush=True)
    fastest = min(r["replay_s"] for r in rows)
    largest = max(rows, key=lambda r: r["run_steps"])["replay_s"]
    keep = min(r["run_steps"] for r in rows if r["replay_s"] <= 1.01 * largest)
    print(json.dumps(dict(keep_run_steps=keep, largest_k_replay_s=largest,
                          fastest_replay_s=fastest)), flush=True)
    print(chip_smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
