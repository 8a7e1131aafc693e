"""The server's call as one CUDA graph (``diffusion/graphs.py::
SamplingProgram``) with DDPM on the north star's whole 1000-step timeline,
bf16, batch 4, 256^2, on the seeded north-star models: each capture's
seconds (its eager warm-up call and the instantiation included), its
graph's kernel nodes, a replay's seconds and the replay bit-equal to the
warm-up call; then the capture dropped (``STORE.clear()``) and made again,
``CAPTURES`` times in all, with the host's resident set (``VmRSS``)
before the first capture and after each capture and each drop, so that a
run shows whether a server that recaptures (a new key, or updated weights)
holds more host memory with every capture.  Needs a CUDA card.  Run from
the root of a checkout:

    python3 program_probe.py

It prints one JSON line per capture, then the card's name and power
limit."""

import contextlib
import gc
import io
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke  # noqa: E402

# Captures made and dropped in turn, and the DDPM timeline's length
CAPTURES, NUM_STEPS = 2, 1000


def rss_gb() -> float:
    """This process's resident set, from /proc/self/status."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1e6
    return float("nan")


def probe(captures: int, num_steps: int):
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
    store = graphs.STORE
    prompts = chip_smoke.SERVE_PROGRAM_PROMPTS[:batch]
    call = lambda: run_batch(prompts, [""] * batch, [5.0] * batch, 1)
    before = rss_gb()
    first = None
    for n in range(captures):
        made = len(store.capture_seconds)
        warm_s, warm = chip_smoke._timed(call)
        assert len(store.capture_seconds) == made + 1, "the call did not capture"
        nodes = sum(store.kernels(run_batch.program.last_key).values())
        captured = rss_gb()
        replay_s, replay = chip_smoke._timed(call)
        assert (replay == warm).all(), "the replay differs from the warm-up call"
        assert first is None or (warm == first).all(), "the recapture differs"
        first = warm
        store.clear()
        gc.collect()
        torch.cuda.empty_cache()
        yield dict(capture=n + 1, evals=num_steps, warm_up_call_s=warm_s,
                   capture_s=store.capture_seconds[-1], kernel_nodes=nodes,
                   replay_s=replay_s, rss_gb_before_first=before, rss_gb_captured=captured,
                   rss_gb_dropped=rss_gb(), replay_equal_to_warm_up=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("program_probe.py needs a CUDA card", file=sys.stderr)
        return 1
    for row in probe(CAPTURES, NUM_STEPS):
        print(json.dumps(row), flush=True)
    print(chip_smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
