"""Persistent text-to-image server of the PyTorch port (JSONL over stdin).

Counterpart of ``ldm_tf2_tpu.cli.serve_ldm``: load the models once, then
answer requests until EOF or an exit command.

    python -m ldm_tf2_tpu_torch.cli.serve_ldm \\
        --config_path ldm_tf2_tpu/configs/all_in_one_config.yaml \\
        --params_blob <path without .bin/.json> [--output_dir .] \\
        [--batch_window_ms 0] [--device cuda]

Protocol (the JAX server's): one JSON object per line on stdin, one JSON
response per line on stdout; logs go to stderr.

  request:  {"prompt": "a cat" | ["p1", ...], "negative_prompt": "",
             "seed": 0, "n": 1, "guidance_scale": 5.0, "out": "name"}
  response: {"ok": true, "out": "<dir>/name.npy", "latency_s": 1.23,
             "shape": [n, H, W, 3], "batched_requests": 3}
  errors:   {"ok": false, "error": "..."}
  exit:     "exit" or {"cmd": "exit"}

Requests already buffered (plus ``--batch_window_ms`` on a live stdin) are
packed into pipeline calls of the config's batch size ``latent_shape[0]``,
grouped by seed (one ``torch.Generator`` seed per call), with a prompt,
negative prompt and guidance scale per slot; a short call is padded with
copies of its last slot, whose images are discarded.

The weights come from a blob the JAX package exported
(``checkpoints/blob.py``).  ``ldm_sampling.sampler`` picks the loop from
the sampler CLI's table (``ddim``, ``ddpm``, ``plms``,
``dpm_solver_pp_2m``), checked as the JAX server checks it.  The serving
modes ``tpu.quantize: int8`` and ``tpu.quantize_attention: int8pv`` apply
(``factory.apply_serving_modes``).  ``ldm_sampling.autoencoder_type: vq``
decodes through the VQ autoencoder with ``force_quantize``, as the JAX
server does.  ``ldm_sampling.cache_interval`` > 1 serves through the
DeepCache loops (``cache_levels`` shallow levels; DDIM or
DPM-Solver++(2M), else the JAX server's ``ValueError``).  As in the JAX
server there is no image to image.

On a mesh (``torchrun``, ``tpu.mesh``), as the JAX server on its devices:
rank 0 reads each wave of requests and broadcasts it (or the exit) to every
rank, so all ranks run the same calls and stop together; when the batch
divides by the ``data`` axis each data coordinate runs its rows of the slot
batch (its token rows and guidances, every draw its rows of the global
draw, ``parallel.RowSlice``) and the images are gathered to rank 0, which
writes the files and the responses.  ``tpu.sequence_parallel`` runs
Ulysses attention over the ``model`` axis; tensor parallelism is never
applied, as in the JAX server.

As the JAX server jits its whole pipeline once and compiles it at
warm-up, this one captures its whole call (text encode, the sampling loop,
DeepCache's included, and the decode) as one CUDA graph at warm-up
(``diffusion/graphs.py::SamplingProgram``), on one card in a process of
world 1, and every later call of the compiled batch replays it: the host
copies the token ids and the guidance in, seeds the call's generator and
launches one graph (DDPM: its encode, its run of ``DDPM_RUN_STEPS`` steps
replayed in turn, and its decode).  stderr says how the calls run, how long
the captures took and how many kernel nodes a call launches.  On the CPU and on a mesh
of more than one rank the calls run eagerly, as does ``graphs=False``.
The JAX server's ``--aot_cache`` keeps compiled executables on disk; a
CUDA graph cannot be written to disk, and what does persist across
restarts is the kernels' nvcc build (``ops/_build.py``).
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from ldm_tf2_tpu_torch import factory
from ldm_tf2_tpu_torch.cli.run_ldm_sampler import (
    CACHE_LOOPS, apply_parallelism, rank_rows, sample_txt2img, sampler_name,
    tensor_to_image,
)
from ldm_tf2_tpu_torch.diffusion import graphs as _graphs
from ldm_tf2_tpu_torch.graphs import describe
from ldm_tf2_tpu_torch.parallel import (
    create_mesh, gather_rows, maybe_initialize_distributed,
)


def _note(msg: str) -> None:
    print(f"[serve] {msg}", file=sys.stderr, flush=True)


def build_server(config: dict, params_blob_path: str = "", device="cuda",
                 models=None, graphs: bool = True):
    """Returns (run_batch, warmup, batch_size): a runner of one pipeline
    call on a packed slot batch (its mesh as ``run_batch.mesh``, its
    ``SamplingProgram`` as ``run_batch.program``, None where the calls run
    eagerly, and the sampling keywords it hands ``sample_txt2img`` or the
    program as ``run_batch.settings``), a warm-up call, which captures
    the whole call as a CUDA graph on the card, and the batch size.

    ``models``: (cond_model, unet, autoencoder) already built on ``device``
    with their weights, used instead of the blob at ``params_blob_path``.
    ``graphs=False`` runs every call eagerly, for comparison."""
    from ldm_tf2_tpu_torch.data.tokenizer import (
        load_tokenizer, packed_cfg_token_ids,
    )

    sampling = config["ldm_sampling"]
    sampler = sampler_name(sampling)
    cache_interval = int(sampling.get("cache_interval", 1))
    cache_levels = int(sampling.get("cache_levels", 1))
    if cache_interval > 1 and sampler not in CACHE_LOOPS:
        raise ValueError(
            "ldm_sampling.cache_interval > 1 requires sampler: ddim or "
            f"dpm_solver_pp_2m, got {sampler!r}"
        )
    device = factory.resolve_device(maybe_initialize_distributed(device))
    mesh = create_mesh(config["tpu"].get("mesh"))
    factory.set_float32_precision()
    factory.apply_tpu_settings(config)
    shape = tuple(sampling["latent_shape"])
    rows_mesh = mesh if mesh.distributed and shape[0] % mesh.shape["data"] == 0 else None
    if rows_mesh is not None:
        _note(f"data-parallel over mesh {dict(mesh.shape)}")
    max_seq_len = config["cond_stage_model"]["max_seq_len"]
    guidance_rescale = float(sampling.get("guidance_rescale", 0.0))

    start = time.perf_counter()
    if models is None:
        from ldm_tf2_tpu_torch.checkpoints.bridge import load_params, read_blob

        _note("restoring params from the blob...")
        blob = read_blob(params_blob_path)
        models = (
            load_params(factory.build_cond_model(config, device),
                        blob["cond_stage_model"]),
            load_params(factory.build_unet(config, device), blob["unet"]),
            load_params(factory.build_autoencoder(
                config, sampling.get("autoencoder_type", "kl"), device,
                resolution=factory.sampling_resolution(config)), blob["autoencoder"]),
        )
    cond_model, unet, autoencoder = models
    factory.apply_serving_modes(config, unet, autoencoder)
    apply_parallelism(config, mesh, (), _note)
    tpu = config["tpu"]
    if tpu["quantize"] == "int8":
        _note("W8A8 int8 U-Net convs (tpu.quantize: int8)")
    if tpu["quantize_attention"] == "int8pv":
        _note("int8 P.V flash attention (tpu.quantize_attention: int8pv)")
    _note(f"params ready in {time.perf_counter() - start:.1f}s; sampler {sampler}")
    schedule = factory.build_schedule(config)
    tokenizer = load_tokenizer(sampling["vocab_dir"])
    settings = dict(sampler=sampler, guidance_rescale=guidance_rescale,
                    cache_interval=cache_interval, cache_levels=cache_levels,
                    scale_factor=config["ldm"]["scale_factor"])
    program = (_graphs.graphed_program(models)
               if graphs and _graphs.graphs_apply(device) else None)

    def run_batch(prompts, negatives, guidances, seed):
        """One pipeline call on a packed slot batch: length-B prompt,
        negative and guidance lists -> uint8 [B, H, W, 3] (every row, on
        every rank)."""
        token_ids = torch.as_tensor(
            packed_cfg_token_ids(tokenizer, prompts, negatives, max_seq_len))
        guidance = torch.as_tensor(
            np.asarray(guidances, np.float32).reshape(shape[0], 1, 1, 1),
            device=device)
        if program is not None:
            images, _ = program(schedule, token_ids.to(device), guidance, shape,
                                int(seed), **settings)
            return tensor_to_image(images.float().cpu().numpy())
        rows_shape = shape
        if rows_mesh is not None:
            token_ids, b = rank_rows(token_ids, shape[0], rows_mesh)
            guidance = guidance[rows_mesh.data_index * b:(rows_mesh.data_index + 1) * b]
            rows_shape = (b,) + shape[1:]
        images, _ = sample_txt2img(
            cond_model, unet, autoencoder, schedule, token_ids, rows_shape,
            guidance_scale=guidance, seed=int(seed), device=device, mesh=rows_mesh,
            graphs=False, **settings)
        images = gather_rows(images, rows_mesh)
        return tensor_to_image(images.float().cpu().numpy())

    run_batch.mesh = mesh
    run_batch.program = program
    run_batch.settings = settings

    def warmup():
        start = time.perf_counter()
        store = _graphs.STORE
        captures = len(store.capture_seconds)
        b = shape[0]
        run_batch([sampling["text_prompt"]] * b,
                  [sampling.get("negative_prompt", "")] * b,
                  [sampling["guidance_scale"]] * b, 0)
        _note(describe(device, graphs,
                       "serving calls (text encode, sampling loop, decode)"))
        made = store.capture_seconds[captures:]
        if made:
            nodes = program.call_nodes()
            nodes = "" if nodes is None else f", {nodes} kernel nodes a call"
            replays = sum(program.last_graphs.values())
            runs = "" if replays == len(made) else f", replayed {replays} times a call"
            _note(f"captured {len(made)} call graph(s) in {sum(made):.2f}s (eager "
                  f"warm-up call included){nodes}{runs}")
        _note(f"warm in {time.perf_counter() - start:.1f}s")

    return run_batch, warmup, shape[0]


def _expand_request(req: dict, sampling: dict, batch_size: int) -> dict:
    """Validate one request into a slot spec: n per-slot prompts and a
    shared negative prompt, guidance, seed and output name."""
    if not isinstance(req, dict):
        raise ValueError(f"request must be a JSON object, got {req!r}")
    prompt = req.get("prompt", sampling["text_prompt"])
    if isinstance(prompt, str):
        # one string: n defaults to the whole batch
        n = int(req.get("n", batch_size))
        prompts = [prompt] * n
    else:
        prompts = [str(p) for p in prompt]
        n = int(req.get("n", len(prompts)))
        if n != len(prompts):
            raise ValueError(
                f'"n": {n} conflicts with a {len(prompts)}-prompt list'
            )
    if n < 1:
        raise ValueError(f'"n" must be >= 1, got {n}')
    return {
        "prompts": prompts,
        "negative": str(
            req.get("negative_prompt", sampling.get("negative_prompt", ""))
        ),
        "guidance": float(
            req.get("guidance_scale", sampling["guidance_scale"])
        ),
        "seed": int(req.get("seed", 0)),
        "out": req.get("out"),
    }


def _read_wave(input_stream, window_s: float):
    """Block for one request line, then drain everything else already
    buffered (or arriving within ``window_s`` on a selectable stream).

    Returns (lines, done): the raw lines of the wave, and whether the
    stream hit EOF or an exit command (earlier lines of the wave still
    run)."""
    import select

    def selectable():
        try:
            input_stream.fileno()
            return True
        except Exception:
            return False  # an in-memory stream: drain to EOF

    lines, done, block = [], False, True
    is_pipe = selectable()
    while True:
        if not block and is_pipe:
            ready, _, _ = select.select([input_stream], [], [], window_s)
            if not ready:
                break
        line = input_stream.readline()
        if not line:  # EOF
            done = True
            break
        block = False
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
            if req == "exit" or (isinstance(req, dict)
                                 and req.get("cmd") == "exit"):
                done = True
                break
        except Exception:
            pass  # a malformed line joins the wave and gets an error
        lines.append(line)
    return lines, done


def serve(config: dict, input_stream, output_stream, output_dir: str = ".",
          batch_window_ms: int = 0, params_blob_path: str = "",
          device="cuda", models=None, graphs: bool = True) -> None:
    """The micro-batching request loop, apart from ``main`` so that tests
    and scripts can drive it with in-memory streams.

    Each wave of buffered requests is packed into full batches (slots
    grouped by seed); responses are written in request order.  On a mesh
    only rank 0 reads ``input_stream`` and writes ``output_stream`` and the
    images; the other ranks take each wave from it.  ``graphs``: as for
    ``build_server``."""
    run_batch, warmup, batch_size = build_server(
        config, params_blob_path, device, models, graphs)
    mesh = run_batch.mesh
    sampling = config["ldm_sampling"]
    warmup()
    _note("ready")
    request_seq = itertools.count()

    while True:
        wave, done = (_read_wave(input_stream, batch_window_ms / 1000.0)
                      if mesh.rank == 0 else (None, None))
        if mesh.distributed:
            shared = [wave, done]
            dist.broadcast_object_list(shared, src=0)
            wave, done = shared
        responses = [None] * len(wave)
        specs = []  # (wave index, spec)
        for i, line in enumerate(wave):
            try:
                specs.append(
                    (i, _expand_request(json.loads(line), sampling, batch_size))
                )
            except Exception as e:
                responses[i] = {"ok": False, "error": f"{type(e).__name__}: {e}"}

        # seed -> [(wave index, slot, prompt, negative, guidance)]
        groups: dict = {}
        results = {i: [None] * len(s["prompts"]) for i, s in specs}
        for i, s in specs:
            for j, p in enumerate(s["prompts"]):
                groups.setdefault(s["seed"], []).append(
                    (i, j, p, s["negative"], s["guidance"])
                )
        start = time.perf_counter()
        try:
            for seed, slots in groups.items():
                for lo in range(0, len(slots), batch_size):
                    chunk = slots[lo:lo + batch_size]
                    pad = batch_size - len(chunk)
                    chunk = chunk + [chunk[-1]] * pad  # pad slots discarded
                    images = run_batch([c[2] for c in chunk],
                                       [c[3] for c in chunk],
                                       [c[4] for c in chunk], seed)
                    for k, (i, j, *_) in enumerate(chunk[:len(chunk) - pad]):
                        results[i][j] = images[k]
        except Exception as e:
            err = {"ok": False, "error": f"{type(e).__name__}: {e}"}
            for i, _ in specs:
                responses[i] = dict(err)
        latency = round(time.perf_counter() - start, 4)
        if mesh.rank:
            if done:
                break
            continue

        for i, spec in specs:
            if responses[i] is not None:
                continue  # the batch failed
            images = np.stack(results[i])
            # wall time and a per-process counter: same-second requests
            # must not overwrite each other
            default = f"images_{int(time.time())}_{next(request_seq)}"
            name = str(spec["out"] or default).replace("/", "_")
            path = f"{output_dir}/{name}.npy"
            np.save(path, images)
            responses[i] = {
                "ok": True, "out": path, "latency_s": latency,
                "shape": list(images.shape), "batched_requests": len(specs),
            }
        for resp in responses:
            output_stream.write(json.dumps(resp) + "\n")
        output_stream.flush()
        if done:
            break


def main(argv=None) -> None:
    from ldm_tf2_tpu_torch.configs.loader import load_config

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config_path", required=True)
    parser.add_argument("--params_blob", required=True,
                        help="blob path without the .bin/.json suffix")
    parser.add_argument("--output_dir", default=".",
                        help="directory for the generated .npy images")
    parser.add_argument("--batch_window_ms", type=int, default=0,
                        help="how long to wait for more requests to pack "
                             "with the one just received (0: only what is "
                             "already buffered)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    serve(load_config(args.config_path), sys.stdin, sys.stdout,
          args.output_dir, batch_window_ms=args.batch_window_ms,
          params_blob_path=args.params_blob, device=args.device)


if __name__ == "__main__":
    main()
