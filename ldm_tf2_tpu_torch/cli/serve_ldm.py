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
server there is no image to image.  A device mesh raises
``NotImplementedError`` naming its ROADMAP item.  The JAX server's
``--aot_cache`` has no counterpart: PyTorch runs eagerly and compiles no
pipeline executable to cache.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import time

import numpy as np
import torch

from ldm_tf2_tpu_torch import factory
from ldm_tf2_tpu_torch.cli.run_ldm_sampler import (
    CACHE_LOOPS, check_supported, sample_txt2img, sampler_name, tensor_to_image,
)


def _note(msg: str) -> None:
    print(f"[serve] {msg}", file=sys.stderr, flush=True)


def build_server(config: dict, params_blob_path: str = "", device="cuda",
                 models=None):
    """Returns (run_batch, warmup, batch_size): a runner of one pipeline
    call on a packed slot batch, a warm-up call, and the batch size.

    ``models``: (cond_model, unet, autoencoder) already built on ``device``
    with their weights, used instead of the blob at ``params_blob_path``."""
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
    check_supported(config)
    device = factory.resolve_device(device)
    factory.set_float32_precision()
    factory.apply_tpu_settings(config)
    shape = tuple(sampling["latent_shape"])
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
    tpu = config["tpu"]
    if tpu["quantize"] == "int8":
        _note("W8A8 int8 U-Net convs (tpu.quantize: int8)")
    if tpu["quantize_attention"] == "int8pv":
        _note("int8 P.V flash attention (tpu.quantize_attention: int8pv)")
    _note(f"params ready in {time.perf_counter() - start:.1f}s; sampler {sampler}")
    schedule = factory.build_schedule(config)
    tokenizer = load_tokenizer(sampling["vocab_dir"])

    def run_batch(prompts, negatives, guidances, seed):
        """One pipeline call on a packed slot batch: length-B prompt,
        negative and guidance lists -> uint8 [B, H, W, 3]."""
        token_ids = torch.as_tensor(
            packed_cfg_token_ids(tokenizer, prompts, negatives, max_seq_len))
        guidance = torch.as_tensor(
            np.asarray(guidances, np.float32).reshape(shape[0], 1, 1, 1),
            device=device)
        images, _ = sample_txt2img(
            cond_model, unet, autoencoder, schedule, token_ids, shape,
            sampler=sampler, guidance_scale=guidance,
            guidance_rescale=guidance_rescale, cache_interval=cache_interval,
            cache_levels=cache_levels,
            scale_factor=config["ldm"]["scale_factor"], seed=int(seed),
            device=device,
        )
        return tensor_to_image(images.float().cpu().numpy())

    def warmup():
        start = time.perf_counter()
        b = shape[0]
        run_batch([sampling["text_prompt"]] * b,
                  [sampling.get("negative_prompt", "")] * b,
                  [sampling["guidance_scale"]] * b, 0)
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
          device="cuda", models=None) -> None:
    """The micro-batching request loop, apart from ``main`` so that tests
    and scripts can drive it with in-memory streams.

    Each wave of buffered requests is packed into full batches (slots
    grouped by seed); responses are written in request order."""
    run_batch, warmup, batch_size = build_server(
        config, params_blob_path, device, models)
    sampling = config["ldm_sampling"]
    warmup()
    _note("ready")
    request_seq = itertools.count()

    while True:
        wave, done = _read_wave(input_stream, batch_window_ms / 1000.0)
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
