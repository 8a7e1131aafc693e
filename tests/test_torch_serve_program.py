"""The server's whole call as one graph (``diffusion/graphs.py::SamplingProgram``).

On the CPU the store takes a stand-in for the CUDA graph (``StandIn`` of
``tests/test_torch_graphs.py``, which reruns the captured call at each
replay into the same static outputs) and the card's rule is let through
(``graphs_apply``), so ``build_server``'s warm-up captures the text
encode, the sampling loop and the decode as one program and every later
call replays it.  The replays are held bit-equal to the eager server
(``graphs=False``) over three calls with other seeds and guidance vectors,
for every sampler and DeepCache loop, in float32 and bf16; then the key
(each keyed field, changed, captures anew; an unchanged key replays), the
weights of each of the three models changed after a capture (never
replayed stale), the launch counters' bookkeeping, the CPU rule, and the
body against the JAX server's pipeline math on the same weights
(``ldm_tf2_tpu/cli/serve_ldm.py``'s ``pipeline``: encode, the DDIM or
DeepCache loop, decode) at ``tests/test_torch_pipeline.py``'s tolerances.
JAX is imported inside that test only, so the ``cuda`` test at the end (a
tiny server on the card, its replays bit-equal to the eager calls) runs on
a machine without JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_serve_program.py``.
"""

import functools
import os

import numpy as np
import pytest
import torch

from ldm_tf2_tpu_torch import factory
from ldm_tf2_tpu_torch import graphs as shared
from ldm_tf2_tpu_torch.cli import serve_ldm
from ldm_tf2_tpu_torch.cli.run_ldm_sampler import sample_txt2img, txt2img_body
from ldm_tf2_tpu_torch.configs.loader import validate
from ldm_tf2_tpu_torch.data.tokenizer import load_tokenizer, packed_cfg_token_ids
from ldm_tf2_tpu_torch.diffusion import graphs
from ldm_tf2_tpu_torch.ops import attention
from ldm_tf2_tpu_torch.ops import flash_attention as fa
from test_torch_graphs import StandIn

VOCAB = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, "bert_model")
TR = dict(vocab_size=30522, encoder_stack_size=1, hidden_size=64, num_heads=2,
          size_per_head=32, max_seq_len=8, filter_size=128, dropout_rate=0.0)
UNET = dict(model_channels=32, out_channels=4, num_blocks=1, attention_resolutions=[1],
            dropout_rate=0.0, channel_mult=[1, 2], num_heads=2)
AE = dict(latent_channels=4, channels=32, num_blocks=1, attention_resolutions=[],
          dropout_rate=0.0, multipliers=[1, 2], resample_with_conv=True)
PROMPTS = ["a red fox", "a blue sky"]
# three calls: (seed, per-slot guidance)
CALLS = ((4, [5.0, 2.5]), (9, [7.5, 1.0]), (4, [3.0, 3.0]))


class Runner(StandIn):
    """``StandIn`` with the generators it is handed kept, as a CUDA graph
    registers them, and left where they were by the capture, as a CUDA
    graph's capture leaves them (its replays advance them)."""

    generators = ()

    def register_generators(self, generators):
        self.generators = list(generators)

    def capture(self, fn):
        states = [gen.get_state() for gen in self.generators]
        out = super().capture(fn)
        for gen, state in zip(self.generators, states):
            gen.set_state(state)
        return out


def _config(sampler="ddim", eta=0.0, steps=2, num_steps=50, spacing="uniform",
            cache_interval=1, cache_levels=1, dtype="float32", batch=2, **tpu):
    return validate({
        "cond_stage_model": dict(TR), "unet": dict(UNET), "autoencoder_kl": dict(AE),
        "ldm": dict(num_steps=num_steps, beta_start=0.00085, beta_end=0.012,
                    v_posterior=0.0, scale_factor=0.18215, eta=eta,
                    num_ddim_steps=steps, timestep_spacing=spacing),
        "ldm_sampling": dict(guidance_scale=5.0, latent_shape=[batch, 8, 8, 4],
                             text_prompt="a red fox", vocab_dir=VOCAB,
                             autoencoder_type="kl", sampler=sampler,
                             cache_interval=cache_interval, cache_levels=cache_levels),
        "tpu": {"compute_dtype": dtype, **tpu},
    })


def _models(config, device="cpu"):
    return tuple(factory.randomize_(build(config, device=device), seed)
                 for seed, build in ((1, factory.build_cond_model),
                                     (2, factory.build_unet),
                                     (3, factory.build_autoencoder)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def store(monkeypatch):
    """A store of stand-ins as the process's, the card's rule let through."""
    store = shared.GraphStore(runner=Runner)
    monkeypatch.setattr(graphs, "STORE", store)
    monkeypatch.setattr(graphs, "graphs_apply", lambda device: True)
    return store


def _served(monkeypatch, config, models, graphs_on):
    """The float images of the warm-up and each of ``CALLS`` through
    ``build_server``'s ``run_batch`` (read where it turns them to uint8),
    and its program."""
    seen = []
    real = serve_ldm.tensor_to_image

    def keep(images):
        seen.append(images.copy())
        return real(images)

    monkeypatch.setattr(serve_ldm, "tensor_to_image", keep)
    run_batch, warmup, batch = serve_ldm.build_server(config, device="cpu", models=models,
                                                      graphs=graphs_on)
    warmup()
    for seed, guidance in CALLS:
        run_batch(PROMPTS[:batch], ["", "blurry"][:batch], guidance[:batch], seed)
    monkeypatch.setattr(serve_ldm, "tensor_to_image", real)
    return seen, run_batch.program


# (sampler, eta, steps, num_steps, cache_interval): each loop the server takes
LOOPS = {"ddim": ("ddim", 0.0, 3, 50, 1), "ddim_eta1": ("ddim", 1.0, 3, 50, 1),
         "plms": ("plms", 0.0, 3, 50, 1),
         "dpm_solver_pp_2m": ("dpm_solver_pp_2m", 0.0, 3, 50, 1),
         "ddpm": ("ddpm", 0.0, 3, 6, 1), "ddim_deepcache": ("ddim", 0.0, 4, 50, 2),
         "dpm_deepcache": ("dpm_solver_pp_2m", 0.0, 4, 50, 2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("loop", list(LOOPS))
def test_replays_equal_the_eager_server(monkeypatch, store, loop, dtype):
    """The warm-up captures the whole call once; the three calls after it
    replay it, each bit-equal to the eager server's call.  DDPM's call (6
    steps, runs of 4 here) is its encode, a run of 4 steps, the remaining
    2 and the decode, each captured once and replayed once a call."""
    sampler, eta, steps, num_steps, interval = LOOPS[loop]
    monkeypatch.setattr(graphs, "DDPM_RUN_STEPS", 4)
    config = _config(sampler, eta, steps, num_steps, cache_interval=interval, dtype=dtype)
    models = _models(config)
    eager, none = _served(monkeypatch, config, models, False)
    got, program = _served(monkeypatch, config, models, True)
    assert none is None and program is not None
    assert len(got) == len(eager) == 1 + len(CALLS)
    for g, e in zip(got, eager):
        assert np.array_equal(g, e)
    assert not np.array_equal(got[1], got[2])  # the seeds and guidances tell
    parts = ([("encode",), ("run", 4), ("run", 2), ("decode",)] if sampler == "ddpm"
             else [()])
    keys = [program.last_key + part for part in parts]
    assert list(program.last_graphs) == keys and set(program.last_graphs.values()) == {1}
    assert len(store.capture_seconds) == len(store) == len(keys)
    assert store.replays == len(CALLS) * len(keys)
    assert set(store._entries) == set(keys)
    for key in keys:
        assert key[0] == id(program)  # no U-Net eval capture
        runner = store._entries[key].runner
        assert runner.generators == [store.session(key).generator]
    assert len({id(store.session(key)) for key in keys}) == 1  # one generator


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ddpm_runs_cover_the_timeline_in_turn(monkeypatch, store, dtype):
    """DDPM at T = 12 in runs of k = 5: two runs of 5 steps, then the 2 that
    remain (t = 1 and t = 0); each run reads the tables at the device
    counter, advances it by its steps, and is bit-equal, with the same
    draws, to ``ddpm_step``'s eager steps; the program captures the run of
    5 once and replays it, and its call equals the eager server's."""
    from ldm_tf2_tpu_torch.diffusion import sampler as loops
    from ldm_tf2_tpu_torch.diffusion.schedule import make_schedule

    assert loops.ddpm_runs(12, 5) == [(0, 5), (5, 5), (10, 2)]
    assert loops.ddpm_runs(1000, 50) == [(n * 50, 50) for n in range(20)]
    assert loops.ddpm_runs(3, 5) == [(0, 3)]
    schedule = make_schedule(num_steps=12, beta_start=0.00085, beta_end=0.012,
                             num_ddim_steps=4)
    rng = np.random.default_rng(5)
    w = torch.as_tensor(rng.standard_normal((4, 4)).astype(np.float32) * 0.5).to(dtype)
    seen = []

    def eps(x, t, c):
        seen.append(t.tolist())
        return torch.tanh(x @ w + (t / 1000.0).to(x.dtype)[:, None, None, None])

    context = torch.zeros(4, 3, 8, dtype=dtype)
    x0 = torch.as_tensor(rng.standard_normal((2, 4, 4, 4)).astype(np.float32)).to(dtype)
    tables = loops.ddpm_device_tables(schedule, dtype, "cpu")
    gen = torch.Generator().manual_seed(3)
    xt, step, covered = x0, torch.zeros(1, dtype=torch.long), []
    for first, steps in loops.ddpm_runs(12, 5):
        assert int(step) == first
        seen.clear()
        xt, step = loops.ddpm_run(eps, tables, xt, context, step, steps, gen, 5.0)
        covered.append([t[0] for t in seen])
        assert all(len(set(t)) == 1 and len(t) == 4 for t in seen)
    assert covered == [[11, 10, 9, 8, 7], [6, 5, 4, 3, 2], [1, 0]] and int(step) == 12
    gen_eager = torch.Generator().manual_seed(3)
    want = loops.ddpm_sample_loop(eps, schedule, context, x0.shape, gen_eager, 5.0,
                                  init_noise=x0)
    assert torch.equal(xt, want)
    assert torch.equal(gen.get_state(), gen_eager.get_state())  # t = 0 draws too

    monkeypatch.setattr(graphs, "DDPM_RUN_STEPS", 5)
    config = _config("ddpm", 0.0, 3, 12, dtype=str(dtype).split(".")[1])
    models = _models(config)
    eager, _ = _served(monkeypatch, config, models, False)
    got, program = _served(monkeypatch, config, models, True)
    for g, e in zip(got, eager):
        assert np.array_equal(g, e)
    key = program.last_key
    assert program.last_graphs == {key + ("encode",): 1, key + ("run", 5): 2,
                                   key + ("run", 2): 1, key + ("decode",): 1}
    assert len(store.capture_seconds) == 4 and store.replays == 1 + 5 * len(CALLS)


@functools.lru_cache(maxsize=None)
def _tokenizer():
    return load_tokenizer(VOCAB)


def _ids(batch=2, length=8):
    ids = packed_cfg_token_ids(_tokenizer(), PROMPTS[:batch], ["", "blurry"][:batch], 8)
    return torch.as_tensor(ids)[:, :length]


def _eager(models, schedule, ids, guidance, shape, seed, **settings):
    return sample_txt2img(*models, schedule, ids, shape, guidance_scale=guidance, seed=seed,
                          device="cpu", graphs=False, **settings)


SETTINGS = dict(sampler="ddim", guidance_rescale=0.0, scale_factor=0.18215,
                cache_interval=1, cache_levels=1)
KEYED = ["none", "num_ddim_steps", "eta", "spacing", "betas", "v_posterior", "sampler",
         "guidance_rescale", "scale_factor", "cache_interval", "cache_levels", "batch",
         "token_length", "guidance_dtype", "conv_quant", "pv_int8", "ae_pv_int8",
         "cond_dtype", "ae_dtype", "attention_impl"]


@pytest.mark.parametrize("change", KEYED)
def test_a_changed_key_captures_anew(store, change):
    """A call with one keyed field changed captures anew and equals its
    eager call; the first key is kept and replays."""
    from ldm_tf2_tpu_torch.diffusion.schedule import make_schedule

    config = _config(steps=2)
    config["unet"]["channel_mult"] = [1, 2, 2]  # cache_levels 1 and 2
    models = _models(config)
    cond, unet, ae = models
    program = graphs.graphed_program(models)
    sched = dict(num_steps=50, beta_start=0.00085, beta_end=0.012, num_ddim_steps=2)
    schedule = make_schedule(**sched)
    ids, guidance, shape = _ids(), torch.tensor([5.0, 2.0]).reshape(2, 1, 1, 1), (2, 8, 8, 4)
    first = program(schedule, ids, guidance, shape, 3, **SETTINGS)
    assert len(store.capture_seconds) == 1
    for out, want in zip(program(schedule, ids, guidance, shape, 3, **SETTINGS), first):
        assert torch.equal(out, want)  # replayed
    assert len(store.capture_seconds) == 1 and store.replays == 1
    schedule2, ids2, guidance2, shape2, settings2 = schedule, ids, guidance, shape, SETTINGS
    undo = lambda: None
    if change in ("num_ddim_steps", "eta", "spacing", "v_posterior"):
        value = {"num_ddim_steps": 3, "eta": 1.0, "spacing": "trailing", "v_posterior": 0.1}
        name = "timestep_spacing" if change == "spacing" else change
        schedule2 = make_schedule(**{**sched, name: value[change]})
    elif change == "betas":
        schedule2 = make_schedule(**{**sched, "beta_end": 0.02})
    elif change in ("sampler", "guidance_rescale", "scale_factor", "cache_interval"):
        value = {"sampler": "plms", "guidance_rescale": 0.7, "scale_factor": 0.2,
                 "cache_interval": 2}
        settings2 = {**SETTINGS, change: value[change]}
    elif change == "cache_levels":  # interval 2's capture, then levels 2's
        settings2 = {**SETTINGS, "cache_interval": 2}
        program(schedule, ids, guidance, shape, 3, **settings2)
        settings2 = {**settings2, "cache_levels": 2}
    elif change == "batch":
        ids2, guidance2, shape2 = _ids(1), guidance[:1], (1, 8, 8, 4)
    elif change == "token_length":
        ids2 = _ids(length=6)
    elif change == "guidance_dtype":
        guidance2 = guidance.double()
    elif change in ("conv_quant", "pv_int8"):
        unet.set_serving_modes(**{("attention_pv_int8" if change == "pv_int8"
                                   else change): True})
        undo = unet.set_serving_modes
    elif change == "ae_pv_int8":
        ae.set_serving_modes(attention_pv_int8=True)
        undo = ae.set_serving_modes
    elif change in ("cond_dtype", "ae_dtype"):
        model = cond if change == "cond_dtype" else ae
        model.dtype = torch.bfloat16
        undo = lambda: setattr(model, "dtype", torch.float32)
    elif change == "attention_impl":
        attention.set_attention_impl("xla")
        undo = lambda: attention.set_attention_impl("auto")
    try:
        want = _eager(models, schedule2, ids2, guidance2, shape2, 5, **settings2)
        for _ in range(2):  # a capture, then a replay of it
            for out, w in zip(program(schedule2, ids2, guidance2, shape2, 5, **settings2),
                              want):
                assert torch.equal(out, w)
    finally:
        undo()
    want_keys = {"none": 1, "cache_levels": 3}.get(change, 2)
    assert len(store.capture_seconds) == want_keys
    if change == "conv_quant":  # new int8 weight buffers: the weights check drops the rest
        assert len(store) == 1
    else:
        assert len(store) == want_keys
    for out, want in zip(program(schedule, ids, guidance, shape, 3, **SETTINGS), first):
        assert torch.equal(out, want)  # the first key kept (conv_quant: made anew)
    assert len(store.capture_seconds) == want_keys + (change == "conv_quant")


@pytest.mark.parametrize("how", ["in_place", "replaced"])
@pytest.mark.parametrize("which", ["cond", "unet", "ae"])
def test_changed_weights_of_any_model_drop_the_capture(store, which, how):
    config = _config(steps=2)
    models = _models(config)
    program = graphs.graphed_program(models)
    schedule = factory.build_schedule(config)
    ids, guidance, shape = _ids(), torch.tensor([5.0, 2.0]).reshape(2, 1, 1, 1), (2, 8, 8, 4)
    before, _ = program(schedule, ids, guidance, shape, 3, **SETTINGS)
    program(schedule, ids, guidance, shape, 3, **SETTINGS)
    model = {"cond": models[0], "unet": models[1], "ae": models[2].decoder}[which]
    name, param = next((n, p) for n, p in model.named_parameters() if p.dim() > 1)
    if how == "in_place":
        with torch.no_grad():
            param.mul_(1.5)
    else:
        owner, leaf = model, name
        if "." in name:
            path, leaf = name.rsplit(".", 1)
            owner = model.get_submodule(path)
        setattr(owner, leaf, torch.nn.Parameter(param.detach() * 1.5, requires_grad=False))
    want, _ = _eager(models, schedule, ids, guidance, shape, 3, **SETTINGS)
    got, _ = program(schedule, ids, guidance, shape, 3, **SETTINGS)
    assert torch.equal(got, want) and not torch.equal(got, before)
    assert len(store) == 1 and len(store.capture_seconds) == 2  # dropped, made anew
    assert torch.equal(program(schedule, ids, guidance, shape, 3, **SETTINGS)[0], want)


FWD = "_ZN12_GLOBAL__N_122flash_fwd_wgmma_kernelI6ConfigILi40EEEEvPK"


@pytest.mark.parametrize("nodes", [False, True])
def test_a_replay_counts_what_an_eager_call_counts(monkeypatch, store, nodes):
    """Each U-Net eval and the decode tick the flash counters here (hooks
    standing in for their kernels): a replay adds what an eager call adds,
    the decode's tick included; with a graph that holds the ticks' kernel
    nodes, the counts are read off those nodes."""
    config = _config(steps=3)
    models = _models(config)
    cond, unet, ae = models
    for fn in (fa.flash_attention,):  # the counters restored after the test
        monkeypatch.setattr(fn, "launches", fn.launches)
        monkeypatch.setattr(fn, "launches_by_path", dict(fn.launches_by_path))

    def tick(*_):
        fa.flash_attention.launches += 1
        fa.flash_attention.launches_by_path["wgmma"] += 1

    unet.register_forward_hook(tick)
    ae.decoder.register_forward_hook(tick)
    schedule = factory.build_schedule(config)
    evals = len(schedule.ddim_steps)
    if nodes:
        class Held(Runner):
            def kernels(self):
                return {FWD: evals + 1}  # the evals and the decode
        monkeypatch.setattr(store, "_runner", Held)
    ids, guidance, shape = _ids(), torch.tensor([5.0, 2.0]).reshape(2, 1, 1, 1), (2, 8, 8, 4)
    program = graphs.graphed_program(models)
    before = shared.counts()
    _eager(models, schedule, ids, guidance, shape, 3, **SETTINGS)
    per_call = shared.rise(before, shared.counts())
    assert per_call[(fa.flash_attention, "launches")] == evals + 1
    for n in range(3):  # the warm-up and capture, then replays
        before = shared.counts()
        program(schedule, ids, guidance, shape, 3 + n, **SETTINGS)
        assert shared.rise(before, shared.counts()) == per_call, n
    assert store.replays == 2


def test_the_cpu_runs_eagerly_and_says_so(capsys):
    config = _config()
    models = _models(config)
    run_batch, warmup, _ = serve_ldm.build_server(config, device="cpu", models=models)
    warmup()
    assert run_batch.program is None
    err = capsys.readouterr().err
    assert "serving calls (text encode, sampling loop, decode) run eagerly (no CUDA " \
           "graphs on the CPU)" in err and "captured" not in err
    run_batch, warmup, _ = serve_ldm.build_server(config, device="cpu", models=models,
                                                  graphs=False)
    warmup()
    assert run_batch.program is None and "graphs=False" in capsys.readouterr().err


def test_the_warmup_reports_its_capture(monkeypatch, store, capsys):
    config = _config()
    _, warmup, _ = serve_ldm.build_server(config, device="cpu", models=_models(config))
    warmup()
    assert "captured 1 call graph(s) in" in capsys.readouterr().err
    assert len(store.capture_seconds) == 1 and store.replays == 0


SCALE_FACTOR = 0.18215


@pytest.fixture(scope="module")
def jax_tiny():
    """(port models, the JAX server's pipeline pieces): one set of weights
    drawn by ``golden_utils.materialize``, loaded into the port's models by
    the bridge; the JAX text encode, U-Net passes (full, cache-returning,
    shallow) and decode, each jitted once and called with jit on from loops
    run op by op (``jax.disable_jit``), so that each compiles once."""
    import jax
    import jax.numpy as jnp

    import golden_utils as gu
    from ldm_tf2_tpu import models as jm
    from ldm_tf2_tpu_torch import models as tm
    from ldm_tf2_tpu_torch.checkpoints.bridge import load_params

    unet_kw = dict(model_channels=32, out_channels=4, num_blocks=1, channel_mult=(1, 2),
                   num_heads=2, context_channels=64, dropout_rate=0.0)
    ae_kw = dict(channels=32, num_blocks=1, multipliers=(1, 2))
    tr, un, ae = jm.TransformerModel(**TR), jm.UNet(**unet_kw), jm.AutoencoderKL(**ae_kw)
    key = jax.random.PRNGKey(0)

    def variables(init, order, seed):
        zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jax.eval_shape(init))
        return gu.materialize(zeros, order, seed)

    tr_v, un_v, ae_v = (
        variables(lambda: tr.init(key, jnp.zeros((4, 8), jnp.int32)),
                  gu.transformer_order(1), gu.SEED + 61),
        variables(lambda: un.init(key, jnp.zeros((4, 8, 8, 4)), jnp.zeros((4,)),
                                  jnp.zeros((4, 8, 64))),
                  gu.unet_order(1, (1, 2)), gu.SEED + 62),
        variables(lambda: ae.init({"params": key, "sample": key}, jnp.zeros((1, 16, 16, 3))),
                  gu.autoencoder_kl_order(1, (1, 2), 16), gu.SEED + 63),
    )
    models = (load_params(tm.TransformerModel(**TR), tr_v).eval(),
              load_params(tm.UNet(**unet_kw), un_v).eval(),
              load_params(tm.AutoencoderKL(**ae_kw), ae_v).eval())

    def jitted(fn, v):
        fn = jax.jit(fn)

        def call(*args):
            with jax.disable_jit(False):
                return fn(v, *args)
        return call

    pieces = dict(
        encode=jitted(lambda v, ids: tr.apply(v, ids), tr_v),
        full=jitted(lambda v, x, t, c: un.apply(v, x, t, c), un_v),
        cached=jitted(lambda v, x, t, c: un.apply(v, x, t, c, return_cache=True,
                                                  cache_levels=1), un_v),
        shallow=jitted(lambda v, x, t, c, k: un.apply(v, x, t, c, shallow_cache=k,
                                                      cache_levels=1), un_v),
        decode=jitted(lambda v, z: ae.apply(v, z / SCALE_FACTOR,
                                            method=jm.AutoencoderKL.decode), ae_v))
    return models, pieces


@pytest.mark.parametrize("loop", ["ddim", "ddim_deepcache"])
def test_body_holds_the_jax_servers_pipeline(jax_tiny, loop):
    """``txt2img_body`` (the program's captured call) with the initial
    latent injected against the JAX server's pipeline math (encode, the
    DDIM or DeepCache loop, decode) on the same weights, with a per-slot
    guidance, in float32."""
    import jax
    import jax.numpy as jnp

    from ldm_tf2_tpu.diffusion import make_schedule as jax_make_schedule
    from ldm_tf2_tpu.diffusion import sampler as jsampler
    from ldm_tf2_tpu_torch.diffusion.schedule import make_schedule

    models, jax_fns = jax_tiny
    interval = 2 if loop == "ddim_deepcache" else 1
    sched = dict(num_steps=50, beta_start=0.00085, beta_end=0.012, eta=0.0, num_ddim_steps=4)
    ids = _ids().numpy()
    guidance = np.array([5.0, 2.5], np.float32).reshape(2, 1, 1, 1)
    xt0 = np.random.default_rng(7).standard_normal((2, 8, 8, 4)).astype(np.float32)

    with torch.inference_mode():
        images, x0 = txt2img_body(
            *models, make_schedule(**sched), torch.as_tensor(ids), None,
            torch.as_tensor(guidance), xt0.shape, cache_interval=interval,
            scale_factor=SCALE_FACTOR, init_noise=torch.as_tensor(xt0))

    jschedule = jax_make_schedule(**sched)
    key, shape = jax.random.PRNGKey(0), xt0.shape
    with jax.disable_jit():
        context = jax_fns["encode"](jnp.asarray(ids, jnp.int32))
        if interval > 1:
            jx0 = jsampler.ddim_sample_loop_deepcache(
                jax_fns["cached"], jax_fns["shallow"], jschedule, context, shape, key,
                jnp.asarray(guidance), cache_interval=interval, init_noise=jnp.asarray(xt0))
        else:
            jx0 = jsampler.ddim_sample_loop(jax_fns["full"], jschedule, context, shape, key,
                                            jnp.asarray(guidance),
                                            init_noise=jnp.asarray(xt0))
        jimages = jax_fns["decode"](jx0)
    np.testing.assert_allclose(x0.numpy(), np.asarray(jx0), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(images.numpy(), np.asarray(jimages), rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------------ card --

@pytest.mark.cuda
@pytest.mark.parametrize("modes", ["bf16", "int8"])
def test_program_replays_equal_eager_calls_on_card(monkeypatch, modes):
    """A tiny server on the card in bf16 (and in both int8 serving modes):
    the warm-up captures one program, the calls after it replay it, each
    bit-equal to the eager server's call and counting what it counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    store = shared.GraphStore()
    monkeypatch.setattr(graphs, "STORE", store)
    tpu = dict(quantize="int8", quantize_attention="int8pv") if modes == "int8" else {}
    config = _config(steps=4, dtype="bfloat16", **tpu)
    config["unet"].update(model_channels=160, num_heads=4)
    config["autoencoder_kl"]["channels"] = 256  # the mid-block's attention at S = 512
    config["ldm_sampling"]["latent_shape"] = [2, 32, 32, 4]
    models = _models(config, "cuda")
    runs = {}
    try:
        for on in (False, True):
            seen = []
            real = serve_ldm.tensor_to_image
            monkeypatch.setattr(serve_ldm, "tensor_to_image",
                                lambda a: seen.append(a.copy()) or real(a))
            run_batch, warmup, _ = serve_ldm.build_server(config, device="cuda",
                                                          models=models, graphs=on)
            warmup()
            rises = []
            for seed, guidance in CALLS:
                before = shared.counts()
                run_batch(PROMPTS, ["", "blurry"], guidance, seed)
                torch.cuda.synchronize()
                rises.append(shared.rise(before, shared.counts()))
            monkeypatch.setattr(serve_ldm, "tensor_to_image", real)
            runs[on] = (seen, rises)
        nodes = store.kernels(run_batch.program.last_key)
    finally:
        store.clear()
    for g, e in zip(*(runs[on][0] for on in (True, False))):
        assert np.array_equal(g, e)
    assert runs[True][1] == runs[False][1] and runs[True][1][0]
    assert len(store.capture_seconds) == 1 and store.replays == len(CALLS)
    held = {shared.kernel_base_name(k) for k in nodes}
    assert "flash_fwd_wgmma_kernel" in held or "pv_int8_wgmma_kernel" in held
