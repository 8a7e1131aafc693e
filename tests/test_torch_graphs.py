"""The sampling loops through captured U-Net evals (``diffusion/graphs.py``).

On the CPU the store takes ``StandIn`` for the CUDA graph: it runs the
captured function at capture and again at each replay, writing into the
same static outputs as a replay does, so a loop that kept a graph's output
across a replay would see it overwritten.  Every loop (DDIM at eta 0 and
1, progressive DDIM, DDPM, PLMS, DPM-Solver++(2M), DeepCache DDIM and
DPM-Solver++(2M), img2img, inpainting) runs through the graphed model of a
tiny U-Net and must equal the eager loop bit for bit, and the JAX
package's loop on the same weights (carried across by the bridge) at
``tests/test_torch_samplers.py``'s rtol 1e-4 / atol 1e-5; the graphed
pipeline also holds ``tests/goldens/txt2img_pipeline.npz`` at
``tests/test_torch_pipeline.py``'s tolerances.  Then the key (a key seen
replays, a new shape, dtype, variant or mode captures), weights changed
after a capture (never replayed stale), the launch counters' bookkeeping,
and the CPU and mesh rules.  The JAX package is imported inside the
fixtures, so the ``cuda`` test at the end (a tiny U-Net captured on each
route, the replay bit-equal to the eager eval) runs on a machine without
JAX: ``python -m pytest --noconftest -m cuda tests/test_torch_graphs.py``.
"""

import os

import numpy as np
import pytest
import torch

import golden_utils as gu
from ldm_tf2_tpu_torch import graphs as shared
from ldm_tf2_tpu_torch import models as tm
from ldm_tf2_tpu_torch.checkpoints.bridge import load_params
from ldm_tf2_tpu_torch.cli import run_ldm_sampler as cli
from ldm_tf2_tpu_torch.diffusion import graphs
from ldm_tf2_tpu_torch.diffusion import sampler as tsampler
from ldm_tf2_tpu_torch.diffusion import solvers as tsolvers
from ldm_tf2_tpu_torch.diffusion.schedule import make_schedule
from ldm_tf2_tpu_torch.ops import attention, fused_conv, group_norm
from ldm_tf2_tpu_torch.ops import flash_attention as fa

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
TOL = dict(rtol=1e-4, atol=1e-5)
SHAPE = (2, 8, 8, 4)
UNET = dict(model_channels=32, out_channels=4, num_blocks=1, channel_mult=(1, 2),
            num_heads=2, context_channels=32, dropout_rate=0.0)
STEPS = 4


class StandIn:
    """A CUDA graph's stand-in on the CPU: the capture runs ``fn`` and keeps
    its outputs as the static outputs; a replay runs ``fn`` again on the
    static inputs and copies the result into those same tensors.  The
    counters it ticks while replaying are taken back, since a replay runs
    no wrapper."""

    made = 0

    def __init__(self):
        StandIn.made += 1

    def warmup(self, fn):
        return fn()

    def capture(self, fn):
        self.fn = fn
        self.outputs = fn()
        return self.outputs

    def kernels(self):
        return None

    def replay(self):
        before = shared.counts()
        fresh = self.fn()
        shared.add_counts(shared.rise(before, shared.counts()), -1)
        for static, value in zip(self.outputs, fresh):
            static.copy_(value)


def _store():
    return shared.GraphStore(runner=StandIn)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))  # a writable copy


def _variables_of(module, order, seed):
    """``golden_utils.materialize``'s weights for the port ``module``, the
    zeros tree read off its ``state_dict`` (OIHW kernels back to HWIO)."""
    tree = {}
    for key, value in module.state_dict().items():
        *path, leaf = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        shape = tuple(value.shape)
        node[leaf] = np.zeros(shape[2:] + shape[1::-1] if len(shape) == 4 else shape,
                              np.float32)
    return gu.materialize({"params": tree}, order, seed)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _seeded_unet(**kw):
    """A tiny U-Net of seeded weights (no JAX), for the key cases."""
    unet = tm.UNet(**{**UNET, **kw}).eval().requires_grad_(False)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in unet.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
    return unet


@pytest.fixture
def fresh_unet():
    return _seeded_unet()


def _eval_inputs(batch=2, dtype=torch.float32):
    gen = torch.Generator().manual_seed(9)
    x = torch.randn((2 * batch,) + SHAPE[1:], generator=gen).to(dtype)
    t = torch.tensor([901.0, 501.0, 41.0, 1.0] * batch)[:2 * batch]
    c = torch.randn(2 * batch, 5, 32, generator=gen).to(dtype)
    return x, t, c


# -------------------------------------------------------------- the loops --

@pytest.fixture(scope="module")
def tiny():
    """(port U-Net, JAX eps models, context): one set of weights drawn by
    ``golden_utils.materialize``, loaded into the port's U-Net by the
    bridge; the JAX U-Net's full pass, cache-returning pass and shallow
    pass, each jitted once and called with jit on from loops run op by op
    (``jax.disable_jit``), so that the U-Net compiles once a variant."""
    import jax

    from ldm_tf2_tpu import models as jm

    variables = _variables_of(tm.UNet(**UNET), gu.unet_order(1, UNET["channel_mult"]),
                              gu.SEED + 171)
    unet = load_params(tm.UNet(**UNET), variables).eval().requires_grad_(False)
    junet = jm.UNet(**UNET)
    full = jax.jit(lambda v, x, t, c: junet.apply(v, x, t, c))
    cached = jax.jit(lambda v, x, t, c: junet.apply(v, x, t, c, return_cache=True,
                                                    cache_levels=1))
    shallow = jax.jit(lambda v, x, t, c, k: junet.apply(v, x, t, c, shallow_cache=k,
                                                        cache_levels=1))

    def jitted(fn):
        def call(*args):
            with jax.disable_jit(False):
                return fn(variables, *args)
        return call

    context = np.random.default_rng(173).standard_normal((4, 5, 32)).astype(np.float32)
    return unet, (jitted(full), jitted(cached), jitted(shallow)), context


def _schedules(num_steps=40, **kw):
    from ldm_tf2_tpu.diffusion import make_schedule as jax_make_schedule

    kw = dict(num_steps=num_steps, beta_start=0.00085, beta_end=0.012,
              num_ddim_steps=STEPS, **kw)
    return jax_make_schedule(**kw), make_schedule(**kw)


def _replayed(key, steps, per_step=2):
    """A JAX loop's draws: (key, init_key) first, then a split of
    ``per_step`` keys once a step, the second drawn (and the third, the
    inpainting blend's, when there is one)."""
    import jax
    import jax.numpy as jnp

    key, init_key = jax.random.split(key)
    init = jax.random.normal(init_key, SHAPE, jnp.float32)
    step, blend = [], []
    for _ in range(steps):
        keys = jax.random.split(key, per_step)
        key = keys[0]
        step.append(jax.random.normal(keys[1], SHAPE, jnp.float32))
        if per_step == 3:
            blend.append(jax.random.normal(keys[2], SHAPE, jnp.float32))
    stack = lambda xs: _t(np.stack([np.asarray(a) for a in xs])) if xs else None
    return _t(init), stack(step), stack(blend)


def _half_mask():
    mask = np.zeros((1, 8, 8, 1), np.float32)
    mask[:, :, :4] = 1.0  # the left half regenerated
    return mask


def _case(name, jeps, context):
    """(run, want): ``run(model)`` runs the port's loop on the eps model
    ``model`` (the U-Net or its graphed model) with the JAX loop's draws;
    ``want`` is the JAX loop's result (a list of arrays)."""
    import jax
    import jax.numpy as jnp

    from ldm_tf2_tpu.diffusion import sampler as jsampler
    from ldm_tf2_tpu.diffusion import solvers as jsolvers

    jfull, jcached, jshallow = jeps
    key = jax.random.PRNGKey(sum(map(ord, name)))
    jctx, ctx = jnp.asarray(context), _t(context)
    init = np.random.default_rng(len(name)).standard_normal(SHAPE).astype(np.float32)
    cache_pair = lambda m: (lambda x, t, c: m(x, t, c, return_cache=True, cache_levels=1),
                            lambda x, t, c, k: m(x, t, c, shallow_cache=k, cache_levels=1))
    with jax.disable_jit():
        if name in ("ddim", "ddim_eta1"):
            jsched, sched = _schedules(eta=0.0 if name == "ddim" else 1.0)
            want = jsampler.ddim_sample_loop(jfull, jsched, jctx, SHAPE, key, 5.0)
            x, noises, _ = _replayed(key, STEPS)
            run = lambda m: tsampler.ddim_sample_loop(
                m, sched, ctx, SHAPE, guidance_scale=5.0, init_noise=x,
                step_noises=noises)
        elif name == "progressive":
            jsched, sched = _schedules(eta=1.0)
            want = jsampler.ddim_sample_loop_progressive(jfull, jsched, jctx, SHAPE, key,
                                                         5.0, record_freq=2)
            x, noises, _ = _replayed(key, STEPS)
            run = lambda m: tsampler.ddim_sample_loop_progressive(
                m, sched, ctx, SHAPE, guidance_scale=5.0, record_freq=2, init_noise=x,
                step_noises=noises)
        elif name == "ddpm":
            jsched, sched = _schedules(num_steps=8)
            want = jsampler.ddpm_sample_loop(jfull, jsched, jctx, SHAPE, key, 5.0)
            x, noises, _ = _replayed(key, 8)
            run = lambda m: tsampler.ddpm_sample_loop(
                m, sched, ctx, SHAPE, guidance_scale=5.0, init_noise=x,
                step_noises=noises)
        elif name in ("plms", "dpm_solver_pp_2m"):
            jloop = getattr(jsolvers, f"{name}_sample_loop")
            tloop = getattr(tsolvers, f"{name}_sample_loop")
            jsched, sched = _schedules(timestep_spacing="karras")
            want = jloop(jfull, jsched, jctx, SHAPE, key, 5.0, init_noise=jnp.asarray(init))
            run = lambda m: tloop(m, sched, ctx, SHAPE, guidance_scale=5.0,
                                  init_noise=_t(init))
        elif name == "ddim_deepcache":
            jsched, sched = _schedules(eta=0.0)
            want = jsampler.ddim_sample_loop_deepcache(
                jcached, jshallow, jsched, jctx, SHAPE, key, 5.0, cache_interval=2,
                init_noise=jnp.asarray(init))
            run = lambda m: tsampler.ddim_sample_loop_deepcache(
                *cache_pair(m), sched, ctx, SHAPE, guidance_scale=5.0, cache_interval=2,
                init_noise=_t(init))
        elif name == "dpm_deepcache":
            jsched, sched = _schedules(timestep_spacing="karras")
            want = jsolvers.dpm_solver_pp_2m_sample_loop_deepcache(
                jcached, jshallow, jsched, jctx, SHAPE, key, 5.0, cache_interval=2,
                init_noise=jnp.asarray(init))
            run = lambda m: tsolvers.dpm_solver_pp_2m_sample_loop_deepcache(
                *cache_pair(m), sched, ctx, SHAPE, guidance_scale=5.0, cache_interval=2,
                init_noise=_t(init))
        else:  # img2img, inpainting: strength 0.75 of 4 steps is 3 steps
            mask = _half_mask() if name == "inpainting" else None
            jsched, sched = _schedules(eta=1.0)
            want = jsampler.ddim_img2img_loop(
                jfull, jsched, jctx, jnp.asarray(init), key, strength=0.75,
                guidance_scale=5.0, mask=None if mask is None else jnp.asarray(mask))
            noise0, noises, keeps = _replayed(key, 3, per_step=3)
            run = lambda m: tsampler.ddim_img2img_loop(
                m, sched, ctx, _t(init), strength=0.75, guidance_scale=5.0,
                mask=None if mask is None else _t(mask), init_noise=noise0,
                step_noises=noises, keep_noises=keeps)
    want = want if isinstance(want, tuple) else (want,)
    return run, [np.asarray(w) for w in want]


LOOPS = {"ddim": 1, "ddim_eta1": 1, "progressive": 1, "ddpm": 1, "plms": 1,
         "dpm_solver_pp_2m": 1, "ddim_deepcache": 2, "dpm_deepcache": 2,
         "img2img": 1, "inpainting": 1}  # loop -> its keys (captures)


@pytest.mark.parametrize("name", list(LOOPS))
def test_graphed_loop_equals_eager_and_jax(tiny, name):
    unet, jeps, context = tiny
    run, want = _case(name, jeps, context)
    store = _store()
    with torch.inference_mode():
        eager = run(unet)
        got = run(graphs.graphed_eps_model(unet, store))
        again = run(graphs.graphed_eps_model(unet, store))  # every eval a replay
    as_tuple = lambda out: out if isinstance(out, tuple) else (out,)
    for e, g, a, w in zip(as_tuple(eager), as_tuple(got), as_tuple(again), want):
        assert torch.equal(g, e) and torch.equal(a, e)
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    assert len(store.capture_seconds) == len(store) == LOOPS[name]


def _golden_weights():
    """The tiny pipeline of ``tests/test_torch_pipeline.py`` (its widths and
    golden seeds +1, +2, +3), the zeros trees read off the port's modules."""
    made = (tm.TransformerModel(vocab_size=100, encoder_stack_size=1, hidden_size=1280,
                                num_heads=8, size_per_head=64, max_seq_len=8,
                                filter_size=256, dropout_rate=0.0),
            tm.UNet(model_channels=160, out_channels=4, num_blocks=1, channel_mult=(1, 2),
                    num_heads=4, context_channels=1280, dropout_rate=0.0),
            tm.AutoencoderKL(channels=32, num_blocks=1, multipliers=(1, 2)))
    orders = (gu.transformer_order(1), gu.unet_order(1, (1, 2)),
              gu.autoencoder_kl_order(1, (1, 2), 16))
    return tuple(load_params(m, _variables_of(m, order, gu.SEED + 1 + i)).eval()
                 for i, (m, order) in enumerate(zip(made, orders)))


def test_graphed_pipeline_holds_the_golden(monkeypatch):
    """``sample_txt2img`` with its graphs on (the card's rule let through on
    the CPU, the stand-in for the graph): x0 and images bit-equal to
    ``graphs=False`` and within the golden's tolerances."""
    g = np.load(os.path.join(GOLDENS, "txt2img_pipeline.npz"))
    models = _golden_weights()
    schedule = make_schedule(num_steps=50, beta_start=0.00085, beta_end=0.012,
                             eta=0.0, num_ddim_steps=5)
    store = _store()
    monkeypatch.setattr(graphs, "STORE", store)
    monkeypatch.setattr(graphs, "graphs_apply", lambda device: True)
    kw = dict(guidance_scale=5.0, init_noise=torch.as_tensor(g["xt0"]), device="cpu")
    ids = torch.as_tensor(g["token_ids"])
    images, x0 = cli.sample_txt2img(*models, schedule, ids, g["xt0"].shape, **kw)
    eager_images, eager_x0 = cli.sample_txt2img(*models, schedule, ids, g["xt0"].shape,
                                                graphs=False, **kw)
    assert len(store.capture_seconds) == 1
    assert torch.equal(x0, eager_x0) and torch.equal(images, eager_images)
    np.testing.assert_allclose(x0.numpy(), g["x_final"], rtol=1e-3, atol=1e-4)
    assert float(np.abs(images.numpy() - g["images"]).max()) < 1e-2
    np.testing.assert_allclose(images.numpy(), g["images"], rtol=1e-2, atol=1e-3)


# ---------------------------------------------------------------- the key --

def _switch(what):
    """Set one mode the key must see; returns its undo."""
    if what == "attention_impl":
        attention.set_attention_impl("xla")
        return lambda: attention.set_attention_impl("auto")
    if what == "packed_cross":
        attention.set_packed_cross(True)
        return lambda: attention.set_packed_cross(False)
    if what == "groupnorm":
        group_norm.set_groupnorm_impl("pallas")
        return lambda: group_norm.set_groupnorm_impl("auto")
    if what == "fused_conv":
        fused_conv.set_fused_conv_impl("pallas")
        return lambda: fused_conv.set_fused_conv_impl("auto")
    if what in ("cudnn_benchmark", "cudnn_deterministic"):
        flag = what[len("cudnn_"):]
        was = getattr(torch.backends.cudnn, flag)
        setattr(torch.backends.cudnn, flag, not was)
        return lambda: setattr(torch.backends.cudnn, flag, was)
    raise ValueError(what)


@pytest.mark.parametrize("change", ["none", "shape", "dtype", "return_cache", "shallow",
                                    "cache_levels", "pv_int8", "attention_impl",
                                    "packed_cross", "groupnorm", "fused_conv",
                                    "cudnn_benchmark", "cudnn_deterministic"])
def test_a_new_key_captures_and_a_seen_key_replays(change):
    unet = _seeded_unet(channel_mult=(1, 2, 2))
    store = _store()
    x, t, c = _eval_inputs()
    with torch.inference_mode():
        model = graphs.graphed_eps_model(unet, store)
        first = model(x, t, c)
        assert torch.equal(model(x, t, c), first)  # replayed
        assert len(store.capture_seconds) == 1
        undo = lambda: None
        kw = {}
        if change == "shape":
            x, t, c = _eval_inputs(batch=1)
        elif change == "dtype":
            x, c = x.double(), c.double()
        elif change == "return_cache":
            kw = dict(return_cache=True)
        elif change == "shallow":
            kw = dict(shallow_cache=unet(x, t, c, return_cache=True)[1])
        elif change == "cache_levels":  # level 1's capture, then level 2's
            for levels in (1, 2):
                kw = dict(shallow_cache=unet(x, t, c, return_cache=True,
                                             cache_levels=levels)[1], cache_levels=levels)
                assert torch.equal(model(x, t, c, **kw), unet(x, t, c, **kw))
        elif change == "pv_int8":
            unet.set_serving_modes(attention_pv_int8=True)
            undo = unet.set_serving_modes
        elif change != "none":
            undo = _switch(change)
        try:
            want = unet(x, t, c, **kw)
            for _ in range(2):  # a capture, then a replay of it
                got = model(x, t, c, **kw)
                for g, w in zip(got if isinstance(got, tuple) else (got,),
                                want if isinstance(want, tuple) else (want,)):
                    assert torch.equal(g, w)
        finally:
            undo()
        want_keys = {"none": 1, "cache_levels": 3}.get(change, 2)
        assert len(store.capture_seconds) == len(store) == want_keys
        assert torch.equal(model(*_eval_inputs()), first)  # the first key kept


@pytest.mark.parametrize("how", ["in_place", "replaced", "load_state_dict",
                                 "between_evals", "int8_weights"])
def test_changed_weights_never_replay_stale(fresh_unet, how):
    unet = fresh_unet
    store = _store()
    x, t, c = _eval_inputs()
    with torch.inference_mode():
        model = graphs.graphed_eps_model(unet, store)
        before = model(x, t, c)
        model(x, t, c)
        if how == "in_place" or how == "between_evals":
            with torch.no_grad():
                unet.conv_out.kernel.mul_(1.5)
        elif how == "replaced":
            unet.conv_out.kernel = torch.nn.Parameter(unet.conv_out.kernel * 1.5,
                                                      requires_grad=False)
        elif how == "load_state_dict":
            sd = {k: v * 1.5 for k, v in unet.state_dict().items()}
            unet.load_state_dict(sd)
        else:  # new int8 weights: the serving mode set again, new buffers
            unet.set_serving_modes(conv_quant=True)
            model(x, t, c)
            unet.set_serving_modes(conv_quant=True)
        if how != "between_evals":  # a new sampling call's model
            model = graphs.graphed_eps_model(unet, store)
        want = unet(x, t, c)
        got = model(x, t, c)
        assert torch.equal(got, want) and not torch.equal(got, before)
        assert torch.equal(model(x, t, c), want)
    assert len(store) == 1  # the stale capture dropped, one made anew
    assert len(store.capture_seconds) == (3 if how == "int8_weights" else 2)


class _CaptureOnly:
    """A runner that, like a CUDA graph, keeps no reference to the captured
    function (and so none to the U-Net)."""

    def warmup(self, fn):
        return fn()

    def capture(self, fn):
        return fn()

    def kernels(self):
        return None

    def replay(self):
        pass


def test_a_dead_unets_captures_are_dropped():
    import gc

    store = shared.GraphStore(runner=_CaptureOnly)
    unet = _seeded_unet()
    with torch.inference_mode():
        graphs.graphed_eps_model(unet, store)(*_eval_inputs())
    assert len(store) == 1
    del unet
    gc.collect()
    assert len(store) == 0


def test_a_pool_is_new_once_every_capture_is_dropped(monkeypatch):
    """Graphs share one memory pool, but PyTorch frees a pool once its last
    graph is gone, and a capture into it then fails: after every capture
    is dropped the store asks for a new pool."""
    handles = iter(range(1, 100))
    pools = []

    class Runner(_CaptureOnly):
        def __init__(self, pool):
            pools.append(pool)

    monkeypatch.setattr(graphs.torch.cuda, "graph_pool_handle", lambda: next(handles))
    monkeypatch.setattr(shared, "CUDAGraphRunner", Runner)
    store = shared.GraphStore()
    unet = _seeded_unet()
    x, t, c = _eval_inputs()
    with torch.inference_mode():
        graphs.graphed_eps_model(unet, store)(x, t, c)
        graphs.graphed_eps_model(unet, store)(x, t, c, return_cache=True)
        with torch.no_grad():
            unet.conv_out.bias.add_(1.0)  # drops both captures
        graphs.graphed_eps_model(unet, store)(x, t, c)
        store.clear()
        graphs.graphed_eps_model(unet, store)(x, t, c)
    assert pools == [1, 1, 2, 3]


# -------------------------------------------------------- counters, rules --

def test_replays_count_what_eager_evals_count():
    """A capture's rise in the wrappers' counters is taken back and added
    again at each replay, so a graphed call counts its eager launches."""
    store = _store()
    paths = fa.flash_attention.launches_by_path
    start = (fa.flash_attention.launches, paths["wgmma"])

    def fn(x):
        fa.flash_attention.launches += 3
        fa.flash_attention.launches_by_path["wgmma"] += 3
        return (x * 2,)

    x = torch.ones(3)
    for n in range(1, 5):
        (out,) = store.run("key", fn, (x * n,), shared.Session())
        assert torch.equal(out, x * 2 * n)
        assert fa.flash_attention.launches - start[0] == 3 * n
        assert fa.flash_attention.launches_by_path["wgmma"] - start[1] == 3 * n
    assert len(store.capture_seconds) == 1


class _Nodes(_CaptureOnly):
    """A runner whose graph holds ``_Nodes.kernels_held`` (mangled names)."""

    kernels_held: dict = {}

    def kernels(self):
        return dict(_Nodes.kernels_held)


FWD = "_ZN12_GLOBAL__N_122flash_fwd_wgmma_kernelI6ConfigILi40EEEEvPK"
STATS = "_Z23gn_channel_stats_kernelIN3c108BFloat16ELi8EEvPKT_"
CONV = "_ZN12_GLOBAL__N_117conv_wgmma_kernelI10ConvConfigILi2EEEEvv"
S8 = "_ZN12_GLOBAL__N_120s8_conv_wgmma_kernelI8S8ConfigEEvv"
GNQ = "_ZN3gnc28gn_silu_quant_cluster_kernelIN3c108BFloat16ELi8EEEvv"
GEMM = "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64"


def _tick(fn, attr, n, path=None):
    if path is None:
        setattr(fn, attr, getattr(fn, attr) + n)
    else:
        getattr(fn, attr)[path] += n


# (what a capture counts, the graph's kernel nodes, whether they agree)
BACKING = {
    "agree": ([("fa", "launches", 3), ("fa", "launches_by_path", 3, "wgmma")],
              {FWD: 3, GEMM: 7}, True),
    "a counted launch missing": ([("fa", "launches", 3), ("fa", "launches_by_path", 3, "wgmma")],
                                 {FWD: 2}, False),
    "another path": ([("fa", "launches", 3), ("fa", "launches_by_path", 3, "fma")],
                     {FWD: 3}, False),
    "a kernel not counted": ([("fa", "launches", 1), ("fa", "launches_by_path", 1, "wgmma")],
                             {FWD: 1, S8: 1}, False),
    "a counter no node backs": ([("fc", "relayouts", 1)], {GEMM: 1}, False),
    "the conv chains' stats": ([("fc", "launches", 2), ("fc", "launches_by_path", 2, "wgmma"),
                                ("gs", "launches", 1)], {CONV: 2, STATS: 3}, True),
    "a stats launch missing": ([("fc", "launches", 2), ("fc", "launches_by_path", 2, "wgmma"),
                                ("gs", "launches", 1)], {CONV: 2, STATS: 2}, False),
    "a plan's modes": ([("gq", "launches", 2), ("gq", "launches_by_path", 1, "resident"),
                        ("gq", "launches_by_path", 1, "reread"), ("gq", "stream_launches", 1)],
                       {GNQ: 2}, True),
    "modes past the launches": ([("gq", "launches", 2), ("gq", "launches_by_path", 3, "resident")],
                                {GNQ: 2}, False),
    "int8 pairs": ([("gq", "launches", 2), ("gq", "launches_by_path", 2, "resident"),
                    ("s8", "launches", 2), ("s8", "launches_by_path", 2, "wgmma"),
                    ("pair", "launches", 2)], {GNQ: 2, S8: 2}, True),
    "int8 pairs past a launch": ([("gq", "launches", 2), ("gq", "launches_by_path", 2, "resident"),
                                  ("s8", "launches", 1), ("s8", "launches_by_path", 1, "wgmma"),
                                  ("pair", "launches", 2)], {GNQ: 2, S8: 1}, False),
}


@pytest.mark.parametrize("case", list(BACKING))
def test_replays_count_the_graphs_kernel_nodes(monkeypatch, case):
    """A capture's counts are read off its graph's kernel nodes by name
    (one node of a wrapper's kernel per counted call, by path): a capture
    whose counters and nodes disagree raises; one whose agree adds the
    nodes' counts at each replay."""
    from ldm_tf2_tpu_torch.ops import fused_conv as fc
    from ldm_tf2_tpu_torch.ops import quant_conv as qc

    wrappers = {"fa": fa.flash_attention, "fc": fc.gn_silu_conv3x3_fused,
                "gs": group_norm.group_stats, "gq": qc.gn_silu_quant, "s8": qc.s8_conv3x3,
                "pair": qc.gn_silu_conv3x3_int8}
    for fn in wrappers.values():  # the counters restored after the test
        for attr, value in list(vars(fn).items()):
            if isinstance(value, (int, dict)):
                monkeypatch.setattr(fn, attr, dict(value) if isinstance(value, dict) else value)
    ticks, held, agree = BACKING[case]
    monkeypatch.setattr(_Nodes, "kernels_held", held)
    store = shared.GraphStore(runner=_Nodes)

    def fn(x):
        for name, attr, n, *path in ticks:
            _tick(wrappers[name], attr, n, *path)
        return (x + 1,)

    x = torch.zeros(2)
    start = shared.counts()
    if not agree:
        with pytest.raises(RuntimeError, match="disagree with its graph"):
            store.run("key", fn, (x,), shared.Session())
        return
    store.run("key", fn, (x,), shared.Session())  # the eager warm-up and capture
    per_eval = shared.rise(start, shared.counts())
    for n in range(1, 3):
        before = shared.counts()
        store.run("key", fn, (x,), shared.Session())  # a replay
        assert shared.rise(before, shared.counts()) == per_eval
    assert store.kernels("key") == held


@pytest.mark.parametrize("mangled, base", [
    (FWD, "flash_fwd_wgmma_kernel"), (STATS, "gn_channel_stats_kernel"),
    (GNQ, "gn_silu_quant_cluster_kernel"), ("_ZL10ffn_kernelIfLi2EEvv", "ffn_kernel"),
    (S8, "s8_conv_wgmma_kernel"), (GEMM, GEMM)])
def test_kernel_base_name(mangled, base):
    assert shared.kernel_base_name(mangled) == base


def test_no_graph_on_the_cpu_or_on_a_mesh(monkeypatch, fresh_unet):
    StandIn.made = 0
    store = _store()
    monkeypatch.setattr(graphs, "STORE", store)
    assert graphs.eps_model_for(fresh_unet, "cpu") is fresh_unet
    assert graphs.eps_model_for(fresh_unet, torch.device("cpu"), graphs=True) is fresh_unet
    schedule = make_schedule(num_steps=20, beta_start=0.00085, beta_end=0.012,
                             num_ddim_steps=2)
    cond = lambda ids: torch.zeros(ids.shape[0], 5, 32)
    decoder = tm.AutoencoderKL(channels=32, num_blocks=1, multipliers=(1, 2)).eval()
    cli.sample_txt2img(cond, fresh_unet, decoder, schedule, torch.zeros(4, 5, dtype=torch.long),
                       SHAPE, device="cpu")
    assert StandIn.made == 0 and len(store) == 0
    assert "no CUDA graphs on the CPU" in shared.describe("cpu")
    assert not shared.graphs_apply("cpu")
    monkeypatch.setattr(shared, "distributed_world", lambda: 2)
    assert not shared.graphs_apply("cuda")
    assert graphs.eps_model_for(fresh_unet, "cuda") is fresh_unet
    assert "a mesh of 2 ranks" in shared.describe("cuda")
    assert "graphs=False" in shared.describe("cuda", graphs=False)


# ------------------------------------------------------------------ card --

ROUTES = ("default", "opt-in", "int8")


@pytest.mark.cuda
@pytest.mark.parametrize("route", ROUTES)
def test_replay_is_bit_equal_to_eager_on_card(route):
    """A tiny U-Net (three levels, head dim 40 and 80, level 0 at 1024
    tokens) in bf16, captured on the card on each route: every replay
    bit-equal to the eager eval, the counters' rise per replay (read off the
    graph's kernel nodes) equal to an eager eval's, and the route's kernels
    among them and among the graph's nodes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ldm_tf2_tpu_torch import factory

    kw = dict(model_channels=160, out_channels=4, num_blocks=1, channel_mult=(1, 2, 2),
              num_heads=4, context_channels=64, dropout_rate=0.0)
    with torch.device("cuda"):
        unet = tm.UNet(**kw, dtype=torch.bfloat16)
    unet = factory.randomize_(unet.to(torch.bfloat16).eval().requires_grad_(False), seed=3)
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(4, 32, 32, 4, generator=gen, device="cuda", dtype=torch.bfloat16)
    t = torch.tensor([901.0, 501.0, 901.0, 501.0], device="cuda")
    c = torch.randn(4, 77, 64, generator=gen, device="cuda", dtype=torch.bfloat16)
    want = {"default": ("flash_attention", "fused_ffn"),
            "opt-in": ("group_norm_fused", "gn_silu_conv3x3_fused", "cross_attention"),
            "int8": ("gn_silu_quant", "s8_conv3x3", "flash_attention_pv_int8")}[route]
    store = shared.GraphStore()
    undo = []
    if route == "opt-in":
        undo = [_switch("groupnorm"), _switch("fused_conv"), _switch("packed_cross")]
    elif route == "int8":
        unet.set_serving_modes(conv_quant=True, attention_pv_int8=True)
    try:
        with torch.inference_mode():
            unet(x, t, c)  # plans, relayouts, the kernels' builds
            before = shared.counts()
            eager = unet(x, t, c)
            per_eval = shared.rise(before, shared.counts())
            model = graphs.graphed_eps_model(unet, store)
            outs = []
            for i in range(3):  # the eager warm-up and capture, then replays
                before = shared.counts()
                outs.append(model(x, t, c))
                assert shared.rise(before, shared.counts()) == per_eval, i
            torch.cuda.synchronize()
            held = {shared.kernel_base_name(k) for k in store.kernels(model.key(x, t, c))}
    finally:
        for u in undo:
            u()
        store.clear()
    names = {fn.__name__ for fn, attr in per_eval if attr == "launches"}
    assert set(want) <= names, (route, names)
    for name in want:  # one of the wrapper's kernels among the graph's nodes
        assert held & set(shared._KERNELS[name].values()), (route, name, held)
    for out in outs:
        assert torch.equal(out, eager)
    assert len(store.capture_seconds) == 1
