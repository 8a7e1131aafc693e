"""The train steps through captured CUDA graphs (``training/graphs.py``).

On the CPU the train store takes ``StandIn`` for the CUDA graph, as
``tests/test_torch_graphs.py`` does for the sampling store: the capture
runs the step's device part under the fork plan's replay and keeps its
outputs, then puts back the tensors the step wrote (a capture runs
nothing), and each replay runs the device part again into the same
outputs.  Every case of the LDM step (the clip active and inactive,
warm-up with cosine decay, gradient accumulation, a bf16 first moment,
every remat policy, a trained text encoder, the VQ autoencoder, injected
draws) and both autoencoder phases, graphed, must equal the eager step
bit for bit over four steps: losses, parameters, both moments, the EMA,
D's running statistics and the host counters.  The graphed steps also
meet the JAX package's steps at ``tests/test_torch_train.py``'s and
``tests/test_torch_ae_train.py``'s tolerances, through those files' own
checks.  Then the generator rule, the keys, a restored checkpoint, the
version bump a sampling capture sees, the backward kernels' node counts,
and the CPU and mesh rules.  JAX is imported inside the tests, so the
``cuda`` tests at the end (a tiny U-Net's step and an autoencoder's GAN
step captured for real, replays bit-equal to eager) run on a machine
without JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_train_graphs.py``.
"""

import copy

import numpy as np
import pytest
import torch

from ldm_tf2_tpu_torch import graphs as shared
from ldm_tf2_tpu_torch import models as tm
from ldm_tf2_tpu_torch.diffusion import graphs
from ldm_tf2_tpu_torch.diffusion.schedule import make_schedule
from ldm_tf2_tpu_torch.ops import flash_attention as fa
from ldm_tf2_tpu_torch.ops import fused_conv
from ldm_tf2_tpu_torch.training import ae_trainer as tat
from ldm_tf2_tpu_torch.training import graphs as tg
from ldm_tf2_tpu_torch.training import ldm_trainer as tt

IMG = 16
UNET = dict(model_channels=32, out_channels=4, num_blocks=1, channel_mult=(1, 2),
            num_heads=2, context_channels=32)
COND = dict(vocab_size=64, encoder_stack_size=1, hidden_size=32, num_heads=2,
            size_per_head=8, max_seq_len=8, filter_size=64)
AE = dict(channels=32, num_blocks=1, multipliers=(1, 2))
NULL_IDS = np.array([2, 3] + [0] * 6)
STEPS = 4


class StandIn:
    """A CUDA graph's stand-in on the CPU for a train step: the capture runs
    ``fn`` (keeping its outputs as the static outputs) and then puts back
    the ``watched`` tensors, since a capture runs nothing; a replay runs
    ``fn`` again and copies its outputs into those same tensors.  The
    counters it ticks while replaying are taken back."""

    watched: list = []

    def warmup(self, fn):
        return fn()

    def register_generators(self, generators):
        self.generators = list(generators)

    def capture(self, fn):
        saved = [t.detach().clone() for t in StandIn.watched]
        self.fn = fn
        self.outputs = fn()
        with torch.no_grad():
            for t, s in zip(StandIn.watched, saved):
                t.copy_(s)
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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _seeded(*modules, seed=5):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in modules:
            for p in m.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    return modules


def _ldm(case: dict):
    """A tiny LDM step for ``case``: (program, state, (cond, unet, ae)),
    the same weights at every call."""
    rate = case.get("rate", 0.1)
    unet = tm.UNet(**UNET, dropout_rate=rate)
    cond = tm.TransformerModel(**COND, dropout_rate=rate)
    ae = (tm.AutoencoderKL(**AE) if case.get("ae", "kl") == "kl" else
          tm.AutoencoderVQ(**AE, vocab_size=32, attention_resolutions=(), resolution=IMG))
    _seeded(unet, cond, ae)
    train_cond = case.get("train_cond", False)
    unet.requires_grad_(True)
    cond.requires_grad_(train_cond)
    ae.requires_grad_(False)
    opt = tt.make_optimizer(**{"learning_rate": 1e-3, "epsilon": 1e-3, **case.get("opt", {})},
                            accum_steps=case.get("accum", 1))
    program = tt.make_ldm_train_step(
        unet, cond, ae, make_schedule(num_steps=100, num_ddim_steps=10), opt,
        condition_dropout_rate=0.3, null_token_ids=NULL_IDS, train_cond_model=train_cond,
        remat_unet=case.get("remat", False), ema_decay=0.9, seed=3)
    state = tt.init_ldm_train_state(unet, cond, opt, train_cond, 0.9)
    return program, state, (cond, unet, ae)


def _batch(b=2, seed=1):
    rng = np.random.default_rng(seed)
    return (torch.tensor(rng.uniform(-1, 1, (b, IMG, IMG, 3)), dtype=torch.float32),
            torch.tensor(rng.integers(4, 64, (b, 8))))


def _draws(step, b=2):
    gen = torch.Generator().manual_seed(100 + step)
    latents = (b, IMG // 2, IMG // 2, 4)
    return {"t": torch.randint(0, 100, (b,), generator=gen),
            "posterior_noise": torch.randn(latents, generator=gen),
            "drop": torch.rand(b, generator=gen) < 0.5,
            "noise": torch.randn(latents, generator=gen)}


def _opt_snapshot(opt_state):
    return {f"{part}.{k}" if isinstance(v, dict) else part:
            (v[k].clone() if isinstance(v, dict) else v)
            for part, v in opt_state.items() for k in (v if isinstance(v, dict) else [0])}


def _snapshot(state, *modules) -> dict:
    out = {f"m{i}.{k}": v.detach().clone() for i, m in enumerate(modules)
           for k, v in m.state_dict().items()}
    for name in ("opt_state", "ae_opt_state", "d_opt_state"):
        if hasattr(state, name):
            out.update({f"{name}.{k}": v for k, v in _opt_snapshot(getattr(state, name)).items()})
    for k, v in (getattr(state, "ema", None) or {}).items():
        out[f"ema.{k}"] = v.clone()
    out["step"] = state.step
    return out


def _assert_same(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, w in want.items():
        if isinstance(w, torch.Tensor):
            assert torch.equal(got[k], w), k
        else:
            assert got[k] == w, k


def _ldm_run(case, store=None, n=STEPS):
    """``n`` steps of ``case`` eagerly (no ``store``) or graphed through
    ``store``: (losses, snapshot)."""
    program, state, models = _ldm(case)
    step = program
    if store is not None:
        StandIn.watched = program.written(state)
        step = tg.graphed_train_step(program, store)
    images, ids = _batch()
    losses = []
    for s in range(n):
        state, m = step(state, images, ids, _draws(s) if case.get("draws") else None)
        losses.append(m["loss"].clone())
    return losses, _snapshot(state, *models)


LDM_CASES = {
    "clip_active": dict(opt=dict(clip_grad_norm=0.05)),
    "clip_inactive": dict(opt=dict(clip_grad_norm=100.0)),
    "warmup_cosine": dict(opt=dict(warmup_steps=1, decay_steps=4)),
    "accum2": dict(accum=2),
    "mu_bf16": dict(opt=dict(mu_dtype="bfloat16")),
    "remat_true": dict(remat=True),
    "remat_blocks": dict(remat="blocks"),
    "remat_dots": dict(remat="dots"),
    "train_cond": dict(train_cond=True),
    "vq": dict(ae="vq"),
    "draws": dict(draws=True),
}


@pytest.mark.parametrize("name", list(LDM_CASES))
def test_graphed_ldm_step_is_bit_equal_to_eager(name):
    case = LDM_CASES[name]
    store = _store()
    want_losses, want = _ldm_run(case)
    got_losses, got = _ldm_run(case, store)
    assert all(torch.equal(a, b) for a, b in zip(got_losses, want_losses)), name
    _assert_same(got, want)
    # one capture (two under accumulation: the micro-step and the sync step)
    assert len(store) == len(store.capture_seconds) == (2 if case.get("accum") else 1)
    assert got["step"] == STEPS


def _ae(ae_type: str):
    kw = dict(AE, dropout_rate=0.1) if ae_type == "vq" else AE
    ae = (tm.AutoencoderKL(**kw) if ae_type == "kl" else
          tm.AutoencoderVQ(**kw, vocab_size=32, attention_resolutions=(8,), resolution=IMG))
    disc = tm.Discriminator(16, 2)
    lpips = tm.LPIPS()
    _seeded(ae, disc, lpips)
    ae.requires_grad_(True)
    disc.requires_grad_(True)
    lpips.requires_grad_(False)
    ae_opt, d_opt = tat.make_adam(1e-3), tat.make_adam(1e-3)
    steps = tat.make_ae_train_steps(ae, disc, lpips, ae_opt, d_opt, seed=4,
                                    discriminator_weight=0.5)
    return steps, tat.init_ae_train_state(ae, disc, ae_opt, d_opt), (ae, disc)


@pytest.mark.parametrize("ae_type", ["kl", "vq"])
def test_graphed_ae_phases_are_bit_equal_to_eager(ae_type):
    """Two phase-1 steps then two GAN steps, eager and graphed: the
    metrics, both models (D's running statistics included), both Adam
    states and the step bit-equal; one capture a phase."""
    images = _batch()[0]
    runs = []
    for store in (None, _store()):
        (step1, step2), state, models = _ae(ae_type)
        if store is not None:
            StandIn.watched = step1.written(state)
            step1, step2 = (tg.graphed_train_step(s, store) for s in (step1, step2))
        metrics = []
        for s in range(STEPS):
            state, m = (step1 if s < 2 else step2)(state, images)
            metrics.append({k: v.clone() for k, v in m.items()})
        runs.append((metrics, _snapshot(state, *models), store))
    (want_m, want, _), (got_m, got, store) = runs
    for a, b in zip(got_m, want_m):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    _assert_same(got, want)
    assert got["d_opt_state.count"] == 2 and got["ae_opt_state.count"] == 4
    assert len(store) == 2


# ------------------------------------------------------------- against JAX --

def test_graphed_ldm_steps_match_jax(monkeypatch):
    """``tests/test_torch_train.py``'s warm-up, cosine, clip and bf16-moment
    variant, the port's steps graphed: its own check, tolerances and all."""
    import test_torch_train as ltr

    store = _store()
    make = tt.make_ldm_train_step

    def graphed(*args, **kw):
        program = make(*args, **kw)
        graphed.programs.append(program)
        return tg.graphed_train_step(program, store)

    graphed.programs = []
    monkeypatch.setattr(tt, "make_ldm_train_step", graphed)
    run = ltr._run_variant

    def watched_run(*args, **kw):  # the stand-in's capture puts the state back
        original = tt.init_ldm_train_state

        def init(*a, **k):
            state = original(*a, **k)
            StandIn.watched = graphed.programs[-1].written(state)
            return state

        monkeypatch.setattr(tt, "init_ldm_train_state", init)
        return run(*args, **kw)

    monkeypatch.setattr(ltr, "_run_variant", watched_run)
    ltr.test_train_steps_match_jax("warmup_cosine_clip_mu_bf16")
    assert len(store.capture_seconds) == 1


@pytest.fixture(scope="module")
def jax_ae_case():
    """``tests/test_torch_ae_train.py``'s KL case (its weights, images and
    JAX steps), the port's two steps graphed."""
    import jax
    import jax.numpy as jnp
    import test_torch_ae_train as aet

    import golden_utils as gu
    from ldm_tf2_tpu import models as jm
    from ldm_tf2_tpu_torch.checkpoints.bridge import load_params

    images = (np.random.default_rng(3).standard_normal((2, IMG, IMG, 3)) * 0.5).astype(np.float32)
    key = jax.random.PRNGKey(0)
    ae_vars = aet._variables(
        lambda: jm.AutoencoderKL(**aet.AE_KW["kl"]).init({"params": key, "sample": key}, images),
        gu.autoencoder_kl_order(1, (1, 2), IMG), gu.SEED)
    lpips_vars = aet._variables(lambda: jm.LPIPS().init(key, images, images),
                                gu.lpips_order(), gu.SEED + 1)
    d_vars = aet._variables(lambda: jm.Discriminator(16, 2).init(key, images),
                            gu.discriminator_order(2), gu.SEED + 2)
    jax_out = aet._jax_run("kl", jnp.asarray(images), ae_vars, lpips_vars, d_vars)
    ae = load_params(tm.AutoencoderKL(**aet.AE_KW["kl"]), ae_vars).requires_grad_(True)
    disc = load_params(tm.Discriminator(16, 2), d_vars).requires_grad_(True)
    lpips = load_params(tm.LPIPS(), lpips_vars).requires_grad_(False)
    ae_opt, d_opt = tat.make_adam(aet.LR), tat.make_adam(aet.LR)
    store = _store()
    step1, step2 = (tg.graphed_train_step(s, store) for s in tat.make_ae_train_steps(
        ae, disc, lpips, ae_opt, d_opt, **aet.WEIGHTS["kl"]))
    state = tat.init_ae_train_state(ae, disc, ae_opt, d_opt)
    StandIn.watched = step1.program.written(state)
    x = torch.as_tensor(images)
    draws = [{"posterior_noise": torch.as_tensor(np.array(n))} for n in jax_out[2]]
    state, m1 = step1(state, x, draws[0])
    ae1 = {k: v.detach().clone() for k, v in ae.state_dict().items()}
    state, m2 = step2(state, x, draws[1])
    assert len(store.capture_seconds) == 2
    return dict(ae_type="kl", jax=jax_out, m1=m1, m2=m2, ae1=ae1, ae=ae, disc=disc,
                state=state)


@pytest.mark.parametrize("phase", [1, 2])
def test_graphed_ae_phases_match_jax(jax_ae_case, phase):
    import test_torch_ae_train as aet

    check = aet.test_phase1_step_matches_jax if phase == 1 else aet.test_phase2_step_matches_jax
    check(jax_ae_case)


# ----------------------------------------------------------- the host side --

class _State:
    def __init__(self):
        self.step = 0


def _toy(device="cpu", generators=3):
    """A StepProgram whose device part returns one draw of each generator
    and adds the first to a weight."""
    w = torch.zeros(3, device=device)

    def body(state, gens, hyper, phase, x, draws=None):
        out = tuple(torch.rand(3, generator=g, device=device) for g in gens)
        with torch.no_grad():
            w.add_(out[0] * hyper[0] + x.sum())
        return out

    def finish(state, phase, outputs):
        state.step += 1
        return dict(enumerate(outputs))

    return tt.StepProgram(
        body=body, phase=lambda s: True, hyper=lambda s: np.float32([s.step + 1]),
        finish=finish, tensors=lambda s: [w], written=lambda s: [w], key=("toy",), seed=11,
        device=torch.device(device), generators=generators, inputs=1), w


def test_host_state_advances_once_a_step_and_draws_follow_the_step():
    """Each graphed step draws what ``step_generators(seed, step)`` draws,
    its host scalars are read at that step, and the host counters advance
    once a step, never during the capture."""
    program, w = _toy()
    StandIn.watched = [w]
    store = _store()
    step = tg.graphed_train_step(program, store)
    state = _State()
    x = torch.zeros(2)
    want_w = torch.zeros(3)
    for s in range(STEPS):
        state, out = step(state, x)
        assert state.step == s + 1
        want = [torch.rand(3, generator=g) for g in tt.step_generators(11, s, "cpu", 3)]
        assert all(torch.equal(out[i], want[i]) for i in range(3)), s
        want_w += want[0] * (s + 1)
    assert torch.equal(w, want_w)
    assert len(store.capture_seconds) == 1


def test_fork_plan_reads_a_cuda_state_as_a_step_generator_offset():
    """A CUDA generator's state (seed, then Philox offset, 8 bytes each) is
    recorded as (which step generator, offset); a seed of no step generator
    raises."""
    from ldm_tf2_tpu_torch.parallel import rng

    plan = rng.ForkPlan()
    plan.reset([5, 9])
    state = lambda seed, offset: torch.tensor(
        list(seed.to_bytes(8, "little") + offset.to_bytes(8, "little")), dtype=torch.uint8)
    assert plan.where(state(9, 12)) == (1, 12)
    assert plan.where(state(5, 0)) == (0, 0)
    with pytest.raises(RuntimeError, match="not one of its step generators"):
        plan.where(state(7, 4))


def test_a_new_key_captures_and_a_seen_key_replays():
    """A new batch shape, accumulation phase, remat policy or phase
    captures; a key already seen replays."""
    store = _store()
    program, state, _ = _ldm(dict(accum=2))
    StandIn.watched = program.written(state)
    step = tg.graphed_train_step(program, store)
    made = []
    for b in (2, 2, 2, 2, 4, 4, 2):  # micro, sync, micro, sync; b=4 micro, sync; b=2 micro
        state, _ = step(state, *_batch(b))
        made.append(len(store.capture_seconds))
    assert made == [1, 2, 2, 2, 3, 4, 4]
    other, state2, _ = _ldm(dict(remat="blocks"))
    StandIn.watched = other.written(state2)
    tg.graphed_train_step(other, store)(state2, *_batch())
    assert len(store.capture_seconds) == 5
    (step1, step2), ae_state, _ = _ae("kl")
    StandIn.watched = step1.written(ae_state)
    images = _batch()[0]
    for s in (step1, step1, step2, step2):
        ae_state, _ = tg.graphed_train_step(s, store)(ae_state, images)
    assert len(store.capture_seconds) == 7


def test_a_restored_checkpoint_drops_the_capture():
    """Replaced state tensors (a restored checkpoint's) drop the program's
    captures, and the next step, captured anew, equals the eager one."""
    runs = []
    for store in (None, _store()):
        program, state, (cond, unet, ae) = _ldm({})
        step = program
        if store is not None:
            StandIn.watched = program.written(state)
            step = tg.graphed_train_step(program, store)
        images, ids = _batch()
        for _ in range(2):
            state, _ = step(state, images, ids)
        saved = copy.deepcopy(tt.checkpoint_state(state, unet))
        state = tt.restore_state(saved, unet)
        StandIn.watched = program.written(state)
        if store is not None:
            assert len(store) == 1
        losses = []
        for _ in range(2):
            state, m = step(state, images, ids)
            losses.append(m["loss"])
        runs.append((losses, _snapshot(state, cond, unet, ae), store))
    (want_l, want, _), (got_l, got, store) = runs
    assert all(torch.equal(a, b) for a, b in zip(got_l, want_l))
    _assert_same(got, want)
    assert len(store.capture_seconds) == 2 and len(store) == 1


class _NoOp(StandIn):
    """A graph whose replays do nothing: what a replay changes is then only
    what the store itself does."""

    def replay(self):
        pass


def test_a_replay_bumps_versions_so_a_sampling_capture_drops():
    """After a graphed step's replay the tensors it wrote have moved on in
    version (the graph wrote them where autograd could not see), so a
    ``GraphedEps`` of the trained U-Net drops its capture."""
    program, state, (cond, unet, ae) = _ldm(dict(rate=0.0))
    StandIn.watched = []
    store = shared.GraphStore(runner=_NoOp)
    step = tg.graphed_train_step(program, store)
    images, ids = _batch()
    state, _ = step(state, images, ids)  # warm-up and capture
    sampling = _store()
    eps = graphs.graphed_eps_model(unet, sampling)
    x, t, c = torch.zeros(2, 8, 8, 4), torch.tensor([5.0, 9.0]), torch.zeros(2, 8, 32)
    eps(x, t, c)
    eps(x, t, c)
    assert len(sampling.capture_seconds) == 1
    before = [p._version for p in unet.parameters()]
    mu_before = [v._version for v in state.opt_state["mu"].values()]
    state, _ = step(state, images, ids)  # a replay: nothing runs, versions move
    assert all(p._version > v for p, v in zip(unet.parameters(), before))
    assert all(m._version > v for m, v in zip(state.opt_state["mu"].values(), mu_before))
    eps(x, t, c)
    assert len(sampling.capture_seconds) == 2


# ---------------------------------------------------------- launch counts --

DQ, DKV = "flash_bwd_dq_wgmma_kernel", "flash_bwd_dkv_wgmma_kernel"
BACKWARD = {
    "agree": ({"dq": (2, "wgmma"), "dkv": (2, "wgmma")}, {DQ: 2, DKV: 2}, True),
    "a dq node missing": ({"dq": (2, "wgmma"), "dkv": (2, "wgmma")}, {DQ: 1, DKV: 2}, False),
    "a path mismatch": ({"dq": (2, "wgmma"), "dkv": (2, "wgmma")},
                        {"flash_bwd_dq_mma_kernel": 2, DKV: 2}, False),
}


@pytest.mark.parametrize("case", list(BACKWARD))
def test_backward_kernels_are_counted_off_the_graph(case):
    """The flash backward's dq and dk/dv launches are read off a capture's
    kernel nodes by name, as the forward's are; a capture whose counters
    and nodes disagree raises."""
    ticks, nodes, agree = BACKWARD[case]
    fns = {"dq": fa.flash_backward_dq, "dkv": fa.flash_backward_dkv}
    host = {}
    for name, (n, path) in ticks.items():
        host[(fns[name], "launches")] = n
        host[(fns[name], "launches_by_path")] = {path: n}
    if not agree:
        with pytest.raises(RuntimeError, match="disagree with its graph"):
            shared.backed_rise(host, nodes)
        return
    assert shared.backed_rise(host, nodes) == host


@pytest.mark.parametrize("relayouts, allowed", [(2, True), (1, False)])
def test_relayouts_inside_a_train_capture(relayouts, allowed):
    """A train step's capture relays the weight of each wgmma conv launch
    (``relayout_inside``); a sampling capture relays none."""
    conv = fused_conv.gn_silu_conv3x3_fused
    host = {(conv, "launches"): 2, (conv, "launches_by_path"): {"wgmma": 2},
            (conv, "relayouts"): relayouts}
    nodes = {"conv_wgmma_kernel": 2, "gn_channel_stats_kernel": 2}  # a chain's two stages
    with pytest.raises(RuntimeError, match="do not back"):
        shared.backed_rise(host, nodes)
    if allowed:
        assert shared.backed_rise(host, nodes, relayouts=True) == host
    else:
        with pytest.raises(RuntimeError, match="do not back"):
            shared.backed_rise(host, nodes, relayouts=True)


def test_relayout_inside_skips_the_cache():
    w = torch.randn(8, 4, 3, 3)
    conv = fused_conv.gn_silu_conv3x3_fused
    start = conv.relayouts
    a = fused_conv.relaid_weight(w, torch.float32)
    assert fused_conv.relaid_weight(w, torch.float32) is a
    with fused_conv.relayout_inside():
        b = fused_conv.relaid_weight(w, torch.float32)
    assert b is not a and torch.equal(a, b)
    assert fused_conv.relaid_weight(w, torch.float32) is a
    assert conv.relayouts - start == 2


def test_no_graph_on_the_cpu_or_on_a_mesh(monkeypatch):
    program, _ = _toy()
    assert tg.train_step_for(program) is program
    assert "no CUDA graphs on the CPU" in tg.describe_steps("cpu")
    cuda_program, _ = _toy("cpu")
    cuda_program.device = torch.device("cuda")
    monkeypatch.setattr(shared, "distributed_world", lambda: 2)
    assert tg.train_step_for(cuda_program) is cuda_program
    assert "train steps run eagerly: a mesh of 2 ranks" in tg.describe_steps("cuda")
    monkeypatch.setattr(shared, "distributed_world", lambda: 1)
    assert isinstance(tg.train_step_for(cuda_program), tg.GraphedTrainStep)
    assert "train steps captured as CUDA graphs" in tg.describe_steps("cuda")


# ------------------------------------------------------------------- card --

def _card_ldm(remat, dtype=torch.bfloat16):
    """A tiny U-Net (head dim 40 and 80, level 0 at 1024 tokens) over float32
    masters computing in bf16, a KL autoencoder and text encoder, on the card."""
    from ldm_tf2_tpu_torch import factory

    kw = dict(model_channels=160, out_channels=4, num_blocks=1, channel_mult=(1, 2),
              num_heads=4, context_channels=64, dropout_rate=0.1)
    with torch.device("cuda"):
        unet = tm.UNet(**kw, dtype=dtype)
        cond = tm.TransformerModel(vocab_size=64, encoder_stack_size=1, hidden_size=64,
                                   num_heads=2, size_per_head=32, max_seq_len=8,
                                   filter_size=128, dtype=dtype)
        ae = tm.AutoencoderKL(channels=64, num_blocks=1, multipliers=(1, 2), dtype=dtype)
    unet = factory.randomize_(unet, seed=3).float().requires_grad_(True)
    cond = factory.randomize_(cond, seed=4).requires_grad_(False)
    ae = factory.randomize_(ae, seed=5).requires_grad_(False)
    opt = tt.make_optimizer(learning_rate=1e-4, clip_grad_norm=1.0)
    program = tt.make_ldm_train_step(
        unet, cond, ae, make_schedule(num_steps=100, num_ddim_steps=10), opt,
        condition_dropout_rate=0.3, null_token_ids=NULL_IDS, remat_unet=remat,
        ema_decay=0.99, seed=3)
    return program, tt.init_ldm_train_state(unet, cond, opt, ema_decay=0.99), (unet,)


def _card_compare(build, inputs, steps=3):
    """``steps`` eager steps and ``steps`` graphed ones (a real capture)
    from the same start, cuDNN deterministic: for each run its metrics,
    snapshot and the counters' rise; the graphed run's captures' kernel
    nodes by name, by key (read while its program lives: a program's
    captures are dropped with it)."""
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    store = shared.GraphStore()
    runs = []
    try:
        for graphed in (False, True):
            programs, state, models = build()
            if graphed:
                programs = [tg.graphed_train_step(p, store) for p in programs]
            metrics = []
            before = shared.counts()
            for s in range(steps):
                state, m = programs[min(s, len(programs) - 1)](state, *inputs)
                metrics.append({k: v.clone() for k, v in m.items()})
            torch.cuda.synchronize()
            runs.append((metrics, _snapshot(state, *models), shared.rise(before, shared.counts())))
        nodes = {k: {shared.kernel_base_name(n) for n in store.kernels(k)}
                 for k in store._entries}
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
        store.clear()
    return runs, nodes


def _switch(on: bool):
    from ldm_tf2_tpu_torch.ops import attention, group_norm

    group_norm.set_groupnorm_impl("pallas" if on else "auto")
    fused_conv.set_fused_conv_impl("pallas" if on else "auto")
    attention.set_packed_cross(on)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["default", "remat_full", "opt-in"])
def test_graphed_ldm_step_is_bit_equal_to_eager_on_card(route):
    """A tiny U-Net's step captured for real: three steps (the eager
    warm-up and capture, then replays) bit-equal to three eager steps, the
    counters' rise per replay equal to an eager step's, the flash forward
    and backward among the graph's kernel nodes, and under the opt-in
    switches the relayouts inside the capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(0)
    images = torch.tensor(rng.uniform(-1, 1, (2, 64, 64, 3)), dtype=torch.bfloat16,
                          device="cuda")
    ids = torch.tensor(rng.integers(4, 64, (2, 8)), device="cuda")

    def build():
        program, state, models = _card_ldm("full" if route == "remat_full" else False)
        return [program], state, models

    if route == "opt-in":
        _switch(True)
    try:
        (eager, got), nodes = _card_compare(build, (images, ids))
    finally:
        _switch(False)
    for a, b in zip(got[0], eager[0]):
        assert all(torch.equal(a[k], b[k]) for k in a)
    _assert_same(got[1], eager[1])
    moved = got[2]
    if route == "opt-in":  # the eager run's relayouts are once a weight and version
        conv = fused_conv.gn_silu_conv3x3_fused
        assert moved[(conv, "relayouts")] == moved[(conv, "launches_by_path")]["wgmma"] > 0
        moved, eager_moved = dict(moved), dict(eager[2])
        del moved[(conv, "relayouts")], eager_moved[(conv, "relayouts")]
        assert moved == eager_moved
    else:
        assert moved == eager[2]
    assert moved[(fa.flash_attention, "launches")] > 0
    (held,) = nodes.values()
    assert {"flash_fwd_wgmma_kernel", DQ, DKV} <= held, held
    if route == "opt-in":
        assert "conv_wgmma_kernel" in held


@pytest.mark.cuda
def test_graphed_ae_gan_step_is_bit_equal_to_eager_on_card():
    """A tiny VQ autoencoder's GAN step (attention at S = 256) captured for
    real: three steps bit-equal to eager, D's running statistics included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ldm_tf2_tpu_torch import factory

    images = torch.tensor(np.random.default_rng(1).uniform(-1, 1, (2, 32, 32, 3)),
                          dtype=torch.float32, device="cuda")

    def build():
        with torch.device("cuda"):
            ae = tm.AutoencoderVQ(channels=64, num_blocks=1, multipliers=(1, 2),
                                  attention_resolutions=(16,), vocab_size=64,
                                  resolution=32, dtype=torch.bfloat16)
            disc = tm.Discriminator(16, 2)
            lpips = tm.LPIPS()
        ae = factory.randomize_(ae, seed=6).float().requires_grad_(True)
        disc = factory.randomize_(disc, seed=7).requires_grad_(True)
        lpips = factory.randomize_(lpips, seed=8).requires_grad_(False)
        ae_opt, d_opt = tat.make_adam(1e-4), tat.make_adam(1e-4)
        _, step2 = tat.make_ae_train_steps(ae, disc, lpips, ae_opt, d_opt, seed=9)
        return [step2], tat.init_ae_train_state(ae, disc, ae_opt, d_opt), (ae, disc)

    (eager, got), nodes = _card_compare(build, (images,))
    for a, b in zip(got[0], eager[0]):
        assert all(torch.equal(a[k], b[k]) for k in a)
    _assert_same(got[1], eager[1])
    assert got[2] == eager[2], (got[2], eager[2])
    assert got[2][(fa.flash_attention, "launches")] > 0
    assert got[2][(fa.flash_backward_dq, "launches")] > 0
    assert len(nodes) == 1
