"""The samplers' per-step update in bf16, bit for bit against the JAX package.

The JAX loops cast each table entry to x's dtype and round every product,
sum and square root of the coefficients to it (``take(...).astype(xt.dtype)``
in ``ldm_tf2_tpu/diffusion/sampler.py``'s ``ddim_update`` and
``ddpm_step``, the ``.astype(xt.dtype)`` coefficients of
``solvers.py``); the port's ``ddim_coefficients``, ``ddpm_table`` and
``in_dtype`` do the same.  Each case hands both sides the same bf16 xt,
eps and noise (the JAX step's own draw, ``jax.random.normal`` in bf16) at
the north star's ``make_schedule(1000, 50)``, and asserts equal bits: one
DDIM update at eta 0 per index (in float32 too), one DDPM step per timestep (t = 0
included, where the std is 0), a 20-step DDPM loop with JAX's key splits
replayed, PLMS and DPM-Solver++(2M) over two and three steps (a step of
each order they reach), and the rows of ``ddpm_device_tables`` that a
graphed DDPM run reads.  The one allowed difference: bf16 DDIM at eta > 0
where acp_prev rounds near 1.0, where JAX's ``sqrt(1 - acp_prev - sigma^2)`` is NaN and the
port's is 0 (indices 0 and 1 of the north star's 50).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm_tf2_tpu.diffusion import make_schedule as jax_make_schedule
from ldm_tf2_tpu.diffusion import sampler as jsampler
from ldm_tf2_tpu.diffusion import solvers as jsolvers
from ldm_tf2_tpu_torch.diffusion import sampler as tsampler
from ldm_tf2_tpu_torch.diffusion import solvers as tsolvers
from ldm_tf2_tpu_torch.diffusion.schedule import make_schedule

NORTH_STAR = dict(num_steps=1000, beta_start=0.00085, beta_end=0.012, num_ddim_steps=50)
SHAPE = (2, 8, 8, 4)


def _bf16(a):
    return jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)


def _t(a):
    """A JAX array as a torch tensor of its dtype (bf16 through float32)."""
    a = jnp.asarray(a)
    out = torch.from_numpy(np.array(a.astype(jnp.float32)))
    return out.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else out


def _equal(got, want):
    want = _t(want)
    assert got.dtype == want.dtype
    assert torch.equal(got, want), float((got.float() - want.float()).abs().max())


@pytest.fixture(scope="module")
def draws():
    rng = np.random.default_rng(21)
    return tuple(_bf16(rng.standard_normal(s)) for s in (SHAPE, SHAPE, SHAPE,
                                                          (4,) + SHAPE[1:]))


@pytest.fixture(scope="module")
def schedules():
    return jax_make_schedule(**NORTH_STAR), make_schedule(**NORTH_STAR)


@pytest.mark.parametrize("index", [49, 30, 10, 1, 0])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ddim_update_eta0_is_jax_bit_for_bit(schedules, draws, index, dtype):
    """bf16, and float32 too (whose arithmetic the port always kept)."""
    jschedule, schedule = schedules
    xt, eps, noise, _ = (a.astype(dtype) for a in draws)
    want, want_x0 = jsampler.ddim_update(jschedule, xt, eps, index, None, noise=noise)
    got, got_x0 = tsampler.ddim_update(schedule, _t(xt), _t(eps), index, noise=_t(noise))
    _equal(got, want)
    _equal(got_x0, want_x0)


@pytest.mark.parametrize("t", [999, 700, 300, 50, 1, 0])
def test_ddpm_step_is_jax_bit_for_bit(schedules, draws, t):
    jschedule, schedule = schedules
    xt, _, _, eps2 = draws
    key = jax.random.PRNGKey(t)
    want, want_x0 = jsampler.ddpm_step(lambda x, tt, c: eps2, jschedule, xt, None,
                                       jnp.int32(t), key, 1.0)
    noise = jax.random.normal(key, SHAPE, jnp.bfloat16)  # the JAX step's own draw
    got, got_x0 = tsampler.ddpm_step(lambda x, tt, c: _t(eps2), schedule, _t(xt), None, t,
                                     noise=_t(noise))
    _equal(got, want)
    _equal(got_x0, want_x0)


def test_ddim_eta1_is_finite_where_jax_is_nan(draws):
    """bf16 at eta 1: acp_prev at indices 0 and 1 rounds so that JAX's
    ``1 - acp_prev - sigma^2`` is below 0 and its sqrt NaN; the port clamps
    the radicand at 0 there (float32 stays positive) and is bit-equal to JAX
    at every other index."""
    kw = dict(NORTH_STAR, eta=1.0)
    jschedule, schedule = jax_make_schedule(**kw), make_schedule(**kw)
    xt, eps, noise, _ = draws
    nan = []
    for index in range(50):
        want, _ = jsampler.ddim_update(jschedule, xt, eps, index, None, noise=noise)
        got, _ = tsampler.ddim_update(schedule, _t(xt), _t(eps), index, noise=_t(noise))
        assert torch.isfinite(got).all()
        if bool(jnp.isnan(want).all()):
            nan.append(index)
            assert tsampler.ddim_coefficients(schedule, index, torch.bfloat16)[3] == 0.0
            assert tsampler.ddim_coefficients(schedule, index, torch.float32)[3] > 0.0
        else:
            _equal(got, want)
    assert nan == [0, 1]


def _eps_models():
    """A one-layer bf16 stand-in for the U-Net on both sides."""
    w = _bf16(np.random.default_rng(23).standard_normal((4, 4)) * 0.5)
    tw = _t(w)

    def jeps(x, t, c):
        return jnp.tanh(x @ w + (t / 1000.0).astype(x.dtype)[:, None, None, None])

    def teps(x, t, c):
        return torch.tanh(x @ tw + (t / 1000.0).to(x.dtype)[:, None, None, None])

    return jeps, teps


def test_ddpm_loop_with_replayed_keys_is_jax_bit_for_bit():
    """20 bf16 steps of ``ddpm_sample_loop`` (jitted, a ``lax.scan``) with its
    key splits replayed into the port's ``init_noise`` and ``step_noises``."""
    kw = dict(num_steps=20, beta_start=0.00085, beta_end=0.012, num_ddim_steps=4)
    jschedule, schedule = jax_make_schedule(**kw), make_schedule(**kw)
    jeps, teps = _eps_models()
    context = _bf16(np.random.default_rng(25).standard_normal((4, 5, 8)))
    key = jax.random.PRNGKey(3)
    want = jax.jit(lambda c: jsampler.ddpm_sample_loop(jeps, jschedule, c, SHAPE, key,
                                                       5.0))(context)
    key, init_key = jax.random.split(key)
    init = jax.random.normal(init_key, SHAPE, jnp.bfloat16)
    noises = []
    for _ in range(20):
        key, step_key = jax.random.split(key)
        noises.append(_t(jax.random.normal(step_key, SHAPE, jnp.bfloat16)))
    got = tsampler.ddpm_sample_loop(teps, schedule, _t(context), SHAPE, guidance_scale=5.0,
                                    init_noise=_t(init), step_noises=torch.stack(noises))
    _equal(got, want)
    assert float((got.float() - _t(init).float()).abs().max()) > 0.1


@pytest.mark.parametrize("steps", [2, 3])
@pytest.mark.parametrize("spacing", ["uniform", "karras"])
@pytest.mark.parametrize("loop", ["plms_sample_loop", "dpm_solver_pp_2m_sample_loop"])
def test_multistep_solvers_are_jax_bit_for_bit(draws, loop, spacing, steps):
    kw = dict(num_steps=50, beta_start=0.00085, beta_end=0.012, num_ddim_steps=steps,
              timestep_spacing=spacing)
    jschedule, schedule = jax_make_schedule(**kw), make_schedule(**kw)
    jeps, teps = _eps_models()
    context = _bf16(np.random.default_rng(27).standard_normal((4, 5, 8)))
    xt = draws[0]
    want = jax.jit(lambda c, x: getattr(jsolvers, loop)(
        jeps, jschedule, c, SHAPE, jax.random.PRNGKey(0), 5.0, init_noise=x))(context, xt)
    got = getattr(tsolvers, loop)(teps, schedule, _t(context), SHAPE, guidance_scale=5.0,
                                  init_noise=_t(xt))
    _equal(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_device_tables_hold_ddpm_steps_coefficients(schedules, dtype):
    """Row n of ``ddpm_device_tables`` is ``ddpm_table``'s timestep T - 1 - n,
    exactly, in x's dtype, and its U-Net timestep; the std is 0 at t = 0
    only."""
    _, schedule = schedules
    table, timesteps = tsampler.ddpm_device_tables(schedule, dtype, "cpu")
    rows = tsampler.ddpm_table(schedule, dtype)
    assert table.dtype == dtype and timesteps.dtype == torch.float32
    assert table.shape == (1000, 5) and timesteps.shape == (1000,)
    for n in (0, 1, 500, 998, 999):
        t = 999 - n
        assert float(timesteps[n]) == t
        assert [float(v) for v in table[n]] == [float(v) for v in rows[t]]
    assert (rows[1:, 4] > 0).all() and rows[0, 4] == 0.0
