"""Port samplers against the JAX samplers, from the same starting noise.

JAX's and torch's random streams differ, so each test draws x_T (and, for
the ancestral chain, every step's noise) the way the JAX sampler does and
injects it into the port.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spectrogramgenai_tpu.diffusion import ddpm as jd  # noqa: E402
from spectrogramgenai_tpu.models.unet import ConditionalUNet as JaxUNet  # noqa: E402
from spectrogramgenai_tpu_torch.bridge import state_dict_from_flax  # noqa: E402
from spectrogramgenai_tpu_torch.diffusion import ddpm as td  # noqa: E402
from spectrogramgenai_tpu_torch.models.unet import ConditionalUNet  # noqa: E402
from torch_port_helpers import random_flax_variables  # noqa: E402

SHAPE = (8, 8, 4)
LABELS = np.array([0, 2, 1], np.int32)


def _jax_eps(params, x, t, y, mask):
    """A smooth analytic ε-model, written once per framework."""
    col = (slice(None), None, None, None)
    return 0.5 * x * (t / 1000.0)[col] + 0.05 * (y.astype(jnp.float32) + 1.0)[col] * mask[col]


def _torch_eps(x, t, y, mask):
    col = (slice(None), None, None, None)
    return 0.5 * x * (t / 1000.0)[col] + 0.05 * (y.float() + 1.0)[col] * mask[col]


def _x_T(key, n, shape):
    # the first draw of every JAX sampler: jax.random.normal(key, (n, *shape))
    return torch.from_numpy(np.array(jax.random.normal(key, (n, *shape), jnp.float32)))


@pytest.mark.parametrize("noise_steps", [50, 1000])
def test_schedule_constants_exact(noise_steps):
    js, ts = jd.linear_schedule(noise_steps), td.linear_schedule(noise_steps)
    for name in ("beta", "alpha", "alpha_hat"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name))


@pytest.mark.parametrize("num_steps", [5, 14, 15, 20, 50])
def test_dpmpp_timesteps_and_coefficients_exact(num_steps):
    js, ts = jd.linear_schedule(), td.linear_schedule()
    np.testing.assert_array_equal(td.dpmpp_timesteps(ts, num_steps), jd.dpmpp_timesteps(js, num_steps))
    want = jd.dpmpp_coefficients(js, num_steps)
    got = td.dpmpp_coefficients(ts, num_steps)
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == np.float32
        np.testing.assert_array_equal(got[name], np.asarray(want[name]))


def test_dpmpp_rejects_too_many_steps():
    with pytest.raises(ValueError, match="too large"):
        td.dpmpp_timesteps(td.linear_schedule(10), 10)


@pytest.mark.parametrize("sampler, kw", [("dpmpp", dict(num_steps=20)), ("ddim", dict(num_steps=10)),
                                         ("dpmpp_nocfg", dict(num_steps=8, cfg_scale=0.0))])
def test_deterministic_samplers_analytic_model(sampler, kw):
    key = jax.random.PRNGKey(3)
    labels = jnp.asarray(LABELS)
    fn = {"dpmpp": "dpmpp_sample", "ddim": "ddim_sample", "dpmpp_nocfg": "dpmpp_sample"}[sampler]
    want = np.asarray(getattr(jd, fn)(_jax_eps, None, jd.linear_schedule(), key, labels, SHAPE, **kw))
    got = getattr(td, fn)(_torch_eps, td.linear_schedule(), torch.from_numpy(LABELS).long(), SHAPE,
                          x_T=_x_T(key, len(LABELS), SHAPE), **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)  # f32, different op order


def test_ddpm_sample_with_jax_noise_sequence():
    noise_steps, key = 50, jax.random.PRNGKey(5)
    n = len(LABELS)
    want = np.asarray(jd.ddpm_sample(_jax_eps, None, jd.linear_schedule(noise_steps), key,
                                     jnp.asarray(LABELS), SHAPE))
    # rebuild the chain's noise: the carry key splits once per step into
    # (next carry, step noise key); ddpm_sample's step draws with the latter
    k, noise = key, []
    for _ in range(noise_steps - 1):
        k, k_noise = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(k_noise, (n, *SHAPE))))
    got = td.ddpm_sample(_torch_eps, td.linear_schedule(noise_steps), torch.from_numpy(LABELS).long(),
                         SHAPE, x_T=_x_T(key, n, SHAPE), noise=torch.from_numpy(np.stack(noise)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_ddpm_sample_rejects_misshapen_noise():
    with pytest.raises(ValueError, match="noise has shape"):
        td.ddpm_sample(_torch_eps, td.linear_schedule(8), torch.zeros(2, dtype=torch.long), SHAPE,
                       x_T=torch.zeros(2, *SHAPE), noise=torch.zeros(3, 2, *SHAPE))


@pytest.fixture(scope="module")
def tiny_unets():
    kw = dict(c_in=4, c_out=4, num_classes=3, width_mult=0.125, remove_deep_conv=True)
    jm = JaxUNet(**kw)
    variables = random_flax_variables(jm, jnp.zeros((1, *SHAPE)), jnp.zeros((1,)),
                                      jnp.zeros((1,), jnp.int32), jnp.ones((1,)), seed=4)
    tm = ConditionalUNet(**kw)
    tm.load_state_dict(state_dict_from_flax(tm, variables))
    return jm, variables["params"], tm.eval()


@pytest.mark.parametrize("sampler, num_steps", [("dpmpp_sample", 5), ("ddim_sample", 4)])
def test_samplers_bridged_unet(tiny_unets, sampler, num_steps):
    jm, params, tm = tiny_unets
    key = jax.random.PRNGKey(7)
    # a 50-step schedule ends at ᾱ ≈ 0.6: with random weights the samples stay
    # O(1), where a 1000-step one scales them by 1/√ᾱ_T ≈ 160 and f32
    # rounding alone exceeds 1e-4
    schedule = jd.linear_schedule(50)

    def apply(p, x, t, y, mask):
        return jm.apply({"params": p}, x, t, y, mask)

    run = jax.jit(lambda p, k, y: getattr(jd, sampler)(apply, p, schedule, k, y, SHAPE,
                                                       num_steps=num_steps))
    want = np.asarray(run(params, key, jnp.asarray(LABELS)))
    got = getattr(td, sampler)(tm, td.linear_schedule(50), torch.from_numpy(LABELS).long(), SHAPE,
                               num_steps=num_steps, x_T=_x_T(key, len(LABELS), SHAPE))
    assert np.isfinite(want).all() and np.abs(want).max() < 50
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_seeded_generator_reproduces_x_T():
    g = torch.Generator().manual_seed(0)
    a = td.ddim_sample(_torch_eps, td.linear_schedule(), torch.zeros(2, dtype=torch.long), SHAPE,
                       num_steps=3, generator=g)
    b = td.ddim_sample(_torch_eps, td.linear_schedule(), torch.zeros(2, dtype=torch.long), SHAPE,
                       num_steps=3, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(a, b, rtol=0, atol=0)  # seeded generator → reproducible


def test_to_uint8_matches_jax():
    x = np.linspace(-1.5, 1.5, 1001, dtype=np.float32)
    np.testing.assert_array_equal(td.to_uint8(torch.from_numpy(x)).numpy(),
                                  np.asarray(jd.to_uint8(jnp.asarray(x))))
