"""Port models against the flax modules, weights shared through bridge.py.

All in float32 on the CPU, at a small size (width_mult 0.125, a 32×32
latent so that sa_5 sees 1024 tokens and takes the fused route).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import spectrogramgenai_tpu.ops.attention as jax_attn  # noqa: E402
from spectrogramgenai_tpu.models import layers as jl  # noqa: E402
from spectrogramgenai_tpu.models.unet import ConditionalUNet as JaxUNet  # noqa: E402
from spectrogramgenai_tpu.models.vqvae import VQVAE as JaxVQVAE  # noqa: E402
from spectrogramgenai_tpu_torch.bridge import state_dict_from_flax  # noqa: E402
from spectrogramgenai_tpu_torch.models import layers as tl  # noqa: E402
from spectrogramgenai_tpu_torch.models.unet import ConditionalUNet  # noqa: E402
from spectrogramgenai_tpu_torch.models.vqvae import VQVAE  # noqa: E402
from torch_port_helpers import random_flax_variables  # noqa: E402

UNET_KW = dict(c_in=4, c_out=4, num_classes=3, width_mult=0.125)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _interpret_kernel(monkeypatch):
    # the JAX SA block imports fused_attention at call time; on the CPU the
    # Pallas kernel runs in interpret mode (as tests/test_attention.py does)
    monkeypatch.setattr(jax_attn, "fused_attention",
                        functools.partial(jax_attn.fused_attention, interpret=True))


def test_sinusoidal_time_embedding():
    t = np.array([0.0, 1.0, 17.0, 500.0, 999.0], np.float32)
    want = np.asarray(jl.sinusoidal_time_embedding(jnp.asarray(t), 256))
    got = tl.sinusoidal_time_embedding(torch.from_numpy(t), 256).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)  # sin/cos of angles up to 999 rad in f32


def test_upsample_bilinear_align_corners():
    x = np.random.default_rng(0).standard_normal((2, 7, 9, 3)).astype(np.float32)
    want = np.asarray(jl.upsample_bilinear_align_corners(jnp.asarray(x), 2))
    got = _nhwc(tl.upsample_bilinear_align_corners(_nchw(x), 2))
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("residual", [False, True])
def test_double_conv(residual):
    x = np.random.default_rng(1).standard_normal((2, 16, 16, 8)).astype(np.float32)
    jm = jl.DoubleConv(8, residual=residual)
    variables = random_flax_variables(jm, jnp.asarray(x))
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    tm = tl.DoubleConv(8, 8, residual=residual)
    tm.load_state_dict(state_dict_from_flax(tm, variables))
    np.testing.assert_allclose(_nhwc(tm(_nchw(x))), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("side, fused", [(16, False), (32, False), (32, True)])
def test_spatial_self_attention(side, fused, monkeypatch):
    # side 32 → 1024 tokens: the fused route on both sides when fused=True
    x = np.random.default_rng(2).standard_normal((2, side, side, 64)).astype(np.float32)
    variables = random_flax_variables(jl.SpatialSelfAttention(channels=64), jnp.asarray(x))
    _interpret_kernel(monkeypatch)
    want = np.asarray(jl.SpatialSelfAttention(channels=64, fused=fused).apply(variables, jnp.asarray(x)))
    tm = tl.SpatialSelfAttention(64, fused=fused)
    tm.load_state_dict(state_dict_from_flax(tm, variables))
    with torch.no_grad():
        got = _nhwc(tm(_nchw(x)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=5e-5)


@pytest.fixture(scope="module")
def unet_variables():
    return random_flax_variables(JaxUNet(**UNET_KW), jnp.zeros((1, 32, 32, 4)), jnp.zeros((1,)),
                                 jnp.zeros((1,), jnp.int32), jnp.ones((1,)))


@pytest.mark.parametrize("fused", [False, True])
def test_conditional_unet(unet_variables, fused, monkeypatch):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 32, 32, 4)).astype(np.float32)
    t = np.array([1.0, 10.0, 500.0, 999.0], np.float32)
    y = np.array([0, 2, 1, 2])
    mask = np.array([1.0, 0.0, 1.0, 0.0], np.float32)  # cond and uncond rows in one batch
    _interpret_kernel(monkeypatch)
    jm = JaxUNet(**UNET_KW, fused_attention=fused)
    want = np.asarray(jax.jit(jm.apply)(unet_variables, jnp.asarray(x), jnp.asarray(t),
                                        jnp.asarray(y), jnp.asarray(mask)))
    tm = ConditionalUNet(**UNET_KW, fused_attention=fused)
    tm.load_state_dict(state_dict_from_flax(tm, unet_variables))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y),
                 torch.from_numpy(mask)).numpy()
    assert got.shape == (4, 32, 32, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_unet_remove_deep_conv_and_unconditional_default():
    jm = JaxUNet(**UNET_KW, remove_deep_conv=True)
    x = np.random.default_rng(4).standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.array([3.0, 700.0], np.float32)
    variables = random_flax_variables(jm, jnp.asarray(x), jnp.asarray(t), seed=1)
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x), jnp.asarray(t)))  # y=None: label 0, mask 0
    tm = ConditionalUNet(**UNET_KW, remove_deep_conv=True)
    tm.load_state_dict(state_dict_from_flax(tm, variables))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def vq_pair():
    jm = JaxVQVAE(hidden_dim=16, n_embeddings=16)
    variables = random_flax_variables(jm, jnp.zeros((1, 32, 32, 1)), seed=1)
    tm = VQVAE(hidden_dim=16, n_embeddings=16)
    tm.load_state_dict(state_dict_from_flax(tm, variables))
    return jm, variables, tm


def test_vqvae_encode(vq_pair):
    jm, variables, tm = vq_pair
    img = np.random.default_rng(5).uniform(-1, 1, (2, 32, 32, 1)).astype(np.float32)
    want = np.asarray(jm.apply(variables, jnp.asarray(img), method=JaxVQVAE.encode))
    with torch.no_grad():
        got = tm.encode(torch.from_numpy(img)).numpy()
    assert got.shape == (2, 8, 8, 4)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_vqvae_decode_quantized(vq_pair):
    jm, variables, tm = vq_pair
    # latents spread over the codebook's range, so several codes are picked
    z = np.random.default_rng(6).uniform(-0.08, 0.08, (2, 8, 8, 4)).astype(np.float32)
    want = np.asarray(jm.apply(variables, jnp.asarray(z), method=JaxVQVAE.decode_quantized))
    want_idx = np.asarray(jm.apply(variables, jnp.asarray(z), method=lambda m, z: m.codebook.encode(z)[1]))
    with torch.no_grad():
        got = tm.decode_quantized(torch.from_numpy(z)).numpy()
        _, got_idx = tm.codebook.encode(torch.from_numpy(z))
    assert len(np.unique(want_idx)) > 1
    np.testing.assert_array_equal(got_idx.numpy(), want_idx)
    assert got.shape == (2, 32, 32, 1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_conv_transpose_needs_the_spatial_flip(vq_pair):
    # guards the bridge rule: without the flip the decoder does not match flax
    jm, variables, tm = vq_pair
    sd = state_dict_from_flax(tm, variables)
    for key in ("decoder.ConvTranspose_0.weight", "decoder.ConvTranspose_1.weight"):
        sd[key] = sd[key].flip(2, 3)
    wrong = VQVAE(hidden_dim=16, n_embeddings=16)
    wrong.load_state_dict(sd)
    z = np.random.default_rng(6).uniform(-0.08, 0.08, (2, 8, 8, 4)).astype(np.float32)
    want = np.asarray(jm.apply(variables, jnp.asarray(z), method=JaxVQVAE.decode_quantized))
    with torch.no_grad():
        got = wrong.decode_quantized(torch.from_numpy(z)).numpy()
    assert np.abs(got - want).max() > 1e-3


def test_bridge_rejects_a_foreign_tree(unet_variables):
    tm = ConditionalUNet(**{**UNET_KW, "width_mult": 0.25})
    with pytest.raises((KeyError, ValueError)):
        state_dict_from_flax(tm, unet_variables)
