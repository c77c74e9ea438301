"""The plain reference computes what the port computes: at a small size on
the CPU, in float32, they agree to rounding. (Tests may import the port;
the reference itself does not.)"""

import numpy as np
import pytest
import torch
from spectrogramgenai_tpu_torch.diffusion import ddpm
from spectrogramgenai_tpu_torch.models.unet import ConditionalUNet
from spectrogramgenai_tpu_torch.models.vqvae import VQVAE

from portbench import harness, weights
from portbench.reference import compare, nets, sampler

CFG = dict(harness.load("configs", "ldm27"), width_mult=0.125, time_dim=32)


@pytest.fixture(scope="module")
def unet():
    P = weights.make(nets.unet_leaves(CFG), 5, "unet", "cpu")
    m = ConditionalUNet(c_in=4, c_out=4, time_dim=32, num_classes=27, width_mult=0.125)
    m.load_state_dict(P)
    return P, m


def test_unet_forward(unet):
    P, m = unet
    x, t = torch.randn(3, 16, 16, 4), torch.tensor([5.0, 500.0, 999.0])
    y, mask = torch.tensor([0, 5, 26]), torch.tensor([1.0, 0.0, 1.0])
    with torch.no_grad():
        want = m(x, t, y, mask)
    assert torch.allclose(nets.unet(P, CFG, x, t, y, mask), want, rtol=1e-4, atol=1e-4)


def test_solver_nodes():
    assert np.array_equal(sampler.dpmpp_nodes(CFG, 20), ddpm.dpmpp_timesteps(ddpm.linear_schedule(), 20))


def test_chain_and_decode(unet):
    P, m = unet
    x_T, labels = torch.randn(2, 16, 16, 4, generator=torch.Generator().manual_seed(1)), torch.tensor([3, 4])
    with torch.no_grad():
        want = ddpm.dpmpp_sample(m, ddpm.linear_schedule(), labels, (16, 16, 4), num_steps=6, cfg_scale=3.0, x_T=x_T)
    got = sampler.dpmpp_chain(P, CFG, x_T, labels, 6)
    assert compare.latent_gap(got, want) < 1e-5
    V = weights.make(nets.vqvae_leaves(16, 4, 512, code_range=1.0), 2, "vq", "cpu")
    vq = VQVAE(hidden_dim=16)
    vq.load_state_dict(V)
    with torch.no_grad():
        img = ddpm.to_uint8(vq.decode_quantized(want.clamp(-1, 1)))
    ref = sampler.decode_uint8(V, want)
    assert torch.equal(img, ref) and ref.float().std() > 10  # the decode follows the latents


def test_png_reader():
    from spectrogramgenai_tpu_torch.audio.export import generated_png_bytes

    img = np.random.default_rng(0).integers(0, 256, (2, 24, 20, 1), dtype=np.uint8)
    rgb = compare.png_rgb(generated_png_bytes(img)[1])
    assert np.array_equal(rgb, compare.VIRIDIS[img[1, ..., 0]])


def test_rounding():
    x = torch.randn(1000) * 3
    assert torch.equal(nets.rounded(x, "fp32"), x)
    e8 = (nets.rounded(x, "fp8") - x).abs() / x.abs()
    assert 0.005 < e8.median() < 0.05 and (e8[x.abs() > x.abs().max() / 64] <= 2.0 ** -4).all()
