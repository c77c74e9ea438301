"""The operation and byte counts behind mfu.* and *_roofline.* against hand
counts and against PyTorch's own counter at a small shape."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import weights
from portbench.flops import attention, unet, vqvae
from portbench.reference import nets

CFG = dict(time_dim=32, latent_dim=4, num_classes=27, width_mult=0.125, latent=True)


def test_attention_by_hand():
    # one head of 128 tokens of width 16: QKᵀ and PV are 2·128·128·16 each
    assert attention.fwd(1, 1, 128, 16) == (4 * 128 * 128 * 16, 2 * 4 * 128 * 16)
    flops, nbytes = attention.bwd(2, 4, 256, 32)
    assert flops == 2.5 * attention.fwd(2, 4, 256, 32)[0]
    assert nbytes == 8 * 256 * (2 * 7 * 32 + 4 + 4 * 32)
    peaks = {"bf16_flops_per_s": 1e12, "hbm_bytes_per_s": 1e9}
    assert attention.least_seconds(1e12, 1e6, peaks) == 1.0 and attention.least_seconds(1.0, 2e9, peaks) == 2.0


def test_unet_matches_the_counter_plus_the_upsample():
    size = 16
    P = weights.make(nets.unet_leaves(CFG), 1, "unet", "cpu")
    with FlopCounterMode(display=False) as fc:
        nets.unet(P, CFG, torch.randn(1, size, size, 4), torch.tensor([3.0]), torch.tensor([1]), torch.tensor([1.0]))
    w = nets.unet_widths(CFG)
    # the port upsamples by two matrix products a stage, which F.interpolate does not count
    # (rows: (2h × h) by (h × h) per channel; columns: (2h × h) by (h × 2h) per channel)
    ups = sum(2 * (2 * h) * h * ch * h + 2 * (2 * h) * h * ch * (2 * h)
              for h, ch in ((size // 8, w[256]), (size // 4, w[128]), (size // 2, w[64])))
    assert unet.forward(CFG, size) == pytest.approx(fc.get_total_flops() + ups, rel=1e-12)


def test_vqvae_matches_the_counter():
    P = weights.make(nets.vqvae_leaves(16, 4, 32), 1, "vq", "cpu")
    x = torch.randn(1, 32, 32, 1)
    with FlopCounterMode(display=False) as fc:
        z = nets.vq_encode(P, x)
    assert vqvae.encode(16, 4, 32) == fc.get_total_flops()
    with FlopCounterMode(display=False) as fc:
        nets.vq_decode(P, z)
    assert vqvae.decode(16, 4, 32) == fc.get_total_flops()
    assert vqvae.quantise(4, 512, 256) == 2 * 512 * 4 * 64 * 64
