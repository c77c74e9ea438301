"""The port's CUDA attention kernel against its plain version, on the card.

The kernel has no CPU mode, so every test here is marked ``gpu`` and skips
without a CUDA device. On a machine with an NVIDIA Hopper card and nvcc:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q
"""

import math

import pytest

torch = pytest.importorskip("torch")

from spectrogramgenai_tpu_torch.models.unet import ConditionalUNet  # noqa: E402
from spectrogramgenai_tpu_torch.ops.attention import (  # noqa: E402
    attention_reference,
    fused_attention,
)

pytestmark = pytest.mark.gpu


@pytest.fixture()
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the attention kernel has no CPU mode")
    # full-f32 references: cuDNN convolutions default to TF32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _qkv(gen, shape, dtype=torch.float32):
    return [torch.randn(shape, device="cuda", generator=gen).to(dtype) for _ in range(3)]


def _exact(q, k, v):
    q, k, v = q.double(), k.double(), v.double()
    return torch.softmax(q @ k.mT / math.sqrt(q.shape[-1]), dim=-1) @ v


@pytest.mark.parametrize("shape", [(4, 4, 1024, 32), (4, 4, 1024, 16), (1, 4, 4096, 16),
                                   (2, 2, 256, 2), (2, 2, 256, 4), (2, 2, 128, 8), (2, 2, 384, 64)])
@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
def test_kernel_matches_plain_version(gen, shape, dtype, tol):
    q, k, v = _qkv(gen, shape, dtype)
    before = fused_attention.launches
    out = fused_attention(q, k, v)
    torch.cuda.synchronize()
    assert fused_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    # the plain version on the f32 upcast of the same inputs: f32 sums in
    # another order (1e-4), or the bf16 rounding of the O(1) output (1e-2)
    want = attention_reference(q.float(), k.float(), v.float())
    assert (out.float() - want).abs().max().item() <= tol


def test_large_logits_stay_finite_and_exact(gen):
    # |logit| in the hundreds: f32 rounding of the logits alone is ~1e-4
    q, k, v = _qkv(gen, (1, 4, 1024, 16))
    q = q * 100.0
    out = fused_attention(q, k, v)
    assert torch.isfinite(out).all()
    assert (out.double() - _exact(q, k, v)).abs().max().item() <= 1e-3


def test_underflow_rows_are_uniform(gen):
    # every logit −400: exp underflows unless the row max is subtracted
    n, d = 256, 16
    q = torch.full((1, 1, n, d), 100.0, device="cuda")
    k = torch.full((1, 1, n, d), -100.0, device="cuda")
    v = torch.randn((1, 1, n, d), device="cuda", generator=gen)
    out = fused_attention(q, k, v)
    torch.testing.assert_close(out, v.mean(dim=2, keepdim=True).expand_as(v), rtol=0, atol=1e-5)


def test_nan_input_gives_nan(gen):
    q, k, v = _qkv(gen, (1, 1, 128, 16))
    k[0, 0, 5, 3] = float("nan")
    assert torch.isnan(fused_attention(q, k, v)).all()


def test_wrapper_rejects_mixed_devices(gen):
    q, k, v = _qkv(gen, (1, 1, 128, 16))
    with pytest.raises(ValueError, match="one device"):
        fused_attention(q, k.cpu(), v)


def test_unet_kernel_route_matches_plain_route(gen):
    # 64×64 latent at width 0.25: sa_0 and sa_4 see 1024 tokens (d 8 and 4),
    # sa_5 sees 4096 (d 4), so three sites take the kernel
    kw = dict(c_in=4, c_out=4, num_classes=3, width_mult=0.25)
    plain = ConditionalUNet(**kw).reset_parameters(torch.Generator().manual_seed(0)).cuda().eval()
    fused = ConditionalUNet(**kw, fused_attention=True).cuda().eval()
    fused.load_state_dict(plain.state_dict())
    x = torch.randn(2, 64, 64, 4, device="cuda", generator=gen)
    t = torch.tensor([10.0, 900.0], device="cuda")
    y = torch.tensor([2, 0], device="cuda")
    mask = torch.tensor([1.0, 0.0], device="cuda")
    before = fused_attention.launches
    with torch.inference_mode():
        got, want = fused(x, t, y, mask), plain(x, t, y, mask)
    assert fused_attention.launches == before + 3
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-4  # f32, TF32 off
