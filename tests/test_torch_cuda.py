"""The port's CUDA kernels (attention forward and backward, mel power) against their plain versions, on the card;
the float32 trainers' steps and the GAN, denoiser and evaluator forwards, card against CPU.

The kernels have no CPU mode, so every test here is marked ``gpu`` and skips
without a CUDA device. On a machine with an NVIDIA Hopper card and nvcc:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from spectrogramgenai_tpu_torch.audio.spectrogram import (  # noqa: E402
    SpectrogramConfig,
    reference_logmel_np,
)
from spectrogramgenai_tpu_torch.models.unet import ConditionalUNet  # noqa: E402
from spectrogramgenai_tpu_torch.ops.attention import (  # noqa: E402
    attention_bwd_reference,
    attention_reference,
    fused_attention,
    fused_attention_bwd,
    fused_attention_residuals,
    tensor_core_route,
)
from spectrogramgenai_tpu_torch.ops.mel_kernel import (  # noqa: E402
    fused_logmel,
    fused_mel_power,
    mel_power_reference,
    rung_name,
)
from torch_mel_helpers import MEL_TOL, RUNG_BOUNDS, mel_rel_err, mma_tile_frames, stress_audio  # noqa: E402

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
    before = (fused_attention.launches, fused_attention.mma_launches)
    out = fused_attention(q, k, v)
    torch.cuda.synchronize()
    # bf16 at d ≥ 16 on the tensor cores, the rest on the scalar kernel
    mma = int(dtype == torch.bfloat16 and shape[-1] >= 16)
    assert (fused_attention.launches, fused_attention.mma_launches) == (before[0] + 1, before[1] + mma)
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


def test_attention_op_on_the_card_and_in_an_exported_unet(gen):
    # K1's forward as the operator spectrogramgenai_tpu_torch::attention_fwd: on bf16
    # inputs it launches the tensor-core kernel, as fused_attention does, and an
    # exported UNet keeps it at its three fused sites and launches it when it runs
    import io

    q, k, v = _qkv(gen, (2, 4, 1024, 32), torch.bfloat16)
    launches, mma = fused_attention.launches, fused_attention.mma_launches
    with torch.inference_mode():
        got = torch.ops.spectrogramgenai_tpu_torch.attention_fwd(q, k, v)
        want = fused_attention(q, k, v)
    assert (fused_attention.launches, fused_attention.mma_launches) == (launches + 2, mma + 2)
    assert torch.equal(got, want)
    assert (got.float() - attention_reference(q, k, v).float()).abs().max().item() <= 1e-2

    kw = dict(c_in=4, c_out=4, num_classes=3, width_mult=0.25)
    fused = ConditionalUNet(**kw, fused_attention=True).reset_parameters(torch.Generator().manual_seed(0))
    fused = fused.cuda().eval()
    x = torch.randn(2, 64, 64, 4, device="cuda", generator=gen)
    args = (x, torch.tensor([10.0, 900.0], device="cuda"), torch.tensor([2, 0], device="cuda"),
            torch.tensor([1.0, 0.0], device="cuda"))
    with torch.no_grad():
        program = torch.export.export(fused, args, strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    buf.seek(0)
    loaded = torch.export.load(buf)
    ops = [nd for nd in loaded.graph.nodes if "spectrogramgenai_tpu_torch.attention_fwd" in str(nd.target)]
    assert len(ops) == 3
    before = fused_attention.launches
    with torch.inference_mode():
        got = loaded.module()(*args)
        want = fused(*args)
    assert fused_attention.launches == before + 6  # 3 sites, twice
    assert torch.equal(got, want)



def _row_rel_err(got, want) -> float:
    """max over rows of |got − want| / |want|, norms over the head dim."""
    got, want = got.double(), want.double()
    return ((got - want).norm(dim=-1) / want.norm(dim=-1)).max().item()


def _exact_bwd(q, k, v, do):
    q, k, v, do = q.double(), k.double(), v.double(), do.double()
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.softmax(q @ k.mT * scale, dim=-1)
    dp = do @ v.mT
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    return ds @ k * scale, ds.mT @ q * scale, p.mT @ do


@pytest.mark.parametrize("shape", [(2, 4, 1024, 32), (2, 4, 1024, 16), (1, 2, 4096, 16),
                                   (2, 2, 256, 2), (2, 2, 256, 4), (2, 2, 128, 8), (1, 2, 384, 64)])
@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_backward_kernel_matches_plain_version(gen, shape, dtype, tol):
    q, k, v, do = (torch.randn(shape, device="cuda", generator=gen).to(dtype) for _ in range(4))
    # bf16: the tensor-core kernels, given the forward's residuals; f32: the scalar kernels
    res = fused_attention_residuals(q, k, v)[1:] if dtype == torch.bfloat16 else ()
    before = fused_attention_bwd.launches
    got = fused_attention_bwd(q, k, v, do, *res)
    torch.cuda.synchronize()
    assert fused_attention_bwd.launches == before + 1
    want = attention_bwd_reference(q, k, v, do)
    exact = _exact_bwd(q, k, v, do)
    for g, w, e in zip(got, want, exact):
        assert g.dtype == dtype and g.shape == q.shape and torch.isfinite(g).all()
        # per row against float64: f32 sums in another order, or the bf16
        # rounding of the outputs (2⁻⁹ relative), as the plain version has it
        assert _row_rel_err(g, e) <= max(tol, 2 * _row_rel_err(w, e))


def test_autograd_through_the_kernels(gen):
    q, k, v = (x.requires_grad_() for x in _qkv(gen, (2, 4, 1024, 16)))
    do = torch.randn(q.shape, device="cuda", generator=gen)
    before = (fused_attention.launches, fused_attention_bwd.launches)
    fused_attention(q, k, v).backward(do)
    assert (fused_attention.launches, fused_attention_bwd.launches) == (before[0] + 1, before[1] + 1)
    for g, w in zip((q.grad, k.grad, v.grad), fused_attention_bwd(q.detach(), k.detach(), v.detach(), do)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_forward_residuals_match_plain_version(gen):
    q, k, v = _qkv(gen, (2, 4, 1024, 16), torch.bfloat16)
    before = fused_attention.launches
    out, lse, o32 = fused_attention_residuals(q, k, v)
    assert fused_attention.launches == before + 1
    _, lse_p, o32_p = attention_reference(q, k, v, residuals=True)
    assert (lse - lse_p).abs().max().item() <= 1e-4 and (o32 - o32_p).abs().max().item() <= 1e-4
    assert torch.equal(o32.bfloat16(), out)
    # the score is rounded as the backward rounds it, so the output may differ
    # from the serving kernel's in its last bf16 bit: held to the plain version
    assert (out.float() - attention_reference(q.float(), k.float(), v.float())).abs().max().item() <= 1e-2


@pytest.mark.parametrize("shape", [(2, 4, 1024, 32), (2, 4, 1024, 16), (1, 4, 4096, 16), (2, 2, 384, 64),
                                   (2, 2, 256, 8), (2, 2, 256, 4), (2, 2, 256, 2)])
def test_bf16_residuals_match_plain_version_on_each_route(gen, shape):
    # the tensor-core kernel (d ≥ 16: P as bf16 hi + lo, lse from the f32 P)
    # and the scalar one (d < 16) write the same residuals
    q, k, v = _qkv(gen, shape, torch.bfloat16)
    assert tensor_core_route(q.dtype, shape[-1]) == (shape[-1] >= 16)
    before = fused_attention.mma_launches
    out, lse, o32 = fused_attention_residuals(q, k, v)
    assert fused_attention.mma_launches == before + int(shape[-1] >= 16)
    _, lse_p, o32_p = attention_reference(q, k, v, residuals=True)
    assert (lse - lse_p).abs().max().item() <= 1e-4 and (o32 - o32_p).abs().max().item() <= 1e-4
    assert torch.equal(o32.bfloat16(), out)


@pytest.mark.parametrize("shape", [(2, 4, 1024, 32), (2, 4, 1024, 16), (1, 4, 4096, 16)])  # sa_0, sa_4, sa_5
def test_bf16_serving_large_logits_and_underflow_on_the_tensor_cores(gen, shape):
    q, k, v = _qkv(gen, shape, torch.bfloat16)
    big = fused_attention((q.float() * 100.0).bfloat16(), k, v)
    want = _exact((q.float() * 100.0).bfloat16(), k, v)
    # one-hot rows copy a V entry: bf16 rounds 2⁻⁸ relative (chip_smoke.py's bound)
    assert ((big.double() - want).abs() / want.abs().clamp(min=1.0)).max().item() <= 1e-2
    n, d = shape[2], shape[3]
    qu = torch.full((1, 1, n, d), 100.0, device="cuda").bfloat16()
    vu = torch.randn((1, 1, n, d), device="cuda", generator=gen).bfloat16()
    out = fused_attention(qu, -qu, vu)  # every logit −10⁴·√d
    # uniform weights: the mean of V, to the bf16 rounding of P (1/N is exact) and of the output
    assert (out.float() - vu.float().mean(dim=2, keepdim=True)).abs().max().item() <= 1e-2


@pytest.mark.parametrize("shape", [(2, 4, 1024, 32), (2, 4, 1024, 16), (1, 4, 4096, 16)])  # sa_0, sa_4, sa_5
def test_bf16_autograd_runs_the_tensor_core_backward(gen, shape):
    q, k, v = (x.requires_grad_() for x in _qkv(gen, shape, torch.bfloat16))
    do = torch.randn(shape, device="cuda", generator=gen).bfloat16()
    before = (fused_attention.launches, fused_attention_bwd.launches)
    fused_attention(q, k, v).backward(do)
    assert (fused_attention.launches, fused_attention_bwd.launches) == (before[0] + 1, before[1] + 1)
    exact = _exact_bwd(q.detach(), k.detach(), v.detach(), do)
    for g, e in zip((q.grad, k.grad, v.grad), exact):
        assert g.dtype == torch.bfloat16 and _row_rel_err(g, e) <= 5e-3  # chip_smoke.py's BWD_TOL
    with pytest.raises(ValueError, match="residuals"):
        fused_attention_bwd(q.detach(), k.detach(), v.detach(), do)


def test_backward_large_logits_and_underflow(gen):
    q, k, v, do = (torch.randn(1, 2, 1024, 16, device="cuda", generator=gen) for _ in range(4))
    k[..., 0] += 200.0  # logits up to ~165 (see tests/test_torch_attention_bwd.py)
    # f32 rounding of logits that large: the plain version reads 1.4e-4 here on the card
    for g, e in zip(fused_attention_bwd(q, k, v, do), _exact_bwd(q, k, v, do)):
        assert torch.isfinite(g).all() and _row_rel_err(g, e) <= 1e-3
    q = torch.full((1, 1, 256, 16), 100.0, device="cuda")
    k = torch.full((1, 1, 256, 16), -100.0, device="cuda")
    v = torch.ones((1, 1, 256, 16), device="cuda")
    do = torch.randn(1, 1, 256, 16, device="cuda", generator=gen)
    dq, dk, dv = fused_attention_bwd(q, k, v, do)
    assert torch.isfinite(dq).all() and torch.isfinite(dk).all()
    # 0 up to the rounding of dP − c carried by |k| = 100 (see chip_smoke.py)
    assert dq.abs().max().item() <= 1e-2 and dk.abs().max().item() <= 1e-2
    torch.testing.assert_close(dv, do.mean(dim=2, keepdim=True).expand_as(dv), rtol=0, atol=1e-5)


@pytest.mark.parametrize("exact", [True, "high", False])
@pytest.mark.parametrize("sr, batch, n", [(22050, 1, 132300), (22050, 64, 132300), (48000, 4, 288000),
                                          (22050, 5, 100001)])
def test_mel_kernel_matches_plain_version_and_oracle(gen, exact, sr, batch, n):
    cfg = SpectrogramConfig(sample_rate=sr)
    clips = stress_audio(cfg, batch)[:, :n]  # the JAX tool's own clips (seed 0)
    audio = torch.from_numpy(np.ascontiguousarray(clips)).cuda()
    before = fused_mel_power.launches
    got = fused_mel_power(audio, cfg, exact)
    torch.cuda.synchronize()
    assert fused_mel_power.launches == before + 1
    assert got.shape == (batch, cfg.frames_for(n), cfg.n_mels) and got.dtype == torch.float32
    want = mel_power_reference(audio, cfg, exact)
    assert mel_rel_err(got, want) <= MEL_TOL[rung_name(exact)]  # per element, down to the dB floor

    db = fused_logmel(audio, cfg, exact).cpu().numpy()
    err = np.abs(db - np.stack([reference_logmel_np(c, cfg) for c in clips])).max(axis=(1, 2))
    typical, adversarial = RUNG_BOUNDS[exact]
    assert err.max() <= adversarial, err
    if batch == 64:  # typical: kind 3 of the JAX tool's own set
        assert err[3::4].max() <= typical, err


@pytest.mark.parametrize("exact, n_fft, hop, n_mels, tiles", [
    (exact, *shape) for shape in [(64, 16, 16, (96, 96)), (64, 48, 20, (96, 96)), (2048, 512, 256, (64, 96)),
                                  (2048, 1024, 256, (32, 64)), (4096, 384, 256, (96, 96))]
    for exact in ("high", False)
])
def test_mma_mel_kernel_at_other_shapes_and_tiles(gen, exact, n_fft, hop, n_mels, tiles):
    # the small shapes of the CPU mirror, audio spans too wide for a 96-frame
    # tile, and the longest DFT the front end takes
    cfg = SpectrogramConfig(n_fft=n_fft, hop_length=hop, n_mels=n_mels)
    assert (mma_tile_frames(cfg, "high"), mma_tile_frames(cfg, "fast")) == tiles
    clips = stress_audio(cfg, 6)[:, :100_001]
    audio = torch.from_numpy(np.ascontiguousarray(clips)).cuda()
    got = fused_mel_power(audio, cfg, exact)
    assert mel_rel_err(got, mel_power_reference(audio, cfg, exact)) <= MEL_TOL[rung_name(exact)]


@pytest.mark.parametrize("n_fft, hop, n_mels", [(64, 16, 16), (128, 32, 32), (256, 64, 64), (512, 128, 128),
                                              (1024, 256, 128), (2048, 384, 256), (4096, 384, 256)])
def test_fft_kernel_matches_plain_version_and_oracle(gen, n_fft, hop, n_mels):
    cfg = SpectrogramConfig(n_fft=n_fft, hop_length=hop, n_mels=n_mels)
    clips = stress_audio(cfg, 8)[:, :100_001]  # odd length: the last pair holds one frame
    audio = torch.from_numpy(np.ascontiguousarray(clips)).cuda()
    before = fused_mel_power.launches
    got = fused_mel_power(audio, cfg)
    torch.cuda.synchronize()
    assert fused_mel_power.launches == before + 1
    assert mel_rel_err(got, mel_power_reference(audio, cfg)) <= MEL_TOL["exact"]
    err = np.abs(fused_logmel(audio, cfg).cpu().numpy() - np.stack([reference_logmel_np(c, cfg) for c in clips]))
    assert err.max() <= RUNG_BOUNDS[True][1]


def test_mel_wrapper_rejects_what_the_kernel_does_not_take(gen):
    cfg = SpectrogramConfig()
    audio = torch.randn(2, 30000, device="cuda", generator=gen)
    with pytest.raises(TypeError, match="float32"):
        fused_mel_power(audio.bfloat16(), cfg)
    with pytest.raises(ValueError, match="contiguous"):
        fused_mel_power(torch.randn(30000, 2, device="cuda", generator=gen).T, cfg)
    with pytest.raises(ValueError, match="device"):
        fused_mel_power(torch.zeros(2, 30000, device="meta"), cfg)
    with pytest.raises(ValueError, match="hop"):
        fused_mel_power(audio, SpectrogramConfig(hop_length=100))
    with pytest.raises(ValueError, match="power of two"):
        fused_mel_power(audio, SpectrogramConfig(n_fft=1536))
    before = fused_mel_power.launches
    fused_mel_power(audio, cfg)
    fused_mel_power(audio, cfg, exact=False)
    assert fused_mel_power.launches == before + 2


def _vqvae_steps(device: str, images: list[np.ndarray]):
    from spectrogramgenai_tpu_torch.core.config import VQVAEConfig
    from spectrogramgenai_tpu_torch.train.vqvae_task import VQVAETask

    task = VQVAETask(VQVAEConfig(hidden_dim=32, n_embeddings=32, compute_dtype="float32"), device)
    state = task.init_state(0)
    for x in images:
        state, m = task.train_step(state, torch.from_numpy(x).to(device))
    return state, {k: float(v) for k, v in m.items()}


def test_vqvae_float32_steps_on_the_card_match_the_cpu(gen):
    # the same three float32 steps (convolutions in full float32, TF32 off),
    # codebook included, on the card and on the CPU: float32 sums in another
    # order, the train-state tolerance of tests/test_torch_vqvae_train.py
    rng = np.random.default_rng(0)
    images = [rng.uniform(0, 1, (8, 64, 64, 1)).astype(np.float32) for _ in range(3)]
    card, m_card = _vqvae_steps("cuda", images)
    cpu, m_cpu = _vqvae_steps("cpu", images)
    for k in m_cpu:
        assert m_card[k] == pytest.approx(m_cpu[k], rel=1e-4), k
    for name in ("params", "stats"):
        for k, v in getattr(cpu, name).items():
            np.testing.assert_allclose(getattr(card, name)[k].cpu().numpy(), v.numpy(), rtol=1e-4, atol=5e-5,
                                       err_msg=k)


def test_classifier_float32_step_on_the_card_matches_the_cpu(gen):
    # one ResNet18 step (frozen prefix, BatchNorm batch statistics) on the card and on the CPU
    from spectrogramgenai_tpu_torch.core.config import ClassifierConfig, DataConfig
    from spectrogramgenai_tpu_torch.train.classifier_task import ClassifierTask

    rng = np.random.default_rng(1)
    images = rng.uniform(0, 1, (8, 64, 64, 1)).astype(np.float32)
    labels = rng.integers(0, 5, 8)
    out = {}
    for device in ("cuda", "cpu"):
        task = ClassifierTask(ClassifierConfig(model_name="resnet", num_classes=5, compute_dtype="float32",
                                               data=DataConfig(img_size=64)), device)
        state = task.init_state(0)
        state, m = task.train_step(state, torch.from_numpy(images).to(device), torch.from_numpy(labels).to(device))
        out[device] = (state, float(m["train_loss"]), task.mask)
    (card, loss_card, mask), (cpu, loss_cpu, _) = out["cuda"], out["cpu"]
    assert loss_card == pytest.approx(loss_cpu, rel=1e-5)
    for k, v in cpu.stats.items():
        np.testing.assert_allclose(card.stats[k].cpu().numpy(), v.numpy(), rtol=1e-4, atol=5e-5, err_msg=k)
    for k, v in cpu.params.items():
        if not mask[k]:  # frozen: bit-equal on both
            assert torch.equal(card.params[k].cpu(), v), k


def test_exact_mel_kernel_at_the_mix_shape(gen):
    # the separator's mix batch: 3 × 8 clips of 2¹⁷ samples (342 frames; the last frames run past the end)
    from spectrogramgenai_tpu_torch.audio.mix import mix_stack

    cfg = SpectrogramConfig()
    n = 2**17
    rng = np.random.default_rng(2)
    noise = rng.standard_normal((8, n)).astype(np.float32)
    bird = np.ascontiguousarray(stress_audio(cfg, 8)[:, :n])
    audio = torch.from_numpy(mix_stack(noise, bird, rng.uniform(0, 0.3, 8))).cuda()
    before = fused_mel_power.launches
    got = fused_mel_power(audio, cfg)
    torch.cuda.synchronize()
    assert fused_mel_power.launches == before + 1 and got.shape == (24, 342, cfg.n_mels)
    assert mel_rel_err(got, mel_power_reference(audio, cfg)) <= MEL_TOL["exact"]
    err = np.abs(fused_logmel(audio, cfg).cpu().numpy() - np.stack([reference_logmel_np(c, cfg)
                                                                     for c in audio.cpu().numpy()]))
    assert err.max() <= RUNG_BOUNDS[True][1]


def _evaluator_mel_batch(shape: str):
    """The exact mel kernel's (config, audio on the card) of an evaluator's front end: "clap" is 8 clips
    of 10 s at 48 kHz (6-s stress clips repeat-padded), reflect-padded by 512 for the CLAP log-mel
    (centring off, 481,024 samples → 1001 frames); "fad" is FAD's mel mode, 32 clips at 48 kHz."""
    import dataclasses

    from spectrogramgenai_tpu_torch.eval.clap import ClapAudioTowerConfig, repeatpad, spectrogram_config

    if shape == "clap":
        clips = stress_audio(SpectrogramConfig(sample_rate=48000), 8)
        padded = np.stack([repeatpad(c, 480000) for c in clips])
        audio = torch.nn.functional.pad(torch.from_numpy(padded).cuda(), (512, 512), mode="reflect").contiguous()
        cfg = spectrogram_config(ClapAudioTowerConfig())
        return dataclasses.replace(cfg, num_frames=cfg.frames_for(audio.shape[1])), audio
    cfg = SpectrogramConfig(sample_rate=48000)
    return cfg, torch.from_numpy(stress_audio(cfg, 32, seed=3)[:, :250_000].copy()).cuda()


@pytest.mark.parametrize("shape, frames", [("clap", 1001), ("fad", 652)])
def test_exact_mel_kernel_at_the_evaluator_shapes(gen, shape, frames):
    from spectrogramgenai_tpu_torch.ops.mel_kernel import logmel_from_power

    cfg, audio = _evaluator_mel_batch(shape)
    before = fused_mel_power.launches
    got = fused_mel_power(audio, cfg)
    torch.cuda.synchronize()
    assert fused_mel_power.launches == before + 1 and got.shape == (audio.shape[0], frames, cfg.n_mels)
    assert mel_rel_err(got, mel_power_reference(audio, cfg)) <= MEL_TOL["exact"]
    db = logmel_from_power(got, cfg).cpu().numpy()
    err = np.abs(db - np.stack([reference_logmel_np(c, cfg) for c in audio.cpu().numpy()])).max(axis=(1, 2))
    assert err.max() <= RUNG_BOUNDS[True][1] and np.median(err) <= RUNG_BOUNDS[True][0], err


def test_evaluator_towers_on_the_card_match_the_cpu(gen):
    # InceptionV3 (both pool kinds) and the HTSAT-tiny CLAP tower, float32 with TF32 off, seeded weights
    from spectrogramgenai_tpu_torch.core.precision import full_float32
    from spectrogramgenai_tpu_torch.eval.clap import ClapAudioTower
    from spectrogramgenai_tpu_torch.eval.inception import build_inception
    from spectrogramgenai_tpu_torch.models.layers import init_weights_

    x = torch.rand(2, 299, 299, 3, generator=torch.Generator().manual_seed(0)) * 2 - 1
    for fid_pool in (False, True):
        model = build_inception(None, "cpu", fid_pool=fid_pool)
        with full_float32():
            card, cpu, _, _ = _forward_card_and_cpu(model, x, return_features=fid_pool)
        assert float((card.cpu() - cpu).norm() / cpu.norm()) <= 1e-4
    tower = init_weights_(ClapAudioTower(), torch.Generator().manual_seed(1)).eval()
    feats = torch.randn(2, 1, 1001, 64, generator=torch.Generator().manual_seed(2)) * 5 - 20
    with full_float32():
        card, cpu, _, _ = _forward_card_and_cpu(tower, feats)
    assert float((card.cpu() - cpu).norm() / cpu.norm()) <= 1e-4


def _forward_card_and_cpu(module, x: torch.Tensor, **kw):
    """module's float32 forward on the card and on the CPU, each from the same
    weights and state (TF32 off); returns both outputs and both modules."""
    import copy

    on_cpu = copy.deepcopy(module)
    with torch.no_grad():
        card = module.cuda()(x.cuda(), **kw)
        cpu = on_cpu(x, **kw)
    return card, cpu, module, on_cpu


def test_gan_forwards_on_the_card_match_the_cpu(gen):
    from spectrogramgenai_tpu_torch.models.gan import Discriminator, Generator, reset_gan

    g = reset_gan(Generator(noise_dim=91), torch.Generator().manual_seed(0))
    z = torch.randn(2, 91, generator=torch.Generator().manual_seed(1))
    for train in (False, True):  # the running statistics, and the batch's (BatchNorm updated on both)
        card, cpu, g_card, g_cpu = _forward_card_and_cpu(g, z, train=train)
        np.testing.assert_allclose(card.cpu().numpy(), cpu.numpy(), rtol=1e-4, atol=1e-4)
        g = g_cpu
    np.testing.assert_allclose(g_card.block_0.bn1.running_var.cpu().numpy(), g_cpu.block_0.bn1.running_var.numpy(),
                               rtol=1e-5)
    d = reset_gan(Discriminator(n_classes=27, n_ind=11), torch.Generator().manual_seed(2))
    x = torch.rand(2, 256, 256, 1, generator=torch.Generator().manual_seed(3)) * 2 - 1
    card, cpu, d_card, d_cpu = _forward_card_and_cpu(d, x, train=True)  # each updates its u
    for a, b in zip(card, cpu):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4, atol=1e-5)
    for name in ("block_0_conv", "block_3_conv", "layer_c"):
        np.testing.assert_allclose(getattr(d_card, name).u.cpu().numpy(), getattr(d_cpu, name).u.numpy(),
                                   rtol=1e-4, atol=1e-6)


def test_denoiser_forward_on_the_card_matches_the_cpu(gen):
    from spectrogramgenai_tpu_torch.models.denoiser import TransformerDenoiser
    from spectrogramgenai_tpu_torch.models.layers import init_weights_

    model = init_weights_(TransformerDenoiser(out_channels=2), torch.Generator().manual_seed(0))
    x = torch.rand(2, 256, 256, 1, generator=torch.Generator().manual_seed(1)) * 2 - 1
    card, cpu, _, _ = _forward_card_and_cpu(model, x)
    np.testing.assert_allclose(card.cpu().numpy(), cpu.numpy(), rtol=1e-4, atol=1e-5)
