"""The port's mel front end against the JAX package, on the CPU.

The same numpy-seeded audio goes through ``spectrogramgenai_tpu`` (the fused
Pallas kernel in interpret mode, and the jnp pipeline) and through
``spectrogramgenai_tpu_torch`` (the plain PyTorch version that stands in for
the CUDA kernels on CPU tensors). Each precision rung's plain version is held
to the float64 oracle at the JAX ladder's bounds (PARITY.md, mel kernel
precision ladder), and numpy mirrors of the CUDA kernels
(``tests/torch_mel_helpers.py``) check the kernels' operand layouts.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from spectrogramgenai_tpu.audio import mel as jmel  # noqa: E402
from spectrogramgenai_tpu.audio import spectrogram as jspec  # noqa: E402
from spectrogramgenai_tpu.ops import mel_kernel as jkernel  # noqa: E402
from spectrogramgenai_tpu_torch.audio import mel as tmel  # noqa: E402
from spectrogramgenai_tpu_torch.audio import spectrogram as tspec  # noqa: E402
from spectrogramgenai_tpu_torch.ops import mel_kernel as tkernel  # noqa: E402
from torch_mel_helpers import (  # noqa: E402
    RING_BYTES,
    RUNG_BOUNDS,
    SLOT_STEPS,
    fft_kernel,
    mel_rel_err,
    mma_kernel,
    mma_tile_frames,
    stress_audio,
)
from torch_port_helpers import one_torch_thread  # noqa: E402, F401


def _audio(sr: int, n: int, b: int = 2, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    clips = [np.sin(2 * np.pi * (1500 + 700 * k) * t) * np.exp(-0.5 * t) + 0.05 * rng.standard_normal(n)
             for k in range(b)]
    return np.stack(clips).astype(np.float32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------- copies


@pytest.mark.parametrize("name, args", [
    ("hz_to_mel", (np.array([0.0, 440.0, 999.9, 1000.0, 5000.0, 11025.0]),)),
    ("mel_to_hz", (np.array([0.0, 7.5, 15.0, 30.0, 45.0]),)),
    ("mel_frequencies", (258, 0.0, 11025.0)),
    ("fft_frequencies", (22050, 2048)),
    ("mel_filterbank", (22050, 2048, 256)),
    ("mel_filterbank", (48000, 2048, 256)),
    ("mel_filterbank", (16000, 512, 64, 100.0, 7000.0)),
    ("hann_window", (2048,)),
])
def test_mel_copies_are_bit_equal(name, args):
    want, got = getattr(jmel, name)(*args), getattr(tmel, name)(*args)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    if name in ("hz_to_mel", "mel_to_hz"):  # the HTK variant as well
        assert np.array_equal(getattr(tmel, name)(*args, htk=True), getattr(jmel, name)(*args, htk=True))


def test_dft_matrices_are_bit_equal():
    window = jmel.hann_window(2048)
    for a, b in zip(jmel.dft_matrices(2048, window), tmel.dft_matrices(2048, window)):
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)


def test_spectrogram_config_fields_and_defaults_match_jax():
    jf, tf = dataclasses.fields(jspec.SpectrogramConfig), dataclasses.fields(tspec.SpectrogramConfig)
    assert [(f.name, f.default) for f in jf] == [(f.name, f.default) for f in tf]
    for sr in (22050, 48000):
        j, t = jspec.SpectrogramConfig(sample_rate=sr), tspec.SpectrogramConfig(sample_rate=sr)
        assert (j.n_bins, j.clip_samples) == (t.n_bins, t.clip_samples)
        for n in (1, 383, 384, 132300, 288000, 131999):
            assert j.frames_for(n) == t.frames_for(n)


# ------------------------------------------------------- tensor functions


@pytest.mark.parametrize("n", [22050, 11111])
def test_frames_and_stft_power_match_jax(n):
    cfg = tspec.SpectrogramConfig()
    jcfg = jspec.SpectrogramConfig()
    audio = _audio(22050, n, seed=2)
    frames = tspec.frame_signal(_t(audio), cfg).numpy()
    assert np.array_equal(frames, np.asarray(jspec.frame_signal(jnp.asarray(audio), jcfg)))
    want = np.asarray(jspec.stft_power(jnp.asarray(audio), jcfg))
    got = tspec.stft_power(_t(audio), cfg).numpy()
    np.testing.assert_allclose(got / want.max(), want / want.max(), atol=2e-6)


def test_centre_padding_is_zeros_not_reflect():
    cfg = tspec.SpectrogramConfig()
    audio = _audio(22050, 22050, b=1, seed=4)
    frames = tspec.frame_signal(_t(audio), cfg)[0]
    assert torch.all(frames[0, : cfg.n_fft // 2] == 0)
    assert torch.equal(frames[0, cfg.n_fft // 2:], _t(audio)[0, : cfg.n_fft // 2])
    # torch.stft's default reflect padding gives another first frame; constant padding matches
    window = torch.from_numpy(tmel.hann_window(cfg.n_fft))
    power = tspec.stft_power(_t(audio), cfg)[0]
    for mode, same in (("constant", True), ("reflect", False)):
        spec = torch.stft(_t(audio)[0].double(), cfg.n_fft, cfg.hop_length, window=window.double(),
                          center=True, pad_mode=mode, return_complex=True).abs().square().T.float()
        close = torch.allclose(spec[0], power[0], rtol=1e-4, atol=1e-4 * float(power.max()))
        assert close == same, mode


def test_power_to_db_matches_jax():
    rng = np.random.default_rng(5)
    s = (10.0 ** rng.uniform(-14, 2, (3, 16, 40))).astype(np.float32)
    s[1] = 0.0  # a silent clip: ref = amin
    for top_db in (80.0, None):
        want = np.asarray(jspec.power_to_db(jnp.asarray(s), amin=1e-10, top_db=top_db))
        got = tspec.power_to_db(_t(s), amin=1e-10, top_db=top_db).numpy()
        np.testing.assert_allclose(got, want, atol=2e-5)


# ----------------------------------------------- plain version vs the JAX kernel


@pytest.mark.parametrize("sr, seconds", [(22050, 2.0), (32000, 1.0), (48000, 1.0)])
def test_mel_power_reference_matches_jax_kernel_and_jnp(sr, seconds):
    jcfg, cfg = jspec.SpectrogramConfig(sample_rate=sr), tspec.SpectrogramConfig(sample_rate=sr)
    audio = _audio(sr, int(seconds * sr))
    got = tkernel.mel_power_reference(_t(audio), cfg).numpy()
    want = np.asarray(jkernel.fused_mel_power(jnp.asarray(audio), jcfg, interpret=True))
    want_jnp = np.swapaxes(np.asarray(jspec.mel_power_spectrogram(jnp.asarray(audio), jcfg)), 1, 2)
    assert got.shape == want.shape == want_jnp.shape == (2, cfg.frames_for(audio.shape[1]), cfg.n_mels)
    scale = want.max()
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-6)
    np.testing.assert_allclose(got / scale, want_jnp / scale, atol=2e-6)
    # the port's own rfft path, too
    mel = tspec.mel_power_spectrogram(_t(audio), cfg).numpy()
    np.testing.assert_allclose(np.swapaxes(mel, 1, 2) / scale, want_jnp / scale, atol=2e-6)


def test_high_rung_matches_jax_three_pass_kernel():
    # interpret mode runs the bf16 hi/lo products in float32: the same
    # products as the port's plain "high" version, summed in another order
    jcfg, cfg = jspec.SpectrogramConfig(), tspec.SpectrogramConfig()
    audio = _audio(22050, 22050, seed=6)
    got = tkernel.mel_power_reference(_t(audio), cfg, exact="high").numpy()
    want = np.asarray(jkernel.fused_mel_power(jnp.asarray(audio), jcfg, interpret=True, exact="high"))
    np.testing.assert_allclose(got / want.max(), want / want.max(), atol=1e-5)


@pytest.mark.parametrize("n", [132300, 100001])
def test_logmel_matches_jax_and_oracle(n):
    jcfg, cfg = jspec.SpectrogramConfig(), tspec.SpectrogramConfig()
    audio = _audio(22050, n, b=3, seed=1)
    want = np.asarray(jspec.logmel_spectrogram(jnp.asarray(audio), jcfg))
    oracle = np.stack([jspec.reference_logmel_np(a, jcfg) for a in audio])
    fused = tkernel.fused_logmel(_t(audio), cfg).numpy()
    plain = tspec.logmel_spectrogram(_t(audio), cfg).numpy()
    assert fused.shape == plain.shape == want.shape == (3, cfg.n_mels, min(cfg.num_frames, cfg.frames_for(n)))
    for got in (fused, plain):
        np.testing.assert_allclose(got, want, atol=5e-3)
        np.testing.assert_allclose(got, oracle, atol=5e-3)
    # the port's oracle is the JAX one
    assert np.array_equal(np.stack([tspec.reference_logmel_np(a, cfg) for a in audio]), oracle)


@pytest.mark.parametrize("exact", [True, "high", False])
def test_rung_plain_version_meets_ladder_bounds(exact):
    cfg = tspec.SpectrogramConfig()
    audio = stress_audio(cfg, 8)  # the first clips of the JAX tool's own set (seed 0)
    oracle = np.stack([tspec.reference_logmel_np(a, cfg) for a in audio])
    err = np.abs(tkernel.fused_logmel(_t(audio), cfg, exact=exact).numpy() - oracle).max(axis=(1, 2))
    typical, adversarial = RUNG_BOUNDS[exact]
    assert err[3::4].max() <= typical, err
    assert err.max() <= adversarial, err


@pytest.mark.parametrize("n_fft, hop, n_mels", [(64, 16, 16), (512, 128, 64), (4096, 384, 256)])
def test_exact_plain_version_is_the_float64_oracle_rounded_once(n_fft, hop, n_mels):
    # the exact rung's plain version computes the oracle's mel power (float64
    # frames, window, FFT and filterbank) and rounds it once to float32
    cfg = tspec.SpectrogramConfig(n_fft=n_fft, hop_length=hop, n_mels=n_mels)
    audio = stress_audio(cfg, 4, seed=4)[:, :30_001]
    window, fb = tspec.constants(cfg)
    x = np.pad(audio.astype(np.float64), ((0, 0), (n_fft // 2, n_fft // 2)))
    starts = np.arange(cfg.frames_for(audio.shape[1])) * hop
    frames = x[:, starts[:, None] + np.arange(n_fft)] * window.astype(np.float64)
    want = (np.abs(np.fft.rfft(frames, axis=-1)) ** 2 @ fb.astype(np.float64).T).astype(np.float32)
    got = tkernel.mel_power_reference(_t(audio), cfg).numpy()
    assert got.shape == want.shape
    assert mel_rel_err(_t(got), _t(want)) <= 2.4e-7  # float32's half ulp and float64 noise


def test_second_sample_rate_and_odd_length_meet_exact_bound():
    cfg = tspec.SpectrogramConfig(sample_rate=48000)
    audio = stress_audio(cfg, 4, seed=3)[:, :271_111]  # odd length, T = 707
    oracle = np.stack([tspec.reference_logmel_np(a, cfg) for a in audio])
    got = tkernel.fused_logmel(_t(audio), cfg).numpy()
    assert got.shape == (4, 256, 256)
    assert np.abs(got - oracle).max() <= RUNG_BOUNDS[True][1]


# ------------------------------------------------------- the kernels' layouts


EMU_CFGS = [  # small shapes: a partial second tile, a hop that does not divide n_fft, n_mels < 256,
    # and chunks of 16 k-steps (n_fft 256) beside chunks of 4
    (tspec.SpectrogramConfig(sample_rate=8000, n_fft=64, hop_length=16, n_mels=16), 2000),
    (tspec.SpectrogramConfig(sample_rate=8000, n_fft=64, hop_length=48, n_mels=20), 3100),
    (tspec.SpectrogramConfig(sample_rate=8000, n_fft=256, hop_length=64, n_mels=24), 2000),
]


@pytest.mark.parametrize("cfg, n", EMU_CFGS)
@pytest.mark.parametrize("exact, tol", [(True, 1e-6), ("high", 3e-5), (False, 1e-3)])
def test_kernel_mirror_matches_plain_version(cfg, n, exact, tol):
    # per element, down to 80 dB under each clip's max. The mirrors sum in
    # float64; the plain version sums in float64 for the exact rung (the
    # FFT mirror and rfft then differ by float64 rounding only), in float64
    # with float32 stores of re, im and the power for "high" (1.42e-5 at
    # most), and in float32 for "fast", which rounds the power to bf16 and
    # can flip on that difference (2⁻⁸ of one term)
    rng = np.random.default_rng(8)
    audio = (rng.standard_normal((2, n)) * np.exp(rng.uniform(-3, 0, (2, 1)))).astype(np.float32)
    want = tkernel.mel_power_reference(_t(audio), cfg, exact).numpy()
    rung = tkernel.rung_name(exact)
    got = fft_kernel(audio, cfg) if rung == "exact" else mma_kernel(audio, cfg, rung)
    assert got.shape == want.shape
    assert mel_rel_err(torch.from_numpy(got), torch.from_numpy(want)) <= tol


def test_kernel_constants_are_padded_with_zeros():
    cfg = tspec.SpectrogramConfig()
    wc, ws = tkernel._dft(cfg)
    fb_t = np.ascontiguousarray(tspec.constants(cfg)[1].T)
    # the FFT kernel's: float64 twiddles, and mel ranges that rebuild the dense filterbank exactly
    win, tw, ranges, weights = tkernel.fft_constants(cfg)
    assert tw.dtype == win.dtype == weights.dtype == np.float64 and tw.shape == (2048, 2)
    assert np.array_equal(tw[:, 0] + 1j * tw[:, 1], np.exp(-2j * np.pi * np.arange(2048) / 2048))
    assert np.array_equal(win, tspec.constants(cfg)[0].astype(np.float64))
    assert ranges.shape == (256, 4) and ranges.dtype == np.int32 and ranges[:, 1].sum() == len(weights)
    dense = np.zeros((256, 1025))
    for m, (first, count, offset, _) in enumerate(ranges):
        dense[m, first:first + count] = weights[offset:offset + count]
    assert np.array_equal(dense, fb_t.T.astype(np.float64))
    assert ranges[:, 1].max() < 64  # every filter covers a short bin range
    for rung, parts in (("high", 2), ("fast", 1)):
        w, fb, nbp = tkernel.mma_layout(wc, ws, fb_t, rung)
        assert nbp == 1040 and w.shape == (65, 128, parts, 2, 32, 4) and fb.shape == (65, 16, parts, 32, 4)
        # bin block 64 holds bins 1024 … 1039 and only bin 1024 exists: lane 4g + q reads column
        # 16·64 + 8t + g, so every word but tile 0 of lanes 0 … 3 is padding
        assert not w[64, :, :, :, 4:].any() and not w[64, :, :, :, :4, 2:].any() and w[64, :, :, :, :4, :2].any()
        # filterbank rows of bins ≥ 1025: b23 (rows + 8) of every lane, b01 of lanes with q > 0
        assert not fb[64, ..., 1::2].any() and not fb[64, :, :, np.arange(32) % 4 > 0].any()
        # the kernel stages W in chunks of 16 k-steps of one bin block, each a contiguous
        # run of 16·parts·64 uint4 (one bulk copy), through a 64 KB ring beside the audio
        # span of 96 frames (for "high" hi and lo)
        chunks = w.reshape(65 * 128 // SLOT_STEPS, SLOT_STEPS * parts * 64 * 4)
        assert np.array_equal(chunks[9], w[1, 16:32].reshape(-1))
        assert RING_BYTES % (SLOT_STEPS * parts * 64 * 16) == 0
        assert mma_tile_frames(cfg, rung) == 96


# ------------------------------------------------------------ the wrapper


def test_wrapper_validates_and_takes_the_plain_version_on_cpu():
    cfg = tspec.SpectrogramConfig()
    audio = _t(_audio(22050, 20000))
    before = tkernel.fused_mel_power.launches
    assert torch.equal(tkernel.fused_mel_power(audio, cfg), tkernel.mel_power_reference(audio, cfg))
    assert tkernel.fused_mel_power.launches == before  # no kernel ran
    with pytest.raises(TypeError, match="float32"):
        tkernel.fused_mel_power(audio.double(), cfg)
    with pytest.raises(ValueError, match="contiguous"):
        tkernel.fused_mel_power(torch.zeros(20000, 2).T, cfg)
    with pytest.raises(ValueError, match="device"):
        tkernel.fused_mel_power(torch.zeros(2, 20000, device="meta"), cfg)
    with pytest.raises(ValueError, match=r"\(B, N\)"):
        tkernel.fused_mel_power(audio[0], cfg)
    with pytest.raises(ValueError, match="exact"):
        tkernel.fused_mel_power(audio, cfg, exact="highest")
    with pytest.raises(ValueError, match="power"):
        tkernel.fused_mel_power(audio, dataclasses.replace(cfg, power=1.0))


def test_mel_rel_err_is_per_element_down_to_the_db_floor():
    want = torch.tensor([[[1.0, 1e-4, 1e-9]], [[1e-6, 1e-7, 1e-16]]])
    # a 10 % error on a bin 40 dB under its clip's max counts in full, in a quiet clip as in a loud one
    assert mel_rel_err(want * torch.tensor([[[1.0, 1.1, 1.0]], [[1.0, 1.0, 1.0]]]), want) == pytest.approx(0.1)
    assert mel_rel_err(want * torch.tensor([[[1.0, 1.0, 1.0]], [[1.0, 1.1, 1.0]]]), want) == pytest.approx(0.1)
    # under the floor (80 dB below the clip's max) an error counts against the floor
    assert mel_rel_err(want * torch.tensor([[[1.0, 1.0, 2.0]], [[1.0, 1.0, 1.0]]]), want) == pytest.approx(0.1)
    assert mel_rel_err(want, want) == 0.0
