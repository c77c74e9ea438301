"""The port's gen_specs CLI against the JAX package's, on the CPU.

One synthetic corpus (two sample rates, stereo, 8-bit and float WAVs, a short
file, a window that runs off the end, a missing and an unreadable file) goes
through ``spectrogramgenai_tpu.cli.gen_specs`` and through
``spectrogramgenai_tpu_torch.cli.gen_specs --device cpu``: the same files
must come out, the .npy arrays within 5e-3 dB and the PNGs within one
viridis level. One difference is known and checked: the JAX CLI's native
decoder (native/wav_batch.cpp), where it builds, reads an 8-bit PCM file as
silence, while the JAX package's own ``load_wav``, which the port copies,
decodes it.
"""

import csv
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402
from scipy.io import wavfile  # noqa: E402

from spectrogramgenai_tpu.audio import wavio as jwavio  # noqa: E402
from spectrogramgenai_tpu.audio.spectrogram import SpectrogramConfig, reference_logmel_np  # noqa: E402
from spectrogramgenai_tpu.cli import gen_specs as jgen  # noqa: E402
from spectrogramgenai_tpu.data.native_wav import native_available  # noqa: E402
from spectrogramgenai_tpu_torch.audio import wavio as twavio  # noqa: E402
from spectrogramgenai_tpu_torch.audio.export import VIRIDIS_LUT, spec_png_name  # noqa: E402
from spectrogramgenai_tpu_torch.cli import gen_specs as tgen  # noqa: E402
from spectrogramgenai_tpu_torch.data.manifest import read_detection_manifest  # noqa: E402


def _tone(sr: int, seconds: float, f0: float, rng) -> np.ndarray:
    t = np.arange(int(sr * seconds)) / sr
    return 0.5 * np.sin(2 * np.pi * f0 * t) * np.exp(-0.1 * t) + 0.02 * rng.standard_normal(len(t))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("gen_specs")
    wav_dir = root / "wavs"
    wav_dir.mkdir()
    rng = np.random.default_rng(0)
    rows = []

    def add(name, sr, data, detections):
        wavfile.write(str(wav_dir / name), sr, data)
        rows.extend({"file_name": name, "begin_time": b, "end_time": e, "common_name": f"bird{len(rows) % 3}",
                     "confidence": "0.9"} for b, e in detections)

    for i in range(2):
        add(f"rec{i}.wav", 22050, (_tone(22050, 9, 600 + 300 * i, rng) * 32767).astype(np.int16),
            [(0, 3), (1.5, 4), (5, 9)])  # 5 s: the window runs off the end → ends at 9 s
    add("stereo.wav", 22050, (np.stack([_tone(22050, 7, 900, rng)] * 2, 1) * 32767).astype(np.int16), [(0, 3)])
    add("hires.wav", 48000, _tone(48000, 7, 3000, rng).astype(np.float32), [(0, 3), (1, 4)])
    add("short.wav", 22050, (_tone(22050, 2, 1200, rng) * 32767).astype(np.int16), [(0, 2)])
    add("eightbit.wav", 22050, ((_tone(22050, 7, 1500, rng) + 1) * 127).astype(np.uint8), [(1, 4)])
    rows.append({"file_name": "missing.wav", "begin_time": 0, "end_time": 3, "common_name": "x",
                 "confidence": "0.1"})
    (wav_dir / "broken.wav").write_bytes(b"RIFF0000WAVEjunk")
    rows.append({"file_name": "broken.wav", "begin_time": 0, "end_time": 3, "common_name": "x",
                 "confidence": "0.1"})
    manifest = root / "manifest.csv"
    with open(manifest, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return str(manifest), str(wav_dir), root


def _viridis_index(path: str) -> np.ndarray:
    rgb = np.asarray(Image.open(path).convert("RGB"), np.int32)
    d = ((rgb[..., None, :] - VIRIDIS_LUT.astype(np.int32)[None, None]) ** 2).sum(-1)
    return d.argmin(-1)


def test_gen_specs_cpu_matches_jax_cli(corpus, capsys):
    manifest, wav_dir, root = corpus
    out_t, out_j = str(root / "port"), str(root / "jax")
    n_t = tgen.run(manifest, wav_dir, out_t, batch_size=2, save_npy=True, device="cpu")
    printed = capsys.readouterr().out
    assert "gen_specs: decode" in printed and "wrote 11 spectrograms" in printed
    n_j = jgen.run(manifest, wav_dir, out_j, batch_size=2, save_npy=True)
    assert n_t == n_j == 11  # 2×3 + stereo + 2 at 48 kHz + short + 8-bit; missing and broken skipped
    files = sorted(os.listdir(out_t))
    assert files == sorted(os.listdir(out_j))
    assert "rec0.wav_1_1.png" in files and "hires.wav_1_1.npy" in files

    wav, sr = jwavio.load_wav(os.path.join(wav_dir, "eightbit.wav"))
    oracle = reference_logmel_np(jwavio.slice_clip(wav, sr, 1, 4), SpectrogramConfig())
    np.testing.assert_allclose(np.load(os.path.join(out_t, "eightbit.wav_1_1.npy")), oracle, atol=5e-3)
    jax_8bit = np.load(os.path.join(out_j, "eightbit.wav_1_1.npy"))
    if native_available():  # the JAX CLI decoded with native/wav_batch.cpp: silence
        assert np.ptp(jax_8bit) < 1e-3
    else:  # its scipy fallback, load_wav
        np.testing.assert_allclose(jax_8bit, oracle, atol=5e-3)
    for name in files:
        if name.startswith("eightbit"):
            continue
        if name.endswith(".npy"):
            got, want = np.load(os.path.join(out_t, name)), np.load(os.path.join(out_j, name))
            assert got.shape == want.shape == (256, 256)
            np.testing.assert_allclose(got, want, atol=5e-3)
        else:
            idx_t, idx_j = _viridis_index(os.path.join(out_t, name)), _viridis_index(os.path.join(out_j, name))
            assert idx_t.shape == (256, 256) and np.abs(idx_t - idx_j).max() <= 1, name

    # skip_existing: nothing new; without it, everything again
    assert tgen.run(manifest, wav_dir, out_t, batch_size=2, device="cpu") == 0
    assert tgen.run(manifest, wav_dir, out_t, batch_size=4, skip_existing=False, limit=3, device="cpu") == 3


def test_gen_specs_main_high_rung_and_device_flag(corpus, monkeypatch):
    manifest, wav_dir, root = corpus
    out = str(root / "main_high")
    tgen.main(["--manifest", manifest, "--wav_dir", wav_dir, "--out_dir", out, "--exact", "high",
               "--device", "cpu", "--limit", "4"])
    assert sorted(os.listdir(out)) == sorted(
        spec_png_name(r["file_name"], r["begin_time"]) for r in read_detection_manifest(manifest, 4))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgen.main(["--manifest", manifest, "--wav_dir", wav_dir, "--out_dir", str(root / "none")])
    assert not os.path.exists(str(root / "none"))


def test_manifest_rows_and_names_match_pandas(corpus):
    import pandas as pd

    manifest, _, _ = corpus
    rows = read_detection_manifest(manifest)
    df = pd.read_csv(manifest)
    assert [r["file_name"] for r in rows] == list(df["file_name"])
    assert [spec_png_name(r["file_name"], r["begin_time"]) for r in rows] == [
        spec_png_name(r["file_name"], r["begin_time"]) for _, r in df.iterrows()]
    assert rows[1]["begin_time"] == 1.5 and rows[1]["confidence"] == "0.9"
    assert len(read_detection_manifest(manifest, limit=2)) == 2


@pytest.mark.parametrize("name", ["rec0.wav", "stereo.wav", "hires.wav", "short.wav"])
def test_wav_loading_and_slicing_match_jax(corpus, name):
    _, wav_dir, _ = corpus
    path = os.path.join(wav_dir, name)
    (wav, sr), (want, want_sr) = twavio.load_wav(path), jwavio.load_wav(path)
    assert sr == want_sr and wav.dtype == want.dtype == np.float32 and np.array_equal(wav, want)
    for begin, end in ((0, 3), (1.5, 4), (5, 9), (0, 2)):
        assert np.array_equal(twavio.slice_clip(wav, sr, begin, end), jwavio.slice_clip(want, sr, begin, end))
