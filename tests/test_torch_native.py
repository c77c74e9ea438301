"""The port's native WAV and PNG codecs (``csrc/wav_batch.cpp``, ``csrc/png_batch.cpp``) on the CPU.

The WAV decoder is held bit for bit to the port's and the JAX package's
``load_wav`` + ``slice_clip`` (8/16/24/32-bit PCM and float32; 1, 2 and 3
channels; 22,050 to 96,000 Hz; windows inside, past the end, short, missing
and broken files), and the JAX native decoder's differences from them are
shown: 8-bit PCM read as silence, a window past the end clamped to the file,
a 96-kHz row cut at 6 s of 48 kHz. The PNG decoder is held to PIL's
``convert("L")`` and the JAX native decoder exactly, with its rejected rows
counted; the encoder's bytes to the JAX native encoder's (the same libz) and
its pixels to the input.
"""

import io
import os
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402
from scipy.io import wavfile  # noqa: E402

from spectrogramgenai_tpu.audio import export as jexport  # noqa: E402
from spectrogramgenai_tpu.audio import wavio as jwavio  # noqa: E402
from spectrogramgenai_tpu.data import native_png as jpng  # noqa: E402
from spectrogramgenai_tpu.data import native_wav as jwav  # noqa: E402
from spectrogramgenai_tpu_torch.audio import export as texport  # noqa: E402
from spectrogramgenai_tpu_torch.audio import wavio as twavio  # noqa: E402
from spectrogramgenai_tpu_torch.data import native_png as tpng  # noqa: E402
from spectrogramgenai_tpu_torch.data.native_wav import load_wav_batch, wav_rates  # noqa: E402
from spectrogramgenai_tpu_torch.ops import _build  # noqa: E402
from torch_port_helpers import one_torch_thread  # noqa: E402, F401

RATES = (22050, 44100, 48000, 96000)
WINDOWS = ((0, 3), (1.5, 4.9), (2, 9), (5, 9), (8, 12), (0, 0), (-1, 2))  # the last three: past the end, short, odd
SECONDS = 7.3


def _pcm24(path, sr: int, x: np.ndarray) -> None:
    """A 24-bit PCM WAV (scipy cannot write one): x (frames, channels) in [-1, 1]."""
    s = np.round(x * (2**23 - 1)).astype(np.int32)
    raw = np.stack([s & 255, (s >> 8) & 255, (s >> 16) & 255], -1).astype(np.uint8).tobytes()
    ch = x.shape[1]
    fmt = struct.pack("<HHIIHH", 1, ch, sr, sr * 3 * ch, 3 * ch, 24)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(raw)) + b"WAVE" + b"fmt " + struct.pack("<I", 16) + fmt
                + b"data" + struct.pack("<I", len(raw)) + raw)


FORMATS = {
    "u8": lambda x: np.round((x + 1) * 127.5).astype(np.uint8),
    "i16": lambda x: np.round(x * 32767).astype(np.int16),
    "i24": None,
    "i32": lambda x: np.round(x * 2147483000).astype(np.int32),
    "f32": lambda x: x.astype(np.float32),
}


def _write(path, fmt: str, sr: int, x: np.ndarray) -> None:
    if fmt == "i24":
        _pcm24(path, sr, x)
    else:
        data = FORMATS[fmt](x)
        wavfile.write(path, sr, data[:, 0] if data.shape[1] == 1 else data)


def _python_rows(paths, windows, reader):
    """load_wav + slice_clip of ``reader`` (a wavio module), None for an unreadable file."""
    rows = []
    for p, (b, e) in zip(paths, windows):
        try:
            wav, sr = reader.load_wav(p)
        except (OSError, ValueError):
            rows.append(None)
            continue
        rows.append((reader.slice_clip(wav, sr, b, e), sr))
    return rows


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_wav_decoder_bit_equal_to_load_wav_and_slice_clip(tmp_path, fmt):
    rng = np.random.default_rng(len(fmt) + ord(fmt[0]))
    paths, windows = [], []
    for sr in RATES:
        for ch in (1, 2, 3):
            path = str(tmp_path / f"{fmt}_{sr}_{ch}.wav")
            _write(path, fmt, sr, rng.uniform(-1, 1, (int(SECONDS * sr), ch)))
            for w in WINDOWS:
                paths.append(path)
                windows.append(w)
    (tmp_path / "broken.wav").write_bytes(b"RIFF0000WAVEjunk")
    paths += [str(tmp_path / "broken.wav"), str(tmp_path / "missing.wav")]
    windows += [(0, 3), (0, 3)]

    clips, rates = load_wav_batch(paths, [w[0] for w in windows], [w[1] for w in windows], 6.0, num_threads=2)
    assert clips.shape == (len(paths), int(6.0 * 96000)) and clips.dtype == np.float32
    port, jax_rows = _python_rows(paths, windows, twavio), _python_rows(paths, windows, jwavio)
    for i, (want, jwant) in enumerate(zip(port, jax_rows)):
        if want is None:
            assert jwant is None and rates[i] == 0 and not clips[i].any(), paths[i]
            continue
        clip, sr = want
        n = int(6.0 * sr)
        assert rates[i] == sr and len(clip) == n, paths[i]
        np.testing.assert_array_equal(clips[i, :n].view(np.int32), clip.view(np.int32),
                                      err_msg=f"{paths[i]} {windows[i]}")
        np.testing.assert_array_equal(jwant[0].view(np.int32), clip.view(np.int32))
        assert not clips[i, n:].any()
    assert list(rates[-2:]) == [0, 0]


def test_wav_decoder_mixes_down_as_numpy_mean(tmp_path):
    # NumPy sums 8 channels and more pairwise (8 accumulators): the decoder follows it
    x = np.random.default_rng(3).standard_normal((22050 * 7, 9)).astype(np.float32) * 1e3
    wavfile.write(tmp_path / "nine.wav", 22050, x)
    clips, rates = load_wav_batch([str(tmp_path / "nine.wav")], [0], [3], 6.0, num_threads=1)
    wav, sr = twavio.load_wav(str(tmp_path / "nine.wav"))
    np.testing.assert_array_equal(clips[0].view(np.int32), twavio.slice_clip(wav, sr, 0, 3).view(np.int32))
    sequential = np.zeros(6 * 22050, np.float32)
    for c in range(9):
        sequential += x[: 6 * 22050, c]
    assert not np.array_equal(clips[0], sequential / np.float32(9))  # not a sequential sum


def test_wav_rates_and_the_jax_decoders_three_differences(tmp_path):
    rng = np.random.default_rng(4)
    eight = str(tmp_path / "eight.wav")
    wavfile.write(eight, 22050, np.round((rng.uniform(-1, 1, 22050 * 7) + 1) * 127.5).astype(np.uint8))
    ten = str(tmp_path / "ten.wav")
    wavfile.write(ten, 22050, (rng.uniform(-1, 1, 22050 * 10) * 32767).astype(np.int16))
    hires = str(tmp_path / "hires.wav")
    wavfile.write(hires, 96000, rng.uniform(-1, 1, 96000 * 7).astype(np.float32))
    paths, begins, ends = [eight, ten, hires], [0, 8, 0], [3, 12, 3]
    assert list(wav_rates(paths + [str(tmp_path / "none.wav")], num_threads=2)) == [22050, 22050, 96000, 0]

    got, rates = load_wav_batch(paths, begins, ends, 6.0, num_threads=2)
    want = _python_rows(paths, list(zip(begins, ends)), twavio)
    for row, (clip, sr) in zip(got, want):
        np.testing.assert_array_equal(row[: len(clip)], clip)
    assert jwav.native_available()
    jgot, jrates = jwav.load_wav_batch(paths, begins, ends, 6.0, int(6.0 * 48000), num_threads=2)
    assert list(jrates) == list(rates) == [22050, 22050, 96000]
    n = 6 * 22050
    # 1. 8-bit PCM: silence in JAX, (u8 − 128) / 128 here
    assert not jgot[0].any() and np.abs(got[0, :n]).max() > 0.9
    # 2. the window (8, 12) of a 10-s file: JAX clamps the end to the file and reads 4–10 s;
    #    slice_clip reads 6–10 s and pads 2 s of zeros
    ten_wav, _ = twavio.load_wav(ten)
    np.testing.assert_array_equal(jgot[1, :n], ten_wav[4 * 22050:])
    np.testing.assert_array_equal(got[1, : 4 * 22050], ten_wav[6 * 22050:])
    assert not got[1, 4 * 22050:n].any()
    # 3. a 96-kHz row: JAX's buffer of 6 s at 48 kHz holds 3 s of it; here the whole 6 s
    assert jgot.shape[1] == 288000 and got.shape[1] == 576000
    np.testing.assert_array_equal(got[2], want[2][0])
    np.testing.assert_array_equal(jgot[2], want[2][0][:288000])


# -- PNG ---------------------------------------------------------------------------

def _pngs(tmp_path, size=(23, 31)):
    rng = np.random.default_rng(5)
    h, w = size
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    paths = []
    for mode in ("RGB", "RGBA", "L", "LA", "P"):
        im = Image.fromarray(rgb).quantize(40) if mode == "P" else Image.fromarray(rgb).convert(mode)
        if mode == "RGBA":
            im.putalpha(Image.fromarray(rng.integers(0, 256, (h, w), dtype=np.uint8)))
        paths.append(str(tmp_path / f"{mode}.png"))
        im.save(paths[-1])
    return paths


def test_png_decoder_equals_pil_and_the_jax_decoder(tmp_path):
    paths = _pngs(tmp_path)
    port_png = str(tmp_path / "port.png")
    texport.save_generated_pngs(np.random.default_rng(6).integers(0, 256, (1, 23, 31), dtype=np.uint8), [port_png])
    paths.append(port_png)
    got, ok = tpng.load_png_batch_gray(paths, 23, 31, num_threads=2)
    jgot, jok = jpng.load_png_batch_gray(paths, 23, 31, num_threads=2)
    assert ok.all() and jok.all()
    for path, row, jrow in zip(paths, got, jgot):
        want = np.asarray(Image.open(path).convert("L"))
        np.testing.assert_array_equal(row, want, err_msg=path)
        np.testing.assert_array_equal(jrow, want)


def test_png_decoder_counts_rejected_rows(tmp_path):
    good = _pngs(tmp_path)[0]
    Image.fromarray((np.arange(23 * 31, dtype=np.uint16).reshape(23, 31) * 90)).save(tmp_path / "deep.png")
    buf = io.BytesIO()
    Image.fromarray(np.zeros((23, 31), np.uint8)).save(buf, format="PNG")
    data = bytearray(buf.getvalue())
    data[28] = 1  # IHDR interlace → Adam7
    (tmp_path / "adam7.png").write_bytes(bytes(data))
    Image.fromarray(np.zeros((20, 31), np.uint8)).save(tmp_path / "small.png")
    (tmp_path / "gif.png").write_bytes(b"GIF89a")
    rejected = ["deep.png", "adam7.png", "small.png", "gif.png", "none.png"]
    paths = [good] + [str(tmp_path / n) for n in rejected]
    tpng.load_png_batch_gray.rejected = 0
    got, ok = tpng.load_png_batch_gray(paths, 23, 31, num_threads=2)
    assert list(ok) == [True] + [False] * 5 and tpng.load_png_batch_gray.rejected == 5
    assert not got[1:].any()


def test_png_encoder_bytes_equal_the_jax_encoder_and_round_trip(tmp_path):
    rgb = np.random.default_rng(7).integers(0, 256, (4, 19, 40, 3), dtype=np.uint8)
    rgb[0] = 0
    got = tpng.encode_png_batch_rgb(rgb, num_threads=2)
    assert got == jpng.encode_png_batch_rgb(rgb, num_threads=2)
    for png, im in zip(got, rgb):
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png)).convert("RGB")), im)
        np.testing.assert_array_equal(texport.decode_png_rgb(png), im)  # the NumPy reader, Sub rows
    paths = [str(tmp_path / f"{i}.png") for i in range(4)]
    tpng.save_png_batch_rgb(rgb, paths, num_threads=2)
    assert [open(p, "rb").read() for p in paths] == got
    with pytest.raises(OSError, match="1 of 1"):
        tpng.save_png_batch_rgb(rgb[:1], [str(tmp_path / "no_dir" / "x.png")])
    with pytest.raises(ValueError, match="uint8"):
        tpng.encode_png_batch_rgb(rgb.astype(np.int16))


def test_spectrogram_and_generated_pngs_equal_the_jax_files(tmp_path):
    rng = np.random.default_rng(8)
    specs = rng.normal(-40, 15, (3, 32, 24)).astype(np.float32)
    names = [f"{i}.png" for i in range(3)]
    texport.save_spectrogram_pngs(specs, [str(tmp_path / "p" / n) for n in names])
    jexport.save_spectrogram_pngs(specs, [str(tmp_path / "j" / n) for n in names], num_threads=2)
    imgs = rng.integers(0, 256, (3, 16, 16, 1), dtype=np.uint8)
    texport.save_generated_pngs(imgs, [str(tmp_path / "p" / f"g{n}") for n in names])
    jexport.save_generated_pngs(imgs, [str(tmp_path / "j" / f"g{n}") for n in names], num_threads=2)
    for n in names + [f"g{n}" for n in names]:  # the same colormap, filter and zlib level: the same bytes
        assert (tmp_path / "p" / n).read_bytes() == (tmp_path / "j" / n).read_bytes(), n


def test_host_sources_build_with_gxx_and_a_failed_build_raises(tmp_path, monkeypatch):
    assert _build.library_path("wav_batch").name.startswith("libwav_batch_")
    assert "-lz" in _build.HOST_LIBS["png_batch"] and "-march=native" not in _build.HOST_FLAGS
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "good.cpp").write_text('extern "C" int answer() { return 42; }\n')
    (csrc / "bad.cpp").write_text("int broken( {\n")
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    _build._compile(["good"])
    import ctypes

    assert ctypes.CDLL(str(_build.library_path("good"))).answer() == 42
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for bad.cpp"):
        _build._compile(["bad"])
    assert not _build.library_path("bad").exists()
    assert [p for p in os.listdir(tmp_path / "_build") if p.endswith(".tmp")] == []
