"""The port's FAD harness, its CLI and ``verify_metrics`` against the JAX package, on the CPU.

``mel_statistics_embeddings`` (the exact mel kernel's plain version, float64
sums) against JAX's float32 log-mel within 1e-3 dB; ``fad_score`` and
``load_embeddings`` (a directory of ``.npy``, a ``.npz``, a ``.npy``) against
JAX's; ``embeddings_for_dir``'s refusals; the CLIs' printed lines and
refusals against JAX's through the same flags. ``verify_metrics.run`` scores
IS, FID and CLAP-FAD from a weights directory of flax-written files (random
weights; the HTSAT-tiny tower at its full width), and JAX's ``run`` on the
same directories gives the same scores.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from flax import serialization  # noqa: E402
from scipy.io import wavfile  # noqa: E402

from spectrogramgenai_tpu.cli import fad as jfad_cli  # noqa: E402
from spectrogramgenai_tpu.cli import verify_metrics as jverify  # noqa: E402
from spectrogramgenai_tpu.eval import clap as jclap  # noqa: E402
from spectrogramgenai_tpu.eval import fad as jfad  # noqa: E402
from spectrogramgenai_tpu.eval import inception as jinc  # noqa: E402
from spectrogramgenai_tpu_torch.audio.export import encode_png_rgb  # noqa: E402
from spectrogramgenai_tpu_torch.cli import fad as tfad_cli  # noqa: E402
from spectrogramgenai_tpu_torch.cli import verify_metrics as tverify  # noqa: E402
from spectrogramgenai_tpu_torch.cli.inception_score import load_images  # noqa: E402
from spectrogramgenai_tpu_torch.eval import fad as tfad  # noqa: E402
from spectrogramgenai_tpu_torch.eval import inception as tinc  # noqa: E402
from torch_port_helpers import one_torch_thread, random_flax_variables  # noqa: E402, F401

# dB statistics (mean and std over time of each mel row) against JAX's float32 log-mel
DB_TOL = 1e-3


def _clips(seed: int, n: int, sr: int, seconds: float = 2.0) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    out = []
    for i in range(n):
        f0 = rng.uniform(500, 6000)
        x = 0.4 * np.sin(2 * np.pi * (f0 * t + 300 * t**2)) + 0.05 * rng.standard_normal(t.size)
        out.append(x[: len(t) - 97 * i].astype(np.float32))  # unequal lengths: cut to the shortest
    return out


def _wav_dir(root, seed: int, n: int = 3, sr: int = 22050) -> str:
    os.makedirs(root)
    for i, x in enumerate(_clips(seed, n, sr)):
        wavfile.write(os.path.join(root, f"clip_{i}.wav"), sr, (x * 32767).astype(np.int16))
    return str(root)


def test_mel_statistics_match_jax():
    wavs = _clips(0, 5, 48000)
    want = jfad.mel_statistics_embeddings(wavs, 48000, batch=2)
    got = tfad.mel_statistics_embeddings(wavs, 48000, batch=2, device="cpu")
    assert got.shape == want.shape == (5, 512) and got.dtype == np.float32
    assert np.abs(got - want).max() <= DB_TOL


def test_fad_score_and_load_embeddings_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    a, b = rng.normal(size=(40, 8)), rng.normal(size=(40, 8)) + 0.5
    assert tfad.fad_score(a, b) == jfad.fad_score(a, b) and tfad.fad_score(a, b) > 0.5
    assert tfad.fad_score(a, a) == jfad.fad_score(a, a) == 0.0  # clamped at 0
    os.makedirs(tmp_path / "dir")
    for i in (2, 0, 1):
        np.save(tmp_path / "dir" / f"e{i}.npy", a[i])
    np.savez(tmp_path / "m.npz", first=a, second=b)
    np.save(tmp_path / "m.npy", b)
    for path in (tmp_path / "dir", tmp_path / "m.npz", tmp_path / "m.npy"):
        np.testing.assert_array_equal(tfad.load_embeddings(str(path)), jfad.load_embeddings(str(path)))
    np.testing.assert_array_equal(tfad.load_embeddings(str(tmp_path / "dir")), a[:3])


def test_embeddings_for_dir_refusals(tmp_path):
    d = _wav_dir(tmp_path / "w", seed=2, n=2)
    for mode, kw, match in (("clap", {}, "needs --clap_ckpt"),
                            ("clap", {"clap_ckpt": "x.msgpack", "target_sr": 22050}, "requires sample_rate=48000"),
                            ("nope", {}, "unknown embedding mode")):
        with pytest.raises(ValueError, match=match) as texc:
            tfad.embeddings_for_dir(d, mode, device="cpu", **kw)
        with pytest.raises(ValueError) as jexc:
            jfad.embeddings_for_dir(d, mode, **kw)
        assert str(texc.value) == str(jexc.value)
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError, match="no wav files"):
        tfad.embeddings_for_dir(str(tmp_path / "empty"), device="cpu")


def test_fad_cli_lines_match_jax(tmp_path, capsys):
    bg, ev = _wav_dir(tmp_path / "bg", seed=3), _wav_dir(tmp_path / "ev", seed=4)
    lines = {}
    for name, main, extra in (("jax", jfad_cli.main, []), ("port", tfad_cli.main, ["--device", "cpu"])):
        main(["--background_dir", bg, "--eval_dir", ev, *extra])
        mel = capsys.readouterr()
        main(["--background_dir", bg, "--eval_dir", bg, *extra])
        self_line = capsys.readouterr().out
        np.save(tmp_path / "a.npy", np.random.default_rng(5).normal(size=(30, 4)))
        np.save(tmp_path / "b.npy", np.random.default_rng(6).normal(size=(30, 4)))
        main(["--background_emb", str(tmp_path / "a.npy"), "--eval_emb", str(tmp_path / "b.npy"), *extra])
        lines[name] = (mel.out, mel.err, self_line, capsys.readouterr().out)
        with pytest.raises(SystemExit):
            main(["--background_dir", bg, *extra])
        assert "need either --background_dir/--eval_dir or --background_emb/--eval_emb" in capsys.readouterr().err
    (jmel, jerr, jself, jemb), (tmel, terr, tself, temb) = lines["jax"], lines["port"]
    assert terr == jerr and terr.startswith("WARNING: --mode mel is a framework-native embedding")
    assert temb == jemb
    assert tself == jself == "FAD (mel embeddings (relative comparisons only — not CLAP-comparable)): 0.000000\n"
    prefix = "FAD (mel embeddings (relative comparisons only — not CLAP-comparable)): "
    assert tmel.startswith(prefix) and jmel.startswith(prefix)
    # the mel-statistics FAD (units of dB²) to the printed precision, and within the embeddings' tolerance
    assert abs(float(tmel[len(prefix):]) - float(jmel[len(prefix):])) <= 1e-3 * float(jmel[len(prefix):]) + 1e-5


def _weights_dir(root, images_u8: np.ndarray) -> str:
    """inception_v3.msgpack and clap_audio.msgpack of random JAX weights, and a
    manifest. The random net's features differ by ~0.3 % between images, so
    its ``fc`` is recentred on the mean feature of ``images_u8`` and scaled
    by 30000: the softmax is then far from flat, and the Inception Score
    depends on which images reach it."""
    os.makedirs(root)
    inc = random_flax_variables(jinc.InceptionV3(), jnp.zeros((1, 75, 75, 3)), seed=0)
    with torch.no_grad():
        feats = tinc.build_inception(inc, "cpu")(tinc.inception_inputs(images_u8, "cpu"), return_features=True)
    kernel = inc["params"]["fc"]["kernel"] * 30000
    inc["params"]["fc"] = {"kernel": kernel, "bias": -(feats.mean(0).double().numpy() @ kernel)}
    (root / "inception_v3.msgpack").write_bytes(serialization.to_bytes(inc))
    clap = random_flax_variables(jclap.ClapAudioTower(), jnp.zeros((1, 1, 1001, 64)), seed=1)
    (root / "clap_audio.msgpack").write_bytes(serialization.to_bytes(clap))
    (root / "manifest.json").write_text('{"inception_v3": {"sha256": "0123456789abcdef", "verified": false, '
                                        '"max_abs_forward_err": null}}')
    return str(root)


def test_verify_metrics_refuses_as_jax_and_scores(tmp_path, capsys):
    # real: smooth vertical gradients; generated: uniform noise, so IS differs between the two sets
    for name, draw in (("real", lambda rng: np.cumsum(rng.integers(0, 9, (40, 40, 3)), axis=0)),
                       ("gen", lambda rng: rng.integers(0, 256, (40, 40, 3)))):
        rng = np.random.default_rng(len(name))
        os.makedirs(tmp_path / name)
        for i in range(2):
            with open(tmp_path / name / f"{i}.png", "wb") as f:
                f.write(encode_png_rgb(draw(rng).astype(np.uint8)))
    real, gen = str(tmp_path / "real"), str(tmp_path / "gen")
    with pytest.raises(SystemExit) as jexit:
        jverify.run(real, gen, str(tmp_path / "none"))
    with pytest.raises(SystemExit) as texit:
        tverify.run(real, gen, str(tmp_path / "none"), device="cpu")
    assert str(texit.value) == str(jexit.value) and "--allow_random_weights 1" in str(texit.value)

    weights = _weights_dir(tmp_path / "eval", np.concatenate([load_images(real), load_images(gen)]))
    bg = _wav_dir(tmp_path / "bg", seed=7, n=2)
    ev = _wav_dir(tmp_path / "ev", seed=8, n=2)
    results = tverify.main(["--real_dir", real, "--gen_dir", gen, "--weights_dir", weights, "--splits", "1",
                            "--real_audio_dir", bg, "--gen_audio_dir", ev, "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "inception_v3: sha256=0123456789ab… verified=False max_abs_err=None"
    assert out[1] == f"Inception Score (gen, n=2): {results['inception_score_mean']:.4f} ± 0.0000"
    assert out[2] == f"FID (real vs gen, n=2/2): {results['fid']:.4f}"
    assert out[3] == f"FAD (CLAP): {results['fad']:.6f}"
    assert results["inception_score_mean"] >= 1.0 and results["fid"] >= 0 and results["fad"] >= 0
    assert all(np.isfinite(v) for v in results.values())
    # JAX's run on the same directories and weights: the same images and clips reach each metric.
    # Relative error of IS 1.033 (reading 3.2e-6; IS of the real images instead reads 1.005),
    # FID 2.5e-5 (reading 2.2e-5) and CLAP-FAD 3.1e-3 (reading 2.7e-8).
    want = jverify.run(real, gen, weights, real_audio_dir=bg, gen_audio_dir=ev, splits=1)
    assert capsys.readouterr().out.splitlines()[0] == out[0]
    for key, tol in (("inception_score_mean", 3e-5), ("fid", 2e-4), ("fad", 1e-6)):
        assert abs(results[key] - want[key]) <= tol * abs(want[key]), (key, results[key], want[key])
