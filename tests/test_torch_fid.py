"""The port's classifier-feature FID path against the JAX package, on the CPU.

PIL's BILINEAR and BICUBIC resize of uint8 images and ``load_images`` are
held bit-equal to Pillow and to JAX's ``load_images``; the FID and IS
statistics to JAX's NumPy functions; ``classifier_features`` to JAX's on one
checkpoint of the custom classifier (256×256, five classes, random weights
carried across by ``bridge.py``), in float32 and in bf16;
``tools/port_fid_batch.py`` to ``tools/fid_batch.py``.
"""

import functools
import os
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

from spectrogramgenai_tpu.cli import fid as jfid  # noqa: E402
from spectrogramgenai_tpu.cli.inception_score import load_images as jax_load_images  # noqa: E402
from spectrogramgenai_tpu.core import config as jc  # noqa: E402
from spectrogramgenai_tpu.core.checkpoint import CheckpointManager as JaxCheckpointManager  # noqa: E402
from spectrogramgenai_tpu.core.mesh import MeshSpec, create_mesh  # noqa: E402
from spectrogramgenai_tpu.eval import inception as jinc  # noqa: E402
from spectrogramgenai_tpu.train.classifier_task import ClassifierTask as JaxClassifierTask  # noqa: E402
from spectrogramgenai_tpu_torch.audio.export import encode_png_rgb, pil_resize, spectrogram_rgb  # noqa: E402
from spectrogramgenai_tpu_torch.bridge import state_dict_from_flax  # noqa: E402
from spectrogramgenai_tpu_torch.cli import fid as tfid  # noqa: E402
from spectrogramgenai_tpu_torch.cli.inception_score import load_images  # noqa: E402
from spectrogramgenai_tpu_torch.core.checkpoint import CheckpointManager  # noqa: E402
from spectrogramgenai_tpu_torch.eval import inception as tinc  # noqa: E402
from spectrogramgenai_tpu_torch.models import classifiers as tm  # noqa: E402
from torch_port_helpers import one_torch_thread, random_flax_variables  # noqa: E402, F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_CLASSES = 5
# the custom CNN's logits (|x| ≤ 0.40) at 256×256 against JAX's, absolute:
# float32 sums in another order (reading 3.0e-7), bf16 products (2.4e-3)
FEAT_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


@pytest.mark.parametrize("kind", ["bilinear", "bicubic"])
@pytest.mark.parametrize("src,dst,channels", [((256, 256), (299, 299), 3), ((299, 299), (256, 256), 1),
                                              ((37, 50), (20, 81), 3), ((64, 17), (64, 5), 1),
                                              ((5, 90), (33, 90), 1)])
def test_resize_bit_equal_to_pillow(kind, src, dst, channels):
    rng = np.random.default_rng(hash((kind, src, dst)) % 2**32)
    shape = src if channels == 1 else (*src, 3)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize(dst[::-1], {"bilinear": Image.BILINEAR,
                                                              "bicubic": Image.BICUBIC}[kind]))
    np.testing.assert_array_equal(pil_resize(img, dst[::-1], kind), want)


def _spectrogram_pngs(root, n: int, seed: int, size: int = 256) -> None:
    """``n`` viridis PNGs of smooth random spectrograms under ``root``, some of
    them written by PIL as gray, palette or RGBA images."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    base = np.cumsum(rng.standard_normal((n, size, size)), axis=2)
    rgb = spectrogram_rgb(base + 5 * np.sin(np.arange(size) / (3 + seed))[None, :, None])
    for i, im in enumerate(rgb):
        path = os.path.join(root, f"img_{i:02d}.png")
        kind = i % 4
        if kind == 0:
            with open(path, "wb") as f:
                f.write(encode_png_rgb(im))
        else:
            pil = Image.fromarray(im)
            pil = {1: pil.convert("L"), 2: pil.quantize(200), 3: pil.convert("RGBA")}[kind]
            pil.save(path)


def test_load_images_bit_equal_to_jax(tmp_path):
    _spectrogram_pngs(tmp_path / "tree" / "train" / "a", 2, seed=1)
    _spectrogram_pngs(tmp_path / "tree" / "val" / "b", 4, seed=2, size=200)
    (tmp_path / "tree" / "notes.txt").write_text("not an image")
    for limit in (None, 4):
        want = jax_load_images(str(tmp_path / "tree"), limit)
        got = load_images(str(tmp_path / "tree"), limit)
        assert got.shape == want.shape == ((6 if limit is None else 4), 299, 299, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    with pytest.raises(FileNotFoundError):
        load_images(str(tmp_path / "empty_dir_that_is_missing"))


def test_statistics_equal_to_jax():
    rng = np.random.default_rng(3)
    f1 = rng.standard_normal((60, 7)) @ rng.standard_normal((7, 7))
    f2 = rng.standard_normal((50, 7)) + 0.5
    for a, b in ((f1, f2), (f1, f1), (f1[:4], f2[:5])):  # the last: singular covariances
        (mu1, s1), (mu2, s2) = tinc.gaussian_statistics(a), tinc.gaussian_statistics(b)
        (jmu1, js1), (jmu2, js2) = jinc.gaussian_statistics(a), jinc.gaussian_statistics(b)
        for got, want in ((mu1, jmu1), (s1, js1), (mu2, jmu2), (s2, js2)):
            np.testing.assert_array_equal(got, want)
        assert tinc.frechet_distance(mu1, s1, mu2, s2) == jinc.frechet_distance(mu1, s1, mu2, s2)
    assert abs(tinc.frechet_distance(*tinc.gaussian_statistics(f1), *tinc.gaussian_statistics(f1))) < 1e-6
    probs = rng.dirichlet(np.ones(10), 95)
    assert tinc.inception_score(probs, splits=10) == jinc.inception_score(probs, splits=10)
    assert tinc.inception_score(probs[:3], splits=10) == jinc.inception_score(probs[:3], splits=10)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """One random custom classifier saved as a JAX checkpoint and, bridged, as a port one."""
    root = tmp_path_factory.mktemp("ckpt")
    cfg = jc.ClassifierConfig(num_classes=N_CLASSES, compute_dtype="float32")
    task = JaxClassifierTask(cfg, create_mesh(MeshSpec(data=1, model=1), devices=jax.devices()[:1]))
    state = task.init_state(img_size=256)
    variables = random_flax_variables(task.model, jnp.zeros((1, 256, 256, 1)), seed=4)
    state = state.replace(params=variables["params"], stats={k: v for k, v in variables.items() if k != "params"})
    JaxCheckpointManager(str(root / "jax")).save(0, state, best=True)
    with torch.device("meta"):
        tmodel = tm.build_classifier("custom", N_CLASSES, img_size=256)
    # a port checkpoint with no best/ mirror: the latest one stands in
    CheckpointManager(str(root / "port")).save(0, {"params": state_dict_from_flax(tmodel, variables)})
    return root


def _images(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    base = np.cumsum(rng.standard_normal((n, 299, 299)), axis=2)
    return spectrogram_rgb(base)


def _args(ckpt, dtype="bfloat16"):
    return types.SimpleNamespace(classifier_ckpt=str(ckpt), classifier_model="custom", num_classes=N_CLASSES,
                                 compute_dtype=dtype, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_classifier_features_match_jax(checkpoints, monkeypatch, dtype):
    images = _images(6, seed=5)
    monkeypatch.setattr(jc, "ClassifierConfig", functools.partial(jc.ClassifierConfig, compute_dtype=dtype))
    want = jfid.classifier_features(images, _args(checkpoints / "jax"), batch=8)
    got = tfid.classifier_features(images, _args(checkpoints / "port", dtype), batch=4)
    assert got.shape == want.shape == (6, N_CLASSES) and got.dtype == np.float32
    assert np.abs(got - want).max() <= FEAT_TOL[dtype]


def test_fid_batch_tool_matches_jax(checkpoints, tmp_path, monkeypatch, capsys):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import fid_batch
    import port_fid_batch

    _spectrogram_pngs(tmp_path / "real" / "a", 6, seed=6)
    _spectrogram_pngs(tmp_path / "gen", 7, seed=7)
    pairs = [f"floor:{tmp_path / 'real'}:{tmp_path / 'gen'}", f"self:{tmp_path / 'gen'}:{tmp_path / 'gen'}"]
    common = ["--classifier_model", "custom", "--num_classes", str(N_CLASSES), "--limit", "6"]
    # both in float32: the JAX classifier config's compute dtype patched
    monkeypatch.setattr(jc, "ClassifierConfig", functools.partial(jc.ClassifierConfig, compute_dtype="float32"))
    assert fid_batch.main(["--classifier_ckpt", str(checkpoints / "jax"), *common, *pairs]) == 0
    jax_out = capsys.readouterr().out
    assert port_fid_batch.main(["--classifier_ckpt", str(checkpoints / "port"), "--compute_dtype", "float32",
                                "--device", "cpu", *common, *pairs]) == 0
    port_out = capsys.readouterr().out

    def fids(text):
        return {line.split("]")[0][4:]: (float(line.split(": ")[1].split()[0]), line.split("(n1=")[1])
                for line in text.splitlines() if line.startswith("FID[")}

    want, got = fids(jax_out), fids(port_out)
    assert set(got) == set(want) == {"floor", "self"}
    assert got["floor"][1] == want["floor"][1] == "6, n2=6)"
    # printed to 4 decimals
    assert got["floor"][0] > 0 and abs(got["floor"][0] - want["floor"][0]) <= 1e-4 * want["floor"][0] + 2e-4
    assert abs(got["self"][0]) <= 1e-4 and abs(want["self"][0]) <= 1e-4
    assert port_out.splitlines()[-1].startswith("features: 12 images in ")
    # a pair that fails is reported, and the exit code says so
    assert port_fid_batch.main(["--classifier_ckpt", str(checkpoints / "port"), "--device", "cpu", *common,
                                f"bad:{tmp_path / 'gen'}:{tmp_path / 'missing'}"]) == 1
    assert "FID[bad:" in capsys.readouterr().out


def test_fid_cli(checkpoints, tmp_path, capsys):
    _spectrogram_pngs(tmp_path / "a", 3, seed=8)
    _spectrogram_pngs(tmp_path / "b", 3, seed=9)
    tfid.main(["--dir1", str(tmp_path / "a"), "--dir2", str(tmp_path / "b"), "--classifier_ckpt",
               str(checkpoints / "port"), "--num_classes", str(N_CLASSES), "--device", "cpu",
               "--compute_dtype", "float32"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("FID (classifier 'custom' logits space): ") and "(n1=3, n2=3)" in line
    assert float(line.split(": ")[1].split()[0]) >= 0
    # the InceptionV3 path: JAX's refusal without weights, a score with the port's random init
    with pytest.raises(SystemExit) as jexit:
        jfid.main(["--dir1", str(tmp_path / "a"), "--dir2", str(tmp_path / "b")])
    with pytest.raises(SystemExit) as texit:
        tfid.main(["--dir1", str(tmp_path / "a"), "--dir2", str(tmp_path / "b"), "--device", "cpu"])
    assert str(texit.value) == str(jexit.value) and "--allow_random_weights 1" in str(texit.value)
    tfid.main(["--dir1", str(tmp_path / "a"), "--dir2", str(tmp_path / "b"), "--allow_random_weights", "1",
               "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0] == "WARNING: random InceptionV3 weights — FID is NOT meaningful"
    assert out[1].startswith("FID: ") and out[1].endswith("  (n1=3, n2=3)") and float(out[1].split()[1]) >= 0
    with pytest.raises(FileNotFoundError):
        tfid.load_classifier(str(tmp_path / "none"), num_classes=N_CLASSES, device="cpu")
