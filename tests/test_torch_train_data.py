"""The port's training data path and trainer CLI on the CPU, against the JAX package.

The image-folder index stream, the PNG reader (against PIL through the JAX
package's ``load_image_grayscale``), the latent cache (against the JAX
task's ``make_encoder``), exact resume, and ``cli.train_ddpm.run`` end to end
on a tiny folder, serving its checkpoint through ``cli.common.load_task``.
"""

import dataclasses
import io
import json
import os
import struct
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

from spectrogramgenai_tpu.audio.export import load_image_grayscale as jax_load_image_grayscale  # noqa: E402
from spectrogramgenai_tpu.core import config as jc  # noqa: E402
from spectrogramgenai_tpu.core.mesh import MeshSpec, create_mesh  # noqa: E402
from spectrogramgenai_tpu.data.latent_cache import LatentCacheSource as JaxLatentCacheSource  # noqa: E402
from spectrogramgenai_tpu.data.pipeline import ImageFolderSource as JaxImageFolderSource  # noqa: E402
from spectrogramgenai_tpu.models.vqvae import VQVAE as JaxVQVAE  # noqa: E402
from spectrogramgenai_tpu.train.diffusion_task import DiffusionTask as JaxTask  # noqa: E402
from spectrogramgenai_tpu_torch.audio.export import encode_png_rgb, load_image_grayscale  # noqa: E402
from spectrogramgenai_tpu_torch.bridge import state_dict_from_flax  # noqa: E402
from spectrogramgenai_tpu_torch.core import config as tc  # noqa: E402
from spectrogramgenai_tpu_torch.core.checkpoint import CheckpointManager  # noqa: E402
from spectrogramgenai_tpu_torch.data.latent_cache import LatentCacheSource  # noqa: E402
from spectrogramgenai_tpu_torch.data.pipeline import (  # noqa: E402
    ImageFolderSource,
    device_prefetch,
    iterate_batches,
)
from spectrogramgenai_tpu_torch.models.vqvae import VQVAE  # noqa: E402
from spectrogramgenai_tpu_torch.train.diffusion_task import DiffusionTask  # noqa: E402
from torch_port_helpers import one_torch_thread, random_flax_variables  # noqa: E402, F401


def _folder(root, counts: dict[str, int], size: int = 32, seed: int = 0):
    """Grayscale PNGs written by PIL under root/<class>/."""
    rng = np.random.default_rng(seed)
    for cls, n in counts.items():
        d = root / cls
        d.mkdir(parents=True)
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (size, size), dtype=np.uint8)).save(d / f"{i:03d}.png")
    return str(root)


# -- the index stream -------------------------------------------------------------

@pytest.mark.parametrize("bootstrap", [True, False])
def test_epoch_indices_match_jax_over_three_epochs(tmp_path, bootstrap):
    root = _folder(tmp_path, {"ant": 3, "bee": 7, "cat": 5}, size=8)
    jsrc = JaxImageFolderSource(root, bootstrap_balance=bootstrap, seed=11)
    src = ImageFolderSource(root, bootstrap_balance=bootstrap, seed=11)
    assert src.paths == jsrc.paths and src.classes == jsrc.classes
    np.testing.assert_array_equal(src.labels, jsrc.labels)
    for _ in range(3):
        np.testing.assert_array_equal(src.epoch_indices(), jsrc.epoch_indices())


def test_batches_skip_and_cache(tmp_path):
    root = _folder(tmp_path, {"ant": 4, "bee": 4}, size=16)
    src = ImageFolderSource(root, seed=0, cache_decoded=True)
    full = list(iterate_batches(src, 3, epochs=2))
    src = ImageFolderSource(root, seed=0, cache_decoded=True)
    resumed = list(iterate_batches(src, 3, epochs=2, skip_batches=3))
    assert len(full) == 4 and len(resumed) == 1  # 8 images → 2 full batches per epoch
    np.testing.assert_array_equal(resumed[0]["image"], full[3]["image"])
    np.testing.assert_array_equal(resumed[0]["label"], full[3]["label"])
    assert full[0]["image"].shape == (3, 16, 16, 1) and full[0]["image"].dtype == np.float32
    moved = list(device_prefetch(iter(full[:2]), torch.device("cpu")))
    assert torch.equal(moved[1]["image"], torch.from_numpy(full[1]["image"]))


# -- the PNG reader ---------------------------------------------------------------

def _png_with_filter(pixels: np.ndarray, colour: int, kind: int) -> bytes:
    """An 8-bit PNG whose every row uses filter ``kind`` (0 None … 4 Paeth)."""
    h, w, bpp = pixels.shape
    x = pixels.reshape(h, w * bpp).astype(np.int32)
    rows = []
    for y in range(h):
        up = x[y - 1] if y else np.zeros(w * bpp, np.int32)
        left = np.concatenate([np.zeros(bpp, np.int32), x[y, :-bpp]])
        up_left = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) >> 1
        else:
            p = left + up - up_left
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, up_left))
        rows.append(bytes([kind]) + ((x[y] - pred) & 0xFF).astype(np.uint8).tobytes())

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


def _both(path):
    got, want = load_image_grayscale(str(path)), jax_load_image_grayscale(str(path))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_png_reader_is_bit_equal_to_pil(tmp_path, mode):
    rng = np.random.default_rng(1)
    smooth = np.linspace(0, 255, 37 * 29).reshape(29, 37)  # PIL picks varied filters for this
    noise = rng.integers(0, 40, (29, 37, 4))
    px = np.clip(smooth[..., None] + noise, 0, 255).astype(np.uint8)
    if mode == "P":
        im = Image.fromarray(px[..., :3]).quantize(50)
    else:
        arr = px[..., :{"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]]
        im = Image.fromarray(arr[..., 0] if mode == "L" else arr, mode)
    for opts in ({}, {"optimize": True}, {"compress_level": 0}):
        path = tmp_path / f"{mode}_{len(opts)}_{list(opts)}.png"
        im.save(path, **opts)
        _both(path)


@pytest.mark.parametrize("colour, bpp", [(0, 1), (2, 3), (4, 2), (6, 4)])
def test_png_reader_every_filter_type(tmp_path, colour, bpp):
    px = np.random.default_rng(colour).integers(0, 256, (13, 11, bpp), dtype=np.uint8)
    for kind in range(5):
        path = tmp_path / f"c{colour}_f{kind}.png"
        path.write_bytes(_png_with_filter(px, colour, kind))
        _both(path)


def test_png_reader_reads_the_ports_own_pngs(tmp_path):
    rgb = np.random.default_rng(2).integers(0, 256, (64, 48, 3), dtype=np.uint8)
    path = tmp_path / "port.png"
    path.write_bytes(encode_png_rgb(rgb))
    _both(path)


@pytest.mark.parametrize("case", ["16-bit", "interlaced", "not-png"])
def test_png_reader_rejects_other_encodings(tmp_path, case):
    path = tmp_path / "x.png"
    if case == "16-bit":
        Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000).save(path)
    elif case == "interlaced":
        buf = io.BytesIO()
        Image.fromarray(np.zeros((8, 8), np.uint8)).save(buf, format="PNG")
        data = bytearray(buf.getvalue())
        data[28] = 1  # IHDR interlace method → Adam7
        path.write_bytes(bytes(data))
    else:
        path.write_bytes(b"GIF89a")
    with pytest.raises(ValueError):
        load_image_grayscale(str(path))


# -- latent cache -----------------------------------------------------------------

def test_latent_cache_matches_jax_encoder(tmp_path):
    root = _folder(tmp_path, {"ant": 3, "bee": 2}, size=128)
    jvq = JaxVQVAE(hidden_dim=32, n_embeddings=32)
    vq_vars = random_flax_variables(jvq, jnp.zeros((1, 128, 128, 1)), seed=1)
    kw = dict(img_size=128, num_classes=2, width_mult=0.125, remove_deep_conv=True, vq_hidden_dim=32,
              vq_n_embeddings=32, compute_dtype="float32")
    mesh = create_mesh(MeshSpec(data=1, model=1), devices=jax.devices()[:1])
    jt = JaxTask(jc.DDPMConfig(**kw), mesh, total_steps=1, vq_variables=vq_vars, vqvae=jvq)
    want = JaxLatentCacheSource(JaxImageFolderSource(root, seed=3, img_size=128), jt.make_encoder(),
                                encode_batch=4)
    vq_sd = state_dict_from_flax(VQVAE(hidden_dim=32, n_embeddings=32), vq_vars)
    task = DiffusionTask(tc.DDPMConfig(**kw), "cpu", vq_params=vq_sd)
    got = LatentCacheSource(ImageFolderSource(root, seed=3, img_size=128), task.make_encoder(),
                            torch.device("cpu"), encode_batch=4)
    assert got.latents.shape == want.latents.shape == (5, 32, 32, 4)
    # f32 convolutions in another order
    np.testing.assert_allclose(got.latents, want.latents, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.epoch_indices(), want.epoch_indices())
    np.testing.assert_array_equal(got.load_batch(np.array([4, 0]))["latent"], got.latents[[4, 0]])


def test_metrics_logger_writes_what_the_jax_logger_writes(tmp_path):
    from spectrogramgenai_tpu.core.metrics import MetricsLogger as JaxMetricsLogger
    from spectrogramgenai_tpu_torch.core.metrics import MetricsLogger

    for name, cls in (("jax", JaxMetricsLogger), ("port", MetricsLogger)):
        with cls(str(tmp_path / name), csv_name="runs.csv", csv_columns=["epoch", "acc"]) as logger:
            logger.log(3, epoch=1, train_mse=np.float32(0.5))
            logger.log_csv_row({"epoch": 1, "acc": 0.25, "other": 9})
            logger.log_csv_row({"epoch": 2})
            assert logger.log_images(3, {"x": np.zeros((2, 2))}) is False
            assert logger.log_artifact(str(tmp_path)) is False
    assert (tmp_path / "port" / "runs.csv").read_text() == (tmp_path / "jax" / "runs.csv").read_text()
    (rec,) = [json.loads(line) for line in open(tmp_path / "port" / "metrics.jsonl")]
    assert {k: v for k, v in rec.items() if k != "time"} == {"step": 3, "epoch": 1, "train_mse": 0.5}


# -- resume and the CLI -----------------------------------------------------------

PIXEL_KW = dict(img_size=16, latent=False, num_classes=3, noise_steps=50, width_mult=0.125,
                remove_deep_conv=True, compute_dtype="float32", ema_start=2)


def test_resume_is_bit_equal(tmp_path):
    rng = np.random.default_rng(5)
    batches = [(torch.from_numpy(rng.uniform(0, 1, (4, 16, 16, 1)).astype(np.float32)),
                torch.from_numpy(rng.integers(0, 3, 4))) for _ in range(4)]
    cfg = tc.DDPMConfig(**PIXEL_KW)

    task = DiffusionTask(cfg, "cpu", total_steps=4)
    straight = task.init_state(0)
    for images, labels in batches:
        straight, _ = task.train_step(straight, images, labels)

    first = DiffusionTask(cfg, "cpu", total_steps=4)
    state = first.init_state(0)
    for images, labels in batches[:2]:
        state, _ = first.train_step(state, images, labels)
    CheckpointManager(str(tmp_path)).save(state.step, state.state_dict())
    second = DiffusionTask(cfg, "cpu", total_steps=4)
    state = second.load_state(second.init_state(1), CheckpointManager(str(tmp_path)).restore())
    assert state.step == 2
    for images, labels in batches[2:]:
        state, _ = second.train_step(state, images, labels)

    assert state.step == straight.step == 4
    for name in ("params", "ema_params"):
        for k, v in getattr(straight, name).items():
            assert torch.equal(getattr(state, name)[k], v), f"{name}.{k}"
    for k, v in straight.opt_state().items():
        assert torch.equal(state.opt_state()[k], v), k
    assert torch.equal(state.generator.get_state(), straight.generator.get_state())


def test_train_step_after_sampling_in_inference_mode():
    # sampling fills the UNet's cached upsampling matrices under
    # torch.inference_mode; a later train step must still be able to use them
    cfg = tc.DDPMConfig(**{**PIXEL_KW, "img_size": 24})
    task = DiffusionTask(cfg, "cpu", total_steps=1)
    state = task.init_state(0)
    task.sample([0, 1], generator=torch.Generator().manual_seed(0), sampler="ddim", num_steps=2)
    state, m = task.train_step(state, torch.rand(2, 24, 24, 1), torch.tensor([0, 2]))
    assert torch.isfinite(m["train_mse"]) and state.step == 1


def test_train_cli_runs_resumes_and_serves(tmp_path, monkeypatch, capsys):
    from spectrogramgenai_tpu_torch.cli import train_ddpm
    from spectrogramgenai_tpu_torch.cli.common import load_task

    monkeypatch.chdir(tmp_path)
    for split, n in (("train", 4), ("val", 2)):
        rng = np.random.default_rng(len(split))
        for c in ("ant", "bee", "cat"):
            d = tmp_path / "datasets" / split / c
            d.mkdir(parents=True)
            for i in range(n):
                (d / f"{i}.png").write_bytes(encode_png_rgb(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)))
    vq = VQVAE(hidden_dim=16, n_embeddings=16).reset_parameters(torch.Generator().manual_seed(1))
    CheckpointManager("models/vq").save(0, {"params": vq.state_dict()})
    cfg = tc.DDPMConfig(img_size=32, num_classes=3, noise_steps=50, width_mult=0.125, remove_deep_conv=True,
                        vq_hidden_dim=16, vq_n_embeddings=16, compute_dtype="float32", vqae_ckpt="models/vq",
                        epochs=2, log_every_epoch=1,
                        data=tc.DataConfig(dataset_path="datasets", img_size=32, batch_size=4),
                        run=tc.RunConfig(run_name="tiny", seed=0, log_every=1, ckpt_every_epochs=1))

    state = train_ddpm.run(cfg, device="cpu")
    assert state.step == 6  # 12 images, batch 4, 2 epochs
    out = capsys.readouterr().out
    assert "latent cache: 12 images encoded" in out and "epoch 1: 3 steps" in out
    records = [json.loads(line) for line in open("results/tiny/metrics.jsonl")]
    assert [r["step"] for r in records if "train_mse" in r] == [1, 2, 3, 4, 5, 6]
    assert sum("val_mse" in r for r in records) == 2
    assert sorted(os.listdir("results/tiny/samples_epoch_0001")) == [f"class_{i:02d}.png" for i in range(3)]
    saved = CheckpointManager("models/tiny").restore()
    assert set(saved) == {"params", "ema_params", "opt_state", "step", "rng"} and int(saved["step"]) == 6

    task = load_task(cfg, torch.device("cpu"))  # serving reads the training checkpoint unchanged
    for k, v in task.model.state_dict().items():
        assert torch.equal(v, state.params[k])
    assert task.sample([0, 2], generator=torch.Generator().manual_seed(0), sampler="ddim",
                       num_steps=2).shape == (2, 32, 32, 1)

    state = train_ddpm.run(dataclasses.replace(cfg, epochs=3), device="cpu")
    assert "resumed from step 6" in capsys.readouterr().out and state.step == 9


def test_train_cli_without_a_card_refuses_cuda():
    from spectrogramgenai_tpu_torch.cli import train_ddpm

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_ddpm.main(["--device", "cuda"])
