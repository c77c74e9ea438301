"""The port's serving slice end to end, against the JAX package.

Latent DDPM (bridged weights) → DPM-Solver++ → codebook quantize → VQ
decode → uint8 → viridis PNG → HTTP, on the CPU at a small size: a 32×32
latent (128×128 images), width_mult 0.125, VQ hidden 16 with 16 codes,
3 classes. The schedule has 50 steps, so that with random weights the
latents stay O(1) and an absolute tolerance means something.
"""

import base64
import dataclasses
import io
import json
import os
import subprocess
import sys
import threading
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402
from scipy.io import wavfile  # noqa: E402

from spectrogramgenai_tpu.core import config as jc  # noqa: E402
from spectrogramgenai_tpu.core.mesh import MeshSpec, create_mesh  # noqa: E402
from spectrogramgenai_tpu.diffusion.ddpm import dpmpp_sample  # noqa: E402
from spectrogramgenai_tpu.models.vqvae import VQVAE as JaxVQVAE  # noqa: E402
from spectrogramgenai_tpu.train.diffusion_task import DiffusionTask as JaxTask  # noqa: E402
from spectrogramgenai_tpu_torch.bridge import state_dict_from_flax  # noqa: E402
from spectrogramgenai_tpu_torch.core import config as tc  # noqa: E402
from spectrogramgenai_tpu_torch.core.checkpoint import CheckpointManager  # noqa: E402
from spectrogramgenai_tpu_torch.models.vqvae import VQVAE  # noqa: E402
from spectrogramgenai_tpu_torch.train.diffusion_task import DiffusionTask  # noqa: E402
from torch_port_helpers import random_flax_variables  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_KW = dict(img_size=128, latent=True, num_classes=3, noise_steps=50, width_mult=0.125,
              remove_deep_conv=True, vq_hidden_dim=16, vq_n_embeddings=16, compute_dtype="float32")
CLASSES = ["bird_a", "bird_b", "bird_c"]


@pytest.fixture(scope="module")
def pair():
    """A JAX latent DiffusionTask and the port's, holding the same random weights."""
    jvq = JaxVQVAE(hidden_dim=16, n_embeddings=16)
    vq_vars = random_flax_variables(jvq, jnp.zeros((1, 128, 128, 1)), seed=1)
    # spread the codebook over the clamped latent range so that quantization
    # discriminates (flax's init puts every code within ±1/16)
    emb = np.random.default_rng(2).uniform(-1, 1, (16, 4)).astype(np.float32)
    vq_vars["codebook"]["codebook"].update(embedding=emb, ema_weight=emb.copy())
    mesh = create_mesh(MeshSpec(data=1, model=1), devices=jax.devices()[:1])
    jtask = JaxTask(jc.DDPMConfig(**CFG_KW), mesh, total_steps=1, vq_variables=vq_vars, vqvae=jvq)
    params = random_flax_variables(jtask.model, jnp.zeros((1, 32, 32, 4)), jnp.zeros((1,)),
                                   jnp.zeros((1,), jnp.int32), jnp.ones((1,)), seed=3)["params"]

    vq_sd = state_dict_from_flax(VQVAE(hidden_dim=16, n_embeddings=16), vq_vars)
    ttask = DiffusionTask(tc.DDPMConfig(**CFG_KW), "cpu", vq_params=vq_sd)
    unet_sd = state_dict_from_flax(ttask.model, {"params": params})
    ttask.load_params(unet_sd)
    return types.SimpleNamespace(jtask=jtask, jvq=jvq, vq_vars=vq_vars, params=params,
                                 ttask=ttask, vq_sd=vq_sd, unet_sd=unet_sd)


def test_slice_matches_jax(pair):
    key = jax.random.PRNGKey(11)
    labels = np.array([0, 1, 2, 1], np.int32)
    jt = pair.jtask
    want_u8 = np.asarray(jt.sample(types.SimpleNamespace(params=pair.params), key, jnp.asarray(labels),
                                   sampler="dpmpp", num_steps=5))
    want_lat = np.asarray(jax.jit(lambda p, k, y: dpmpp_sample(
        jt._apply_sample, p, jt.schedule, k, y, (32, 32, 4), num_steps=5))(pair.params, key,
                                                                             jnp.asarray(labels)))
    want_codes = np.asarray(pair.jvq.apply(pair.vq_vars, jnp.clip(want_lat, -1, 1),
                                           method=lambda m, z: m.codebook.encode(z)[1]))

    x_T = torch.from_numpy(np.array(jax.random.normal(key, (4, 32, 32, 4), jnp.float32)))
    tt = pair.ttask
    lat = tt.sample_latents(labels, x_T=x_T, sampler="dpmpp", num_steps=5)
    u8 = tt.decode(lat).numpy()
    _, codes = tt.vqvae.codebook.encode(torch.clamp(lat, -1, 1))
    codes = codes.numpy()
    lat = lat.numpy()

    assert np.isfinite(want_lat).all() and 0.5 < np.abs(want_lat).max() < 50
    np.testing.assert_allclose(lat, want_lat, atol=1e-4)
    agree = codes == want_codes
    assert agree.mean() >= 0.999 and len(np.unique(want_codes)) > 4
    # a latent cell reaches the pixels of its 3×3 neighbourhood (the decoder's
    # 3×3 conv), each cell 4×4 pixels (two stride-2 transposed convs)
    bad = torch.from_numpy((~agree).astype(np.float32))[:, None]
    bad = torch.nn.functional.max_pool2d(bad, 3, stride=1, padding=1)[:, 0].numpy() > 0
    ok = ~bad.repeat(4, axis=1).repeat(4, axis=2)
    assert u8.shape == want_u8.shape == (4, 128, 128, 1) and u8.dtype == np.uint8
    diff = np.abs(u8.astype(int) - want_u8.astype(int))[..., 0]
    assert diff[ok].max() <= 1
    # task.sample is the same chain and decode
    np.testing.assert_array_equal(
        tt.sample(labels, x_T=x_T, sampler="dpmpp", num_steps=5).numpy(), u8)


@pytest.fixture()
def served(pair, tmp_path, monkeypatch):
    """The port's server on the CPU, started through cli.serve.run from saved checkpoints."""
    from spectrogramgenai_tpu_torch.cli.serve import run

    monkeypatch.chdir(tmp_path)
    CheckpointManager("models/ddpm_tiny").save(1, {"params": pair.unet_sd, "ema_params": pair.unet_sd})
    CheckpointManager("models/vq_tiny").save(1, {"params": pair.vq_sd})
    cfg = tc.DDPMConfig(**CFG_KW, vqae_ckpt="models/vq_tiny",
                        run=tc.RunConfig(run_name="ddpm_tiny", seed=0))
    server, batcher = run(cfg, port=0, serve_batch=4, max_delay_ms=500.0, sampler="ddim",
                          num_steps=3, class_names=CLASSES, warmup=False, block=False, device="cpu")
    try:
        yield f"http://127.0.0.1:{server.port}", batcher
    finally:
        server.shutdown()
        batcher.close()


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, json.loads(r.read())


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_server_coalesces_and_reports(served):
    base, batcher = served
    status, health = _get(f"{base}/healthz")
    assert status == 200 and health["ok"] and health["classes"] == 3
    assert health["backend"] == "cpu" and health["device"] == "cpu"

    results = {}

    def hit(i, label):
        results[i] = _post(f"{base}/generate", {"label": label})

    threads = [threading.Thread(target=hit, args=(i, lab))
               for i, lab in enumerate(["bird_a", 1, "bird_c", 0])]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert all(not t.is_alive() for t in threads)
    assert sorted(r[1]["label"] for r in results.values()) == [0, 0, 1, 2]
    for status, body in results.values():
        assert status == 200 and len(body["images"]) == 1
        png = base64.b64decode(body["images"][0])
        assert png.startswith(b"\x89PNG\r\n\x1a\n")
        img = Image.open(io.BytesIO(png))
        assert img.size == (128, 128) and img.mode == "RGB"

    _, stats = _get(f"{base}/stats")
    # four concurrent single-image requests in one window → ONE fixed-shape chain
    assert stats["batches"] == 1 and stats["images"] == 4 and stats["requests"] == 4
    assert stats["slots_filled"] == 4 and stats["slots_padded"] == 0
    assert stats["mean_occupancy"] == 1.0 and "images_per_sec_busy" in stats

    status, body = _post(f"{base}/generate", {"label": "bird_b", "count": 3})
    assert status == 200 and body["label"] == 1 and len(body["images"]) == 3

    for payload, code in (({"label": "nope"}, 400), ({"label": 99}, 400), ({"count": 0}, 400)):
        status, body = _post(f"{base}/generate", payload)
        assert status == code and "error" in body

    # "audio": true → one 22,050-Hz WAV per image, inverted on the task's device
    status, body = _post(f"{base}/generate", {"label": 0, "count": 2, "audio": True})
    assert status == 200 and len(body["images"]) == len(body["audio"]) == 2
    assert body["sample_rate"] == 22050
    for wav in body["audio"]:
        sr, data = wavfile.read(io.BytesIO(base64.b64decode(wav)))
        assert sr == 22050 and data.dtype == np.int16 and data.shape == (127 * 384,)
        assert np.abs(data).max() > 1000  # peak-normalised, not silence
    _, stats = _get(f"{base}/stats")
    assert stats["audio_seconds"] > 0


def test_http_server_503_after_device_error(served):
    base, batcher = served

    def boom(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    batcher.task.sample = boom  # instance attribute: this task only
    status, body = _post(f"{base}/generate", {"label": 0, "count": 2})
    assert status == 500 and "illegal memory access" in body["error"]
    try:
        urllib.request.urlopen(f"{base}/healthz", timeout=30)
        raise AssertionError("expected 503")
    except urllib.error.HTTPError as e:
        assert e.code == 503
        body = json.loads(e.read())
        assert not body["ok"] and "illegal memory access" in body["device_error"]


def test_batching_sampler_splits_oversize_requests(pair):
    from spectrogramgenai_tpu_torch.serving import BatchingSampler

    b = BatchingSampler(pair.ttask, batch_size=2, max_delay_ms=10.0, sampler="ddim", num_steps=2)
    try:
        out = b.submit(1, count=5).result(timeout=300)  # 5 slots through batch 2 → 3 chains
        assert out.shape == (5, 128, 128, 1) and out.dtype == np.uint8
        assert b.snapshot_stats()["batches"] == 3
    finally:
        b.close()


def test_generate_cli_writes_named_pngs(pair, tmp_path, monkeypatch):
    from spectrogramgenai_tpu_torch.cli import generate

    monkeypatch.chdir(tmp_path)
    CheckpointManager("models/gen_tiny").save(3, {"params": pair.unet_sd, "ema_params": pair.unet_sd})
    CheckpointManager("models/vq_tiny").save(3, {"params": pair.vq_sd})
    for c in CLASSES:
        (tmp_path / "train" / c).mkdir(parents=True)
    generate.main(["--run.run_name", "gen_tiny", "--img_folder", "gen", "--num_samples", "2",
                   "--start_idx", "5", "--sampler", "ddim", "--num_steps", "2", "--device", "cpu",
                   "--train_folder_for_classes", "train", "--vqae_ckpt", "models/vq_tiny",
                   *[f"--{k}={v}" for k, v in CFG_KW.items()]])
    names = sorted(os.listdir(tmp_path / "gen"))
    assert names == sorted(f"{c}_gen_imgs_{i}_{s}.png" for s in (5, 6) for i, c in enumerate(CLASSES))
    img = Image.open(tmp_path / "gen" / names[0])
    assert img.size == (128, 128) and img.mode == "RGB"


def test_generate_cli_writes_audio_beside_pngs(pair, tmp_path, monkeypatch):
    from spectrogramgenai_tpu_torch.cli import generate

    monkeypatch.chdir(tmp_path)
    CheckpointManager("models/gen_tiny").save(3, {"params": pair.unet_sd, "ema_params": pair.unet_sd})
    CheckpointManager("models/vq_tiny").save(3, {"params": pair.vq_sd})
    generate.main(["--run.run_name", "gen_tiny", "--img_folder", "gen", "--num_samples", "1",
                   "--sampler", "ddim", "--num_steps", "2", "--device", "cpu", "--vqae_ckpt", "models/vq_tiny",
                   "--audio_dir", "gen_audio", "--audio_out_sr", "16000",
                   *[f"--{k}={v}" for k, v in CFG_KW.items()]])
    pngs = sorted(os.listdir(tmp_path / "gen"))
    wavs = sorted(os.listdir(tmp_path / "gen_audio"))
    assert len(pngs) == 3 and wavs == [n.replace(".png", ".wav") for n in pngs]
    for name in wavs:
        sr, data = wavfile.read(tmp_path / "gen_audio" / name)
        assert sr == 16000 and data.dtype == np.int16 and abs(len(data) - 127 * 384 * 16000 / 22050) <= 1


def test_cuda_device_without_a_card_raises(monkeypatch):
    from spectrogramgenai_tpu_torch.cli.common import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_checkpoint_round_trip_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    assert mgr.restore() is None
    sd = {"w": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3), "n": torch.tensor([3])}
    for step in (1, 2, 3):
        mgr.save(step, {"params": sd})
    assert mgr.all_steps() == [2, 3]
    got = mgr.restore()["params"]
    assert got["w"].dtype == torch.float32 and got["n"].dtype == torch.long
    torch.testing.assert_close(got["w"], sd["w"].float())


def test_png_pixels_match_jax_encoder():
    from spectrogramgenai_tpu.serving.server import _png_bytes
    from spectrogramgenai_tpu_torch.audio.export import generated_png_bytes

    imgs = np.random.default_rng(0).integers(0, 256, (3, 24, 40, 1), dtype=np.uint8)
    imgs[0, 0, :4, 0] = [0, 1, 254, 255]
    for png, img in zip(generated_png_bytes(imgs), imgs):
        got = np.asarray(Image.open(io.BytesIO(png)).convert("RGB"))
        want = np.asarray(Image.open(io.BytesIO(_png_bytes(img))).convert("RGB"))
        np.testing.assert_array_equal(got, want)


def test_viridis_lut_matches_jax():
    from spectrogramgenai_tpu.audio.export import _viridis_lut
    from spectrogramgenai_tpu_torch.audio.export import VIRIDIS_LUT

    np.testing.assert_array_equal(VIRIDIS_LUT, _viridis_lut())


@pytest.mark.parametrize("name", ["RunConfig", "DataConfig", "DDPMConfig", "VQVAEConfig", "ClassifierConfig",
                                  "ACGANConfig", "SpecUNetConfig"])
def test_config_fields_and_defaults_match_jax(name):
    jcls, tcls = getattr(jc, name), getattr(tc, name)
    assert [f.name for f in dataclasses.fields(tcls)] == [f.name for f in dataclasses.fields(jcls)]
    assert dataclasses.asdict(tcls()) == dataclasses.asdict(jcls())
    assert list(tc._flatten_fields(tcls)) == list(jc._flatten_fields(jcls))


def test_config_overrides_match_jax():
    import argparse

    argv = ["--num_classes", "5", "--run.run_name", "x", "--remove_deep_conv", "true",
            "--data.batch_size", "3", "--cfg_scale", "1.5"]
    parsed = []
    for mod in (jc, tc):
        p = argparse.ArgumentParser()
        mod.add_config_args(p, mod.DDPMConfig)
        parsed.append(dataclasses.asdict(mod.apply_overrides(mod.DDPMConfig(), p.parse_args(argv))))
    assert parsed[0] == parsed[1] and parsed[1]["run"]["run_name"] == "x"


def test_port_imports_without_jax():
    code = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "msgpack", "spectrogramgenai_tpu", "pandas", "PIL", "matplotlib"):
    sys.modules[name] = None  # any import of these now raises ImportError
import spectrogramgenai_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
print(" ".join(mods))
print(len(mods))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 30
    mods = set(out.stdout.split("\n")[-3].split())
    assert {"spectrogramgenai_tpu_torch.serving.export", "spectrogramgenai_tpu_torch.cli.export_model"} <= mods


def test_kernel_build_runs_one_compiler_per_source(tmp_path, monkeypatch):
    from spectrogramgenai_tpu_torch.ops import _build

    # a stand-in compiler: writes its -o file and a report, and fails on bad.cu
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text('#!/bin/sh\nout=""; src=""\nwhile [ $# -gt 0 ]; do\n'
                    '  case "$1" in -o) out="$2"; shift;; *.cu) src="$1";; esac; shift\ndone\n'
                    'case "$src" in *bad.cu) echo "bad.cu(1): error"; exit 1;; esac\n'
                    'echo "ptxas info    : Used 40 registers"; echo built > "$out"\n')
    nvcc.chmod(0o755)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("one", "two", "bad"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")

    _build._compile(["one", "two"])
    for name in ("one", "two"):
        assert _build.library_path(name).read_text() == "built\n"
        assert "40 registers" in _build.build_log(name)
    with pytest.raises(RuntimeError, match="bad.cu"):
        _build._compile(["bad", "one"])
    assert not _build.library_path("bad").exists()
    assert sorted(p.name for p in (tmp_path / "_build").iterdir() if p.suffix == ".tmp") == []
    # an edited source is another library
    before = _build.library_path("one")
    (csrc / "one.cu").write_text("// one, edited\n")
    assert _build.library_path("one") != before
