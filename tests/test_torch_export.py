"""The port's sampler export (``serving/export.py``), its CLIs and its packaging, on the CPU.

A latent DDPM at a small size (64×64 images, a 16×16×4 latent, UNet
width_mult 0.125, VQ hidden 16 with 16 codes, 3 classes, a 50-step
schedule), float32. The artifact must equal the port's eager sampler with
the same seed, bit for bit (the same operations in the same order), and
the JAX package's artifact given the same starting noise, at the tolerance
of ``tests/test_torch_slice.py::test_slice_matches_jax``.
"""

import fnmatch
import io
import json
import os
import subprocess
import sys
import tomllib
import types
import urllib.request
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spectrogramgenai_tpu.core import config as jc  # noqa: E402
from spectrogramgenai_tpu.core.mesh import MeshSpec, create_mesh  # noqa: E402
from spectrogramgenai_tpu.diffusion.ddpm import ddim_sample as jax_ddim_sample  # noqa: E402
from spectrogramgenai_tpu.diffusion.ddpm import dpmpp_sample as jax_dpmpp_sample  # noqa: E402
from spectrogramgenai_tpu.models.vqvae import VQVAE as JaxVQVAE  # noqa: E402
from spectrogramgenai_tpu.serving import export as jax_export  # noqa: E402
from spectrogramgenai_tpu.train.diffusion_task import DiffusionTask as JaxTask  # noqa: E402
from spectrogramgenai_tpu_torch.bridge import state_dict_from_flax  # noqa: E402
from spectrogramgenai_tpu_torch.core import config as tc  # noqa: E402
from spectrogramgenai_tpu_torch.diffusion.ddpm import ddpm_sample  # noqa: E402
from spectrogramgenai_tpu_torch.models import layers  # noqa: E402
from spectrogramgenai_tpu_torch.models.vqvae import VQVAE  # noqa: E402
from spectrogramgenai_tpu_torch.serving import BatchingSampler, GenerationHTTPServer  # noqa: E402
from spectrogramgenai_tpu_torch.serving.export import (  # noqa: E402
    ExportedSampler,
    export_sampler,
    load_artifact,
    save_artifact,
)
from spectrogramgenai_tpu_torch.train.diffusion_task import DiffusionTask  # noqa: E402
from torch_port_helpers import one_torch_thread, random_flax_variables  # noqa: E402, F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_KW = dict(img_size=64, latent=True, num_classes=3, noise_steps=50, width_mult=0.125,
              remove_deep_conv=True, vq_hidden_dim=16, vq_n_embeddings=16, compute_dtype="float32")
LATENT = (16, 16, 4)
CLASSES = ["bird_a", "bird_b", "bird_c"]
# (sampler, steps, label batch) of the module's artifacts
ARTIFACTS = {"ddim": ("ddim", 4, 6), "dpmpp": ("dpmpp", 4, 4), "ddpm": ("ddpm", 50, 3)}
OP = "spectrogramgenai_tpu_torch.attention_fwd"


@pytest.fixture(scope="module")
def pair():
    """A JAX latent DiffusionTask and the port's, holding the same random weights."""
    jvq = JaxVQVAE(hidden_dim=16, n_embeddings=16)
    vq_vars = random_flax_variables(jvq, jnp.zeros((1, 64, 64, 1)), seed=1)
    # spread the codebook over the clamped latent range, so that quantization discriminates
    emb = np.random.default_rng(2).uniform(-1, 1, (16, 4)).astype(np.float32)
    vq_vars["codebook"]["codebook"].update(embedding=emb, ema_weight=emb.copy())
    mesh = create_mesh(MeshSpec(data=1, model=1), devices=jax.devices()[:1])
    jtask = JaxTask(jc.DDPMConfig(**CFG_KW), mesh, total_steps=1, vq_variables=vq_vars, vqvae=jvq)
    params = random_flax_variables(jtask.model, jnp.zeros((1, *LATENT)), jnp.zeros((1,)),
                                   jnp.zeros((1,), jnp.int32), jnp.ones((1,)), seed=3)["params"]
    vq_sd = state_dict_from_flax(VQVAE(hidden_dim=16, n_embeddings=16), vq_vars)
    ttask = DiffusionTask(tc.DDPMConfig(**CFG_KW), "cpu", vq_params=vq_sd)
    ttask.load_params(state_dict_from_flax(ttask.model, {"params": params}))
    return types.SimpleNamespace(jtask=jtask, jvq=jvq, vq_vars=vq_vars, params=params, ttask=ttask)


def _eager_ddim(task):
    return task.sample(_labels(3), generator=torch.Generator().manual_seed(2), sampler="ddim", num_steps=2).numpy()


@pytest.fixture(scope="module")
def blobs(pair):
    """The port's artifacts of ARTIFACTS, each exported once, and an eager
    sample made before them. The exports run with the resize-matrix cache
    empty, as the first use in a process would."""
    before = _eager_ddim(pair.ttask)
    layers._resize_matrix.cache_clear()
    out = {name: export_sampler(pair.ttask, num_labels=n, sampler=s, num_steps=k, platforms=["cpu"])
           for name, (s, k, n) in ARTIFACTS.items()}
    pair.eager_before_export = before
    return out


@pytest.fixture(scope="module")
def arts(blobs):
    return {name: ExportedSampler(blob, device="cpu") for name, blob in blobs.items()}


def _labels(n):
    return np.arange(n) % 3


# -- (a) the artifact is the eager sampler -------------------------------------------------------

@pytest.mark.parametrize("name", list(ARTIFACTS))
def test_artifact_equals_eager_sample(pair, arts, name):
    sampler, steps, n = ARTIFACTS[name]
    art = arts[name]
    got = art(7, _labels(n))
    want = pair.ttask.sample(_labels(n), generator=torch.Generator().manual_seed(7), sampler=sampler,
                             num_steps=steps).numpy()
    assert got.shape == (n, 64, 64, 1) and got.dtype == np.uint8
    assert len(np.unique(got)) > 10  # not a constant image
    np.testing.assert_array_equal(got, want)  # the same operations in the same order
    assert not np.array_equal(art(8, _labels(n)), got)  # the seed is the chain's


def test_ddpm_artifact_takes_injected_noise(pair, arts):
    n = 3
    rng = np.random.default_rng(4)
    x_T = torch.from_numpy(rng.standard_normal((n, *LATENT)).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((49, n, *LATENT)).astype(np.float32))
    got = arts["ddpm"](0, _labels(n), x_T=x_T, noise=noise)
    with torch.inference_mode():
        lat = ddpm_sample(pair.ttask.model, pair.ttask.schedule, torch.as_tensor(_labels(n)), LATENT,
                          cfg_scale=pair.ttask.cfg.cfg_scale, x_T=x_T, noise=noise)
    want = pair.ttask.decode(lat).numpy()
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="per-step noise is for the ddpm chain"):
        arts["ddim"](0, _labels(6), noise=noise)


# -- (b) the ε program holds K1's operator at each fused site -------------------------------------

def test_exported_eps_program_holds_the_attention_op():
    # 64×64 pixels: sa_0 and sa_4 see 32×32 = 1024 tokens, sa_5 64×64 = 4096;
    # the CPU kernel of the operator is the plain version
    cfg = tc.DDPMConfig(img_size=64, latent=False, num_classes=3, noise_steps=20, width_mult=0.125,
                        remove_deep_conv=True, compute_dtype="float32")
    task = DiffusionTask(cfg, "cpu")
    task.init_state(0)
    fused = task._unet(fused=True)
    fused.load_state_dict(task.model.state_dict())
    task.model = fused.eval()
    blob = export_sampler(task, num_labels=1, sampler="ddim", num_steps=2, cfg_scale=0.0)
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        assert sorted(z.namelist()) == ["decode_cpu.pt2", "eps_cpu.pt2", "manifest.json"]
        program = torch.export.load(io.BytesIO(bytearray(z.read("eps_cpu.pt2"))))
    nodes = [nd for nd in program.graph.nodes if nd.op == "call_function" and str(nd.target).startswith(OP)]
    sites = sorted({path.split(".")[-1] for nd in nodes for path, _ in nd.meta["nn_module_stack"].values()
                    if path.split(".")[-1].startswith("sa_")})
    assert len(nodes) == 3 and sites == ["sa_0", "sa_4", "sa_5"]
    rng = np.random.default_rng(5)
    args = (torch.from_numpy(rng.standard_normal((1, 64, 64, 1)).astype(np.float32)), torch.tensor([37.0]),
            torch.tensor([2]), torch.tensor([1.0]))
    with torch.inference_mode():
        want = fused(*args)
        got = program.module()(*args)
    assert got.shape == (1, 64, 64, 1)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# -- (c) against the JAX package's artifact ------------------------------------------------------

@pytest.fixture(scope="module")
def jax_blobs(pair):
    state = types.SimpleNamespace(params=pair.params)
    return {name: jax_export.export_sampler(pair.jtask, state, num_labels=ARTIFACTS[name][2], sampler=name,
                                            num_steps=ARTIFACTS[name][1])
            for name in ("ddim", "dpmpp")}


@pytest.mark.parametrize("name", ["ddim", "dpmpp"])
def test_artifact_matches_jax_artifact(pair, arts, jax_blobs, name):
    sampler, steps, n = ARTIFACTS[name]
    seed, labels = 11, _labels(n)
    jart = jax_export.ExportedSampler(jax_blobs[name])
    want_u8 = np.asarray(jart(seed, labels.astype(np.int32)))
    key = jax.random.PRNGKey(seed)  # the JAX artifact's own draw of x_T
    x_T = torch.from_numpy(np.array(jax.random.normal(key, (n, *LATENT), jnp.float32)))
    got_u8 = arts[name](seed, labels, x_T=x_T)

    # the chains' latents and codes, to place the decoder's disagreements (as test_slice_matches_jax)
    jt = pair.jtask
    jax_sampler = {"ddim": jax_ddim_sample, "dpmpp": jax_dpmpp_sample}[name]
    want_lat = np.asarray(jax.jit(lambda p, k, y: jax_sampler(jt._apply_sample, p, jt.schedule, k, y, LATENT,
                                                              num_steps=steps))(pair.params, key,
                                                                                jnp.asarray(labels)))
    want_codes = np.asarray(pair.jvq.apply(pair.vq_vars, jnp.clip(want_lat, -1, 1),
                                           method=lambda m, z: m.codebook.encode(z)[1]))
    lat = pair.ttask.sample_latents(labels, x_T=x_T, sampler=sampler, num_steps=steps)
    codes = pair.ttask.vqvae.codebook.encode(torch.clamp(lat, -1, 1))[1].numpy()
    assert np.isfinite(want_lat).all() and 0.5 < np.abs(want_lat).max() < 50
    np.testing.assert_allclose(lat.numpy(), want_lat, atol=1e-4)
    agree = codes == want_codes
    assert agree.mean() >= 0.999 and len(np.unique(want_codes)) > 4
    bad = torch.from_numpy((~agree).astype(np.float32))[:, None]
    bad = torch.nn.functional.max_pool2d(bad, 3, stride=1, padding=1)[:, 0].numpy() > 0
    ok = ~bad.repeat(4, axis=1).repeat(4, axis=2)
    assert got_u8.shape == want_u8.shape == (n, 64, 64, 1) and got_u8.dtype == np.uint8
    diff = np.abs(got_u8.astype(int) - want_u8.astype(int))[..., 0]
    assert diff[ok].max() <= 1


def test_manifest_holds_the_jax_manifest(arts, jax_blobs):
    for name in ("ddim", "dpmpp"):
        with zipfile.ZipFile(io.BytesIO(jax_blobs[name])) as z:
            jax_manifest = json.loads(z.read("manifest.json"))
        ours = arts[name].manifest
        assert {k: ours.get(k) for k in jax_manifest} == jax_manifest
        assert ours["format"] == "torch.export" and ours["sample_shape"] == list(LATENT)
        assert ours["compute_dtype"] == "float32" and (ours["beta_start"], ours["beta_end"]) == (1e-4, 0.02)


# -- (d) the artifact's contract -----------------------------------------------------------------

def test_rejects_wrong_label_count(arts):
    with pytest.raises(ValueError, match="compiled for 6 labels"):
        arts["ddim"](0, np.zeros((5,), np.int64))


def _rezip(blob: bytes, **manifest_changes) -> bytes:
    out = io.BytesIO()
    with zipfile.ZipFile(io.BytesIO(blob)) as z, zipfile.ZipFile(out, "w") as w:
        for name in z.namelist():
            data = z.read(name)
            if name == "manifest.json":
                data = json.dumps({**json.loads(data), **manifest_changes})
            w.writestr(name, data)
    return out.getvalue()


def test_rejects_newer_format_and_jax_artifacts(blobs, jax_blobs):
    with pytest.raises(ValueError, match="newer than this runtime"):
        ExportedSampler(_rezip(blobs["ddim"], format_version=999), device="cpu")
    with pytest.raises(ValueError, match="StableHLO artifact of the JAX package"):
        ExportedSampler(jax_blobs["ddim"], device="cpu")


def test_device_choice_never_falls_back(blobs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ExportedSampler(blobs["ddim"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match=r"no program for 'cuda' \(exported for \['cpu'\]\)"):
        ExportedSampler(blobs["ddim"])


def test_generate_cli_from_artifact(blobs, tmp_path, monkeypatch):
    from spectrogramgenai_tpu_torch.cli import generate

    monkeypatch.chdir(tmp_path)
    for c in CLASSES:
        (tmp_path / "train" / c).mkdir(parents=True)
    save_artifact("ddim.zip", blobs["ddim"])
    generate.main(["--artifact", "ddim.zip", "--img_folder", "gen", "--num_samples", "3", "--device", "cpu",
                   "--train_folder_for_classes", "train"])
    files = sorted(os.listdir("gen"))
    # 3 rounds × 3 classes; batch 6 = 2 rounds a chain → chains of 2 then 1
    assert files == sorted(f"{c}_gen_imgs_{i}_{s}.png" for s in range(3) for i, c in enumerate(CLASSES))
    with pytest.raises(ValueError, match="artifact has 3 classes, got 2 names"):
        generate.run(None, "gen2", 1, 0, CLASSES[:2], device="cpu", artifact="ddim.zip")
    save_artifact("dpmpp.zip", blobs["dpmpp"])
    with pytest.raises(ValueError, match="label batch 4 is not a multiple of num_classes 3"):
        generate.run(None, "gen2", 1, 0, CLASSES, device="cpu", artifact="dpmpp.zip")


def test_artifact_backed_serving(arts):
    b = BatchingSampler.from_artifact(arts["ddim"], max_delay_ms=10.0)
    server = GenerationHTTPServer(b, CLASSES, port=0)
    server.start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        assert b.num_classes == 3 and b.batch_size == 6 and b.sampler == "ddim" and b.num_steps == 4
        out = b.submit(1, count=7).result(timeout=120)  # 7 slots through batch 6
        assert out.shape == (7, 64, 64, 1) and out.dtype == np.uint8
        req = urllib.request.Request(f"{base}/generate", data=json.dumps({"label": "bird_c", "count": 2}).encode(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            body = json.loads(r.read())
        assert body["label"] == 2 and len(body["images"]) == 2
        with urllib.request.urlopen(f"{base}/stats", timeout=30) as r:
            stats = json.loads(r.read())
        assert stats["images"] == 9 and stats["batches"] >= 2 and "images_per_sec_busy" in stats
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["ok"] and health["backend"] == "cpu" and health["classes"] == 3
    finally:
        server.shutdown()
        b.close()


def test_serve_cli_runs_from_artifact(blobs, tmp_path):
    from spectrogramgenai_tpu_torch.cli.serve import run

    path = str(tmp_path / "dpmpp.zip")
    save_artifact(path, blobs["dpmpp"])
    # no checkpoint anywhere: the config's run name and VQ-VAE path point at nothing
    cfg = tc.DDPMConfig(run=tc.RunConfig(run_name="missing"), vqae_ckpt=str(tmp_path / "missing"))
    server, batcher = run(cfg, port=0, class_names=CLASSES, warmup=True, block=False, device="cpu",
                          artifact=path)
    try:
        assert batcher.batch_size == 4 and batcher.sampler == "dpmpp"
        req = urllib.request.Request(f"http://127.0.0.1:{server.port}/generate",
                                     data=json.dumps({"label": 1}).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            assert len(json.loads(r.read())["images"]) == 1
    finally:
        server.shutdown()
        batcher.close()


def test_export_cli_writes_and_checks(pair, tmp_path, monkeypatch, capsys):
    from spectrogramgenai_tpu_torch.cli import export_model
    from spectrogramgenai_tpu_torch.core.checkpoint import CheckpointManager

    monkeypatch.chdir(tmp_path)
    sd = pair.ttask.model.state_dict()
    CheckpointManager("models/ddpm").save(1, {"params": sd, "ema_params": sd})
    CheckpointManager("models/vq").save(1, {"params": pair.ttask.vqvae.state_dict()})
    out = export_model.main(["--run.run_name", "ddpm", "--vqae_ckpt", "models/vq", "--out", "s.zip",
                             "--num_labels", "3", "--sampler", "ddim", "--num_steps", "2", "--device", "cpu",
                             "--check", *[f"--{k}={v}" for k, v in CFG_KW.items()]])
    printed = capsys.readouterr().out
    assert out == "s.zip" and "MB) in" in printed and "check: artifact generated (3, 64, 64, 1) uint8" in printed
    art = load_artifact("s.zip", device="cpu")
    assert (art.manifest["sampler"], art.manifest["num_steps"], art.num_labels) == ("ddim", 2, 3)


# -- (e) loading imports no model code -----------------------------------------------------------

def test_loader_imports_no_model_code(blobs, tmp_path):
    path = str(tmp_path / "ddim.zip")
    save_artifact(path, blobs["ddim"])
    code = f"""
import sys
import numpy as np
from spectrogramgenai_tpu_torch.serving.export import load_artifact
imgs = load_artifact({path!r}, device="cpu")(3, np.arange(6) % 3)
assert imgs.shape == (6, 64, 64, 1), imgs.shape
bad = [m for m in sys.modules if m.startswith(("spectrogramgenai_tpu_torch.models", "spectrogramgenai_tpu_torch.train",
                                               "jax", "flax", "spectrogramgenai_tpu."))
       or m == "spectrogramgenai_tpu"]
print("loaded", bad)
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[-2] == "loaded []"


# -- (f) an export leaves eager sampling as it was -----------------------------------------------

def test_eager_sampling_after_an_export_is_unchanged(pair, blobs):
    # the exports filled no cache: eager sampling fills it now, with real tensors
    np.testing.assert_array_equal(_eager_ddim(pair.ttask), pair.eager_before_export)
    assert layers._resize_matrix.cache_info().currsize > 0
    assert type(layers._resize_matrix(8, 16, torch.device("cpu"), torch.float32)) is torch.Tensor


# -- packaging -----------------------------------------------------------------------------------

def test_package_data_ships_every_native_source():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"]["spectrogramgenai_tpu_torch"]
    csrc = os.path.join(REPO, "spectrogramgenai_tpu_torch", "csrc")
    names = sorted(os.listdir(csrc))
    assert {os.path.splitext(n)[1] for n in names} >= {".cu", ".cpp"}
    missing = [n for n in names if not any(fnmatch.fnmatch(f"csrc/{n}", g) for g in globs)]
    assert not missing, f"not shipped by pyproject.toml's package-data {globs}: {missing}"
