"""The port's CLI leftovers on the CPU, against the JAX package.

``generate --sav_denoise_path`` (the 999-step chain's trajectory dump, here
on a shortened schedule and a small UNet: its file names against the JAX
dump's, its grids against the latents, its last state against
``ddpm_sample``), ``train_ddpm --profile_dir`` (a trace that loads as JSON
and holds the port's spans; none without a directory), ``utils/misc`` against the JAX helpers, and
``eval_classifiers``' confusion PNG against matplotlib's viridis mapping.
"""

import io
import json
import os
import random
from contextlib import redirect_stdout
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from matplotlib import cm as mpl_cm  # noqa: E402
from matplotlib.colors import Normalize  # noqa: E402

from spectrogramgenai_tpu.cli import generate as jgen  # noqa: E402
from spectrogramgenai_tpu.core import config as jc  # noqa: E402
from spectrogramgenai_tpu.core.mesh import MeshSpec, create_mesh  # noqa: E402
from spectrogramgenai_tpu.models.vqvae import VQVAE as JaxVQVAE  # noqa: E402
from spectrogramgenai_tpu.train.diffusion_task import DiffusionTask as JaxTask  # noqa: E402
from spectrogramgenai_tpu.utils import misc as jmisc  # noqa: E402
from spectrogramgenai_tpu.utils import profiling as jprof  # noqa: E402
from spectrogramgenai_tpu_torch.audio.export import (  # noqa: E402
    VIRIDIS_LUT,
    decode_png_rgb,
    encode_png_rgb,
    save_confusion_png,
)
from spectrogramgenai_tpu_torch.bridge import state_dict_from_flax  # noqa: E402
from spectrogramgenai_tpu_torch.cli import generate as tgen  # noqa: E402
from spectrogramgenai_tpu_torch.core import config as tc  # noqa: E402
from spectrogramgenai_tpu_torch.core.checkpoint import CheckpointManager  # noqa: E402
from spectrogramgenai_tpu_torch.diffusion.ddpm import ddpm_sample  # noqa: E402
from spectrogramgenai_tpu_torch.models.vqvae import VQVAE  # noqa: E402
from spectrogramgenai_tpu_torch.train.diffusion_task import DiffusionTask  # noqa: E402
from spectrogramgenai_tpu_torch.utils import misc as tmisc  # noqa: E402
from spectrogramgenai_tpu_torch.utils import profiling as tprof  # noqa: E402
from torch_port_helpers import one_torch_thread, random_flax_variables  # noqa: E402, F401

CLASSES = ["ant", "bee", "cat"]
NOISE_STEPS = 52  # steps 51 … 1: the dump writes 51, 50 and 1


def _pixels(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png_rgb(f.read())


def _tiny_cfg(module):
    return module.DDPMConfig(img_size=32, num_classes=3, noise_steps=NOISE_STEPS, width_mult=0.125,
                             remove_deep_conv=True, vq_hidden_dim=16, vq_n_embeddings=16, compute_dtype="float32",
                             cfg_scale=3.0, run=module.RunConfig(run_name="tiny"), vqae_ckpt="models/vq")


def test_trajectory_dump_names_grids_and_last_state(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    jvq = JaxVQVAE(hidden_dim=16, n_embeddings=16)
    vq_vars = random_flax_variables(jvq, jnp.zeros((1, 32, 32, 1)), seed=1)
    mesh = create_mesh(MeshSpec(data=1, model=1), devices=jax.devices()[:1])
    jt = JaxTask(_tiny_cfg(jc), mesh, total_steps=1, vq_variables=vq_vars, vqvae=jvq)
    unet_vars = random_flax_variables(jt.model, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)), jnp.zeros((1,), jnp.int32),
                                      jnp.ones((1,)), seed=2)
    jgen._dump_denoise_trajectory(jt, SimpleNamespace(params=unet_vars["params"]), jnp.arange(3), CLASSES,
                                  str(tmp_path / "jax"), False)
    jax_names = sorted(os.listdir(tmp_path / "jax"))
    assert len(jax_names) == 3 * 3 * 2 and "bee_noise_51_latent.png" in jax_names

    cfg = _tiny_cfg(tc)
    vq_sd = state_dict_from_flax(VQVAE(hidden_dim=16, n_embeddings=16), vq_vars)
    task = DiffusionTask(cfg, "cpu", vq_params=vq_sd)
    task.load_params(state_dict_from_flax(task._unet(fused=False), unet_vars))
    rng = np.random.default_rng(3)
    x_T = torch.from_numpy(rng.standard_normal((3, 8, 8, 4)).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((NOISE_STEPS - 1, 3, 8, 8, 4)).astype(np.float32))
    labels = torch.arange(3)
    last = tgen.dump_denoise_trajectory(task, labels, CLASSES, str(tmp_path / "port"), x_T=x_T, noise=noise)
    assert sorted(os.listdir(tmp_path / "port")) == jax_names

    seen = {}
    want = ddpm_sample(task.model, task.schedule, labels, (8, 8, 4), cfg_scale=3.0, x_T=x_T, noise=noise,
                       callback=lambda i, x: seen.__setitem__(i, x.clone()))
    assert torch.equal(last, want)
    assert tgen.trajectory_steps(NOISE_STEPS) == {51, 50, 1} and len(tgen.trajectory_steps(1000)) == 21
    for i in sorted(tgen.trajectory_steps(NOISE_STEPS)):
        x = torch.clamp(seen[i], -1, 1).numpy()
        decoded = task.decode(torch.from_numpy(x)).numpy()[..., 0]
        for b, name in enumerate(CLASSES):
            grid = np.block([[x[b, :, :, 0], x[b, :, :, 1]], [x[b, :, :, 2], x[b, :, :, 3]]])
            grid_u8 = ((grid + 1) / 2 * 255).astype(np.uint8)
            np.testing.assert_array_equal(_pixels(str(tmp_path / "port" / f"{name}_noise_{i}_latent.png")),
                                          VIRIDIS_LUT[grid_u8])
            np.testing.assert_array_equal(_pixels(str(tmp_path / "port" / f"{name}_noise_{i}_decode.png")),
                                          VIRIDIS_LUT[decoded[b]])

    # the CLI: the checkpoint's weights, the reference's message, no final images
    CheckpointManager("models/vq").save(0, {"params": vq_sd})
    CheckpointManager("models/tiny").save(0, {"params": task.model.state_dict()})
    tgen.main(["--sav_denoise_path", "traj", "--img_folder", "gen", "--img_size", "32", "--num_classes", "3",
               "--noise_steps", str(NOISE_STEPS), "--width_mult", "0.125", "--remove_deep_conv", "true",
               "--vq_hidden_dim", "16", "--vq_n_embeddings", "16", "--compute_dtype", "float32",
               "--run.run_name", "tiny", "--vqae_ckpt", "models/vq", "--device", "cpu"])
    assert "not saving images, just noise portions" in capsys.readouterr().out
    assert sorted(os.listdir("traj")) == [n.replace("ant", "class00").replace("bee", "class01")
                                          .replace("cat", "class02") for n in jax_names]
    assert os.listdir("gen") == []


def test_trajectory_dump_refuses_a_pixel_model():
    cfg = tc.DDPMConfig(img_size=8, num_classes=2, noise_steps=10, width_mult=0.125, remove_deep_conv=True,
                        latent=False, compute_dtype="float32")
    task = DiffusionTask(cfg, "cpu")
    with pytest.raises(ValueError, match="latent model"):
        tgen.dump_denoise_trajectory(task, [0, 1], ["a", "b"], "unused")


def test_train_ddpm_profile_dir_writes_a_chrome_trace(tmp_path, monkeypatch):
    from spectrogramgenai_tpu_torch.cli import train_ddpm

    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(4)
    for c in ("ant", "bee"):
        d = tmp_path / "datasets" / "train" / c
        d.mkdir(parents=True)
        for i in range(4):
            (d / f"{i}.png").write_bytes(encode_png_rgb(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)))
    vq = VQVAE(hidden_dim=16, n_embeddings=16).reset_parameters(torch.Generator().manual_seed(1))
    CheckpointManager("models/vq").save(0, {"params": vq.state_dict()})
    with redirect_stdout(io.StringIO()):
        state = train_ddpm.main(["--profile_dir", "prof", "--device", "cpu", "--data.dataset_path", "datasets",
                                 "--data.img_size", "32", "--img_size", "32", "--num_classes", "2",
                                 "--noise_steps", "20", "--width_mult", "0.125", "--remove_deep_conv", "true",
                                 "--vq_hidden_dim", "16", "--vq_n_embeddings", "16", "--vqae_ckpt", "models/vq",
                                 "--compute_dtype", "float32", "--data.batch_size", "4", "--epochs", "1",
                                 "--preview_sampler", "ddpm", "--run.run_name", "prof"])
    assert state.step == 2
    with open(os.path.join("prof", tprof.TRACE_FILE)) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("aten::convolution" in n for n in names)
    assert {"sgai.train.step", "sgai.train.optimizer", "sgai.train.ema", "sgai.norm.group", "sgai.norm.layer"} <= names


def test_no_trace_without_a_dir():
    with tprof.trace(None) as prof:
        assert prof is None
    assert "jax.profiler" in open(jprof.__file__).read()  # the JAX hook the port's replaces


def test_misc_helpers_match_jax():
    gen = tmisc.set_seed(11)
    a = (np.random.random(), random.random())
    jmisc.set_seed(11)
    assert a == (np.random.random(), random.random()) and gen.initial_seed() == 11

    labels = np.array([2, 0, 1, 2])
    np.testing.assert_array_equal(tmisc.onehot(torch.from_numpy(labels), 3).numpy(),
                                  np.asarray(jmisc.onehot(jnp.asarray(labels), 3)))
    x = np.random.default_rng(5).standard_normal((4, 5, 6, 2)).astype(np.float32)
    got = tmisc.add_class_channels(torch.from_numpy(x), torch.from_numpy(labels), 3).numpy()
    np.testing.assert_allclose(got, np.asarray(jmisc.add_class_channels(jnp.asarray(x), jnp.asarray(labels), 3)),
                               rtol=0, atol=1e-6)
    assert got.shape == (4, 5, 6, 5)
    logits = np.random.default_rng(6).standard_normal((7, 4)) * 5
    np.testing.assert_allclose(tmisc.softmax_np(logits), jmisc.softmax_np(logits), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tmisc.softmax_np(logits, axis=0), jmisc.softmax_np(logits, axis=0), atol=1e-6)
    lab = np.array([0, 1, 3, 3, 2, 0, 1])
    assert tmisc.compute_acc(logits, lab) == pytest.approx(jmisc.compute_acc(logits, lab), abs=1e-6)

    w = tmisc.dcgan_initializer()(torch.empty(200, 100), torch.Generator().manual_seed(0))
    jw = np.asarray(jmisc.dcgan_initializer()(jax.random.PRNGKey(0), (200, 100)))
    for v in (w.numpy(), jw):  # two streams, one law: N(0, 0.02) over 20,000 draws
        assert abs(v.mean()) < 1e-3 and abs(v.std() - 0.02) < 1e-3

    rows = [{"common_name": c, "x": i} for i, c in enumerate("aaaaabbcacb")]
    want = jmisc.prop_counts(pd.DataFrame(rows))
    got = tmisc.prop_counts(rows)
    assert list(got) == list(want.index)
    np.testing.assert_allclose(list(got.values()), want.to_numpy(), rtol=0, atol=1e-6)

    train = [{"common_name": "z", "x": 100}]
    val = [{"common_name": "z", "x": 200}]
    got = tmisc.redistribute_datasets(rows, train, val, min_test=2)
    want = jmisc.redistribute_datasets(pd.DataFrame(rows), pd.DataFrame(train), pd.DataFrame(val), min_test=2)
    assert list(got) and all(g == w.to_dict("records") for g, w in zip(got, want))

    sw = tmisc.Stopwatch()
    sw.tic()
    with redirect_stdout(io.StringIO()) as out:
        assert sw.toc() >= 0
    assert out.getvalue().startswith("Elapsed time: ")


@pytest.mark.parametrize("kind", ["counts", "constant"])
def test_confusion_png_is_matplotlibs_viridis_mapping(tmp_path, kind):
    cm = np.random.default_rng(7).integers(0, 40, (6, 6)) if kind == "counts" else np.full((4, 4), 3)
    path = str(tmp_path / "cm.png")
    save_confusion_png(cm, path)
    px = _pixels(path)
    cell = 256 // len(cm)
    assert px.shape == (len(cm) * cell, len(cm) * cell, 3)
    blocks = px.reshape(len(cm), cell, len(cm), cell, 3)
    assert (blocks == blocks[:, :1, :, :1]).all()  # one colour a cell
    want = (mpl_cm.viridis(Normalize(cm.min(), cm.max())(cm)) * 255).astype(np.uint8)[..., :3]
    np.testing.assert_array_equal(blocks[:, 0, :, 0], want)
    scaled = (cm - cm.min()) / max(cm.max() - cm.min(), 1)
    np.testing.assert_array_equal(blocks[:, 0, :, 0], VIRIDIS_LUT[np.clip((scaled * 256).astype(int), 0, 255)])
