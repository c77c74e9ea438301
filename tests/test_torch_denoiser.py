"""The port's transformer denoiser, ε-mix front end, SpecUNet trainer and the classifiers' denoiser
preprocessing against the JAX package, on the CPU.

Float32. The denoiser is compared at 64×64 with d_model 64 and 2 layers, and
once at full width (256², d_model 512, 6 layers, batch 1); the step with d_model
64 and 2 layers, swapped into both tasks. Weights cross with
``bridge.state_dict_from_flax``. Dropout draws its masks from each package's
own stream, so the train step takes NumPy-seeded keep masks: into the port
by Dropout path, into the JAX model by ``flax.linen.intercept_methods``
around ``nn.Dropout`` (the JAX step's microbatch scan traces its body once,
so with ``grad_accum`` = k each microbatch gets the same mask, and the port
is given that mask k times over). Adam's first update is lr·g/(|g| + eps) ≈
lr·sign(g), so the step's gradients are compared through Adam's first
moment (0.1·g) and the parameters where |g| is well above rounding.
"""

import functools
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from scipy.io import wavfile  # noqa: E402

from spectrogramgenai_tpu.audio import mix as jmix  # noqa: E402
from spectrogramgenai_tpu.audio import wavio as jwavio  # noqa: E402
from spectrogramgenai_tpu.audio.spectrogram import SpectrogramConfig as JaxSpecConfig  # noqa: E402
from spectrogramgenai_tpu.cli import train_specunet as jcli  # noqa: E402
from spectrogramgenai_tpu.core import config as jc  # noqa: E402
from spectrogramgenai_tpu.core.mesh import MeshSpec, create_mesh  # noqa: E402
from spectrogramgenai_tpu.models import denoiser as jd  # noqa: E402
from spectrogramgenai_tpu.train import classifier_task as jctask  # noqa: E402
from spectrogramgenai_tpu.train import specunet_task as jtask  # noqa: E402
from spectrogramgenai_tpu.train.state import new_train_state  # noqa: E402
from spectrogramgenai_tpu_torch.audio import mix as tmix  # noqa: E402
from spectrogramgenai_tpu_torch.audio import wavio as twavio  # noqa: E402
from spectrogramgenai_tpu_torch.audio.export import encode_png_rgb  # noqa: E402
from spectrogramgenai_tpu_torch.audio.spectrogram import SpectrogramConfig  # noqa: E402
from spectrogramgenai_tpu_torch.bridge import state_dict_from_flax  # noqa: E402
from spectrogramgenai_tpu_torch.cli import train_classifiers as tclf  # noqa: E402
from spectrogramgenai_tpu_torch.cli import train_specunet as tcli  # noqa: E402
from spectrogramgenai_tpu_torch.core import config as tc  # noqa: E402
from spectrogramgenai_tpu_torch.core.checkpoint import CheckpointManager  # noqa: E402
from spectrogramgenai_tpu_torch.models import classifiers as tm  # noqa: E402
from spectrogramgenai_tpu_torch.models import denoiser as td  # noqa: E402
from spectrogramgenai_tpu_torch.train import classifier_task as tctask  # noqa: E402
from spectrogramgenai_tpu_torch.train import specunet_task as ttask  # noqa: E402
from torch_port_helpers import one_torch_thread, random_flax_variables  # noqa: E402, F401

SIZE, D_MODEL, LAYERS = 64, 64, 2
FWD_RTOL, FWD_ATOL = 1e-4, 1e-5  # float32 forwards: convolutions and matmuls summed in another order
GRAD_TOL = 1e-4  # a step's gradient per tensor, relative to its norm
LR = 1e-3
# the plain log-mel against the JAX one within 5e-3 dB, as tests/test_torch_gen_specs.py holds it;
# after the midpoint normalisation (s − m)/m with |m| ≈ 40 dB that is ≤ 5e-3·(1/40 + 80/40²) ≈ 4e-4
NORM_ATOL = 4e-4


def _variables(module, *args, seed: int = 0, **kw) -> dict:
    return random_flax_variables(types.SimpleNamespace(init=functools.partial(module.init, **kw)), *args, seed=seed)


def _pair(out_channels: int = 1, d_model: int = D_MODEL, layers: int = LAYERS, size: int = SIZE, seed: int = 0):
    jmodel = jd.TransformerDenoiser(out_channels=out_channels, num_layers=layers, d_model=d_model)
    variables = _variables(jmodel, jnp.zeros((1, size, size, 1)), seed=seed)
    tmodel = td.TransformerDenoiser(out_channels=out_channels, num_layers=layers, d_model=d_model)
    tmodel.load_state_dict(state_dict_from_flax(tmodel, variables))
    return jmodel, variables, tmodel


class _Masks:
    """NumPy-seeded dropout keep masks by Dropout path (``TransformerEncoderLayer_0.Dropout_1``),
    made at a Dropout's first call; as a flax interceptor it applies them in the JAX model."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.masks: dict[str, np.ndarray] = {}

    def __call__(self, next_fun, args, kwargs, context):
        mod = context.module
        if not isinstance(mod, fnn.Dropout) or context.method_name != "__call__":
            return next_fun(*args, **kwargs)
        x = args[0]
        det = fnn.module.merge_param("deterministic", mod.deterministic, kwargs.get("deterministic"))
        if det or mod.rate == 0.0:
            return next_fun(*args, **kwargs)
        name = ".".join(mod.scope.path)
        if name not in self.masks:
            self.masks[name] = self.rng.uniform(size=x.shape) >= mod.rate
        return jnp.where(self.masks[name], x / (1.0 - mod.rate), jnp.zeros_like(x))

    def torch(self, repeat: int = 1) -> dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.concatenate([v] * repeat)) for k, v in self.masks.items()}


def _close(got, want, rtol=FWD_RTOL, atol=FWD_ATOL, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


# -- the model ----------------------------------------------------------------------

def test_denoiser_matches_jax():
    jmodel, variables, tmodel = _pair(out_channels=2)
    x = np.random.default_rng(1).uniform(-1, 1, (2, SIZE, SIZE, 1)).astype(np.float32)
    got = tmodel(torch.from_numpy(x))
    assert got.shape == (2, SIZE, SIZE, 2) and got.dtype == torch.float32
    _close(got, jmodel.apply(variables, jnp.asarray(x)))
    masks = _Masks(seed=2)  # train mode: dropout 0.1 after the attention, the ReLU and the FFN, each layer
    with fnn.intercept_methods(masks):
        want = jmodel.apply(variables, jnp.asarray(x), deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)})
    assert sorted(masks.masks) == [f"TransformerEncoderLayer_{i}.Dropout_{j}" for i in range(LAYERS) for j in range(3)]
    _close(tmodel(torch.from_numpy(x), keep=tm.DropoutKeep(masks=masks.torch())), want)


def test_full_width_denoiser_matches_jax():
    jmodel, variables, tmodel = _pair(d_model=512, layers=6, size=256)
    x = np.random.default_rng(3).uniform(-1, 1, (1, 256, 256, 1)).astype(np.float32)
    got = tmodel(torch.from_numpy(x))
    assert got.shape == (1, 256, 256, 1)
    _close(got, jmodel.apply(variables, jnp.asarray(x)))


def test_conv_transpose_same_is_the_cropped_adjoint():
    # flax ConvTranspose(3×3, stride 2, "SAME"): torch's adjoint with no padding and the kernel
    # flipped (the bridge flips it), keeping the first 2n rows and columns; padding=1 with
    # output_padding=1 keeps rows 1 … 2n instead
    jconv = fnn.ConvTranspose(3, (3, 3), strides=(2, 2), padding="SAME")
    x = np.random.default_rng(4).standard_normal((2, 5, 5, 4)).astype(np.float32)
    variables = _variables(jconv, jnp.asarray(x))
    want = np.asarray(jconv.apply(variables, jnp.asarray(x)))
    holder = torch.nn.Module()
    holder.c = td.ConvTranspose2dSame(4, 3)
    holder.load_state_dict(state_dict_from_flax(holder, {"params": {"c": variables["params"]}}))
    got = holder.c(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == (2, 10, 10, 3)
    _close(got, want, 1e-5, 1e-6)
    other = torch.nn.functional.conv_transpose2d(torch.from_numpy(x).permute(0, 3, 1, 2), holder.c.weight,
                                                 holder.c.bias, stride=2, padding=1, output_padding=1)
    assert np.abs(other.permute(0, 2, 3, 1).detach().numpy() - want).max() > 0.1


# -- the ε-mix front end --------------------------------------------------------------

def _wavs(root, rng, specs) -> list[str]:
    paths = []
    for name, sr, seconds, kind in specs:
        t = np.arange(int(sr * seconds)) / sr
        x = 0.4 * np.sin(2 * np.pi * rng.uniform(500, 4000) * t) + 0.05 * rng.standard_normal(len(t))
        data = (np.clip(x, -1, 1) * 32767).astype(np.int16) if kind == "int16" else x.astype(np.float32)
        path = str(root / name)
        wavfile.write(path, sr, data)
        paths.append(path)
    return paths


def test_load_wav_fixed_window_and_midpoint_normalize_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    paths = _wavs(tmp_path, rng, [("a.wav", 44100, 2.0, "int16"), ("b.wav", 22050, 1.0, "float32"),
                                  ("c.wav", 16000, 3.0, "int16")])
    for path in paths:
        for target in (None, 22050):
            got, sr = twavio.load_wav(path, target_sr=target)
            want, jsr = jwavio.load_wav(path, target_sr=target)
            assert sr == jsr and got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
            for start, n in ((0.5, 30_000), (10.0, 30_000), (0.0, 200_000)):  # inside, the tail, tiled
                np.testing.assert_array_equal(twavio.fixed_window(got, sr, start, n), jwavio.fixed_window(want, sr, start, n))
    spec = rng.uniform(-80, 0, (256, 256)).astype(np.float32)
    for s in (spec, spec + 100.0):  # m < 0 and m > 0
        want = jmix.midpoint_normalize(s)
        np.testing.assert_array_equal(tmix.midpoint_normalize(s), want)
        np.testing.assert_array_equal(tmix.midpoint_normalize_batch(torch.from_numpy(s[None]))[0].numpy(), want)


def test_mix_rounds_the_float64_mix_once():
    # ε is float64, so the mix and its rescale are float64, rounded to float32 once
    rng = np.random.default_rng(6)
    noise, bird = (rng.uniform(-1, 1, (3, 4096)).astype(np.float32) for _ in range(2))
    eps = rng.uniform(0, 0.3, 3)
    stacked = tmix.mix_stack(noise, bird, eps)
    assert stacked.dtype == np.float32 and stacked.shape == (9, 4096)
    np.testing.assert_array_equal(stacked[:3], jmix.rescale_batch(noise))
    np.testing.assert_array_equal(stacked[6:], jmix.rescale_batch(eps[:, None] * noise + (1 - eps[:, None]) * bird)
                                  .astype(np.float32))
    mix32 = eps[:, None].astype(np.float32) * noise + (1 - eps[:, None].astype(np.float32)) * bird
    assert not np.array_equal(stacked[6:], jmix.rescale_batch(mix32))
    for got, want in zip(tmix.mix_waveforms(noise[0], bird[0], eps[0]), jmix.mix_waveforms(noise[0], bird[0], eps[0])):
        np.testing.assert_array_equal(got, want)  # the one-pair form, and rescale_wav under it
    np.testing.assert_array_equal(tmix.rescale_wav(noise[1]), jmix.rescale_wav(noise[1]))


def test_mix_batch_specs_matches_jax_plain_path():
    rng = np.random.default_rng(7)
    n = 2**17
    noise = np.stack([jwavio.normalize_peak(rng.standard_normal(n).astype(np.float32)) for _ in range(2)])
    t = np.arange(n) / 22050
    bird = np.stack([jwavio.normalize_peak((np.sin(2 * np.pi * f * t) * np.sin(np.pi * t / t[-1])).astype(np.float32))
                     for f in (1800.0, 3500.0)])
    eps = rng.uniform(0, 0.3, 2)
    want = jmix.mix_batch_specs(noise, bird, eps, JaxSpecConfig(), use_pallas=False)
    got = tmix.mix_batch_specs(noise, bird, eps, SpectrogramConfig(), device="cpu")
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2, 256, 256)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=NORM_ATOL)


# -- the train step -----------------------------------------------------------------

def _step_both(mode: str, grad_accum: int = 1, batch: int = 2):
    """One SpecUNet step of each package from the same weights, batch and dropout masks."""
    mesh = create_mesh(MeshSpec(data=1, model=1), devices=jax.devices()[:1])
    kw = dict(mode=mode, compute_dtype="float32", grad_accum=grad_accum)
    out_c = 1 if mode == "denoise" else 2
    rng = np.random.default_rng(8)
    mix, noise, bird = (rng.uniform(-1, 1, (batch, SIZE, SIZE, 1)).astype(np.float32) for _ in range(3))
    jmodel, variables, _ = _pair(out_channels=out_c, seed=9)
    jt = jtask.SpecUNetTask(jc.SpecUNetConfig(**kw), mesh)
    jt.model = jmodel
    jstate = new_train_state(variables["params"], jt.tx, jax.random.PRNGKey(0))
    masks = _Masks(seed=10)
    with fnn.intercept_methods(masks):
        jstate, jm = jax.jit(jt._train_step)(jstate, jnp.asarray(mix), jnp.asarray(noise), jnp.asarray(bird))
    tt = ttask.SpecUNetTask(tc.SpecUNetConfig(**kw), "cpu")
    tt.model = td.TransformerDenoiser(out_channels=out_c, num_layers=LAYERS, d_model=D_MODEL)
    state = tt.init_state(0, state_dict_from_flax(tt.model, variables))
    initial = {k: v.clone() for k, v in state.params.items()}
    state, m = tt.train_step(state, torch.from_numpy(mix), torch.from_numpy(noise), torch.from_numpy(bird),
                             keep=masks.torch(repeat=grad_accum))
    return jt, jax.tree_util.tree_map(np.asarray, (jstate, jm)), tt, state, m, initial


@pytest.mark.parametrize("mode, grad_accum", [("separate", 1), ("denoise", 2)])
def test_train_step_matches_jax(mode, grad_accum):
    jt, (jstate, jm), tt, state, m, initial = _step_both(mode, grad_accum)
    assert state.step == int(jstate.step) == 1
    np.testing.assert_allclose(float(m["train_mse"]), float(jm["train_mse"]), rtol=1e-5)
    jgrads = state_dict_from_flax(tt.model, {"params": jax.tree_util.tree_map(lambda a: a / 0.1,
                                                                              jstate.opt_state[0].mu)})
    want = state_dict_from_flax(tt.model, {"params": jstate.params})
    scale = max(float(g.abs().max()) for g in jgrads.values())
    for k, p in state.params.items():
        g, gj = state.opt_state()[f"exp_avg.{k}"] / 0.1, jgrads[k]
        assert float((g - gj).norm()) <= GRAD_TOL * float(gj.norm()) + 1e-6 * scale * g.numel() ** 0.5, k
        # Adam's first update lr·g/(|g| + 1e-8): equal where |g| is well above eps and rounding
        sure = (gj.abs() > max(1e-3 * float(gj.abs().max()), 1e-4)) & ((g - gj).abs() <= 0.01 * gj.abs())
        _close(p[sure], want[k].numpy()[sure.numpy()], 1e-5, 1e-6, k)
        assert float((p - want[k]).abs().max()) <= 2 * LR + 1e-5, k
        assert not torch.equal(p, initial[k]), k
    for k, v in tt.model.named_parameters():  # the working copy is the masters
        assert torch.equal(v, state.params[k]), k
    pred_noise, pred_bird = tt.separate(state, torch.zeros(1, SIZE, SIZE, 1))
    assert pred_noise.shape == (1, SIZE, SIZE, 1) and pred_bird.shape == (1, SIZE, SIZE, 2 - (mode == "denoise") - 1)


# -- the CLIs -----------------------------------------------------------------------

def _recordings(root, rng):
    """Noise and bird WAVs (some at 44.1 kHz, so that target_sr resamples) and their CSVs."""
    root.mkdir(parents=True, exist_ok=True)
    noise = _wavs(root, rng, [(f"noise{i}.wav", sr, 3.0, "int16") for i, sr in enumerate((22050, 44100, 22050))])
    bird = _wavs(root, rng, [(f"bird{i}.wav", sr, 7.0, "float32") for i, sr in enumerate((44100, 22050, 22050))])
    with open(root / "noise.csv", "w") as f:
        f.write("path,st,common_name\n" + "".join(f"{p},0.0,noise\n" for p in noise))
    with open(root / "birds.csv", "w") as f:
        f.write("path,st,common_name\n" + "".join(f"{p},{st},bird{i}\n" for i, (p, st)
                                                  in enumerate(zip(bird, ("0.1", "1.3", "6.9")))))
    return str(root / "noise.csv"), str(root / "birds.csv")


def test_make_mix_batches_matches_jax(tmp_path):
    import pandas as pd

    noise_csv, bird_csv = _recordings(tmp_path / "rec", np.random.default_rng(11))
    want = list(jcli.make_mix_batches(pd.read_csv(noise_csv), pd.read_csv(bird_csv), 22050, 2, seed=3,
                                      use_pallas=False))
    got = list(tcli.make_mix_batches(tcli.read_rows(noise_csv), tcli.read_rows(bird_csv), 22050, 2, seed=3,
                                     device="cpu"))
    assert len(got) == len(want) == 1
    for k in ("noise", "bird", "mix"):
        assert got[0][k].shape == want[0][k].shape == (2, 256, 256, 1)
        np.testing.assert_allclose(got[0][k].numpy(), want[0][k], rtol=0, atol=NORM_ATOL, err_msg=k)
    assert got[0]["labels"] == want[0]["labels"]


@pytest.mark.parametrize("mode", ["separate", "denoise"])
def test_train_specunet_cli_runs(tmp_path, monkeypatch, capsys, mode):
    # a small denoiser (d_model 64, 2 layers) in the CLI's task
    monkeypatch.setattr(ttask, "TransformerDenoiser", functools.partial(td.TransformerDenoiser, num_layers=LAYERS,
                                                                         d_model=D_MODEL))
    monkeypatch.chdir(tmp_path)
    noise_csv, bird_csv = _recordings(tmp_path / "rec", np.random.default_rng(12))
    task, state = tcli.main(["--noise_csv", noise_csv, "--bird_csv", bird_csv, "--mode", mode, "--epochs", "1",
                             "--data.batch_size", "2", "--compute_dtype", "float32", "--run.log_every", "1",
                             "--device", "cpu"])
    out = capsys.readouterr().out
    assert state.step == 1 and "epoch 0: 1 steps in" in out and "mel kernel" in out and "load/resample" in out
    assert CheckpointManager("models/specunet").all_steps() == [1]
    assert os.path.exists("results/specunet/sep_examples_epoch_000.png")
    assert all(np.isfinite(float(line.split("train_mse ")[1].split(";")[0])) for line in out.splitlines()
               if line.startswith("epoch "))
    if mode == "denoise":
        # the checkpoint feeds the classifiers' preprocessing, its width read from its shapes
        apply = tclf.load_denoiser_apply("models/specunet", "cpu")
        x = torch.rand(2, SIZE, SIZE, 1) * 2 - 1
        np.testing.assert_allclose(apply(x).numpy(), task.separate(state, x)[0].numpy(), rtol=1e-5, atol=1e-6)


def test_denoise_mode_figure_leaves_out_the_bird(tmp_path):
    # the JAX CLI draws a "pred bird" panel in denoise mode too, where the net has no bird
    # channel: matplotlib refuses the (H, W, 0) image; the port draws four columns
    batch = {k: np.zeros((2, 8, 8, 1), np.float32) for k in ("mix", "noise", "bird")}
    fake = types.SimpleNamespace(separate=lambda state, mix: (np.asarray(mix), np.asarray(mix)[..., 1:]))
    with pytest.raises(TypeError, match="Invalid shape"):
        jcli._plot_separation(fake, None, batch, str(tmp_path), 0)
    fake_t = types.SimpleNamespace(separate=lambda state, mix: (mix, mix[..., 1:]))
    tcli._plot_separation(fake_t, None, {k: torch.from_numpy(v) for k, v in batch.items()}, str(tmp_path), 0)
    assert os.path.getsize(tmp_path / "sep_examples_epoch_000.png") > 0


# -- the classifiers' denoiser preprocessing -----------------------------------------------

def test_classifier_denoiser_preprocessing_matches_jax():
    mesh = create_mesh(MeshSpec(data=1, model=1), devices=jax.devices()[:1])
    jmodel, variables, tmodel = _pair(seed=13)
    images = np.random.default_rng(14).uniform(0, 1, (3, SIZE, SIZE, 1)).astype(np.float32)
    for use_denoiser in (True, False):
        kw = dict(model_name="resnet", num_classes=5, use_denoiser=use_denoiser, compute_dtype="float32")
        jt = jctask.ClassifierTask(jc.ClassifierConfig(**kw), mesh,
                                   denoiser_apply=lambda x: jmodel.apply(variables, x, deterministic=True))
        tt = tctask.ClassifierTask(tc.ClassifierConfig(**kw, data=tc.DataConfig(img_size=SIZE)), "cpu",
                                   denoiser_apply=lambda x: tmodel(x))
        want = np.asarray(jt._preprocess(jnp.asarray(images)))
        got = tt.preprocess(torch.from_numpy(images))
        assert got.shape == (3, SIZE, SIZE, 3)
        _close(got, want)
        plain = np.broadcast_to(np.asarray(jctask.renorm_m1_1(jnp.asarray(images))), want.shape)
        assert np.allclose(want, plain) != use_denoiser


def test_train_classifiers_cli_with_denoiser_ckpt(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(15)
    for split, n in (("train", 3), ("val", 2)):
        for c in ("ant", "bee"):
            os.makedirs(f"datasets/{split}/{c}")
            for i in range(n):
                with open(f"datasets/{split}/{c}/{i}.png", "wb") as f:
                    f.write(encode_png_rgb(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)))
    den = td.TransformerDenoiser(num_layers=1, d_model=32)
    CheckpointManager("models/den").save(7, {"params": den.state_dict()})
    seen = []
    init = tctask.ClassifierTask.__init__

    def spy(self, cfg, device, denoiser_apply=None):
        seen.append((cfg.use_denoiser, denoiser_apply is not None))
        init(self, cfg, device, denoiser_apply)

    monkeypatch.setattr(tctask.ClassifierTask, "__init__", spy)
    results = tclf.main(["--train_dir", "datasets/train", "--val_dir", "datasets/val", "--models", "custom",
                         "--synths", "0", "--epochs", "1", "--data.img_size", "32", "--data.batch_size", "2",
                         "--compute_dtype", "float32", "--denoiser_ckpt", "models/den", "--device", "cpu"])
    assert set(results) == {("custom", 0)} and seen == [(True, True)]
    line = next(x for x in capsys.readouterr().out.splitlines() if x.startswith("custom_synth0 epoch 0"))
    assert np.isfinite(float(line.split("train_loss=")[1].split()[0]))
    with pytest.raises(FileNotFoundError, match="denoiser"):
        tclf.load_denoiser_apply("models/none", "cpu")
    assert tclf.load_denoiser_apply(None) is None
