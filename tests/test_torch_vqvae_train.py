"""The port's VQ-VAE training against the JAX ``VQVAETask``, on the CPU.

A small config: hidden 16, 16 codes, latent 4, 16×16 images (4×4×4
latents), batch 4, float32. Weights and codebook cross with
``bridge.state_dict_from_flax``. The codebook search is an argmin, so each
comparison checks the indices first: an index that differs between the two
packages must be a tie within float32 rounding of the two distances.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spectrogramgenai_tpu.core import config as jc  # noqa: E402
from spectrogramgenai_tpu.core.mesh import MeshSpec, create_mesh  # noqa: E402
from spectrogramgenai_tpu.data.transforms import renorm_m1_1 as jax_renorm  # noqa: E402
from spectrogramgenai_tpu.models.vqvae import VQEmbeddingEMA as JaxCodebook  # noqa: E402
from spectrogramgenai_tpu.train.state import new_train_state  # noqa: E402
from spectrogramgenai_tpu.train.vqvae_task import VQVAETask as JaxTask  # noqa: E402
from spectrogramgenai_tpu_torch.audio.export import encode_png_rgb  # noqa: E402
from spectrogramgenai_tpu_torch.bridge import state_dict_from_flax  # noqa: E402
from spectrogramgenai_tpu_torch.core import config as tc  # noqa: E402
from spectrogramgenai_tpu_torch.core.checkpoint import CheckpointManager  # noqa: E402
from spectrogramgenai_tpu_torch.data.transforms import renorm_m1_1  # noqa: E402
from spectrogramgenai_tpu_torch.models.vqvae import VQVAE, VQEmbeddingEMA  # noqa: E402
from spectrogramgenai_tpu_torch.train.common import microbatch_accumulate  # noqa: E402
from spectrogramgenai_tpu_torch.train.vqvae_task import VQVAETask  # noqa: E402
from torch_port_helpers import one_torch_thread, random_flax_variables  # noqa: E402, F401

CFG_KW = dict(hidden_dim=16, n_embeddings=16, compute_dtype="float32")
BATCH, SIZE = 4, 16
# float32 train state, as tests/test_torch_train.py holds the DDPM's: Adam
# moves an element whose gradient cancels to near 0 by up to ~lr a step on
# the sign of its rounding (3 steps of lr 2e-4 sum to 6e-4)
RTOL, ATOL = 1e-4, 5e-5
GRAD_TOL = 1e-4  # per tensor, relative to its own norm


def _nearest64(x: np.ndarray, emb: np.ndarray) -> np.ndarray:
    """(N, D) → the squared distance of each row to every code, in float64."""
    x, emb = x.astype(np.float64), emb.astype(np.float64)
    return (x**2).sum(1, keepdims=True) - 2.0 * x @ emb.T + (emb**2).sum(1)[None, :]


def assert_same_codes(got: np.ndarray, want: np.ndarray, x: np.ndarray, emb: np.ndarray) -> None:
    """Indices equal, or, where one differs, the two codes' distances tie
    within float32 rounding (|d| · 2⁻²² of the float32 sum's terms)."""
    got, want = got.reshape(-1), want.reshape(-1)
    diff = np.nonzero(got != want)[0]
    if len(diff):
        d2 = _nearest64(x.reshape(len(got), -1)[diff], emb)
        rows = np.arange(len(diff))
        scale = (x.reshape(len(got), -1)[diff].astype(np.float64) ** 2).sum(1) + (emb.astype(np.float64) ** 2).sum(1).max()
        gap = np.abs(d2[rows, got[diff]] - d2[rows, want[diff]])
        assert (gap <= 2.0**-22 * scale).all(), (diff, gap, scale)


def _jax_task(grad_accum: int = 1):
    mesh = create_mesh(MeshSpec(data=1, model=1), devices=jax.devices()[:1])
    jt = JaxTask(jc.VQVAEConfig(**CFG_KW, grad_accum=grad_accum), mesh)
    variables = random_flax_variables(jt.model, jnp.zeros((1, SIZE, SIZE, 1)), seed=2)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = {"codebook": jax.tree_util.tree_map(jnp.asarray, variables["codebook"])}
    return jt, variables, new_train_state(params, jt.tx, jax.random.PRNGKey(0), stats=stats)


def _port_task(variables, grad_accum: int = 1):
    task = VQVAETask(tc.VQVAEConfig(**CFG_KW, grad_accum=grad_accum), "cpu")
    return task, task.init_state(0, state_dict_from_flax(task.model, variables))


def _images(steps: int, seed: int = 3):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (BATCH, SIZE, SIZE, 1)).astype(np.float32) for _ in range(steps)]


def _port_form(model, jstate) -> dict[str, torch.Tensor]:
    return state_dict_from_flax(model, {"params": jstate.params, **jstate.stats})


def _assert_state_close(task, state, jstate, check_moments=True):
    want = _port_form(task.model, jstate)
    for k, w in want.items():
        got = state.params[k] if k in state.params else state.stats[k]
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=RTOL, atol=ATOL, err_msg=k)
    if check_moments:
        adam = jstate.opt_state[0]
        for name, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
            moments = state_dict_from_flax(task.model, {"params": tree, **jstate.stats})
            for k in state.params:
                g, w = state.opt_state()[f"{name}.{k}"], moments[k]
                assert (g - w).norm().item() <= GRAD_TOL * w.norm().item() + 1e-30, f"{name}.{k}"


# -- the codebook's train forward --------------------------------------------------

@pytest.mark.parametrize("train", [True, False])
def test_codebook_forward_matches_jax(train):
    rng = np.random.default_rng(0)
    m, d = 16, 4
    emb = rng.uniform(-1 / m, 1 / m, (m, d)).astype(np.float32)
    count = rng.uniform(0.5, 2.0, m).astype(np.float32)
    cb = {"embedding": emb, "ema_count": count, "ema_weight": (emb * count[:, None]).astype(np.float32)}
    x = (0.05 * rng.standard_normal((2, 4, 4, d))).astype(np.float32)

    (q, commit, codebook, perp), upd = JaxCodebook(m, d).apply(
        {"codebook": {k: jnp.asarray(v) for k, v in cb.items()}}, jnp.asarray(x), train=train,
        mutable=["codebook"])
    port = VQEmbeddingEMA(m, d)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in cb.items()})
    _, want_idx = JaxCodebook(m, d).apply({"codebook": cb}, jnp.asarray(x), method="encode")
    got_idx = port._nearest(torch.from_numpy(x).reshape(-1, d)).numpy()
    assert_same_codes(got_idx, np.asarray(want_idx), x, emb)

    xt = torch.from_numpy(x).requires_grad_()
    tq, tcommit, tcodebook, tperp = port(xt, train=train)
    np.testing.assert_allclose(tq.detach().numpy(), np.asarray(q), rtol=1e-6, atol=1e-7)
    for got, want in ((tcommit, commit), (tcodebook, codebook), (tperp, perp)):
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    new = upd["codebook"]
    for k in ("embedding", "ema_count", "ema_weight"):
        want = np.asarray(new[k]) if train else cb[k]
        np.testing.assert_allclose(getattr(port, k).numpy(), want, rtol=1e-6, atol=1e-9, err_msg=k)
    # the straight-through output carries x's gradient; the commitment loss β·2(x − q)/n
    tq.sum().backward()
    torch.testing.assert_close(xt.grad, torch.ones_like(xt))


# -- the train step ------------------------------------------------------------------

def test_first_step_gradients_match_jax():
    jt, variables, jstate = _jax_task()
    task, state = _port_task(variables)
    (images,) = _images(1)
    x = jnp.asarray(images)
    jgrads = jax.jit(jax.grad(lambda p: jt._loss(p, jstate.stats, jax_renorm(x))[0]))(jstate.params)
    want = state_dict_from_flax(task.model, {"params": jgrads, **jstate.stats})
    module = dict(task.model.named_parameters())

    def loss_fn(mb):
        return task._losses(renorm_m1_1(torch.from_numpy(images)), train=True)[0], {}

    _, grads, _ = microbatch_accumulate(loss_fn, [{}], [module[n] for n in state.params])
    for name, g in zip(state.params, grads):
        w = want[name]
        assert (g - w).norm().item() <= GRAD_TOL * w.norm().item(), name


def _codes(task, jt, jstate, images: np.ndarray) -> None:
    """Both packages' codebook search on the batch, at the state before the step."""
    with torch.no_grad():
        z = task.model.encode(renorm_m1_1(torch.from_numpy(images)))
        _, got = task.model.codebook.encode(z)
    _, want = jt.model.apply({"params": jstate.params, **jstate.stats}, jax_renorm(jnp.asarray(images)),
                             method=lambda m, x: m.codebook.encode(m.encoder(x)))
    assert_same_codes(got.numpy(), np.asarray(want), z.numpy(), np.asarray(jstate.stats["codebook"]["codebook"]["embedding"]))


def _run_both(grad_accum: int, steps: int):
    jt, variables, jstate = _jax_task(grad_accum)
    task, state = _port_task(variables, grad_accum)
    jstep = jax.jit(jt._train_step)
    metrics = []
    for images in _images(steps):
        _codes(task, jt, jstate, images)
        jstate, jm = jstep(jstate, jnp.asarray(images))
        state, m = task.train_step(state, torch.from_numpy(images))
        metrics.append((m, jm))
    return task, state, jstate, metrics


@pytest.fixture(scope="module")
def three_steps():
    return _run_both(grad_accum=1, steps=3)


def test_one_and_three_train_steps_match_jax(three_steps):
    task, state, jstate, metrics = three_steps
    assert state.step == int(jstate.step) == 3
    for m, jm in metrics:
        assert set(m) == set(jm) == {"recon_mse", "commitment", "codebook", "perplexity", "loss"}
        for k in m:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    _assert_state_close(task, state, jstate)


def test_one_train_step_matches_jax():
    task, state, jstate, _ = _run_both(grad_accum=1, steps=1)
    _assert_state_close(task, state, jstate)
    # the EMA count started at 0: one update holds (1 − decay) of the batch's 64 assignments
    np.testing.assert_allclose(float(state.stats["codebook.ema_count"].sum()), 1e-3 * 64, rtol=1e-5)


def test_two_microbatches_thread_the_codebook():
    task, state, jstate, metrics = _run_both(grad_accum=2, steps=2)
    assert state.step == int(jstate.step) == 2
    for m, jm in metrics:
        for k in m:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    _assert_state_close(task, state, jstate)
    # four codebook updates of 32 assignments each, in order (the Laplace
    # smoothing keeps the count's sum): Σ 32·(1 − d)·dⁱ for i < 4
    d = 0.999
    np.testing.assert_allclose(float(state.stats["codebook.ema_count"].sum()),
                               sum(32 * (1 - d) * d**i for i in range(4)), rtol=1e-5)


def test_eval_step_and_reconstruct_match_jax(three_steps):
    task, state, jstate, _ = three_steps
    jt = JaxTask(jc.VQVAEConfig(**CFG_KW), create_mesh(MeshSpec(data=1, model=1), devices=jax.devices()[:1]))
    (images,) = _images(1, seed=9)
    want = jax.jit(jt._eval_step)(jstate, jnp.asarray(images))
    embedding = state.stats["codebook.embedding"].clone()
    got = task.eval_step(state, torch.from_numpy(images))
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, err_msg=k)
    assert torch.equal(state.stats["codebook.embedding"], embedding)  # eval leaves the codebook
    x_hat, z, z_q = task.reconstruct(state, torch.from_numpy(images))
    jx_hat, jz, jz_q = jt.reconstruct(jstate, jnp.asarray(images))
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(x_hat.numpy(), np.asarray(jx_hat), rtol=1e-4, atol=1e-4)
    assert x_hat.shape == (BATCH, SIZE, SIZE, 1) and z_q.shape == (BATCH, 4, 4, 4)


# -- the CLI -----------------------------------------------------------------------------

def _folder(root, n_train: int = 6, n_val: int = 2, size: int = SIZE):
    for split, n in (("train", n_train), ("val", n_val)):
        rng = np.random.default_rng(len(split))
        for c in ("ant", "bee"):
            d = root / "datasets" / split / c
            d.mkdir(parents=True)
            for i in range(n):
                (d / f"{i}.png").write_bytes(encode_png_rgb(rng.integers(0, 256, (size, size, 3), dtype=np.uint8)))


def test_vqvae_cli_runs_resumes_and_feeds_ddpm(tmp_path, monkeypatch, capsys):
    from spectrogramgenai_tpu_torch.cli import train_ddpm, train_vqvae

    monkeypatch.chdir(tmp_path)
    _folder(tmp_path, size=32)
    cfg = tc.VQVAEConfig(**CFG_KW, epochs=2, data=tc.DataConfig(dataset_path="datasets", img_size=32, batch_size=4),
                         run=tc.RunConfig(run_name="vq", seed=0, log_every=1))
    _, state = train_vqvae.run(cfg, device="cpu")
    assert state.step == 6  # 12 images, batch 4, 2 epochs
    out = capsys.readouterr().out
    assert "epoch 1: 3 steps" in out and "saved VQ-VAE step 6" in out
    assert sorted(os.listdir("results/vq")) == ["metrics.jsonl", "recon_epoch_000.png", "recon_epoch_001.png"]
    records = [json.loads(line) for line in open("results/vq/metrics.jsonl")]
    assert [r["step"] for r in records if "recon_mse" in r] == [1, 2, 3, 4, 5, 6]
    assert sum("val_recon_mse" in r for r in records) == 2

    saved = CheckpointManager("models/vq").restore()
    assert set(saved) == {"params", "opt_state", "step", "rng"} and int(saved["step"]) == 6
    assert set(saved["params"]) == set(VQVAE(hidden_dim=16, n_embeddings=16).state_dict())

    # 2 epochs, then 1 resumed, are 3 epochs straight
    _, resumed = train_vqvae.run(dataclasses.replace(cfg, epochs=1), device="cpu")
    assert "resumed VQ-VAE from step 6" in capsys.readouterr().out and resumed.step == 9
    (tmp_path / "straight").mkdir()
    monkeypatch.chdir(tmp_path / "straight")
    os.symlink(tmp_path / "datasets", "datasets")
    _, straight = train_vqvae.run(dataclasses.replace(cfg, epochs=3), device="cpu")
    for k, v in straight.params.items():
        assert torch.equal(resumed.params[k], v), k
    for k, v in straight.stats.items():
        assert torch.equal(resumed.stats[k], v), k
    for k, v in straight.opt_state().items():
        assert torch.equal(resumed.opt_state()[k], v), k

    # the checkpoint feeds the latent DDPM trainer as written
    monkeypatch.chdir(tmp_path)
    ddpm = tc.DDPMConfig(img_size=32, num_classes=2, noise_steps=20, width_mult=0.125, remove_deep_conv=True,
                         vq_hidden_dim=16, vq_n_embeddings=16, compute_dtype="float32", vqae_ckpt="models/vq",
                         epochs=1, data=tc.DataConfig(dataset_path="datasets", img_size=32, batch_size=4),
                         run=tc.RunConfig(run_name="ddpm", seed=0))
    assert train_ddpm.load_vq_variables("models/vq").keys() == saved["params"].keys()
    assert train_ddpm.run(ddpm, device="cpu").step == 3
