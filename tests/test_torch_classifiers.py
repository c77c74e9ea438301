"""The port's classifier zoo, classifier training and sweep CLIs against the JAX package, on the CPU.

Five classes at 32×32, float32; 64×64 for the ensemble, ResNet18 and
MobileNetV2, whose last stages are 1×1 at 32×32. BatchNorm there
normalises one value per image in train mode, 2 or 4 in all, often clipped
alike by ReLU6 to a variance under 1e-8 that eps 1e-5 turns into a ~300×
magnifier of float32 rounding: both packages then read ~1e-3 from a
float64 evaluation of the same MobileNetV2 (7e-4 and 1.8e-3), where at
64×64 they read 2.3e-5 and 9.1e-5. Weights and
BatchNorm statistics cross with ``bridge.state_dict_from_flax``. Dropout
draws its masks from each package's own stream, so a train-mode comparison
injects NumPy-seeded keep masks: into the port through the train step's
``keep``, into the JAX model by ``flax.linen.intercept_methods`` around
``nn.Dropout``. VGG16 and the ensemble are compared on the forward and the
mask only: a step over VGG's 25088×4096 head costs too much time here.
"""

import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from spectrogramgenai_tpu.cli import train_classifiers as jcli  # noqa: E402
from spectrogramgenai_tpu.core import config as jc  # noqa: E402
from spectrogramgenai_tpu.core.mesh import MeshSpec, create_mesh  # noqa: E402
from spectrogramgenai_tpu.data.pipeline import ImageFolderSource as JaxImageFolderSource  # noqa: E402
from spectrogramgenai_tpu.eval.classification import ClassificationMetrics as JaxMetrics  # noqa: E402
from spectrogramgenai_tpu.eval.classification import confusion_matrix as jax_confusion_matrix  # noqa: E402
from spectrogramgenai_tpu.eval.classification import top_k_accuracy as jax_top_k_accuracy  # noqa: E402
from spectrogramgenai_tpu.models import classifiers as jm  # noqa: E402
from spectrogramgenai_tpu.train import classifier_task as jtask  # noqa: E402
from spectrogramgenai_tpu.train.state import new_train_state  # noqa: E402
from spectrogramgenai_tpu_torch.audio.export import encode_png_rgb  # noqa: E402
from spectrogramgenai_tpu_torch.bridge import state_dict_from_flax  # noqa: E402
from spectrogramgenai_tpu_torch.cli import train_classifiers as tcli  # noqa: E402
from spectrogramgenai_tpu_torch.core import config as tc  # noqa: E402
from spectrogramgenai_tpu_torch.data.pipeline import ImageFolderSource  # noqa: E402
from spectrogramgenai_tpu_torch.eval.classification import (  # noqa: E402
    ClassificationMetrics,
    confusion_matrix,
    top_k_accuracy,
)
from spectrogramgenai_tpu_torch.models import classifiers as tm  # noqa: E402
from spectrogramgenai_tpu_torch.train import classifier_task as ttask  # noqa: E402
from torch_port_helpers import one_torch_thread, random_flax_variables  # noqa: E402, F401

N_CLASSES = 5
SIZES = {"custom": 32, "resnet": 64, "vgg": 32, "mobilenet": 64, "ensemble": 64}
# float32 forward through up to 20 layers (the convolutions sum in another order)
FWD_RTOL, FWD_ATOL = 1e-4, 1e-4
# one Adam step of lr 1e-3, as tests/test_torch_train.py holds the DDPM's state
RTOL, ATOL = 1e-4, 5e-5


def _channels(name: str) -> int:
    return 1 if name == "ensemble" else tm.MODEL_CHANNELS[name]


def _images(name: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (n, SIZES[name], SIZES[name], _channels(name))).astype(np.float32)


class _Masks:
    """NumPy-seeded dropout keep masks, made at a Dropout's first call by its
    name and shape; as a flax interceptor it applies them in the JAX model."""

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
        if mod.name not in self.masks:
            self.masks[mod.name] = self.rng.uniform(size=x.shape) >= mod.rate
        return jnp.where(self.masks[mod.name], x / (1.0 - mod.rate), jnp.zeros_like(x))

    def torch(self) -> dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v) for k, v in self.masks.items()}


@functools.lru_cache(maxsize=None)
def _pair(name: str):
    """The JAX net, random flax variables for it (seed 0) and the port's net holding them."""
    jmodel = jm.build_classifier(name, N_CLASSES)
    variables = random_flax_variables(jmodel, jnp.zeros((1, SIZES[name], SIZES[name], _channels(name))), seed=0)
    with torch.device("meta"):  # no init of its own: it takes the bridged tensors
        tmodel = tm.build_classifier(name, N_CLASSES, img_size=SIZES[name])
    tmodel.load_state_dict(state_dict_from_flax(tmodel, variables), assign=True)
    return jmodel, variables, tmodel


def _as_port(model, variables) -> dict[str, torch.Tensor]:
    return state_dict_from_flax(model, variables)


# -- the nets' forward --------------------------------------------------------------

@pytest.mark.parametrize("name", list(SIZES))
def test_forward_eval_and_train_match_jax(name):
    jmodel, variables, tmodel = _pair(name)
    x = _images(name, 4, seed=1)
    want = jax.jit(functools.partial(jmodel.apply, train=False))(variables, jnp.asarray(x))
    got = tmodel(torch.from_numpy(x), train=False)
    assert got.dtype == torch.float32 and got.shape == (4, N_CLASSES)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=FWD_RTOL, atol=FWD_ATOL)

    masks = _Masks(seed=2)
    with fnn.intercept_methods(masks):  # the masks are made while jit traces
        want, updated = jax.jit(functools.partial(jmodel.apply, train=True, mutable=["batch_stats"]))(
            variables, jnp.asarray(x), rngs={"dropout": jax.random.PRNGKey(0)})
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), train=True, keep=tm.DropoutKeep(masks=masks.torch()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FWD_RTOL, atol=FWD_ATOL)
    assert bool(masks.masks) == (name in ("custom", "vgg", "mobilenet"))  # the ensemble's subs run in eval mode
    if name in ("resnet", "mobilenet", "vgg", "ensemble") and updated:
        # flax's running variance is the biased batch variance (nn.BatchNorm2d's is not)
        stats = _as_port(tmodel, {"params": variables["params"], **updated})
        for k, v in tmodel.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(v.numpy(), stats[k].numpy(), rtol=1e-5, atol=1e-6, err_msg=k)


def test_batchnorm_keeps_the_biased_variance():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 8, 8)).astype(np.float32)
    bn = tm.BatchNorm(3)
    bn(torch.from_numpy(x), train=True)
    var = x.transpose(1, 0, 2, 3).reshape(3, -1).var(axis=1)  # ddof 0
    np.testing.assert_allclose(bn.running_var.numpy(), 0.99 + 0.01 * var, rtol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(), 0.01 * x.mean(axis=(0, 2, 3)), atol=1e-8)


@pytest.mark.parametrize("name", list(SIZES))
def test_trainable_flags_match_jax_mask(name):
    jmodel, variables, tmodel = _pair(name)
    jmask = jm.trainable_mask(variables["params"], name)
    as_float = jax.tree_util.tree_map(lambda p, m: np.full(np.shape(p), float(m), np.float32),
                                      variables["params"], jmask)
    want = _as_port(tmodel, {**variables, "params": as_float})
    got = tm.trainable_mask(tmodel, name)
    assert set(got) == {k for k, _ in tmodel.named_parameters()}
    for k, flag in got.items():
        assert flag == bool(want[k].all()) == bool(want[k].any()), k
        assert tmodel.get_parameter(k).requires_grad == flag
    assert any(got.values()) and (name == "custom" or not all(got.values()))


@pytest.mark.parametrize("name", ["resnet", "vgg", "mobilenet", "ensemble"])
def test_frozen_prefix_runs_without_a_backward(name):
    # freeze_prefix: the layers before the trainable boundary run under
    # torch.no_grad, so no gradient reaches the input, while the trainable
    # layers get theirs
    with torch.device("meta"):
        model = tm.build_classifier(name, N_CLASSES, img_size=SIZES[name], freeze_prefix=True)
    model.load_state_dict(_pair(name)[2].state_dict(), assign=True)
    mask = tm.trainable_mask(model, name)
    x = torch.from_numpy(_images(name, 2, seed=3)).requires_grad_()
    model(x, train=True, keep=tm.DropoutKeep(torch.Generator().manual_seed(0))).sum().backward()
    assert x.grad is None
    assert all((p.grad is not None) == mask[k] for k, p in model.named_parameters())


# -- the train step -----------------------------------------------------------------

def _step_both(name: str, grad_accum: int = 1, batch: int = 4):
    """One train step of the port (float32) and of the JAX task in float64 (the
    net built with dtype float64, params, stats and Adam in float64 under
    ``jax.enable_x64``), from the same weights, batch and dropout masks."""
    mesh = create_mesh(MeshSpec(data=1, model=1), devices=jax.devices()[:1])
    size = SIZES[name]
    kw = dict(model_name=name, num_classes=N_CLASSES, compute_dtype="float32", grad_accum=grad_accum)
    rng = np.random.default_rng(4)
    images = rng.uniform(0, 1, (batch, size, size, 1))
    labels = rng.integers(0, N_CLASSES, batch).astype(np.int32)
    masks = _Masks(seed=5)
    variables = random_flax_variables(jm.build_classifier(name, N_CLASSES), jnp.zeros((1, size, size, _channels(name))),
                                      seed=3)
    with jax.enable_x64(True):
        jt = jtask.ClassifierTask(jc.ClassifierConfig(**kw, data=jc.DataConfig(img_size=size)), mesh)
        jt.model = jm.build_classifier(name, N_CLASSES, dtype=jnp.float64, freeze_prefix=True)
        wide = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        # the optimizer of the task's init_state (classifier_task.py:356-359),
        # built here because init_state's flax init runs op by op: ~8 s a net
        jt.tx = optax.chain(optax.masked(optax.adam(jt.cfg.lr), jm.trainable_mask(wide["params"], name)))
        jstate = new_train_state(wide.pop("params"), jt.tx, jax.random.PRNGKey(0), stats=wide)
        with fnn.intercept_methods(masks):
            jstate, jmetrics = jax.jit(lambda s, x, y: jt._train_step(s, x, y))(jstate, jnp.asarray(images),
                                                                                jnp.asarray(labels))
        jstate, jmetrics = jax.tree_util.tree_map(np.asarray, (jstate, jmetrics))
    tt = ttask.ClassifierTask(tc.ClassifierConfig(**kw, data=tc.DataConfig(img_size=size)), "cpu")
    state = tt.init_state(0, _as_port(tt.model, variables))
    initial = {k: v.clone() for k, v in {**state.params, **state.stats}.items()}
    state, metrics = tt.train_step(state, torch.from_numpy(images.astype(np.float32)), torch.from_numpy(labels),
                                   keep=masks.torch())
    return jstate, jmetrics, tt, state, metrics, initial


def _jax_first_gradients(model, jstate) -> dict[str, torch.Tensor]:
    """The gradient of the JAX step, from Adam's first moment after one
    update (m = (1 − b1)·g); 0 for the masked-out parameters."""
    mu = jstate.opt_state[0].inner_state[0].mu
    g = jax.tree_util.tree_map(lambda p, m: np.zeros(np.shape(p)) if isinstance(m, optax.MaskedNode)
                               else np.asarray(m) / 0.1, jstate.params, mu)
    return _as_port(model, {"params": g, **jstate.stats})


@pytest.mark.parametrize("name, grad_accum", [("custom", 1), ("resnet", 1), ("mobilenet", 1), ("resnet", 2)])
def test_train_step_matches_jax(name, grad_accum):
    # the JAX step runs in float64: its own float32 step on the CPU reads up
    # to 5.8e-3 from it per gradient tensor at MobileNetV2's late
    # BatchNorms, where the port's float32 step reads ≤ 2.9e-5 (tensors
    # whose gradient does not vanish)
    jstate, jmetrics, tt, state, metrics, initial = _step_both(name, grad_accum)
    assert state.step == int(jstate.step) == 1
    np.testing.assert_allclose(float(metrics["train_loss"]), float(jmetrics["train_loss"]), rtol=1e-5)
    assert float(metrics["train_acc"]) == float(jmetrics["train_acc"])
    want = _as_port(tt.model, {"params": jstate.params, **jstate.stats})
    for k in state.stats:  # BatchNorm running statistics, frozen layers' included
        np.testing.assert_allclose(state.stats[k].numpy(), want[k].numpy(), rtol=RTOL, atol=ATOL, err_msg=k)
    # the gradients, per tensor; then the params. Adam's first step moves an
    # element by lr·g/(|g| + 1e-8), about ±lr whatever |g|, so where the
    # port's gradient of an element is more than 1 % off the reference's
    # (its true value is near 0 against the tensor's float32 rounding) the
    # two steps may differ by up to 2·lr: those elements are held to that
    jgrads, lr = _jax_first_gradients(tt.model, jstate), 1e-3
    scale = max(float(np.abs(g.numpy()).max()) for g in jgrads.values())
    for k, flag in tt.mask.items():
        if not flag:
            continue
        got, w = state.params[k].numpy(), want[k].numpy()
        g, gj = state.opt_state()[f"exp_avg.{k}"].numpy() / 0.1, jgrads[k].numpy()
        # relative to the tensor's norm, plus float32 rounding of the step's
        # largest gradient on each element: some tensors' true gradient is
        # near 0 (a bias ahead of a train-mode BatchNorm, whose batch mean
        # takes any shift out; a scale ahead of one through per-channel
        # linear layers) and both sides hold rounding there
        assert np.linalg.norm(g - gj) <= 1e-4 * np.linalg.norm(gj) + 1e-6 * scale * np.sqrt(g.size), k
        agree = np.abs(g - gj) <= 0.01 * np.abs(gj)
        np.testing.assert_allclose(got[agree], w[agree], rtol=RTOL, atol=ATOL, err_msg=k)
        assert np.abs(got - w).max() <= 2 * lr + ATOL, k
    # the frozen prefix: parameters bit-equal to their initial values in the
    # masters and the module, BatchNorm running statistics moved (train mode)
    frozen = [k for k, flag in tt.mask.items() if not flag]
    assert bool(frozen) == (name != "custom")
    for k in frozen:
        assert torch.equal(state.params[k], initial[k]) and torch.equal(tt.model.get_parameter(k), initial[k]), k
        np.testing.assert_array_equal(want[k].numpy(), initial[k].numpy(), err_msg=k)  # and the JAX step's
    assert all(not torch.equal(v, initial[k]) for k, v in state.stats.items())
    # the working copy is the masters
    for k, v in tt.model.named_parameters():
        assert torch.equal(v, state.params[k]), k


def test_kd_loss_matches_jax():
    rng = np.random.default_rng(6)
    logits, emb = rng.standard_normal((4, 7)).astype(np.float32), rng.standard_normal((4, 7)).astype(np.float32)
    want = float(jtask.kd_loss(jnp.asarray(logits), jnp.asarray(emb), 3.0))
    got = ttask.kd_loss(torch.from_numpy(logits), torch.from_numpy(emb), 3.0).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(ttask.cross_entropy(torch.from_numpy(logits), torch.tensor([0, 1, 2, 6])).item(),
                               float(jtask.cross_entropy(jnp.asarray(logits), jnp.asarray([0, 1, 2, 6]))), rtol=1e-6)


# -- metrics and the sweep's data --------------------------------------------------

def test_classification_metrics_match_jax():
    rng = np.random.default_rng(7)
    got, want = ClassificationMetrics(6), JaxMetrics(6)
    for n in (13, 9, 1):
        logits = rng.standard_normal((n, 6)).astype(np.float32)
        labels = rng.integers(0, 5, n)  # class 5 has no support
        got.update(logits, labels, loss=0.5 * n)
        want.update(logits, labels, loss=0.5 * n)
    np.testing.assert_array_equal(got.cm, want.cm)
    preds, labels = rng.integers(0, 6, 40), rng.integers(0, 6, 40)
    np.testing.assert_array_equal(confusion_matrix(preds, labels, 6),
                                  np.asarray(jax_confusion_matrix(jnp.asarray(preds), jnp.asarray(labels), 6)))
    logits = rng.standard_normal((40, 6)).astype(np.float32)
    for k in (1, 3, 5):
        assert top_k_accuracy(logits, labels, k) == pytest.approx(
            float(jax_top_k_accuracy(jnp.asarray(logits), jnp.asarray(labels), k)), abs=1e-7)
    a, b = got.compute(), want.compute()
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-6, err_msg=k)
    names = [f"c{i}" for i in range(6)]
    frame = want.classification_report(names)
    rows = got.classification_report(names)
    assert [r["class"] for r in rows] == list(frame.index)
    for col in ("precision", "recall", "f1-score", "support"):
        np.testing.assert_allclose([r[col] for r in rows], frame[col].to_numpy(), rtol=1e-12, err_msg=col)


def _png(path, rng, size: int = 32):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(encode_png_rgb(rng.integers(0, 256, (size, size, 3), dtype=np.uint8)))


def _dataset(root, classes=("ant", "bee", "cat", "dog", "eel"), per_class=(4, 2), gen: int = 5):
    rng = np.random.default_rng(8)
    for split, n in zip(("train", "val"), per_class):
        for c in classes:
            for i in range(n):
                _png(root / "datasets" / split / c / f"{i}.png", rng)
    for c in classes:  # idx 0 … gen − 1; one file past the cap and one of a foreign class
        for samp in range(gen):
            _png(root / "gen" / f"{c}_gen_imgs_{samp % 3}_{samp}.png", rng)
    _png(root / "gen" / "ant_gen_imgs_0_300.png", rng)
    _png(root / "gen" / "zebra_gen_imgs_0_0.png", rng)


def test_inject_synthetic_picks_the_jax_files(tmp_path):
    _dataset(tmp_path)
    train = str(tmp_path / "datasets" / "train")
    for per_class in (2, 9):
        j, t = JaxImageFolderSource(train, seed=3), ImageFolderSource(train, seed=3)
        jcli._inject_synthetic(j, str(tmp_path / "gen"), per_class, 250, 42)
        added = tcli._inject_synthetic(t, str(tmp_path / "gen"), per_class, 250, 42)
        assert [str(p) for p in t.paths] == [str(p) for p in j.paths]
        np.testing.assert_array_equal(t.labels, j.labels)
        assert added == 5 * min(per_class, 5) and len(t.paths) == 20 + added
        assert not any("_300.png" in str(p) or "zebra" in str(p) for p in t.paths)


def test_embeddings_csv_feeds_knowledge_distillation(tmp_path):
    _dataset(tmp_path)
    src = ImageFolderSource(str(tmp_path / "datasets" / "train"), seed=3, img_size=32)
    with open(tmp_path / "emb.csv", "w") as f:
        f.write("file_name,embeddings\n")
        f.write(f"{src.paths[0]},\"1.0,2.0,3.0,4.0,5.0\"\n")
    tcli._attach_embeddings(src, str(tmp_path / "emb.csv"))
    batch = src.load_batch(np.array([0, 1]))
    np.testing.assert_array_equal(batch["embedding"], [[1, 2, 3, 4, 5], [0, 0, 0, 0, 0]])  # no row: zeros

    losses = []
    for kd in (False, True):
        task = ttask.ClassifierTask(tc.ClassifierConfig(model_name="custom", num_classes=5, compute_dtype="float32",
                                                        knowledge_dist=kd, data=tc.DataConfig(img_size=32)), "cpu")
        state = task.init_state(0)
        _, m = task.train_step(state, torch.from_numpy(batch["image"]), torch.from_numpy(batch["label"]),
                               torch.from_numpy(batch["embedding"]), keep={})
        losses.append(float(m["train_loss"]))
    assert np.isfinite(losses).all() and losses[0] != losses[1]


def test_sweep_and_eval_clis_run(tmp_path, monkeypatch, capsys):
    import csv
    import json

    from spectrogramgenai_tpu_torch.cli import eval_classifiers
    from spectrogramgenai_tpu_torch.core.checkpoint import CheckpointManager

    monkeypatch.chdir(tmp_path)
    _dataset(tmp_path)
    common = ["--val_dir", "datasets/val", "--data.img_size", "32", "--data.batch_size", "4",
              "--compute_dtype", "float32", "--run.output_dir", "sweep", "--device", "cpu"]
    results = tcli.main(["--train_dir", "datasets/train", "--gen_dir", "gen", "--models", "custom,resnet",
                         "--synths", "0,2", "--epochs", "2", *common])
    assert set(results) == {("custom", 0), ("custom", 2), ("resnet", 0), ("resnet", 2)}
    out = capsys.readouterr().out
    assert "custom synth 2: added 10 generated images to 20 real ones" in out
    assert "custom_synth2 epoch 1: 7 steps" in out and "custom_synth0 epoch 1: 5 steps" in out
    with open("sweep/resnet_synth2/resnet_synth2_metrics.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert [r["epoch"] for r in rows] == ["0", "1"] and all(np.isfinite(float(r["train_loss"])) for r in rows)
    meta = CheckpointManager("sweep/ckpt_resnet_synth2").best_meta()
    assert meta["metric"] == pytest.approx(results[("resnet", 2)])
    best = CheckpointManager("sweep/ckpt_resnet_synth2").restore(best=True)
    assert set(best) == {"params", "opt_state", "step", "rng"}
    assert any(k.endswith("running_var") for k in best["params"])

    rows = eval_classifiers.main(["--test_dir", "datasets/val", "--out_dir", "eval", "--models", "custom,resnet",
                                  "--synths", "0,2", *common])
    assert len(rows) == 4 and sorted(os.listdir("eval")) == sorted(
        ["eval_results.csv"] + [f"{m}_synth{s}_{kind}" for m in ("custom", "resnet") for s in (0, 2)
                                for kind in ("classification_report.csv", "confusion_matrix.png")])
    # the best checkpoint, evaluated again, gives the validation accuracy it was kept for
    for row in rows:
        assert row["val_accuracy"] == pytest.approx(results[(row["model"], row["synth"])], abs=1e-12)
    with open("eval/custom_synth0_classification_report.csv", newline="") as f:
        report = list(csv.DictReader(f))
    assert [r["class"] for r in report] == ["ant", "bee", "cat", "dog", "eel"]
    assert json.loads(open("sweep/custom_synth0/metrics.jsonl").readline())["step"] == 0
