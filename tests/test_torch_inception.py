"""The port's InceptionV3, Inception Score and Inception FID against the JAX package, on the CPU.

InceptionV3 at full width with random JAX weights (``random_flax_variables``)
carried across by ``bridge.py``, at 75×75 (its smallest input) and batch 2,
float32: logits and pool features within 1e-4 relative L2 (readings 3.0e-7
and 1.9e-7 with torchvision's pools, 3.2e-7 and 2.1e-7 with pytorch-fid's:
float32 sums in another order), for both pool kinds; ``compute_probs`` and
``compute_features`` against JAX's on the same weights (JAX pads its last
chunk to 299×299, the port does not pad); ``load_inception_params`` of a flax-written file;
the CLIs' refusals and printed lines against JAX's. Without weights each
package draws its own random init (JAX ``PRNGKey(0)``, the port a seeded
torch generator), so random-weight scores differ between the two.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import serialization  # noqa: E402

from spectrogramgenai_tpu.cli import fid as jfid  # noqa: E402
from spectrogramgenai_tpu.cli import inception_score as jis  # noqa: E402
from spectrogramgenai_tpu.eval import inception as jinc  # noqa: E402
from spectrogramgenai_tpu_torch.audio.export import encode_png_rgb  # noqa: E402
from spectrogramgenai_tpu_torch.cli import fid as tfid  # noqa: E402
from spectrogramgenai_tpu_torch.cli import inception_score as tis  # noqa: E402
from spectrogramgenai_tpu_torch.eval import inception as tinc  # noqa: E402
from torch_port_helpers import one_torch_thread, random_flax_variables  # noqa: E402, F401

SIZE, BATCH = 75, 2
# relative L2 of logits and features, port against JAX (float32, see the docstring)
REL_TOL = 1e-4


def _rel(got, want) -> float:
    return float(np.linalg.norm(np.asarray(got) - np.asarray(want)) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def weights():
    x = jnp.zeros((1, SIZE, SIZE, 3))
    return random_flax_variables(jinc.InceptionV3(), x, seed=0)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(1).integers(0, 256, (4, SIZE, SIZE, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def jax_outputs(weights, images):
    """JAX logits and features at batch 2 for each pool kind, jitted once each."""
    x = jnp.asarray((images[:BATCH].astype(np.float32) / 255.0 - 0.5) / 0.5)
    out = {}
    for fid_pool in (False, True):
        model = jinc.InceptionV3(fid_pool=fid_pool)
        fwd = jax.jit(lambda a, m=model: (m.apply(weights, a), m.apply(weights, a, return_features=True)))
        out[fid_pool] = tuple(np.asarray(o) for o in fwd(x))
    return out


@pytest.mark.parametrize("fid_pool", [False, True])
def test_inception_v3_matches_jax(weights, images, jax_outputs, fid_pool):
    model = tinc.build_inception(weights, "cpu", fid_pool=fid_pool)
    x = tinc.inception_inputs(images[:BATCH], "cpu")
    with torch.no_grad():
        logits, feats = model(x), model(x, return_features=True)
    want_logits, want_feats = jax_outputs[fid_pool]
    assert logits.shape == (BATCH, 1000) and feats.shape == (BATCH, 2048)
    assert _rel(logits, want_logits) <= REL_TOL
    assert _rel(feats, want_feats) <= REL_TOL
    # the pool kinds differ: the test tells them apart
    assert _rel(jax_outputs[not fid_pool][1], want_feats) > 1e-3


def test_inception_v3_parameters_and_shapes():
    model = tinc.InceptionV3()
    n = sum(p.numel() for p in model.parameters())
    assert 23.5e6 < n < 24.2e6, n  # torchvision's 27.16 M less the aux head's 3.33 M, as in JAX
    assert len(model.state_dict()) == len(jax.tree_util.tree_leaves(
        jax.eval_shape(jinc.InceptionV3().init, jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))))


def test_compute_probs_and_features_match_jax(weights, images):
    # four images: JAX in chunks of 2 (it pads a short last chunk to 299×299, so
    # the chunks are whole here), the port in chunks of 3 and 1, not padded
    want_p = jis.compute_probs(images, weights, batch=BATCH)
    got_p = tis.compute_probs(images, weights, batch=3, device="cpu")
    assert got_p.shape == (4, 1000) and np.allclose(got_p.sum(axis=1), 1.0, atol=1e-5)
    assert _rel(got_p, want_p) <= REL_TOL
    want_f = jfid.compute_features(images, weights, batch=BATCH)
    got_f = tfid.compute_features(images, weights, batch=3, device="cpu")
    assert got_f.shape == (4, 2048) and _rel(got_f, want_f) <= REL_TOL


def test_load_inception_params_reads_a_flax_file(weights, images, tmp_path):
    path = tmp_path / "inception_v3.msgpack"
    path.write_bytes(serialization.to_bytes(weights))
    loaded = tinc.load_inception_params(str(path))
    model = tinc.build_inception(loaded, "cpu")
    want = tinc.build_inception(weights, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(), want.state_dict().values()))
    assert tinc.load_inception_params(str(tmp_path / "missing.msgpack")) is None
    assert tinc.load_inception_params(None) is None


def _pngs(root, n: int, seed: int) -> None:
    rng = np.random.default_rng(seed)
    os.makedirs(root)
    for i in range(n):
        img = np.cumsum(rng.integers(0, 9, (64, 64, 3)), axis=1).astype(np.uint8)
        with open(os.path.join(root, f"img_{i}.png"), "wb") as f:
            f.write(encode_png_rgb(img))


def test_cli_refusals_and_lines_match_jax(weights, tmp_path, capsys):
    _pngs(tmp_path / "a", 2, seed=2)
    _pngs(tmp_path / "b", 2, seed=3)
    # without weights: the same refusal from both packages
    for args, jmain, tmain in ((["--image_dir", str(tmp_path / "a")], jis.main, tis.main),
                               (["--dir1", str(tmp_path / "a"), "--dir2", str(tmp_path / "b")], jfid.main, tfid.main)):
        with pytest.raises(SystemExit) as jexit:
            jmain(args)
        with pytest.raises(SystemExit) as texit:
            tmain([*args, "--device", "cpu"])
        assert str(texit.value) == str(jexit.value) and "--allow_random_weights 1" in str(texit.value)

    # with weights: the score lines, from the same flax file
    path = tmp_path / "inception_v3.msgpack"
    path.write_bytes(serialization.to_bytes(weights))
    mean, std = tis.main(["--image_dir", str(tmp_path / "a"), "--weights", str(path), "--splits", "1",
                          "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line == f"Inception Score: {mean:.4f} ± {std:.4f}  (n=2)" and mean >= 1.0 and std == 0.0
    tfid.main(["--dir1", str(tmp_path / "a"), "--dir2", str(tmp_path / "b"), "--weights", str(path),
               "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("FID: ") and line.endswith("  (n1=2, n2=2)") and float(line.split()[1]) >= 0

    # random weights: JAX's warning line, then a score
    tis.main(["--image_dir", str(tmp_path / "a"), "--allow_random_weights", "1", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "WARNING: random InceptionV3 weights — score is NOT meaningful"
    assert out[1].startswith("Inception Score: ") and out[1].endswith("(n=2)")
