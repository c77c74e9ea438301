"""The port's reader and writer of flax's msgpack checkpoints, the bridge's
inverse, and the classifiers' ``--pretrained_dir``, against flax and the JAX
package on the CPU.

Round trips are bit-equal: flax ``to_bytes`` → the port's ``restore`` gives
the same arrays (bits, dtype, shape) and scalars, and the port's
``to_bytes`` gives the very bytes flax writes, which flax reads back.
``--pretrained_dir``'s merge is held equal (exactly) to the JAX task's
``_load_pretrained`` on one flax-written file, for ResNet18 at 64×64.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
from flax import serialization  # noqa: E402

from spectrogramgenai_tpu.core import config as jc  # noqa: E402
from spectrogramgenai_tpu.core.mesh import MeshSpec, create_mesh  # noqa: E402
from spectrogramgenai_tpu.models import classifiers as jm  # noqa: E402
from spectrogramgenai_tpu.train import classifier_task as jtask  # noqa: E402
from spectrogramgenai_tpu_torch.bridge import flax_from_state_dict, state_dict_from_flax  # noqa: E402
from spectrogramgenai_tpu_torch.cli import train_classifiers as tcli  # noqa: E402
from spectrogramgenai_tpu_torch.core import config as tc  # noqa: E402
from spectrogramgenai_tpu_torch.core import flax_msgpack  # noqa: E402
from spectrogramgenai_tpu_torch.models import classifiers as tm  # noqa: E402
from spectrogramgenai_tpu_torch.train import classifier_task as ttask  # noqa: E402
from torch_port_helpers import one_torch_thread, random_flax_variables  # noqa: E402, F401


def _tree(rng) -> dict:
    """A tree of every leaf type flax writes, keys of every str length class."""
    return {
        "params": {"f32": rng.standard_normal((3, 4)).astype(np.float32),
                   "bf16": rng.standard_normal((2, 5)).astype(ml_dtypes.bfloat16),
                   "nested": {"i32": rng.integers(-2**31, 2**31 - 1, (7,)).astype(np.int32),
                              "u8": rng.integers(0, 256, (2, 3, 2)).astype(np.uint8),
                              "f64": rng.standard_normal(40).astype(np.float64)},
                   "big": rng.standard_normal((20, 30)).astype(np.float32),  # bin16 and ext16 lengths
                   "zero_d": np.asarray(2.5, np.float32), "empty_array": np.zeros((0, 3), np.float32)},
        "empty": {},
        "scalars": {"np_f32": np.float32(1.5), "np_i64": np.int64(-7), "np_bf16": ml_dtypes.bfloat16(0.75),
                    "ints": [0, 127, 128, 255, 256, 65535, 65536, 2**32, -1, -32, -33, -128, -129, -32768,
                             -32769, -2**31, -2**31 - 1, -2**63],
                    "float": 0.1, "none": None, "true": True, "false": False, "complex": 1.5 - 2j,
                    "str": "é" * 20, "bytes": b"\x00\xff" * 200},
        "k" * 40: {str(i): np.full(i + 1, i, np.int16) for i in range(20)},  # str8 key, map16
    }


def _bits(x):
    """(dtype name, shape, raw bytes) of an array leaf, torch bfloat16 included."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch."), tuple(x.shape), x.view(torch.int16).numpy().tobytes()
    x = np.asarray(x)
    return x.dtype.name, x.shape, x.tobytes()


def _as_port(tree):
    """flax's tree with bfloat16 leaves as torch tensors, the port's form of them."""
    if isinstance(tree, dict):
        return {k: _as_port(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(tree.view(np.int16).copy()).view(torch.bfloat16)
    return tree


def _assert_same(got, want, path=()):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _assert_same(got[k], want[k], path + (k,))
    elif isinstance(want, (np.ndarray, torch.Tensor)) or (isinstance(want, np.generic)
                                                         and want.dtype == ml_dtypes.bfloat16):
        assert _bits(got) == _bits(want), path
    else:
        assert type(got) is type(want) and (got == want or (got != got and want != want)), path


@pytest.mark.parametrize("seed", [0, 1])
def test_flax_bytes_restore_bit_equal(seed):
    tree = _tree(np.random.default_rng(seed))
    payload = serialization.to_bytes(tree)
    want = serialization.msgpack_restore(payload)
    got = flax_msgpack.restore(payload)
    # flax writes the list as {"0": …}; NumPy scalars come back as NumPy scalars
    _assert_same(got, _as_port(want))
    assert got["params"]["bf16"].dtype == torch.bfloat16


@pytest.mark.parametrize("seed", [0, 1])
def test_port_bytes_are_flax_bytes(seed):
    tree = _tree(np.random.default_rng(seed))
    payload = flax_msgpack.to_bytes(_as_port(tree))
    assert payload == serialization.to_bytes(tree)
    _assert_same(_as_port(serialization.msgpack_restore(payload)), _as_port(serialization.msgpack_restore(
        serialization.to_bytes(tree))))


def test_chunked_leaves_both_ways(monkeypatch):
    # flax splits a leaf over MAX_CHUNK_SIZE bytes into flat chunks; shrink the limit on both sides
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(2)
    tree = {"params": {"w": rng.standard_normal((9, 7)).astype(np.float32), "small": np.arange(3, dtype=np.int32)},
            "bf": rng.standard_normal(50).astype(ml_dtypes.bfloat16)}
    payload = serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in payload
    assert flax_msgpack.to_bytes(_as_port(tree)) == payload
    _assert_same(flax_msgpack.restore(payload), _as_port(tree))


def test_file_round_trip_and_errors(tmp_path):
    tree = {"params": {"a": np.arange(6, dtype=np.float32).reshape(2, 3)}, "x": 3}
    path = str(tmp_path / "w.msgpack")
    flax_msgpack.write(path, tree)
    with open(path, "rb") as f:
        _assert_same(serialization.msgpack_restore(f.read()), tree)
    _assert_same(flax_msgpack.read(path), tree)
    payload = serialization.to_bytes(tree)
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.restore(payload[:-3])
    with pytest.raises(ValueError, match="after the msgpack value"):
        flax_msgpack.restore(payload + b"\xc0")
    with pytest.raises(TypeError, match="cannot serialise"):
        flax_msgpack.to_bytes({"a": object()})


@pytest.mark.parametrize("name", ["resnet", "mobilenet", "custom"])
def test_bridge_inverse(name):
    # flax → state_dict → flax gives the flax tree back (Dense kernels are (in, out) here)
    jmodel = {"resnet": jm.ResNet18, "mobilenet": jm.MobileNetV2, "custom": jm.CustomCNN}[name](num_classes=5)
    variables = random_flax_variables(jmodel, jnp.zeros((1, 64, 64, 1 if name == "custom" else 3)))
    module = tm.build_classifier(name, 5, img_size=64)
    sd = state_dict_from_flax(module, variables)
    tree = flax_from_state_dict(module, sd)
    back, want = _flat(tree), _flat(variables)
    assert set(back) == set(want) and all(_bits(back[k]) == _bits(want[k]) for k in want)
    again = state_dict_from_flax(module, tree)
    assert set(again) == set(sd) and all(torch.equal(again[k], sd[k]) for k in sd)


def _resnet_imagenet_file(path: str, seed: int = 5) -> dict:
    """A torchvision-shaped ResNet18 (1000 classes) as tools/convert_torchvision.py writes it, random weights."""
    variables = random_flax_variables(jm.ResNet18(num_classes=1000), jnp.zeros((1, 64, 64, 3)), seed=seed)
    with open(path, "wb") as f:
        f.write(serialization.to_bytes(variables))
    return variables


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + (k,)) if isinstance(v, dict) else {prefix + (k,): v})
    return out


def test_pretrained_merge_matches_jax(tmp_path):
    path = str(tmp_path / "resnet18_imagenet.msgpack")
    pre = _resnet_imagenet_file(path)
    init = random_flax_variables(jm.ResNet18(num_classes=5), jnp.zeros((1, 64, 64, 3)), seed=9)
    mesh = create_mesh(MeshSpec(data=1, model=1), devices=jax.devices()[:1])
    jtask_ = jtask.ClassifierTask(jc.ClassifierConfig(model_name="resnet", num_classes=5,
                                                      data=jc.DataConfig(img_size=64)), mesh)
    jparams, jvars = jtask_._load_pretrained(init["params"], init, path)
    want = {"params": jax.device_get(jparams), "batch_stats": jax.device_get(jvars["batch_stats"])}

    task = ttask.ClassifierTask(tc.ClassifierConfig(model_name="resnet", num_classes=5, compute_dtype="float32",
                                                    data=tc.DataConfig(img_size=64)), "cpu")
    module = tm.build_classifier("resnet", 5)
    merged, n_used = task.pretrained_variables(path, state_dict_from_flax(module, init))
    want_sd = state_dict_from_flax(module, want)
    assert set(merged) == set(want_sd) and all(torch.equal(merged[k], want_sd[k]) for k in want_sd)
    # every parameter but the head's two came from the file; the head stayed fresh; BN statistics rode along
    n_params = len(_flat(init["params"]))
    assert n_used == n_params - 2
    assert torch.equal(merged["fc.weight"], state_dict_from_flax(module, init)["fc.weight"])
    np.testing.assert_array_equal(merged["stem_conv.weight"].numpy(),
                                  pre["params"]["stem_conv"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(merged["layer2_0.downsample_bn.running_var"].numpy(),
                                  pre["batch_stats"]["layer2_0"]["downsample_bn"]["var"])


def test_pretrained_dir_cli(tmp_path, capsys):
    from PIL import Image

    rng = np.random.default_rng(0)
    for split in ("train", "val"):
        for c in range(2):
            os.makedirs(tmp_path / split / f"c{c}")
            for i in range(2):
                Image.fromarray(rng.integers(0, 256, (32, 32), dtype=np.uint8)).save(
                    tmp_path / split / f"c{c}" / f"{i}.png")
    weights = tmp_path / "weights"
    weights.mkdir()
    pre = _resnet_imagenet_file(str(weights / "resnet18_imagenet.msgpack"))
    common = ["--train_dir", str(tmp_path / "train"), "--val_dir", str(tmp_path / "val"), "--synths", "0",
              "--epochs", "1", "--data.img_size", "32", "--data.batch_size", "2", "--compute_dtype", "float32",
              "--pretrained_dir", str(weights), "--device", "cpu"]
    tcli.main(["--models", "resnet,custom", "--run.output_dir", str(tmp_path / "out"), *common])
    out = capsys.readouterr().out
    n_params = len(_flat(pre["params"]))
    assert f"resnet: loaded {n_params - 2} pretrained tensors from {weights / 'resnet18_imagenet.msgpack'}" in out
    assert f"note: no converted weights at {weights / 'custom_imagenet.msgpack'}; training custom from scratch" in out
    # the frozen stem kept the file's weights through the epoch
    saved = torch.load(tmp_path / "out" / "ckpt_resnet_synth0" / "best" / "state.pt", weights_only=True)
    np.testing.assert_array_equal(saved["params"]["stem_conv.weight"].numpy(),
                                  pre["params"]["stem_conv"]["kernel"].transpose(3, 2, 0, 1))
