"""The port's evaluator-weight tools against the JAX tools, on the CPU.

``tools/port_convert_torchvision.py``, ``tools/port_convert_clap.py`` and
``tools/port_provision_eval_weights.py`` take the same seeded state_dicts as
``tools/convert_*.py`` and ``tools/provision_eval_weights.py``: the four
torchvision nets of ``tests/torch_refs.py`` (randomised as
``tests/test_provision.py`` does: 19 classes, 64×64, InceptionV3 at 96) and
HF's tiny CLAP config. The converted trees are bit-equal (every key in order,
dtype, shape and value), the installed files have the JAX tool's SHA-256,
and the forward checks read below 5e-3 (the tools' tolerance) and within
1e-4 of the JAX tool's. Then the port alone: a wrong architecture and CLAP
without transformers are refused, and the provisioned directory feeds
``cli.verify_metrics`` and ``cli.train_classifiers --pretrained_dir``.
"""

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

from flax import serialization  # noqa: E402

import convert_clap as jconvert_clap  # noqa: E402
import convert_torchvision as jconvert  # noqa: E402
import port_convert_clap as tconvert_clap  # noqa: E402
import port_convert_torchvision as tconvert  # noqa: E402
import port_provision_eval_weights as tprov  # noqa: E402
import provision_eval_weights as jprov  # noqa: E402
from spectrogramgenai_tpu_torch.eval.clap import ClapAudioTowerConfig  # noqa: E402
from torch_port_helpers import one_torch_thread  # noqa: E402, F401
from torch_refs import TorchInceptionV3, TorchMobileNetV2, TorchResNet18, TorchVGG16, randomize_  # noqa: E402

CLASSES = 19
CASES = {"inception_v3": (TorchInceptionV3, 96), "mobilenet_v2": (TorchMobileNetV2, 64),
         "resnet18": (TorchResNet18, 64), "vgg16": (TorchVGG16, 64)}
ERR_TOL = 5e-3  # the tools' forward tolerance (atol)
JAX_ERR_TOL = 1e-4  # how far the port's forward error may lie above the JAX tool's
TINY_CLAP = ClapAudioTowerConfig(num_mel_bins=16, spec_size=64, patch_size=4, patch_stride=4,
                                 patch_embeds_hidden_size=8, depths=(2, 2), num_attention_heads=(2, 4),
                                 window_size=4, projection_dim=8)


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _flat(tree, prefix=()):
    """[(path, leaf)] in the tree's order."""
    out = []
    for k, v in tree.items():
        out += _flat(v, prefix + (k,)) if isinstance(v, dict) else [(prefix + (k,), v)]
    return out


def _assert_same_tree(got, want):
    got, want = _flat(got), _flat(want)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert (a.dtype, a.shape) == (b.dtype, b.shape), k
        assert np.array_equal(a, b), k


def _torch_state_dict_numpy(path):
    """The state_dict as the JAX tools read it."""
    return {k: v.numpy() for k, v in torch.load(path, map_location="cpu", weights_only=True).items()}


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    root = tmp_path_factory.mktemp("sources")
    out = {}
    for name, (cls, _) in CASES.items():
        out[name] = str(root / f"{name}.pth")
        torch.save(randomize_(cls(num_classes=CLASSES), seed=5).state_dict(), out[name])
    return out


@pytest.fixture(scope="module")
def manifests(sources, tmp_path_factory):
    """(JAX manifest, port manifest) of the four nets, each net at its own input size."""
    jdir, tdir = str(tmp_path_factory.mktemp("jax_eval")), str(tmp_path_factory.mktemp("port_eval"))
    for name, (_, size) in CASES.items():
        jprov.provision({name: sources[name]}, jdir, num_classes=CLASSES, img_size=size)
        tprov.provision({name: sources[name]}, tdir, num_classes=CLASSES, img_size=size, device="cpu")
    with open(os.path.join(jdir, "manifest.json")) as f, open(os.path.join(tdir, "manifest.json")) as g:
        return json.load(f), json.load(g)


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_tree_is_the_jax_tree(name, sources):
    got = tconvert.CONVERTERS[name](tconvert.load_state_dict(sources[name]))
    want = jconvert.CONVERTERS[name](_torch_state_dict_numpy(sources[name]))
    _assert_same_tree(got, want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_installed_file_has_the_jax_tools_bytes(name, manifests):
    jm, tm = manifests
    j, t = jm[name], tm[name]
    assert t["path"].endswith(tprov.installed_name(name)) and os.path.exists(t["path"])
    assert os.path.basename(t["path"]) == (f"{name}.msgpack" if name == "inception_v3" else f"{name}_imagenet.msgpack")
    assert t["sha256"] == j["sha256"] and t["source_sha256"] == j["source_sha256"]
    assert list(t) == list(j) and t["verified"] is True


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_error_matches_the_jax_tools(name, manifests):
    jm, tm = manifests
    got, want = tm[name]["max_abs_forward_err"], jm[name]["max_abs_forward_err"]
    assert got < ERR_TOL
    assert got <= want + JAX_ERR_TOL, (got, want)


def test_wrong_architecture_is_refused(sources, tmp_path):
    out = tmp_path / "eval"
    with pytest.raises(Exception):
        tprov.provision({"vgg16": sources["resnet18"]}, str(out), num_classes=CLASSES, img_size=64, device="cpu")
    # the right keys with the wrong head width fail the forward check
    with pytest.raises(Exception):
        tprov.provision({"resnet18": sources["resnet18"]}, str(out), num_classes=CLASSES + 1, img_size=64,
                        device="cpu")
    assert not out.exists() or not any(out.iterdir())


def test_cuda_without_a_card_raises(sources, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tprov.main(["--resnet18", sources["resnet18"], "--out_dir", str(tmp_path / "eval")])
    assert not (tmp_path / "eval").exists()


@pytest.fixture(scope="module")
def tiny_clap(tmp_path_factory):
    """A saved HF ClapAudioModelWithProjection state_dict at the tiny config,
    BatchNorm statistics and position-bias tables randomised."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("USE_TF", "0")  # transformers need not import TensorFlow (~6 s)
        from transformers.models.clap.configuration_clap import ClapAudioConfig
        from transformers.models.clap.modeling_clap import ClapAudioModelWithProjection

    torch.manual_seed(0)
    hf = ClapAudioModelWithProjection(ClapAudioConfig(
        num_mel_bins=16, spec_size=64, patch_size=4, patch_stride=4, patch_embeds_hidden_size=8, depths=[2, 2],
        num_attention_heads=[2, 4], window_size=4, hidden_size=16, projection_dim=8, enable_fusion=False,
        num_hidden_layers=2, num_classes=5))
    sd = hf.state_dict()
    gen = torch.Generator().manual_seed(1)
    for key, value in sd.items():
        if key.endswith("running_var"):
            sd[key] = torch.empty_like(value).uniform_(0.5, 1.5, generator=gen)
        elif key.endswith("running_mean"):
            sd[key] = 0.2 * torch.randn(value.shape, generator=gen)
        elif "relative_position_bias_table" in key:
            sd[key] = 0.1 * torch.randn(value.shape, generator=gen)
    path = str(tmp_path_factory.mktemp("clap") / "pytorch_model.bin")
    torch.save(sd, path)
    return path


def test_clap_tiny_tree_bytes_and_forward(tiny_clap, tmp_path):
    sd = _torch_state_dict_numpy(tiny_clap)
    want = jconvert_clap.convert_clap_audio(sd, depths=TINY_CLAP.depths)
    _assert_same_tree(tconvert_clap.convert_clap_audio(tconvert.load_state_dict(tiny_clap), depths=TINY_CLAP.depths),
                      want)
    entry = tprov.provision_clap(tiny_clap, str(tmp_path), device="cpu", cfg=TINY_CLAP)
    assert entry["path"] == str(tmp_path / "clap_audio.msgpack")
    assert entry["sha256"] == _sha256(serialization.to_bytes(want))
    assert entry["verified"] is True and entry["max_abs_forward_err"] < ERR_TOL


def test_clap_without_transformers_needs_skip_verify(tiny_clap, tmp_path, monkeypatch):
    for mod in [m for m in sys.modules if m == "transformers" or m.startswith("transformers.")] + ["transformers"]:
        monkeypatch.setitem(sys.modules, mod, None)
    out = tmp_path / "eval"
    with pytest.raises(RuntimeError, match="--skip_verify"):
        tprov.provision({"clap": tiny_clap}, str(out), device="cpu")
    assert not out.exists()
    with pytest.raises(RuntimeError, match="--skip_verify"):
        tprov.provision_clap(tiny_clap, str(tmp_path), device="cpu", cfg=TINY_CLAP)
    assert not (tmp_path / "clap_audio.msgpack").exists()
    entry = tprov.provision_clap(tiny_clap, str(tmp_path), verify=False, device="cpu", cfg=TINY_CLAP)
    assert entry["verified"] is False and "max_abs_forward_err" not in entry
    want = jconvert_clap.convert_clap_audio(_torch_state_dict_numpy(tiny_clap), depths=TINY_CLAP.depths)
    assert entry["sha256"] == _sha256(serialization.to_bytes(want))


def _write_images(folder, n, seed):
    from PIL import Image

    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)).save(os.path.join(folder, f"img_{i}.png"))


@pytest.fixture(scope="module")
def imagenet_dir(tmp_path_factory):
    """The port's provisioning of 1000-class InceptionV3 and ResNet18 (the
    widths the evaluators and --pretrained_dir read), checked at 75×75."""
    src = tmp_path_factory.mktemp("imagenet_sources")
    sources = {}
    for name, cls in (("inception_v3", TorchInceptionV3), ("resnet18", TorchResNet18)):
        sources[name] = str(src / f"{name}.pth")
        torch.save(randomize_(cls(num_classes=1000), seed=6).state_dict(), sources[name])
    out = str(tmp_path_factory.mktemp("imagenet_eval"))
    return out, sources, tprov.main([*(a for n, p in sources.items() for a in (f"--{n}", p)), "--out_dir", out,
                                     "--img_size", "75", "--device", "cpu"])


def test_verify_metrics_scores_from_the_provisioned_inception(imagenet_dir, tmp_path, capsys):
    from spectrogramgenai_tpu_torch.cli import verify_metrics

    out, _, manifest = imagenet_dir
    assert all(e["verified"] and e["max_abs_forward_err"] < ERR_TOL for e in manifest.values())
    real, gen = str(tmp_path / "real"), str(tmp_path / "gen")
    _write_images(real, 4, 0)
    _write_images(gen, 4, 1)
    capsys.readouterr()
    results = verify_metrics.run(real, gen, out, splits=2, device="cpu")
    printed = capsys.readouterr().out
    assert f"inception_v3: sha256={manifest['inception_v3']['sha256'][:12]}… verified=True" in printed
    assert "WARNING" not in printed
    assert np.isfinite(results["inception_score_mean"]) and results["inception_score_mean"] >= 1.0 - 1e-9
    assert np.isfinite(results["fid"]) and results["fid"] >= 0


class _Stop(Exception):
    pass


def test_pretrained_dir_reads_what_the_port_provisions(imagenet_dir, manifests, tmp_path, capsys, monkeypatch):
    """The port's provisioning feeds the port's --pretrained_dir; the JAX tool's
    {name}.msgpack is not what the JAX CLI looks for."""
    from PIL import Image

    from spectrogramgenai_tpu.cli import common as jcommon
    from spectrogramgenai_tpu.cli import train_classifiers as jcli
    from spectrogramgenai_tpu.train import classifier_task as jtask
    from spectrogramgenai_tpu_torch.cli import train_classifiers as tcli
    from spectrogramgenai_tpu_torch.core import flax_msgpack

    out = imagenet_dir[0]
    rng = np.random.default_rng(0)
    for split in ("train", "val"):
        for c in range(2):
            os.makedirs(tmp_path / split / f"c{c}")
            for i in range(2):
                Image.fromarray(rng.integers(0, 256, (32, 32), dtype=np.uint8)).save(
                    tmp_path / split / f"c{c}" / f"{i}.png")
    common = ["--train_dir", str(tmp_path / "train"), "--val_dir", str(tmp_path / "val"), "--models", "resnet",
              "--synths", "0", "--epochs", "1", "--data.img_size", "32", "--data.batch_size", "2"]
    capsys.readouterr()
    tcli.main([*common, "--compute_dtype", "float32", "--pretrained_dir", out, "--run.output_dir",
               str(tmp_path / "sweep"), "--device", "cpu"])
    printed = capsys.readouterr().out
    path = os.path.join(out, "resnet18_imagenet.msgpack")
    n_params = len(_flat(flax_msgpack.read(path)["params"]))
    assert f"resnet: loaded {n_params - 2} pretrained tensors from {path}" in printed
    assert "no converted weights" not in printed

    # the JAX pair: its tool installs resnet18.msgpack, its CLI looks for resnet18_imagenet.msgpack
    jdir = os.path.dirname(manifests[0]["resnet18"]["path"])
    assert os.path.basename(manifests[0]["resnet18"]["path"]) == "resnet18.msgpack"

    def stop(*args, **kwargs):
        raise _Stop

    monkeypatch.setattr(jcommon, "setup", lambda *a, **k: None)
    monkeypatch.setattr(jtask, "ClassifierTask", stop)  # the CLI's lookup comes first; training is not needed
    capsys.readouterr()
    with pytest.raises(_Stop):
        jcli.main([*common, "--pretrained_dir", jdir, "--run.output_dir", str(tmp_path / "jax_sweep")])
    assert (f"note: no converted weights at {os.path.join(jdir, 'resnet18_imagenet.msgpack')}; training resnet "
            "from scratch") in capsys.readouterr().out


_BLOCKED_IMPORTS = """
import json, sys
BLOCKED = ("jax", "flax", "optax", "transformers", "spectrogramgenai_tpu")
for name in BLOCKED:
    sys.modules[name] = None
sys.path.insert(0, "tools")
import port_convert_clap, port_convert_torchvision, port_provision_eval_weights
resnet, clap, out = sys.argv[1:4]
port_convert_torchvision.main(["--model", "resnet18", "--state_dict", resnet, "--out", out + "/r.msgpack"])
port_convert_clap.main(["--state_dict", clap, "--out", out + "/c.msgpack", "--depths", "2,2"])
manifest = port_provision_eval_weights.main(["--resnet18", resnet, "--out_dir", out, "--num_classes", "19",
                                             "--img_size", "64", "--device", "cpu"])
loaded = [m for m in sys.modules if m.split(".")[0] in BLOCKED and sys.modules[m] is not None]
print(json.dumps({"loaded": loaded, "sha256": manifest["resnet18"]["sha256"]}))
"""


def test_tools_run_without_jax_flax_or_transformers(sources, tiny_clap, manifests, tmp_path):
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORTS, sources["resnet18"], tiny_clap, str(tmp_path)],
                          cwd=ROOT, capture_output=True, text=True, timeout=300,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["loaded"] == []
    assert report["sha256"] == manifests[0]["resnet18"]["sha256"]
    with open(tmp_path / "r.msgpack", "rb") as f:
        assert _sha256(f.read()) == manifests[0]["resnet18"]["sha256"]
    want = jconvert_clap.convert_clap_audio(_torch_state_dict_numpy(tiny_clap), depths=TINY_CLAP.depths)
    with open(tmp_path / "c.msgpack", "rb") as f:
        assert f.read() == serialization.to_bytes(want)
