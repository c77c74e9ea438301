"""One-command evaluator-weights bring-up for the PyTorch port: fetch, convert, verify, install.

The port's counterpart of tools/provision_eval_weights.py, for a machine
with torch and no JAX or flax. It makes the files that the port's
evaluators and classifiers read: torchvision inception_v3 for IS/FID,
laion-CLAP's audio tower for FAD, and ImageNet resnet18 / vgg16 /
mobilenet_v2 for the classifier sweep:

  python tools/port_provision_eval_weights.py --out_dir models/eval \\
      --inception_v3 https://download.pytorch.org/models/inception_v3_google-0cc3c7bd.pth \\
      --resnet18    https://download.pytorch.org/models/resnet18-f37072fd.pth \\
      --vgg16       https://download.pytorch.org/models/vgg16-397923af.pth \\
      --mobilenet_v2 https://download.pytorch.org/models/mobilenet_v2-b0353104.pth \\
      --clap        /path/to/clap-htsat-unfused/pytorch_model.bin

Per source (local path or URL) it:
  1. loads the torch state_dict (downloading first if a URL),
  2. converts it with tools/port_convert_torchvision.py or
     tools/port_convert_clap.py (copies of the NumPy converters of
     tools/convert_*.py),
  3. VERIFIES the conversion on ``--device`` (float32, TF32 off): a
     torchvision net's state_dict loaded into the torch oracle of
     tests/torch_refs.py against the converted tree in the port's own model
     (eval.inception.InceptionV3, models.classifiers); CLAP's against HF
     transformers' ClapAudioModelWithProjection — where transformers is not
     installed, pass ``--skip_verify``, or CLAP is refused,
  4. installs ``<out_dir>/inception_v3.msgpack``, ``clap_audio.msgpack`` or
     ``{resnet18,vgg16,mobilenet_v2}_imagenet.msgpack`` (the name that
     ``--pretrained_dir`` reads; the JAX tool's ``{name}.msgpack`` holds the
     same bytes) and records its sha256 and max-abs forward error in
     ``<out_dir>/manifest.json``.

Afterwards:

  python -m spectrogramgenai_tpu_torch.cli.verify_metrics \\
      --real_dir datasets/val_flat --gen_dir gen_images --weights_dir models/eval
  python -m spectrogramgenai_tpu_torch.cli.train_classifiers ... --pretrained_dir models/eval

Any subset of models may be provisioned; each flag is independent. Runs on
CUDA unless ``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
for p in (_ROOT, _HERE, os.path.join(_ROOT, "tests")):
    if p not in sys.path:
        sys.path.insert(0, p)

TORCHVISION_MODELS = ("inception_v3", "resnet18", "vgg16", "mobilenet_v2")
ATOL, RTOL = 5e-3, 1e-3  # the forward check's tolerance, the JAX tool's


def installed_name(name: str) -> str:
    """The file a source installs as: the classifiers' ``{stem}_imagenet.msgpack``
    is what ``train_classifiers --pretrained_dir`` reads."""
    return f"{name}.msgpack" if name == "inception_v3" else f"{name}_imagenet.msgpack"


def _fetch(src: str, workdir: str) -> str:
    """Return a local path for `src`, downloading it first if it is a URL."""
    if src.startswith(("http://", "https://")):
        import urllib.request

        dest = os.path.join(workdir, os.path.basename(src) or "weights.pth")
        print(f"downloading {src} → {dest}")
        urllib.request.urlretrieve(src, dest)
        return dest
    if not os.path.exists(src):
        raise FileNotFoundError(src)
    return src


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _compare(got, want) -> float:
    """The max-abs error of ``got`` against ``want``; raises beyond the tolerance."""
    got, want = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    return float(np.max(np.abs(got - want)))


def _install(variables: dict, out_path: str, entry: dict, verify: bool) -> dict:
    from spectrogramgenai_tpu_torch.core import flax_msgpack

    flax_msgpack.write(out_path, variables)
    entry.update(path=out_path, sha256=_sha256(out_path), verified=verify)
    return entry


# -- torchvision models -------------------------------------------------------

def _verify_torchvision(name: str, sd: dict, variables: dict, num_classes: int, img_size: int, device) -> float:
    """Forward-parity check: torch oracle (same state_dict) vs the port's model
    (converted tree). Returns the max-abs logit error."""
    import torch
    from torch_refs import TorchInceptionV3, TorchMobileNetV2, TorchResNet18, TorchVGG16

    from spectrogramgenai_tpu_torch.bridge import state_dict_from_flax
    from spectrogramgenai_tpu_torch.core.precision import full_float32
    from spectrogramgenai_tpu_torch.eval.inception import InceptionV3
    from spectrogramgenai_tpu_torch.models.classifiers import VGG16, MobileNetV2, ResNet18

    torch_cls, port_cls = {"inception_v3": (TorchInceptionV3, InceptionV3), "resnet18": (TorchResNet18, ResNet18),
                           "vgg16": (TorchVGG16, VGG16), "mobilenet_v2": (TorchMobileNetV2, MobileNetV2)}[name]
    oracle = torch_cls(num_classes=num_classes).eval()
    # strict=False: real torchvision state_dicts carry keys the oracle omits
    # (AuxLogits.*, num_batches_tracked); anything MISSING is a hard error.
    missing, unexpected = oracle.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()}, strict=False)
    if missing:
        raise ValueError(f"{name}: state_dict is missing oracle keys: {missing[:5]}")
    benign = [k for k in unexpected
              if not (k.startswith("AuxLogits.") or k.endswith("num_batches_tracked"))]
    if benign:
        raise ValueError(f"{name}: unexpected state_dict keys: {benign[:5]}")
    port = port_cls(num_classes=num_classes)  # InceptionV3 with torchvision's pools, not the FID ones
    port.load_state_dict(state_dict_from_flax(port, variables))

    x = np.random.default_rng(7).uniform(-1, 1, (2, img_size, img_size, 3)).astype(np.float32)
    x = torch.from_numpy(x).to(device)
    with torch.inference_mode(), full_float32():
        want = oracle.to(device)(x.permute(0, 3, 1, 2))
        got = port.to(device).eval()(x)
    return _compare(got, want)


def provision_torchvision(name: str, src_path: str, out_dir: str, *, num_classes: int = 1000,
                          img_size: int = 96, verify: bool = True, device="cuda") -> dict:
    from port_convert_torchvision import CONVERTERS, load_state_dict

    sd = load_state_dict(src_path)
    variables = CONVERTERS[name](sd)
    entry = {"source": src_path, "source_sha256": _sha256(src_path)}
    if verify:
        entry["max_abs_forward_err"] = _verify_torchvision(name, sd, variables, num_classes, img_size, device)
    return _install(variables, os.path.join(out_dir, installed_name(name)), entry, verify)


# -- CLAP ---------------------------------------------------------------------

def _hf_clap():
    """transformers' (ClapAudioConfig, ClapAudioModelWithProjection), or an
    error naming --skip_verify where transformers is not installed."""
    try:
        from transformers.models.clap.configuration_clap import ClapAudioConfig
        from transformers.models.clap.modeling_clap import ClapAudioModelWithProjection
    except ImportError as e:
        raise RuntimeError("clap: the forward check needs HF transformers, which is not installed; pass "
                           "--skip_verify to install the converted tower unverified") from e
    return ClapAudioConfig, ClapAudioModelWithProjection


def _verify_clap(sd: dict, variables: dict, cfg, device) -> float:
    """Forward-parity vs HF transformers' torch CLAP audio branch (the
    canonical laion-clap port) at ``cfg``, against the port's tower."""
    import torch

    from spectrogramgenai_tpu_torch.core.precision import full_float32
    from spectrogramgenai_tpu_torch.eval.clap import build_clap

    config_cls, model_cls = _hf_clap()
    hf = model_cls(config_cls(
        enable_fusion=False, num_mel_bins=cfg.num_mel_bins, spec_size=cfg.spec_size, patch_size=cfg.patch_size,
        patch_stride=cfg.patch_stride, patch_embeds_hidden_size=cfg.patch_embeds_hidden_size,
        depths=list(cfg.depths), num_attention_heads=list(cfg.num_attention_heads), window_size=cfg.window_size,
        mlp_ratio=cfg.mlp_ratio, qkv_bias=cfg.qkv_bias, layer_norm_eps=cfg.layer_norm_eps,
        hidden_size=cfg.hidden_size, projection_dim=cfg.projection_dim, num_hidden_layers=len(cfg.depths))).eval()
    prefixed = {}
    for k, v in sd.items():
        t = torch.as_tensor(v)
        if k.startswith(("audio_model.", "audio_projection.")):
            prefixed[k] = t
        elif k.startswith("audio_encoder."):
            prefixed["audio_model." + k] = t
        elif k.startswith("proj."):
            prefixed["audio_projection." + k[len("proj."):]] = t
    missing, _unexpected = hf.load_state_dict(prefixed, strict=False)
    # the model makes these buffers itself
    real_missing = [k for k in missing if not k.endswith(("num_batches_tracked", "relative_position_index"))]
    if real_missing:
        raise ValueError(f"clap: state_dict missing audio-branch keys: {real_missing[:5]}")

    # 1001 frames (10 s at hop 480), or one short of a smaller tower's image width
    frames = min(1001, cfg.spec_size * cfg.freq_ratio - 1)
    feats = np.random.default_rng(11).standard_normal((1, 1, cfg.num_mel_bins, frames)).astype(np.float32) * 0.3
    x = torch.from_numpy(np.transpose(feats, (0, 1, 3, 2)).copy()).to(device)
    with torch.inference_mode(), full_float32():
        want = hf.to(device)(x).audio_embeds
        got = build_clap(variables, device, cfg)(x)
    return _compare(got, want)


def provision_clap(src_path: str, out_dir: str, *, verify: bool = True, device="cuda", cfg=None) -> dict:
    """``cfg``: the tower's ``ClapAudioTowerConfig`` (default: HTSAT-tiny, the reference's)."""
    from port_convert_clap import convert_clap_audio
    from port_convert_torchvision import load_state_dict

    from spectrogramgenai_tpu_torch.eval.clap import ClapAudioTowerConfig

    cfg = cfg or ClapAudioTowerConfig()
    sd = load_state_dict(src_path)
    variables = convert_clap_audio(sd, depths=cfg.depths)
    entry = {"source": src_path, "source_sha256": _sha256(src_path)}
    if verify:
        entry["max_abs_forward_err"] = _verify_clap(sd, variables, cfg, device)
    return _install(variables, os.path.join(out_dir, "clap_audio.msgpack"), entry, verify)


# -- all sources ---------------------------------------------------------------

def provision(sources: dict[str, str], out_dir: str, *, verify: bool = True,
              num_classes: int = 1000, img_size: int = 96, device="cuda") -> dict:
    """Convert+verify+install every (name → path/URL) in `sources` on `device`.

    Returns the manifest dict (also written to <out_dir>/manifest.json).
    """
    from spectrogramgenai_tpu_torch.cli.common import resolve_device

    device = resolve_device(str(device))
    if verify and "clap" in sources:
        _hf_clap()  # refuse before anything is written
    os.makedirs(out_dir, exist_ok=True)
    manifest_path = os.path.join(out_dir, "manifest.json")
    manifest = {}
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            manifest = json.load(f)

    with tempfile.TemporaryDirectory() as tmp:
        for name, src in sources.items():
            local = _fetch(src, tmp)
            print(f"provisioning {name} from {local} …")
            if name == "clap":
                entry = provision_clap(local, out_dir, verify=verify, device=device)
            else:
                entry = provision_torchvision(name, local, out_dir, verify=verify, num_classes=num_classes,
                                              img_size=img_size, device=device)
            manifest[name] = entry
            err = entry.get("max_abs_forward_err")
            print(f"  ok: {entry['path']}  sha256={entry['sha256'][:12]}…"
                  + (f"  max_abs_err={err:.2e}" if err is not None else "  (unverified)"))

    with open(manifest_path, "w") as f:
        json.dump(manifest, f, indent=2)
    print(f"manifest → {manifest_path}")
    return manifest


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    for name in TORCHVISION_MODELS:
        p.add_argument(f"--{name}", default=None, metavar="PATH_OR_URL")
    p.add_argument("--clap", default=None, metavar="PATH_OR_URL",
                   help="HF laion/clap-htsat-unfused state_dict (pytorch_model.bin)")
    p.add_argument("--out_dir", default="models/eval")
    p.add_argument("--skip_verify", action="store_true",
                   help="skip the torch forward-parity check (not recommended; CLAP's needs transformers)")
    p.add_argument("--num_classes", type=int, default=1000,
                   help="classifier head width of the provided state_dicts "
                        "(1000 for stock torchvision; override for test dicts)")
    p.add_argument("--img_size", type=int, default=96,
                   help="verification forward input size")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu for tests)")
    a = p.parse_args(argv)

    sources = {name: getattr(a, name) for name in (*TORCHVISION_MODELS, "clap")
               if getattr(a, name)}
    if not sources:
        p.error("no sources given — pass at least one of "
                + ", ".join(f"--{n}" for n in (*TORCHVISION_MODELS, "clap")))
    return provision(sources, a.out_dir, verify=not a.skip_verify,
                     num_classes=a.num_classes, img_size=a.img_size, device=a.device)


if __name__ == "__main__":
    main()
