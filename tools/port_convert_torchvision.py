"""Convert torchvision ImageNet state_dicts → flax parameter trees, for the PyTorch port.

The port's copy of tools/convert_torchvision.py: the same NumPy converters,
run with torch alone (no JAX, no flax). It writes the file with
``spectrogramgenai_tpu_torch.core.flax_msgpack.write``, whose bytes are the
ones ``flax.serialization.to_bytes`` writes for the same tree:

  python tools/port_convert_torchvision.py --model resnet18 \\
      --state_dict resnet18-f37072fd.pth --out models/eval/resnet18_imagenet.msgpack

The file loads into the port's InceptionV3 (``eval.inception.load_inception_params``,
``cli.inception_score --weights``) and classifiers
(``cli.train_classifiers --pretrained_dir``) as into the JAX package's.
``tools/port_provision_eval_weights.py`` converts, verifies and installs in
one command.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)


def t_conv(w):  # OIHW → HWIO (also handles depthwise (O,1,H,W) → (H,W,1,O))
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def t_linear(w):  # (out, in) → (in, out)
    return np.transpose(np.asarray(w), (1, 0))


def _bn(sd, prefix):
    return (
        {"scale": np.asarray(sd[f"{prefix}.weight"]), "bias": np.asarray(sd[f"{prefix}.bias"])},
        {"mean": np.asarray(sd[f"{prefix}.running_mean"]), "var": np.asarray(sd[f"{prefix}.running_var"])},
    )


def convert_resnet18(sd):
    params, stats = {}, {}
    params["stem_conv"] = {"kernel": t_conv(sd["conv1.weight"])}
    params["stem_bn"], stats["stem_bn"] = _bn(sd, "bn1")
    for stage in range(1, 5):
        for block in range(2):
            src = f"layer{stage}.{block}"
            dst = f"layer{stage}_{block}"
            p = {
                "Conv_0": {"kernel": t_conv(sd[f"{src}.conv1.weight"])},
                "Conv_1": {"kernel": t_conv(sd[f"{src}.conv2.weight"])},
            }
            s = {}
            p["BatchNorm_0"], s["BatchNorm_0"] = _bn(sd, f"{src}.bn1")
            p["BatchNorm_1"], s["BatchNorm_1"] = _bn(sd, f"{src}.bn2")
            if f"{src}.downsample.0.weight" in sd:
                p["downsample_conv"] = {"kernel": t_conv(sd[f"{src}.downsample.0.weight"])}
                p["downsample_bn"], s["downsample_bn"] = _bn(sd, f"{src}.downsample.1")
            params[dst], stats[dst] = p, s
    params["fc"] = {"kernel": t_linear(sd["fc.weight"]), "bias": np.asarray(sd["fc.bias"])}
    return {"params": params, "batch_stats": stats}


VGG16_CONV_IDX = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]


def convert_vgg16(sd):
    params = {}
    for i, idx in enumerate(VGG16_CONV_IDX):
        params[f"conv_{i}"] = {
            "kernel": t_conv(sd[f"features.{idx}.weight"]),
            "bias": np.asarray(sd[f"features.{idx}.bias"]),
        }
    # classifier.0 consumes the flattened 7×7×512 pool output: torch flattens
    # NCHW (C,7,7) but the flax model reshapes NHWC (7,7,C) — permute the
    # input axis of the first linear layer accordingly.
    w0 = np.asarray(sd["classifier.0.weight"])  # (4096, 512·7·7) in (C,H,W) order
    w0 = w0.reshape(-1, 512, 7, 7).transpose(0, 2, 3, 1).reshape(-1, 7 * 7 * 512)
    params["classifier_0"] = {"kernel": w0.T, "bias": np.asarray(sd["classifier.0.bias"])}
    for dst, src in (("classifier_3", "classifier.3"), ("classifier_6", "classifier.6")):
        params[dst] = {"kernel": t_linear(sd[f"{src}.weight"]), "bias": np.asarray(sd[f"{src}.bias"])}
    return {"params": params, "batch_stats": {}}


MOBILENET_PLAN = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
                  (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]


def convert_mobilenet_v2(sd):
    params, stats = {}, {}
    params["features_0"] = {"kernel": t_conv(sd["features.0.0.weight"])}
    params["features_0_bn"], stats["features_0_bn"] = _bn(sd, "features.0.1")
    idx = 1
    for t, c, n, s in MOBILENET_PLAN:
        for _ in range(n):
            src = f"features.{idx}.conv"
            p, st = {}, {}
            if t == 1:  # no expand conv: [dw ConvBNReLU, project conv, bn]
                p["Conv_0"] = {"kernel": t_conv(sd[f"{src}.0.0.weight"])}
                p["BatchNorm_0"], st["BatchNorm_0"] = _bn(sd, f"{src}.0.1")
                p["Conv_1"] = {"kernel": t_conv(sd[f"{src}.1.weight"])}
                p["BatchNorm_1"], st["BatchNorm_1"] = _bn(sd, f"{src}.2")
            else:
                p["Conv_0"] = {"kernel": t_conv(sd[f"{src}.0.0.weight"])}
                p["BatchNorm_0"], st["BatchNorm_0"] = _bn(sd, f"{src}.0.1")
                p["Conv_1"] = {"kernel": t_conv(sd[f"{src}.1.0.weight"])}
                p["BatchNorm_1"], st["BatchNorm_1"] = _bn(sd, f"{src}.1.1")
                p["Conv_2"] = {"kernel": t_conv(sd[f"{src}.2.weight"])}
                p["BatchNorm_2"], st["BatchNorm_2"] = _bn(sd, f"{src}.3")
            params[f"features_{idx}"], stats[f"features_{idx}"] = p, st
            idx += 1
    params[f"features_{idx}"] = {"kernel": t_conv(sd[f"features.{idx}.0.weight"])}
    params[f"features_{idx}_bn"], stats[f"features_{idx}_bn"] = _bn(sd, f"features.{idx}.1")
    params["classifier"] = {"kernel": t_linear(sd["classifier.1.weight"]),
                            "bias": np.asarray(sd["classifier.1.bias"])}
    return {"params": params, "batch_stats": stats}


def convert_inception_v3(sd):
    """torchvision inception_v3 — module names already mirror ours."""
    params, stats = {}, {}
    modules = sorted({k.rsplit(".", 2)[0] for k in sd if k.endswith("conv.weight")})
    for mod in modules:
        if mod.startswith("AuxLogits"):
            continue
        parts = mod.split(".")
        node_p, node_s = params, stats
        for part in parts[:-1]:
            node_p = node_p.setdefault(part, {})
            node_s = node_s.setdefault(part, {})
        leaf = parts[-1]
        bn_p, bn_s = _bn(sd, f"{mod}.bn")
        node_p[leaf] = {"conv": {"kernel": t_conv(sd[f"{mod}.conv.weight"])}, "bn": bn_p}
        node_s[leaf] = {"bn": bn_s}
    params["fc"] = {"kernel": t_linear(sd["fc.weight"]), "bias": np.asarray(sd["fc.bias"])}
    return {"params": params, "batch_stats": stats}


CONVERTERS = {
    "resnet18": convert_resnet18,
    "vgg16": convert_vgg16,
    "mobilenet_v2": convert_mobilenet_v2,
    "inception_v3": convert_inception_v3,
}


def load_state_dict(path: str) -> dict:
    """The tensors of a torch state_dict file (``torch.load`` with
    ``weights_only``; a pickled module gives its ``state_dict()``) as NumPy arrays."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: v.numpy() for k, v in sd.items() if hasattr(v, "numpy")}


def n_params(tree) -> int:
    """The number of values in a tree's array leaves."""
    if isinstance(tree, dict):
        return sum(n_params(v) for v in tree.values())
    return tree.size


def main(argv=None):
    from spectrogramgenai_tpu_torch.core import flax_msgpack

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", required=True, choices=sorted(CONVERTERS))
    p.add_argument("--state_dict", required=True, help=".pth state_dict file")
    p.add_argument("--out", required=True, help="output .msgpack path")
    a = p.parse_args(argv)

    variables = CONVERTERS[a.model](load_state_dict(a.state_dict))
    flax_msgpack.write(a.out, variables)
    print(f"converted {a.model}: {n_params(variables) / 1e6:.1f}M params → {a.out}")


if __name__ == "__main__":
    main()
