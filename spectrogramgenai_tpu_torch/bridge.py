"""flax parameters → the port's state_dicts.

The port's modules repeat the flax module names, so a flax parameter path
(``Down_0/DoubleConv_1/Conv_0/kernel``) is the torch key with dots
(``Down_0.DoubleConv_1.Conv_0.weight``). What changes is the layout:

  * conv kernels HWIO → OIHW;
  * ``Dense`` (in, out) → ``Linear`` (out, in); the attention ``DenseGeneral``
    kernels q/k/v (C, H, Dh) → (H·Dh, C) and ``out`` (H, Dh, C) → (C, H·Dh),
    biases flattened;
  * ``Embed.embedding`` → ``Embedding.weight``; norm ``scale`` → ``weight``;
  * ``nn.ConvTranspose`` (kh, kw, in, out) → (in, out, kh, kw) with the
    kernel flipped in space: flax's default ``transpose_kernel=False`` is a
    fractionally strided convolution, not torch's adjoint convolution;
  * the ``codebook`` collection (``embedding``, ``ema_count``,
    ``ema_weight``) → the codebook's buffers;
  * ``BatchNorm`` ``scale`` / ``bias`` → ``weight`` / ``bias``, and its
    ``batch_stats`` ``mean`` / ``var`` → ``running_mean`` / ``running_var``;
  * a depthwise conv (``feature_group_count`` = channels, kernel
    (kh, kw, 1, C)) → (C, 1, kh, kw), the same HWIO → OIHW transpose;
  * the first Dense after a flatten needs no permutation: the port's
    classifiers flatten NHWC, as flax does.

Inputs are nested dicts of array-likes (numpy arrays, or anything
``np.asarray`` accepts), as flax variables are: ``{"params": …}``, for the
VQ-VAE ``{"params": …, "codebook": …}``, for a classifier with BatchNorm
``{"params": …, "batch_stats": …}``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from spectrogramgenai_tpu_torch.models.classifiers import BatchNorm
from spectrogramgenai_tpu_torch.models.vqvae import VQEmbeddingEMA


def _subtree(tree: dict, path: list[str]) -> dict:
    for name in path:
        tree = tree[name]
    return tree


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def state_dict_from_flax(module: nn.Module, variables: dict) -> dict[str, torch.Tensor]:
    """The state_dict for ``module`` holding the flax ``variables``' values.
    Raises if a key of the module's state_dict is not filled, or a shape differs."""
    out: dict[str, torch.Tensor] = {}
    for name, m in module.named_modules():
        path = name.split(".") if name else []
        prefix = name + "." if name else ""
        if isinstance(m, VQEmbeddingEMA):
            cb = _subtree(variables["codebook"], path)
            for buf in ("embedding", "ema_count", "ema_weight"):
                out[prefix + buf] = _t(cb[buf])
            continue
        if isinstance(m, BatchNorm):
            p, st = _subtree(variables["params"], path), _subtree(variables["batch_stats"], path)
            out.update({prefix + "weight": _t(p["scale"]), prefix + "bias": _t(p["bias"]),
                        prefix + "running_mean": _t(st["mean"]), prefix + "running_var": _t(st["var"])})
            continue
        if not isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear, nn.Embedding,
                              nn.GroupNorm, nn.LayerNorm)):
            continue
        p = _subtree(variables["params"], path)
        if isinstance(m, nn.Conv2d):
            out[prefix + "weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
        elif isinstance(m, nn.ConvTranspose2d):
            k = np.asarray(p["kernel"])[::-1, ::-1]
            out[prefix + "weight"] = _t(k.transpose(2, 3, 0, 1))
        elif isinstance(m, nn.Linear):
            k = np.asarray(p["kernel"]).reshape(m.in_features, m.out_features)
            out[prefix + "weight"] = _t(k.T)
        elif isinstance(m, nn.Embedding):
            out[prefix + "weight"] = _t(p["embedding"])
        else:  # GroupNorm / LayerNorm
            out[prefix + "weight"] = _t(p["scale"])
        if getattr(m, "bias", None) is not None:
            out[prefix + "bias"] = _t(np.asarray(p["bias"]).reshape(-1))

    want = module.state_dict()
    if set(want) != set(out):
        raise KeyError(f"bridge left keys unfilled {sorted(set(want) - set(out))} "
                       f"or made extra ones {sorted(set(out) - set(want))}")
    for k, v in want.items():
        if tuple(v.shape) != tuple(out[k].shape):
            raise ValueError(f"{k}: flax gives shape {tuple(out[k].shape)}, module has {tuple(v.shape)}")
    return out
