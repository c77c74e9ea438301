"""flax parameters → the port's state_dicts, and back.

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
  * a ``SpectralNorm``-wrapped layer (``models/gan.py``): its kernel and
    bias as above, from the layer's own params path, and its power-iteration
    state from ``batch_stats`` of the enclosing module's ``SpectralNorm_<j>``,
    ``<layer>/kernel/u`` (1, out) and ``<layer>/kernel/sigma`` () → the
    layer's ``u`` and ``sigma`` buffers;
  * the first Dense after a flatten needs no permutation: the port's
    classifiers and discriminator flatten NHWC, as flax does, and the
    generator reads its first Dense's output as NHWC;
  * a module's own ``nn.Parameter`` (the CLAP tower's
    ``relative_position_bias_table``) is the flax leaf of the same name, as
    it is; a ``Linear`` without a bias (CLAP's ``reduction``) has no bias leaf.

:func:`flax_from_state_dict` is the inverse for modules without spectral
norm: the ``{"params", "batch_stats", "codebook"}`` tree that
``tools/convert_*.py`` writes for the same weights, with every Dense kernel
as (in, out).

Inputs are nested dicts of array-likes (numpy arrays, or anything
``np.asarray`` accepts), as flax variables are: ``{"params": …}``, for the
VQ-VAE ``{"params": …, "codebook": …}``, for a model with BatchNorm or
spectral norm ``{"params": …, "batch_stats": …}``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from spectrogramgenai_tpu_torch.models.classifiers import BatchNorm
from spectrogramgenai_tpu_torch.models.gan import SpectralNorm
from spectrogramgenai_tpu_torch.models.vqvae import VQEmbeddingEMA


def _subtree(tree: dict, path: list[str]) -> dict:
    for name in path:
        tree = tree[name]
    return tree


def _t(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):  # a bfloat16 leaf of core/flax_msgpack
        return a.detach().to(torch.float32, copy=True)
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy().copy()


def _spectral_norm_stats(batch_stats: dict, path: list[str]) -> dict:
    """{"u", "sigma"} of the layer at ``path`` from its SpectralNorm wrapper's stats."""
    parent, name = _subtree(batch_stats, path[:-1]), path[-1]
    for wrapper, stats in parent.items():
        if wrapper.startswith("SpectralNorm_") and f"{name}/kernel/u" in stats:
            return {"u": stats[f"{name}/kernel/u"], "sigma": stats[f"{name}/kernel/sigma"]}
    raise KeyError(f"no SpectralNorm stats for {'/'.join(path)}")


_LAYERS = (nn.Conv2d, nn.ConvTranspose2d, nn.Linear, nn.Embedding, nn.GroupNorm, nn.LayerNorm)


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
        if not isinstance(m, _LAYERS):
            for pname, _ in m.named_parameters(recurse=False):
                out[prefix + pname] = _t(_subtree(variables["params"], path)[pname])
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
        if isinstance(m, SpectralNorm):
            out.update({prefix + k: _t(v) for k, v in _spectral_norm_stats(variables["batch_stats"], path).items()})

    want = module.state_dict()
    if set(want) != set(out):
        raise KeyError(f"bridge left keys unfilled {sorted(set(want) - set(out))} "
                       f"or made extra ones {sorted(set(out) - set(want))}")
    for k, v in want.items():
        if tuple(v.shape) != tuple(out[k].shape):
            raise ValueError(f"{k}: flax gives shape {tuple(out[k].shape)}, module has {tuple(v.shape)}")
    return out


def flax_from_state_dict(module: nn.Module, state_dict: dict[str, torch.Tensor]) -> dict:
    """The flax variables (nested dicts of float32 NumPy arrays) holding
    ``state_dict``'s values for ``module``: the inverse of
    :func:`state_dict_from_flax`. Raises for a spectral-norm layer, whose
    flax wrapper's index the module does not keep."""
    tree: dict = {}

    def put(collection: str, path: list[str], leaves: dict) -> None:
        node = tree.setdefault(collection, {})
        for name in path:
            node = node.setdefault(name, {})
        node.update(leaves)

    for name, m in module.named_modules():
        path, prefix = (name.split("."), name + ".") if name else ([], "")
        own = [k for k, _ in m.named_parameters(recurse=False)]
        sd = {k: state_dict[prefix + k] for k in own + [k for k, _ in m.named_buffers(recurse=False)]
              if prefix + k in state_dict}  # not the non-persistent buffers
        if isinstance(m, SpectralNorm):
            raise NotImplementedError(f"{name}: spectral-norm layers are not written back to flax")
        if isinstance(m, VQEmbeddingEMA):
            put("codebook", path, {k: _np(sd[k]) for k in ("embedding", "ema_count", "ema_weight")})
        elif isinstance(m, BatchNorm):
            put("params", path, {"scale": _np(sd["weight"]), "bias": _np(sd["bias"])})
            put("batch_stats", path, {"mean": _np(sd["running_mean"]), "var": _np(sd["running_var"])})
        elif isinstance(m, _LAYERS):
            w = _np(sd["weight"])
            if isinstance(m, nn.Conv2d):
                leaf = {"kernel": w.transpose(2, 3, 1, 0)}
            elif isinstance(m, nn.ConvTranspose2d):
                leaf = {"kernel": np.ascontiguousarray(w.transpose(2, 3, 0, 1)[::-1, ::-1])}
            elif isinstance(m, nn.Linear):
                leaf = {"kernel": w.T}
            elif isinstance(m, nn.Embedding):
                leaf = {"embedding": w}
            else:  # GroupNorm / LayerNorm
                leaf = {"scale": w}
            if "bias" in sd:
                leaf["bias"] = _np(sd["bias"])
            put("params", path, {k: np.ascontiguousarray(v) for k, v in leaf.items()})
        elif own:
            put("params", path, {k: _np(sd[k]) for k in own})
    return tree
