"""Convert a HuggingFace CLAP audio-branch state_dict → the flax ClapAudioTower tree, for the PyTorch port.

The port's copy of tools/convert_clap.py: the same NumPy converter, run with
torch alone (no JAX, no flax, no transformers), writing the bytes flax writes
(``spectrogramgenai_tpu_torch.core.flax_msgpack.write``):

  python tools/port_convert_clap.py --state_dict pytorch_model.bin \\
      --out models/eval/clap_audio.msgpack

The file loads through ``spectrogramgenai_tpu_torch.eval.clap.load_clap_params``
and drives the port's CLAP-FAD path (``cli.fad --mode clap --clap_ckpt``,
``cli.verify_metrics``).

Accepts state_dicts from ClapModel, ClapAudioModelWithProjection (standard
``audio_model.audio_encoder.`` / ``audio_projection.`` prefixes), or a bare
ClapAudioModel plus separate projection (``audio_encoder.`` / ``proj.``).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
for _p in (os.path.dirname(_HERE), _HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from port_convert_torchvision import load_state_dict, n_params, t_conv, t_linear  # noqa: E402


def _ln(sd, key):
    return {"scale": np.asarray(sd[f"{key}.weight"]), "bias": np.asarray(sd[f"{key}.bias"])}


def _dense(sd, key):
    return {"kernel": t_linear(sd[f"{key}.weight"]), "bias": np.asarray(sd[f"{key}.bias"])}


def convert_clap_audio(sd: dict, depths=(2, 2, 6, 2)) -> dict:
    """HF CLAP state_dict (numpy values) → {"params": …, "batch_stats": …}."""
    # normalize prefixes: audio_model.audio_encoder.X → X, audio_projection.Y → proj.Y
    norm = {}
    for k, v in sd.items():
        if k.startswith("audio_model.audio_encoder."):
            norm[k[len("audio_model.audio_encoder."):]] = v
        elif k.startswith("audio_encoder."):
            norm[k[len("audio_encoder."):]] = v
        elif k.startswith("audio_projection."):
            norm["proj." + k[len("audio_projection."):]] = v
        else:
            norm[k] = v
    sd = norm

    params: dict = {}
    stats: dict = {}

    params["batch_norm"] = {"scale": np.asarray(sd["batch_norm.weight"]),
                            "bias": np.asarray(sd["batch_norm.bias"])}
    stats["batch_norm"] = {"mean": np.asarray(sd["batch_norm.running_mean"]),
                           "var": np.asarray(sd["batch_norm.running_var"])}

    params["patch_embed_proj"] = {"kernel": t_conv(sd["patch_embed.proj.weight"]),
                                  "bias": np.asarray(sd["patch_embed.proj.bias"])}
    params["patch_embed_norm"] = _ln(sd, "patch_embed.norm")

    for i, depth in enumerate(depths):
        for j in range(depth):
            src = f"layers.{i}.blocks.{j}"
            attn = {
                "query": _dense(sd, f"{src}.attention.self.query"),
                "key": _dense(sd, f"{src}.attention.self.key"),
                "value": _dense(sd, f"{src}.attention.self.value"),
                "out": _dense(sd, f"{src}.attention.output.dense"),
                "relative_position_bias_table": np.asarray(
                    sd[f"{src}.attention.self.relative_position_bias_table"]),
            }
            params[f"layers_{i}_blocks_{j}"] = {
                "layernorm_before": _ln(sd, f"{src}.layernorm_before"),
                "attention": attn,
                "layernorm_after": _ln(sd, f"{src}.layernorm_after"),
                "intermediate": _dense(sd, f"{src}.intermediate.dense"),
                "output": _dense(sd, f"{src}.output.dense"),
            }
        if i < len(depths) - 1:
            params[f"layers_{i}_downsample"] = {
                "norm": _ln(sd, f"layers.{i}.downsample.norm"),
                "reduction": {"kernel": t_linear(sd[f"layers.{i}.downsample.reduction.weight"])},
            }

    params["norm"] = _ln(sd, "norm")
    params["linear1"] = _dense(sd, "proj.linear1")
    params["linear2"] = _dense(sd, "proj.linear2")
    return {"params": params, "batch_stats": stats}


def main(argv=None):
    from spectrogramgenai_tpu_torch.core import flax_msgpack

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--state_dict", required=True, help="HF CLAP .bin/.pt state_dict")
    p.add_argument("--out", required=True, help="output .msgpack path")
    p.add_argument("--depths", default="2,2,6,2")
    a = p.parse_args(argv)

    depths = tuple(int(d) for d in a.depths.split(","))
    variables = convert_clap_audio(load_state_dict(a.state_dict), depths=depths)
    flax_msgpack.write(a.out, variables)
    print(f"converted CLAP audio tower: {n_params(variables) / 1e6:.1f}M params → {a.out}")


if __name__ == "__main__":
    main()
