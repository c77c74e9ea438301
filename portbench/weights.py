"""Seeded weights, made on the device in the served type's master form
(float32) in a few large draws: one normal draw for every "normal" leaf and
one uniform draw for every "uniform" leaf, cut and scaled per leaf."""

from __future__ import annotations

import math

import torch

from portbench.traffic.generator import subseed


def make(leaves, seed: int, tag: str, device) -> dict[str, torch.Tensor]:
    """``leaves``: (name, shape, init) from :mod:`portbench.reference.nets`."""
    g = torch.Generator(device=device).manual_seed(subseed(seed, "weights", tag))
    sizes = {name: math.prod(shape) for name, shape, _ in leaves}
    normal = torch.randn(sum(sizes[n] for n, _, i in leaves if i[0] == "normal"), generator=g, device=device)
    uniform = torch.rand(sum(sizes[n] for n, _, i in leaves if i[0] == "uniform"), generator=g, device=device)
    out, pos = {}, {"normal": 0, "uniform": 0}
    for name, shape, init in leaves:
        kind = init[0]
        if kind == "normal":
            t = normal[pos[kind]:pos[kind] + sizes[name]] * init[1]
        elif kind == "uniform":
            t = uniform[pos[kind]:pos[kind] + sizes[name]] * (init[2] - init[1]) + init[1]
        elif kind == "zeros":
            t = torch.zeros(sizes[name], device=device)
        elif kind == "ones":
            t = torch.ones(sizes[name], device=device)
        elif kind == "same":
            t = out[init[1]].flatten().clone()
        else:
            raise ValueError(f"unknown init {init}")
        pos[kind] = pos.get(kind, 0) + sizes[name]
        out[name] = t.reshape(shape).contiguous()
    return out
