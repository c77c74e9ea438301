"""What the entries share: the port's task configurations built from a
configuration file, the seeded weights of both networks, and the plain
reference's run context (float32 with TF32 off)."""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from portbench import weights
from portbench.reference import nets


def task_config(cls, config: dict):
    """A port config dataclass (``DDPMConfig``, ``VQVAEConfig``) from the file's
    keys that name its fields."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in config.items() if k in names})


def vq_weights(config: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The latent DDPM's frozen VQ-VAE: the codebook drawn over the range the
    configuration's ``assumed`` states, so that the decode follows the latents."""
    leaves = nets.vqvae_leaves(config["vq_hidden_dim"], config["latent_dim"], config["vq_n_embeddings"],
                               code_range=config["assumed"]["vq_code_range"])
    return weights.make(leaves, seed, "vqvae", device)


def unet_weights(config: dict, seed: int, device) -> dict[str, torch.Tensor]:
    return weights.make(nets.unet_leaves(config), seed, "unet", device)


@contextlib.contextmanager
def reference_mode():
    """Full float32 for the plain reference: no TF32 in matrix products or convolutions."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Events:
    """CUDA events around the calls into one layer; ms per call once synchronised."""

    def __init__(self, device: torch.device, on: bool = True):
        self.on = on and device.type == "cuda"
        self.pairs: list[tuple] = []

    @contextlib.contextmanager
    def timed(self):
        if not self.on:
            yield
            return
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        yield
        b.record()
        self.pairs.append((a, b))

    def ms(self) -> list[float]:
        return [a.elapsed_time(b) for a, b in self.pairs]


def ranges(tracing: bool):
    """``record_function`` when tracing, else a context that does nothing."""
    from torch.profiler import record_function

    return record_function if tracing else (lambda name: contextlib.nullcontext())


def traced_tail(unit, light: int, full: int):
    """After the window: ``light`` more units (chains, steps) under a trace of
    the device alone, then ``full`` under a trace of host and device; returns
    both traces."""
    from portbench.trace import Profiler, warm_profiler

    warm_profiler()
    traces = []
    for host, n in ((False, light), (True, full)):
        prof = Profiler(host)
        prof.start()
        for _ in range(n):
            unit()
        prof.stop()
        traces.append(prof)
    return [p.read() for p in traces]
