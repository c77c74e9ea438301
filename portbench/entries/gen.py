"""Offline generation: a closed loop of the sampler chain that
``cli/generate.py`` runs (``DiffusionTask.sample``: ``sample_latents`` then
``decode``), ``rounds`` passes over the classes a chain, the uint8 images
copied to the host. No PNG and no disk in the window.

``images_per_s`` is the images of all whole chains over the host time from
the window's start to the end of the last chain's copy to the host."""

from __future__ import annotations

import time

import torch
from spectrogramgenai_tpu_torch.core.config import DDPMConfig
from spectrogramgenai_tpu_torch.ops import _build
from spectrogramgenai_tpu_torch.train.diffusion_task import DiffusionTask

from portbench import harness
from portbench.entries import common
from portbench.flops import unet as unet_flops
from portbench.flops import vqvae as vq_flops
from portbench.reference import compare, sampler
from portbench.traffic import generator

TRACED_CHAINS = 3  # chains traced after a --trace 1 window, device alone (and one more with the host)


class Cell:
    def __init__(self, config: dict, traffic: dict, workload: dict, seed: int, device: torch.device,
                 clock: harness.SetupClock):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        with clock.part("extensions"):
            if device.type == "cuda":
                _build.build(["attention_fwd"])
        with clock.part("weights"):
            self.P = common.unet_weights(config, seed, device)
            self.V = common.vq_weights(config, seed, device)
        with clock.part("program"):
            self.task = DiffusionTask(common.task_config(DDPMConfig, config), device, vq_params=self.V)
            self.task.load_params(self.P)
        self.size = self.task.sample_size
        self.labels = lambda c: generator.chain_labels(self.traffic, config["num_classes"], seed, c)
        # the chains whose output is checked: the first, and one drawn from the seed
        self.checked = sorted({0, int(generator.rng(seed, "checked").integers(1, self.traffic["check_within"]))})
        with clock.part("warmup"):
            off = common.Events(device, on=False)
            self._chain(-1, common.ranges(False), off, off)
            common.sync(device)

    def _chain(self, c: int, rf, ev_chain, ev_decode):
        g = torch.Generator(device=self.device).manual_seed(generator.chain_seed(self.seed, c))
        labels = torch.as_tensor(self.labels(c), device=self.device)
        with rf("portbench.chain"), ev_chain.timed():
            x = self.task.sample_latents(labels, generator=g, sampler=self.traffic["sampler"],
                                         num_steps=self.traffic["num_steps"])
        with rf("portbench.decode"), ev_decode.timed():
            img = self.task.decode(x)
        return x, img

    def window(self, seconds: float, tracing: bool) -> dict:
        ev_chain, ev_decode = common.Events(self.device), common.Events(self.device)
        off = common.ranges(False)
        self.kept, last = {}, None
        t0 = time.perf_counter()
        end, c = t0 + seconds, 0
        while True:
            x, img = self._chain(c, off, ev_chain, ev_decode)
            host = img.cpu()
            t_last = time.perf_counter()
            if c in self.checked:
                self.kept[c] = (x, host)
            last = (c, x, host)
            c += 1
            if t_last >= end:
                break
        for k in self.checked:  # a short window: the last chain stands in for one it did not reach
            if k not in self.kept:
                self.kept[last[0]] = last[1:]
        per_chain = len(self.labels(0))
        cfg = self.config
        flops = per_chain * (2 * self.traffic["num_steps"] * unet_flops.forward(cfg, self.size)
                             + vq_flops.decode(cfg["vq_hidden_dim"], cfg["latent_dim"], cfg["img_size"])
                             + vq_flops.quantise(cfg["latent_dim"], cfg["vq_n_embeddings"], cfg["img_size"]))
        record = {"chain_ms": ev_chain.ms(), "decode_ms": ev_decode.ms(), "window_flops": c * flops,
                  "window_s": t_last - t0, "peaks": harness.peaks()}
        if tracing:
            tail = iter(range(c, 1 << 30))
            none = common.Events(self.device, on=False)
            unit = lambda: self._chain(next(tail), common.ranges(True), none, none)[1].cpu()  # noqa: E731
            record["trace"], record["full"] = common.traced_tail(unit, TRACED_CHAINS, 1)
        return {"end_to_end": {"images_per_s": c * per_chain / (t_last - t0)}, "attempted": c * per_chain,
                "failed": 0, "failed_checked": 0, "record": record}

    def free(self) -> None:
        del self.task

    def check(self, stand_in: str | None = None) -> dict[str, float]:
        """Each kept chain's latents against the plain reference's chain from
        the same x_T and labels, and its images against the reference's
        decode of those latents (the clamp before the decode hides most of
        the chain's rounding from the images, so the decode is judged on its
        own input); ``stand_in`` ("fp8", …) puts the reference at that
        precision in the program's place."""
        lat, img = [], []
        with common.reference_mode():
            for c, (x, host) in sorted(self.kept.items()):
                g = torch.Generator(device=self.device).manual_seed(generator.chain_seed(self.seed, c))
                labels = torch.as_tensor(self.labels(c), device=self.device)
                x_T = torch.randn((len(labels), self.size, self.size, self.config["latent_dim"]), generator=g,
                                  device=self.device)
                ref = sampler.dpmpp_chain(self.P, self.config, x_T, labels, self.traffic["num_steps"])
                if stand_in is not None:
                    x = sampler.dpmpp_chain(self.P, self.config, x_T, labels, self.traffic["num_steps"], stand_in)
                    host = sampler.decode_uint8(self.V, x, stand_in)
                lat.append(compare.latent_gap(x, ref))
                img.append(compare.image_gap(host, sampler.decode_uint8(self.V, x)))
        return {"latent_gap": max(lat), "decode_gap": max(img)}
