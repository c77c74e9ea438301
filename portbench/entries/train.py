"""Training: the port's train step (``DiffusionTask.train_step`` from the
latent cache, or ``VQVAETask.train_step``) driven from a seeded corpus held
on the device, batches in seeded epoch permutations.

Set-up builds one train state and drives it through its first steps with
the window's own call and feed; the window then goes on with that same
state. ``train_samples_per_s`` is the samples of all whole steps in the
window over the host time they took, ending in a synchronise. The check
follows those first steps with the plain reference: each step's loss, the
first gradient as the optimizer got it (Adam's first moment after one step
over 1 − β1), each leaf's change after the last of them and, for the
VQ-VAE, its EMA codebook after the first step and after the last."""

from __future__ import annotations

import time

import numpy as np
import torch
from spectrogramgenai_tpu_torch.core.config import DDPMConfig, VQVAEConfig
from spectrogramgenai_tpu_torch.ops import _build
from spectrogramgenai_tpu_torch.train.diffusion_task import DiffusionTask
from spectrogramgenai_tpu_torch.train.vqvae_task import VQVAETask

from portbench import harness, weights
from portbench.entries import common
from portbench.flops import unet as unet_flops
from portbench.flops import vqvae as vq_flops
from portbench.reference import nets
from portbench.reference import train as ref_train
from portbench.traffic import generator

B1 = 0.9
VQ_OUTPUT_LEAVES = ("decoder.ConvTranspose_0.weight", "decoder.ConvTranspose_1.weight")
TRACED_STEPS = 20  # steps traced after a --trace 1 window, device alone (and three more with the host)


class Cell:
    def __init__(self, config: dict, traffic: dict, workload: dict, seed: int, device: torch.device,
                 clock: harness.SetupClock):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.ldm = traffic["model"] == "ldm"
        self.batch = traffic["batch"]
        n = traffic["corpus"]
        with clock.part("extensions"):
            if device.type == "cuda" and self.ldm:
                _build.build(["attention_fwd", "attention_bwd"])
        with clock.part("weights"):
            if self.ldm:
                self.P0 = common.unet_weights(config, seed, device)
                self.V = common.vq_weights(config, seed, device)
            else:
                leaves = nets.vqvae_leaves(config["hidden_dim"], config["latent_dim"], config["n_embeddings"])
                self.P0 = weights.make(leaves, seed, "vqvae", device)
        with clock.part("corpus"):
            self.images, self.labels = generator.corpus(n, config["img_size"], config.get("num_classes", 27),
                                                        seed, device)
            self.order = torch.as_tensor(generator.epoch_order(n, self.batch, seed, traffic["epochs_drawn"]),
                                         device=device)
        with clock.part("program"):
            self._program(config, traffic)
        if self.ldm:
            with clock.part("cache_fill"):
                enc = self.task.make_encoder()
                self.cache = torch.cat([enc(self.images[i:i + 64].float() / 255.0) for i in range(0, n, 64)])
                common.sync(device)
        with clock.part("first_steps"):
            self.first = []
            for i in range(traffic["checked_steps"]):
                self.first.append(self._step(i))
                self._snapshot(i)
            self.step_no = traffic["checked_steps"]
        with clock.part("warmup"):
            for _ in range(traffic["warmup_steps"]):
                self._step(self.step_no)
                self.step_no += 1
            common.sync(device)

    def _program(self, config: dict, traffic: dict) -> None:
        if self.ldm:
            self.task = DiffusionTask(common.task_config(DDPMConfig, config), self.device, vq_params=self.V,
                                      total_steps=traffic["total_steps"])
            self.state = self.task.init_state(params={k: v.clone() for k, v in self.P0.items()})
            self.state.step = traffic["start_step"]
            self.draws = generator.TrainDraws(self.seed, self.device, config["noise_steps"], config["label_drop"])
        else:
            self.task = VQVAETask(common.task_config(VQVAEConfig, config), self.device)
            self.state = self.task.init_state(variables={k: v.clone() for k, v in self.P0.items()})

    def _step(self, i: int) -> dict:
        """Optimizer step ``i`` through the window's own call and feed; returns
        what the check needs of the step's inputs and outputs."""
        pos = (i * self.batch) % self.order.numel()
        idx = self.order[pos:pos + self.batch]
        if self.ldm:
            x, y = self.cache[idx], self.labels[idx]
            d = self.draws(tuple(x.shape))
            self.state, m = self.task.train_step(self.state, x, y, encoded=True, t=d["t"], noise=d["noise"],
                                                 keep=d["keep"])
            return {"idx": idx, "loss": m["train_mse"], **d}
        self.state, m = self.task.train_step(self.state, self.images[idx].float() / 255.0)
        return {"idx": idx, "loss": m["loss"]}

    def _snapshot(self, i: int) -> None:
        """After the first checked step: the gradient as the optimizer got it
        (and the VQ-VAE's codebook); after the last: the weights (and the
        DDPM's EMA of them, or the VQ-VAE's codebook)."""
        if i == 0:
            opt = self.state.opt.state  # empty where the step made no update
            self.grads = {k: opt[p]["exp_avg"] / (1.0 - B1) if p in opt else torch.zeros_like(p)
                          for k, p in self.state.params.items()}
            if not self.ldm:
                self.codebook1 = {k: v.clone() for k, v in self.state.stats.items()}
        if i == self.traffic["checked_steps"] - 1:
            self.after = {k: p.clone() for k, p in self.state.params.items()}
            if self.ldm:
                self.after.update({f"ema.{k}": p.clone() for k, p in self.state.ema_params.items()})
            else:
                self.codebook = {k: v.clone() for k, v in self.state.stats.items()}

    def window(self, seconds: float, tracing: bool) -> dict:
        t0 = time.perf_counter()
        end, k = t0 + seconds, 0
        while True:
            self._step(self.step_no)
            self.step_no += 1
            k += 1
            if time.perf_counter() >= end:
                break
        common.sync(self.device)
        elapsed = time.perf_counter() - t0
        cfg = self.config
        if self.ldm:
            size = cfg["img_size"] // cfg["latent_downscale"]
            flops = 3 * self.batch * unet_flops.forward(cfg, size)
        else:
            h, z, s = cfg["hidden_dim"], cfg["latent_dim"], cfg["img_size"]
            flops = self.batch * (3 * (vq_flops.encode(h, z, s) + vq_flops.decode(h, z, s))
                                  + vq_flops.quantise(z, cfg["n_embeddings"], s))
        record = {"window_flops": k * flops, "window_s": elapsed, "traced_steps": TRACED_STEPS,
                  "peaks": harness.peaks()}
        if tracing:
            rf = common.ranges(True)

            def unit():
                with rf("portbench.step"):
                    self._step(self.step_no)
                self.step_no += 1

            record["trace"], record["full"] = common.traced_tail(unit, TRACED_STEPS, 3)
        return {"end_to_end": {"train_samples_per_s": k * self.batch / elapsed}, "attempted": k, "failed": 0,
                "failed_checked": 0, "record": record}

    def free(self) -> None:
        self.losses = [float(s["loss"]) for s in self.first]
        del self.task, self.state
        if self.ldm:
            del self.cache

    def check(self, stand_in: str | None = None, fault: str | None = None) -> dict[str, float]:
        """The program's first steps against the plain reference's. With
        ``stand_in`` (a precision) or ``fault`` ("half", "double",
        "unchanged"; the VQ-VAE's "ema_skip", "ema_decay") the reference so
        computed takes the program's place."""
        batches = []
        for s in self.first:
            b = {"images": self.images[s["idx"]].float() / 255.0, "labels": self.labels[s["idx"]]}
            if self.ldm:
                b.update(t=s["t"], noise=s["noise"], keep=s["keep"])
            batches.append(b)
        with common.reference_mode():
            run = (lambda **kw: ref_train.ldm_steps(self.config, self.traffic, self.P0, self.V, batches, **kw)) \
                if self.ldm else (lambda **kw: ref_train.vqvae_steps(self.config, self.P0, batches, **kw))
            ref = run()
            if stand_in is None and fault is None:
                losses, grads, after = self.losses, self.grads, self.after
                codebooks = None if self.ldm else (self.codebook1, self.codebook)
            else:
                alt = run(prec=stand_in or "fp32", fault=fault)
                losses, grads = alt["losses"], alt["grads"]
                after = dict(alt["params"], **{f"ema.{k}": v for k, v in alt.get("ema", {}).items()})
                codebooks = None if self.ldm else (alt["codebook1"], alt["codebook"])
        ref_after = dict(ref["params"], **{f"ema.{k}": v for k, v in ref.get("ema", {}).items()})
        moved = ref_train.moved_leaves(ref["grads"])
        leaves = moved + [f"ema.{k}" for k in moved if f"ema.{k}" in ref_after]
        change = {k: after[k] - self.P0[k.removeprefix("ema.")] for k in leaves}
        ref_change = {k: ref_after[k] - self.P0[k.removeprefix("ema.")] for k in leaves}
        loss = [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
        grad = ref_train.leaf_gaps(grads, ref["grads"])
        moved = ref_train.leaf_gaps(change, ref_change)
        diff = ref_train.leaf_diffs(grads, ref["grads"])
        self.diag = {"loss_steps": loss, "grad_worst_leaf": max(grad, key=grad.get),
                     "change_worst_leaf": max(moved, key=moved.get), "grad_diff_worst_leaf": max(diff, key=diff.get)}
        out = {"loss_gap": max(loss), "loss1_gap": loss[0], "grad_gap": max(grad.values()),
               "change_gap": max(moved.values()), "grad_diff_median": float(np.median(list(diff.values())))}
        if codebooks is not None:
            # the first gradient of the decoder's two output layers: on some seeds every other leaf's
            # swings far more than rounding explains, with which latents change code; these do not
            rel = {k: float((grads[k].double() - g.double()).norm() / g.double().norm().clamp_min(1e-30))
                   for k, g in ref["grads"].items()}
            self.diag["grad_rel"] = rel
            out["tconv_grad_gap"] = max(rel[k] for k in VQ_OUTPUT_LEAVES)
            for tag, prog, want in zip(("1", ""), codebooks, (ref["codebook1"], ref["codebook"])):
                gaps = ref_train.leaf_gaps(prog, want)
                out[f"codebook{tag}_gap"] = max(gaps.values())
                out[f"code_shift{tag}"] = ref_train.code_shift(prog, want)
                self.diag[f"codebook{tag}_gaps"] = gaps
        return out
