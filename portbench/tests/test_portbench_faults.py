"""Each cell's check, driven as a run drives it (at a CPU size, past the
look for a chip), passes the port in float32 and comes out false for the
control and for each fault the cell can have, planted underneath the timed
path: a step that returns its state unchanged; half of the batch left out;
an answer altered where it is produced."""

import numpy as np
import pytest
import torch
from spectrogramgenai_tpu_torch.diffusion import ddpm
from spectrogramgenai_tpu_torch.models.vqvae import VQEmbeddingEMA
from spectrogramgenai_tpu_torch.serving import server
from spectrogramgenai_tpu_torch.train import diffusion_task, vqvae_task
from spectrogramgenai_tpu_torch.train.diffusion_task import DiffusionTask

from portbench import harness
from portbench.tests import tiny

GEN, SERVE = "gen_ldm27_dpmpp20_b108", "serve_ldm27_b54_open"
LDM, VQ = "train_ldm27_b192", "train_vqvae_b64"


def frozen_step(monkeypatch):
    """The sampler's second step returns its state unchanged."""
    real = ddpm.dpmpp_coefficients

    def coefficients(schedule, num_steps):
        c = real(schedule, num_steps)
        c["sig_ratio"][1], c["coef"][1] = 1.0, 0.0
        return c

    monkeypatch.setattr(ddpm, "dpmpp_coefficients", coefficients)


def half_chain(monkeypatch):
    """The chain runs the first half of its labels; the second half copies it."""
    real = DiffusionTask.sample_latents

    def sample_latents(self, labels, **kw):
        h = (len(labels) + 1) // 2
        x = real(self, labels[:h], **kw)
        return torch.cat([x, x[: len(labels) - h]])

    monkeypatch.setattr(DiffusionTask, "sample_latents", sample_latents)


def altered_image(monkeypatch):
    """The first image of each decode comes out inverted."""
    real = DiffusionTask.decode

    def decode(self, x):
        img = real(self, x).clone()
        img[0] = 255 - img[0]
        return img

    monkeypatch.setattr(DiffusionTask, "decode", decode)


def altered_png(monkeypatch):
    """Each served PNG is of an image one gray level brighter."""
    real = server.generated_png_bytes
    monkeypatch.setattr(server, "generated_png_bytes", lambda imgs: real(np.clip(imgs.astype(int) + 1, 0, 255)
                                                                          .astype(np.uint8)))


def unchanged_state(monkeypatch, module):
    monkeypatch.setattr(module, "optimizer_update", lambda *a, **k: None)


def doubled_leaf(monkeypatch, module):
    """The update of the largest leaf is applied twice."""
    real = module.optimizer_update

    def update(opt, masters, grads, working, *a, **k):
        big = max(range(len(masters)), key=lambda i: masters[i].numel())
        before = masters[big].detach().clone()
        real(opt, masters, grads, working, *a, **k)
        with torch.no_grad():
            masters[big].add_(masters[big] - before)
            working[big].copy_(masters[big])

    monkeypatch.setattr(module, "optimizer_update", update)


def half_batch(monkeypatch, task_cls):
    """The step runs on the first half of its batch alone."""
    real = task_cls.train_step

    def train_step(self, state, batch, *args, **kw):
        h = batch.shape[0] // 2
        args = [a[:h] for a in args]
        kw = {k: (v[:h] if k in ("t", "noise") else v) for k, v in kw.items()}
        return real(self, state, batch[:h], *args, **kw)

    monkeypatch.setattr(task_cls, "train_step", train_step)


def skipped_ema(monkeypatch):
    """The codebook's EMA update is computed and thrown away."""
    real = VQEmbeddingEMA.forward

    def forward(self, x, train=False):
        saved = [b.clone() for b in (self.embedding, self.ema_count, self.ema_weight)]
        out = real(self, x, train=train)
        with torch.no_grad():
            for b, v in zip((self.embedding, self.ema_count, self.ema_weight), saved):
                b.copy_(v)
        return out

    monkeypatch.setattr(VQEmbeddingEMA, "forward", forward)


def misdecayed_ema(monkeypatch):
    """The codebook's EMA weights the new statistics by the decay and the old by its complement."""
    real = VQEmbeddingEMA.forward

    def forward(self, x, train=False):
        decay, self.decay = self.decay, 1.0 - self.decay
        try:
            return real(self, x, train=train)
        finally:
            self.decay = decay

    monkeypatch.setattr(VQEmbeddingEMA, "forward", forward)


FAULTS = {
    GEN: [frozen_step, half_chain, altered_image],
    SERVE: [frozen_step, half_chain, altered_png],
    LDM: [lambda m: unchanged_state(m, diffusion_task), lambda m: half_batch(m, DiffusionTask),
          lambda m: doubled_leaf(m, diffusion_task)],
    VQ: [lambda m: unchanged_state(m, vqvae_task), lambda m: half_batch(m, vqvae_task.VQVAETask),
         lambda m: doubled_leaf(m, vqvae_task), skipped_ema, misdecayed_ema],
}


@pytest.mark.parametrize("name", [GEN, SERVE, LDM, VQ])
def test_sound_run_is_correct(name):
    result = tiny.run_tiny(name)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("name,fault", [(n, i) for n, fs in FAULTS.items() for i in range(len(fs))])
def test_fault_is_caught(name, fault, monkeypatch):
    FAULTS[name][fault](monkeypatch)
    result = tiny.run_tiny(name)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name", [GEN, SERVE, LDM, VQ])
def test_control_is_caught(name):
    """The reference at fp8, put in the program's place, fails the cell's limits."""
    import importlib
    import time

    work, config, traffic = tiny.cell(name)
    entry = importlib.import_module(f"portbench.entries.{work['entry']}")
    cell = entry.Cell(config, traffic, work, 2**31 + 23, torch.device("cpu"), harness.SetupClock(time.perf_counter()))
    cell.window(1.0, False)
    cell.free()
    correct, checks = harness.judge(cell.check(stand_in="fp8"), work["limits"])
    assert not correct, checks
