"""One rank of the port's multi-rank tests (``tests/test_torch_multirank.py``).

    python tests/torch_multiprocess_worker.py JOB.pt OUT_DIR

with ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``) runs ``JOB.pt``'s jobs as that rank over
gloo, on the CPU with one torch thread, and writes each job's result to
``OUT_DIR/<job name>.rank<r>.pt``. Imported, :func:`run_job` with a 1×1
``Mesh`` is the one-rank reference of the same job. Imports no JAX.

A job is a dict with ``kind`` (``ddpm``, ``classifier``, ``vqvae``,
``data``, ``sample``) and ``name``; the global batches in it are whole, each rank takes
its rows (``core.mesh.rank_rows``). Rank 0's result holds the whole
tensors; every rank's holds what differs between ranks.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from spectrogramgenai_tpu_torch.core import config as tc  # noqa: E402
from spectrogramgenai_tpu_torch.core.checkpoint import CheckpointManager  # noqa: E402
from spectrogramgenai_tpu_torch.core.mesh import Mesh, MeshSpec, create_mesh, rank_rows  # noqa: E402


def _rows(t: torch.Tensor | None, mesh: Mesh, k: int) -> torch.Tensor | None:
    """This rank's rows of a global batch tensor split into k microbatches."""
    if t is None or mesh.data == 1:
        return t
    return t[torch.as_tensor(rank_rows(t.shape[0], k, mesh.data, mesh.data_index))]


class _GradSpy:
    """Wraps a task module's ``optimizer_update`` to record each update's
    gradients after the data group's reduction, as whole tensors."""

    def __init__(self, module):
        self.module, self.orig, self.grads = module, module.optimizer_update, []
        module.optimizer_update = self

    def __call__(self, opt, masters, grads, working, plan=None, names=None):
        if plan is not None and plan.mesh.distributed:
            reduced = plan.reduce_grads(names, [g.clone() for g in grads])
            self.grads.append({n: plan.full(n, g) for n, g in zip(names, reduced)})
        else:
            self.grads.append({n: g.clone() for n, g in zip(names, grads)})
        return self.orig(opt, masters, grads, working, plan, names)

    def close(self):
        self.module.optimizer_update = self.orig


def _fractions(state, whole: dict[str, torch.Tensor]) -> dict[str, list[float]]:
    """For each leaf: this rank's share of its master, both Adam moments and
    EMA copy (elements held / elements of the ``whole`` leaf)."""
    out = {}
    for name, p in state.params.items():
        st = state.opt.state[p]
        held = [p, st["exp_avg"], st["exp_avg_sq"], state.ema_params[name]]
        out[name] = [t.numel() / whole[name].numel() for t in held]
    return out


def _full_params(state) -> dict[str, torch.Tensor]:
    return {n: state.plan.full(n, p).clone() for n, p in state.params.items()}


def ddpm_job(job: dict, mesh: Mesh) -> dict:
    """Train steps of the DDPM from ``job["params"]`` on the given global
    batches and draws: the losses, the first step's reduced gradients and
    masters, the last step's masters and EMA; with ``ckpt_dir`` a checkpoint
    before the last step, restored into a fresh task that takes the last
    step too; with ``sample`` (labels, x_T) a DDIM sample after the steps."""
    from spectrogramgenai_tpu_torch.train import diffusion_task as dt

    k = job["cfg"].get("grad_accum", 1)
    cfg = tc.DDPMConfig(**job["cfg"], run=tc.RunConfig(seed=0, param_sharding=job["mode"]))

    def new_task():
        task = dt.DiffusionTask(cfg, "cpu", total_steps=job.get("total_steps", 10), mesh=mesh)
        return task, task.init_state(0, params=job["params"])

    def step(task, state, images, labels, t, noise, keep):
        mine = [_rows(x, mesh, k) for x in (images, labels, t, noise)]
        return task.train_step(state, mine[0], mine[1], t=mine[2], noise=mine[3], keep=keep)

    task, state = new_task()
    out = {"loss": []}
    spy = _GradSpy(dt)
    for i, batch in enumerate(job["steps"]):
        if job.get("ckpt_dir") and i == len(job["steps"]) - 1:
            ckpt = CheckpointManager(job["ckpt_dir"], mesh=mesh)
            ckpt.save(state.step, state.state_dict())
            task2, state2 = new_task()
            task2.load_state(state2, ckpt.restore())
            out["restored_fractions"] = _fractions(state2, job["params"])
            state2, m2 = step(task2, state2, *batch)
            out["resumed_loss"] = float(m2["train_mse"])
            resumed = {n: (p, state2.ema_params[n]) for n, p in state2.params.items()}
        state, m = step(task, state, *batch)
        out["loss"].append(float(m["train_mse"]))
        if i == 0 and mesh.is_main:
            out["grads"], out["params_step0"] = spy.grads[0], _full_params(state)
        elif i == 0:
            _full_params(state)  # the gathers are collectives: every rank takes part
    spy.close()
    out["fractions"] = _fractions(state, job["params"])
    if job.get("ckpt_dir"):  # the resumed step equals the uninterrupted one, bit for bit, on every rank
        out["resume_bit_equal"] = all(torch.equal(p, resumed[n][0]) and torch.equal(state.ema_params[n],
                                                                                     resumed[n][1])
                                      for n, p in state.params.items())
    params = _full_params(state)
    ema = {n: state.plan.full(n, p).clone() for n, p in state.ema_params.items()}
    if mesh.is_main:
        out["params"], out["ema"] = params, ema
    if job.get("sample") is not None:
        labels, x_T = job["sample"]
        out["sample"] = task.sample(labels, x_T=x_T, sampler="ddim", num_steps=4)
    out["collectives"] = dict(mesh.calls)
    out["tp_layers"] = sorted(task.plan.model_dim)
    return out


def classifier_job(job: dict, mesh: Mesh) -> dict:
    """One train step of a BatchNorm classifier; with ``plain_all_reduce``
    the statistics' all-reduce carries no gradient (the trap)."""
    from spectrogramgenai_tpu_torch.train import classifier_task as ct

    k = job["grad_accum"]
    cfg = tc.ClassifierConfig(model_name=job["model_name"], num_classes=job["num_classes"], compute_dtype="float32",
                              grad_accum=k, data=tc.DataConfig(img_size=job["img_size"]),
                              run=tc.RunConfig(seed=0, param_sharding=job["mode"]))
    task = ct.ClassifierTask(cfg, "cpu", mesh=mesh)
    state = task.init_state(0, job["variables"])
    if job.get("plain_all_reduce"):
        def plain(t, axis):  # the sum's value, but the backward sees only this rank's term
            total = mesh.all_reduce_(t.detach().clone(), axis)
            return t + (total - t).detach()

        mesh.all_reduce_autograd = plain
    spy = _GradSpy(ct)
    state, m = task.train_step(state, _rows(job["images"], mesh, k), _rows(job["labels"], mesh, k))
    spy.close()
    return {"loss": float(m["train_loss"]), "acc": float(m["train_acc"]), "grads": spy.grads[0],
            "stats": {n: t.clone() for n, t in state.stats.items()}}


def vqvae_job(job: dict, mesh: Mesh) -> dict:
    """One VQ-VAE step: the codebook after it (every rank), the metrics and the gradients."""
    from spectrogramgenai_tpu_torch.train import vqvae_task as vt

    cfg = tc.VQVAEConfig(**job["cfg"], run=tc.RunConfig(seed=0, param_sharding=job["mode"]))
    task = vt.VQVAETask(cfg, "cpu", mesh=mesh)
    state = task.init_state(0, job["variables"])
    spy = _GradSpy(vt)
    state, m = task.train_step(state, _rows(job["images"], mesh, cfg.grad_accum))
    spy.close()
    return {"metrics": {n: float(v) for n, v in m.items()}, "grads": spy.grads[0],
            "codebook": {n: t.clone() for n, t in state.stats.items()}}


def data_job(job: dict, mesh: Mesh) -> dict:
    """The input path end to end: ``iterate_batches`` over the mesh, device
    prefetch, the DDPM step with its own draws, then ``padded_eval_batches``:
    the train losses, the eval loss and a checksum of the global eval rows."""
    from spectrogramgenai_tpu_torch.data.pipeline import (
        ImageFolderSource,
        device_prefetch,
        iterate_batches,
        padded_eval_batches,
    )
    from spectrogramgenai_tpu_torch.train.diffusion_task import DiffusionTask

    cfg = tc.DDPMConfig(**job["cfg"], run=tc.RunConfig(seed=0, param_sharding=job["mode"]))
    task = DiffusionTask(cfg, "cpu", total_steps=4, mesh=mesh)
    state = task.init_state(0)
    src = ImageFolderSource(os.path.join(job["root"], "train"), bootstrap_balance=True, seed=0,
                            img_size=cfg.data.img_size)
    losses = []
    batches = iterate_batches(src, cfg.data.batch_size, epochs=1, mesh=mesh, grad_accum=cfg.grad_accum)
    for batch in device_prefetch(batches, mesh.device):
        state, m = task.train_step(state, batch["image"], batch["label"])
        losses.append(float(m["train_mse"]))
    val = ImageFolderSource(os.path.join(job["root"], "val"), img_size=cfg.data.img_size)
    gen = torch.Generator().manual_seed(0)
    evals, checksum, count = [], 0.0, 0
    for batch, n in padded_eval_batches(val, job["eval_batch"], mesh.device, mesh):
        evals.append(float(task.eval_step(state, batch["image"], batch["label"], gen)["val_mse"]))
        rows = mesh.gather_rows(batch["image"])[:n]
        checksum += float(rows.double().sum())
        count += n
    return {"loss": losses, "val": evals, "checksum": checksum, "count": count}


def sample_job(job: dict, mesh: Mesh) -> dict:
    """``DiffusionTask.sample`` of ``job["sample"]`` (labels, x_T) with the
    weights ``job["params"]``: the labels split over the data group."""
    from spectrogramgenai_tpu_torch.train.diffusion_task import DiffusionTask

    task = DiffusionTask(tc.DDPMConfig(**job["cfg"], run=tc.RunConfig(seed=0, param_sharding=job["mode"])), "cpu",
                         mesh=mesh)
    task.load_params(job["params"])
    labels, x_T = job["sample"]
    return {"sample": task.sample(labels, x_T=x_T, sampler=job["sampler"], num_steps=job["num_steps"]),
            "collectives": dict(mesh.calls)}


JOBS = {"ddpm": ddpm_job, "classifier": classifier_job, "vqvae": vqvae_job, "data": data_job, "sample": sample_job}


def run_job(job: dict, mesh: Mesh) -> dict:
    return JOBS[job["kind"]](job, mesh)


def main(job_file: str, out_dir: str) -> None:
    from spectrogramgenai_tpu_torch.core.mesh import maybe_initialize_distributed

    torch.set_num_threads(1)
    np.seterr(all="ignore")
    maybe_initialize_distributed("cpu")
    for job in torch.load(job_file, weights_only=False):
        mesh = create_mesh(MeshSpec(*job["mesh"]), "cpu")
        out = run_job(job, mesh)
        torch.save(out, os.path.join(out_dir, f"{job['name']}.rank{mesh.rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:3])
