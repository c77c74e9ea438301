"""Plain reference of the two training steps: the latent DDPM's (ε-MSE,
AdamW with the one-cycle cosine schedule, EMA of the weights) and the
VQ-VAE's (reconstruction + commitment + codebook loss, the EMA codebook,
Adam), written from the papers' and optax's update rules. It follows the
first steps of a run from the weights and batches that the benchmark made,
and can plant the faults a check must catch."""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import nets, sampler

B1, B2 = 0.9, 0.999


def onecycle(step: int, total: int, peak: float, pct_start=0.3, div=25.0, final_div=1e4) -> float:
    """optax.cosine_onecycle_schedule at ``step``."""
    bounds = [0, int(pct_start * total), int(total)]
    values = [peak / div, peak, peak / (div * final_div)]
    for i in range(2):
        if bounds[i] <= step < bounds[i + 1]:
            pct = (step - bounds[i]) / (bounds[i + 1] - bounds[i])
            return values[i + 1] + (values[i] - values[i + 1]) / 2.0 * (math.cos(math.pi * pct) + 1.0)
    return values[-1]


class Adam:
    """Adam / AdamW (decoupled decay scaled by the lr), eps outside the root."""

    def __init__(self, params: dict[str, torch.Tensor], eps: float, weight_decay: float = 0.0):
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.eps, self.wd, self.count = eps, weight_decay, 0

    @torch.no_grad()
    def step(self, params, grads, lr, scale: dict[str, float] | None = None):
        self.count += 1
        c1, c2 = 1.0 - B1 ** self.count, 1.0 - B2 ** self.count
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(B1).add_(g, alpha=1.0 - B1)
            self.v[k].mul_(B2).addcmul_(g, g, value=1.0 - B2)
            update = lr * self.wd * p + (lr / c1) * self.m[k] / (self.v[k].sqrt() / math.sqrt(c2) + self.eps)
            p.sub_(update * (scale or {}).get(k, 1.0))


def _leaves(P: dict[str, torch.Tensor], names) -> dict[str, torch.Tensor]:
    return {k: P[k].detach().clone().requires_grad_(True) for k in names}


def ldm_steps(cfg: dict, work: dict, P0: dict, V: dict, batches: list[dict], prec="fp32",
              fault: str | None = None) -> dict:
    """The first ``len(batches)`` steps of the latent DDPM from weights P0.
    Each batch: images (n, H, W, 1) in [0, 1], labels, t, noise, keep.
    Returns the losses, the first step's gradients, the weights and the EMA
    after the last step."""
    P = _leaves(P0, P0)
    opt = Adam(P, cfg["adam_eps"], weight_decay=0.01)
    ema = {k: v.detach().clone() for k, v in P.items()}
    start = work["start_step"]
    losses, first = [], None
    for i, b in enumerate(batches):
        with torch.no_grad():
            x0 = nets.vq_encode(V, nets.renorm(b["images"].float()))
        rows = slice(None) if fault != "half" else slice(0, x0.shape[0] // 2)
        loss = sampler.diffusion_loss(P, cfg, x0[rows], b["labels"][rows], b["t"][rows], b["noise"][rows],
                                      b["keep"], prec)
        grads = dict(zip(P, torch.autograd.grad(loss, list(P.values()))))
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        if fault != "unchanged":
            lr = onecycle(start + i, work["total_steps"], cfg["lr"])
            opt.step(P, grads, lr, _doubled(P, fault))
        step = start + i
        with torch.no_grad():
            for k in ema:
                if step < cfg["ema_start"]:
                    ema[k].copy_(P[k])
                else:
                    ema[k].lerp_(P[k], 1.0 - cfg["ema_beta"])
    return {"losses": losses, "grads": first, "params": {k: p.detach() for k, p in P.items()}, "ema": ema}


def vqvae_steps(cfg: dict, P0: dict, batches: list[dict], prec="fp32", fault: str | None = None) -> dict:
    """The first steps of the VQ-VAE from weights and codebook P0; batches:
    images in [0, 1]. Returns the losses, the first step's gradients, the
    weights after the last step, and the codebook (embedding, EMA count, EMA
    weight) after the first step and after the last. Besides the faults of
    every trainer it plants two in the EMA: "ema_skip" (the codebook left as
    it was) and "ema_decay" (the decay weighting the new statistics and its
    complement the old)."""
    names = [k for k in P0 if not k.startswith("codebook.")]
    P = _leaves(P0, names)
    emb, ema_count, ema_weight = (P0[f"codebook.{k}"].clone().float() for k in ("embedding", "ema_count",
                                                                                  "ema_weight"))
    opt = Adam(P, 1e-8)
    decay, eps, beta = cfg["ema_decay"], cfg["ema_eps"], cfg["commitment_cost"]
    keep_old = 1.0 - decay if fault == "ema_decay" else decay
    losses, first, codebooks = [], None, []
    for b in batches:
        x = nets.renorm(b["images"].float())
        if fault == "half":
            x = x[: x.shape[0] // 2]
        z = nets.vq_encode(P, x, prec)
        d = z.shape[-1]
        zf = z.detach().reshape(-1, d)
        idx = nets.nearest_code(zf, emb)
        q = emb[idx].reshape(z.shape)
        if fault != "ema_skip":
            with torch.no_grad():
                m = emb.shape[0]
                counts = torch.bincount(idx, minlength=m).float()
                dw = torch.zeros_like(ema_weight).index_add_(0, idx, zf)
                ema_count = keep_old * ema_count + (1.0 - keep_old) * counts
                n = ema_count.sum()
                ema_count = (ema_count + eps) / (n + m * eps) * n
                ema_weight = keep_old * ema_weight + (1.0 - keep_old) * dw
                emb = ema_weight / ema_count[:, None]
        codebooks.append({"codebook.embedding": emb, "codebook.ema_count": ema_count,
                          "codebook.ema_weight": ema_weight})
        codebook_loss = (z.detach() - q).square().mean()
        commitment = beta * (z - q).square().mean()
        x_hat = nets.vq_decode(P, z + (q - z).detach(), prec)
        loss = (x_hat - x).square().mean() + commitment + codebook_loss
        grads = dict(zip(P, torch.autograd.grad(loss, list(P.values()))))
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        if fault != "unchanged":
            opt.step(P, grads, cfg["lr"], _doubled(P, fault))
    return {"losses": losses, "grads": first, "params": {k: p.detach() for k, p in P.items()},
            "codebook1": codebooks[0], "codebook": codebooks[-1]}


def _doubled(P, fault):
    """The "double" fault: the update of the largest leaf applied twice."""
    if fault != "double":
        return None
    return {max(P, key=lambda k: P[k].numel()): 2.0}


def leaf_gaps(prog: dict[str, torch.Tensor], ref: dict[str, torch.Tensor],
              leaves: list[str] | None = None) -> dict[str, float]:
    """Each leaf's |‖prog‖ − ‖ref‖| over the larger of ‖ref‖ of that leaf and
    the median leaf's ‖ref‖."""
    leaves = list(ref) if leaves is None else leaves
    pn = {k: float(prog[k].double().norm()) for k in leaves}
    rn = {k: float(ref[k].double().norm()) for k in leaves}
    med = float(np.median(list(rn.values())))
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in leaves}


def leaf_diffs(prog: dict[str, torch.Tensor], ref: dict[str, torch.Tensor]) -> dict[str, float]:
    """Each leaf's ‖prog − ref‖ over the larger of ‖ref‖ of that leaf and the
    median leaf's ‖ref‖: how far the elements, not the norms, part."""
    rn = {k: float(ref[k].double().norm()) for k in ref}
    med = float(np.median(list(rn.values())))
    return {k: float((prog[k].double() - ref[k].double()).norm()) / max(rn[k], med, 1e-30) for k in ref}


def code_shift(prog: dict[str, torch.Tensor], ref: dict[str, torch.Tensor]) -> float:
    """The share of the EMA's code counts that sit on other codes in the
    program than in the reference: half of Σ|count − count_ref| over Σ count_ref."""
    p, r = prog["codebook.ema_count"].double(), ref["codebook.ema_count"].double()
    return float(0.5 * (p - r).abs().sum() / r.sum().clamp_min(1e-30))


def moved_leaves(ref_grads: dict[str, torch.Tensor]) -> list[str]:
    """Leaves whose reference gradient is at least a thousandth of the median
    leaf's: the others move under Adam by round-off alone."""
    norms = {k: float(g.double().norm()) for k, g in ref_grads.items()}
    med = float(np.median(list(norms.values())))
    return [k for k, n in norms.items() if n >= 1e-3 * med]
