"""Optimizer, learning-rate schedule, gradient accumulation and the
parameter sharding rules (``spectrogramgenai_tpu/train/common.py``).

The schedule is a copy of optax's ``cosine_onecycle_schedule`` as a plain
function of the step, not torch's ``OneCycleLR`` (whose phase ends differ).
AdamW is ``torch.optim.AdamW``: b1 0.9, b2 0.999, eps outside the square
root, weight decay decoupled and scaled by the scheduled lr, which is the
update ``optax.adamw`` computes; Adam is ``torch.optim.Adam``, the update of
``optax.adam``; RMSprop is ``torch.optim.RMSprop``, ν = α·ν + (1 − α)·g²,
update g/(√ν + eps) with eps outside the square root, the update of
``optax.rmsprop(eps_in_sqrt=False)``.

Sharding (``RunConfig.param_sharding``, one of ``SHARD_MODES``) over the
(data, model) mesh of ``core/mesh.py``. :func:`param_sharding` is the JAX
rule, applied to each parameter's flax layout (``bridge.flax_axes``), and
:class:`ShardPlan` carries it out for one module:

  * data parallelism in every mode: each rank computes its rows' mean
    float32 gradients and the data group sums them in ONE flat bucket (an
    all-reduce), divided by the data size;
  * ``fsdp`` / ``tp_fsdp``: the float32 master, both Adam moments and the
    EMA copy of every leaf the rule splits over ``data`` hold only this
    rank's block of the rule's dimension; the gradient bucket of those
    leaves is reduce-scattered, the rank updates its blocks, and the working
    copy (the module's parameters, in the compute dtype) is all-gathered
    after the update. Unlike GSPMD, which also splits the working weights
    and gathers them layer by layer, the working copy stays whole on every
    rank: the custom kernels keep seeing plain local tensors;
  * ``tp`` / ``tp_fsdp`` with a model axis M > 1: a plain ``Conv2d``,
    ``Linear``, ``ConvTranspose2d`` or ``Embedding`` whose kernel the rule
    splits over ``model`` keeps its rank's slice of the output channels (and
    the masters, moments and EMA with it), computes that slice and gathers
    it, Megatron-style: identity forward / sum over the model group backward
    on its input, gather forward / own slice backward on its output. Its
    bias stays whole and is added after the gather. A layer that needs its
    whole kernel in the forward (a spectral-norm layer, a grouped
    convolution, a conv with its own padding rule) stays whole on the model
    group.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from spectrogramgenai_tpu_torch.bridge import flax_axes
from spectrogramgenai_tpu_torch.core.mesh import DATA_AXIS, MODEL_AXIS, Mesh
from spectrogramgenai_tpu_torch.utils.profiling import span


def onecycle_lr(step: int, total_steps: int, peak_value: float, pct_start: float = 0.3,
                div_factor: float = 25.0, final_div_factor: float = 1e4) -> float:
    """optax.cosine_onecycle_schedule(transition_steps=total_steps, …)(step).

    Cosine from peak/div_factor up to peak over the first
    ``int(pct_start·total_steps)`` steps, then down to
    peak/(div_factor·final_div_factor) at ``total_steps``, flat after. A
    phase of zero steps (total_steps < 4) is skipped; optax divides 0 by 0
    there and returns NaN.
    """
    bounds = np.array([0, int(pct_start * total_steps), int(total_steps)])
    values = np.cumprod([peak_value / div_factor, div_factor, 1.0 / (div_factor * final_div_factor)])
    for i in range(2):
        if bounds[i] <= step < bounds[i + 1]:
            pct = (step - bounds[i]) / (bounds[i + 1] - bounds[i])
            return float(values[i + 1] + (values[i] - values[i + 1]) / 2.0 * (math.cos(math.pi * pct) + 1))
    return float(values[-1])


def make_adam(params: list[torch.Tensor], lr: float) -> torch.optim.Adam:
    """``optax.adam(lr)``: b1 0.9, b2 0.999, eps 1e-8 outside the square root."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def make_rmsprop(params: list[torch.Tensor], lr: float, alpha: float = 0.99, eps: float = 1e-8
                 ) -> torch.optim.RMSprop:
    """``optax.rmsprop(lr, decay=alpha, eps=eps, eps_in_sqrt=False)``."""
    return torch.optim.RMSprop(params, lr=lr, alpha=alpha, eps=eps)


def make_adamw_onecycle(params: list[torch.Tensor], max_lr: float, total_steps: int, eps: float = 1e-5,
                        weight_decay: float = 0.01) -> tuple[torch.optim.AdamW, Callable[[int], float]]:
    """AdamW over ``params`` and its lr schedule; the caller sets the lr of
    each update from the step count before it (optax reads its count before
    the update, so the first update uses lr(0))."""
    total = max(total_steps, 1)

    def schedule(step: int) -> float:
        return onecycle_lr(step, total, max_lr)

    opt = torch.optim.AdamW(params, lr=schedule(0), betas=(0.9, 0.999), eps=eps, weight_decay=weight_decay)
    return opt, schedule


def microbatch_split(batch: dict[str, torch.Tensor], k: int) -> list[dict[str, torch.Tensor]]:
    """Cut every (n, …) tensor of ``batch`` into k microbatches of n/k rows."""
    out = [{} for _ in range(k)]
    for name, a in batch.items():
        if a.shape[0] % k:
            raise ValueError(f"batch {a.shape[0]} not divisible by grad_accum={k}")
        for i, part in enumerate(a.chunk(k)):
            out[i][name] = part
    return out


def microbatch_accumulate(loss_fn: Callable[[dict], tuple[torch.Tensor, dict[str, torch.Tensor]]],
                          microbatches: list[dict], params: list[torch.Tensor]
                          ) -> tuple[torch.Tensor, list[torch.Tensor], dict[str, torch.Tensor]]:
    """Run ``loss_fn`` and its backward on each microbatch in turn (only one
    microbatch's activations are live at a time) and return the mean loss,
    the mean float32 gradient of each of ``params`` and the mean of each of
    the auxiliary scalars (loss terms, accuracy …) that ``loss_fn`` returns
    beside its loss: the caller makes ONE optimizer update, one schedule
    tick, for the whole batch. State that the forward updates in place (the
    VQ-VAE's codebook, BatchNorm's running statistics) threads through the
    microbatches in order, as the JAX scan's carry does."""
    k = len(microbatches)
    total, grads, aux = None, None, {}
    for mb in microbatches:
        for p in params:
            p.grad = None
        loss, out = loss_fn(mb)
        loss.backward()
        g = [p.grad.float() for p in params]  # a fresh .grad each microbatch: no copy needed
        out = {name: v.detach() for name, v in out.items()}
        if grads is None:
            total, grads, aux = loss.detach(), g, out
        else:
            total = total + loss.detach()
            torch._foreach_add_(grads, g)
            aux = {name: aux[name] + v for name, v in out.items()}
    for p in params:
        p.grad = None
    if k > 1:
        total = total / k
        torch._foreach_div_(grads, float(k))
        aux = {name: v / k for name, v in aux.items()}
    return total, grads, aux


def optimizer_update(opt: torch.optim.Optimizer, masters: list[torch.Tensor], grads: list[torch.Tensor],
                     working: list[torch.Tensor], plan: ShardPlan | None = None,
                     names: list[str] | None = None) -> None:
    """One update of the float32 ``masters`` from the working copy's float32
    ``grads``, then the working copy (``working``, the module's parameters,
    in its compute dtype) refreshed from the masters. Under a distributed
    ``plan`` (``names``: the parameters' names, in the lists' order) the
    gradients are first reduced over the data group and the refresh gathers
    the split leaves. All of it is the span ``sgai.train.optimizer``."""
    distributed = plan is not None and plan.mesh.distributed
    with span("sgai.train.optimizer"):
        if distributed:
            grads = plan.reduce_grads(names, grads)
        for m, g in zip(masters, grads, strict=True):
            m.grad = g
        opt.step()
        for m in masters:
            m.grad = None
        with torch.no_grad():
            if distributed:
                plan.refresh(names, masters, working)
            else:
                torch._foreach_copy_(working, masters)


# ---------------------------------------------------------------------------
# Sharding rules
# ---------------------------------------------------------------------------

#: valid values of ``RunConfig.param_sharding``
SHARD_MODES = ("replicate", "tp", "fsdp", "tp_fsdp")

# FSDP splits leaves with at least this many elements; below it the
# all-gather latency outweighs the memory saved (biases, norm scales,
# tiny kernels stay whole).
FSDP_MIN_SIZE = 2**15


def param_sharding(shape: tuple[int, ...], mode: str = "tp", data: int = 1, model: int = 1,
                   min_dim: int = 256, fsdp_min_size: int = FSDP_MIN_SIZE) -> tuple[str | None, ...]:
    """The JAX rule (``param_sharding``) for a leaf of flax layout ``shape``
    on a data × model mesh: for each dim, the mesh axis that splits it, or None.

    * ``tp``: the output (last) dim of a kernel over ``model`` when it is
      ≥ ``min_dim`` and divisible by the model size;
    * ``fsdp``: the largest remaining dim divisible by the data size of a
      leaf with ≥ ``fsdp_min_size`` elements, over ``data``;
    * ``tp_fsdp``: both; ``replicate``: nothing.

    One-dimensional leaves are never split. Unlike the JAX rule, a data
    axis of size 1 still names its dimension: a split into one piece is the
    whole leaf, the same layout, and a one-rank distributed run then takes
    the reduce-scatter and all-gather path that a larger one takes.
    """
    if mode not in SHARD_MODES:
        raise ValueError(f"param sharding mode {mode!r} not in {SHARD_MODES}")
    spec: list[str | None] = [None] * len(shape)
    if len(shape) >= 2:
        if "tp" in mode and model > 1 and shape[-1] >= min_dim and shape[-1] % model == 0:
            spec[-1] = MODEL_AXIS
        if "fsdp" in mode and math.prod(shape) >= fsdp_min_size:
            for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
                if spec[i] is None and shape[i] % data == 0:
                    spec[i] = DATA_AXIS
                    break
    return tuple(spec)


def tp_param_sharding(shape: tuple[int, ...], model: int, min_dim: int = 256) -> tuple[str | None, ...]:
    """The tensor-parallel rule alone: :func:`param_sharding` in mode ``tp``."""
    return param_sharding(shape, "tp", model=model, min_dim=min_dim)


def bind_mesh(module: nn.Module, mesh: Mesh) -> None:
    """Hand ``mesh`` to the layers whose train forward needs the global
    batch: BatchNorm's statistics, the VQ codebook's EMA (each a ``mesh``
    attribute, None by default)."""
    for m in module.modules():
        if hasattr(m, "mesh"):
            m.mesh = mesh


_TP_LAYERS = (nn.Conv2d, nn.Linear, nn.ConvTranspose2d, nn.Embedding)


def _computes_slices(m: nn.Module, pname: str) -> bool:
    """Whether ``m`` can compute a slice of its output channels from a slice of its kernel."""
    return pname == "weight" and type(m) in _TP_LAYERS and getattr(m, "groups", 1) == 1


def state_shardings(module: nn.Module, mode: str = "tp", data: int = 1, model: int = 1, min_dim: int = 256
                    ) -> dict[str, dict[str, int]]:
    """For each parameter of ``module`` the rule splits: ``{axis: torch dim}``
    (the JAX rule on the flax layout, mapped through the bridge's layout).
    A model split of a layer that cannot compute slices is dropped."""
    modules = dict(module.named_modules())
    out = {}
    for name, p in module.named_parameters():
        owner, _, pname = name.rpartition(".")
        axes = flax_axes(modules[owner], pname, p.ndim)
        spec = param_sharding(tuple(p.shape[a] for a in axes), mode, data, model, min_dim)
        split = {axis: axes[i] for i, axis in enumerate(spec) if axis is not None}
        if MODEL_AXIS in split and not _computes_slices(modules[owner], pname):
            del split[MODEL_AXIS]
        if split:
            out[name] = split
    return out


def _tensor_parallel(m: nn.Module, mesh: Mesh, dim: int) -> None:
    """Keep this rank's slice of ``m``'s output channels (``dim`` of its
    kernel) and make its forward compute and gather them."""
    w = m.weight
    m.weight = nn.Parameter(w.detach().chunk(mesh.model, dim)[mesh.model_index].clone(),
                            requires_grad=w.requires_grad)
    kind = type(m)

    def forward(x):
        if x.is_floating_point():
            x = mesh.copy_to_model(x)
        if kind is nn.Linear:
            y, out_dim = F.linear(x, m.weight), -1
        elif kind is nn.Embedding:
            y, out_dim = F.embedding(x, m.weight, m.padding_idx, m.max_norm, m.norm_type,
                                     m.scale_grad_by_freq, m.sparse), -1
        elif kind is nn.Conv2d:
            y, out_dim = m._conv_forward(x, m.weight, None), 1
        else:
            y, out_dim = F.conv_transpose2d(x, m.weight, None, m.stride, m.padding, m.output_padding,
                                            m.groups, m.dilation), 1
        y = mesh.gather_from_model(y, out_dim)
        if getattr(m, "bias", None) is not None:
            y = y + (m.bias if out_dim == -1 else m.bias[:, None, None])
        return y

    m.forward = forward


class ShardPlan:
    """How one module's parameters are split over ``mesh`` under ``mode``,
    and the collectives that keep them so.

    A leaf's **working** tensor (the module's parameter) is its model slice,
    the whole leaf unless it is tensor-parallel; its **shard** (the master,
    moments and EMA) is the working tensor's data block, the whole working
    tensor unless the leaf is split over ``data``. Without a process group
    nothing is split and every method is the identity. Building a plan makes
    the module's tensor-parallel layers compute slices.
    """

    def __init__(self, module: nn.Module, mesh: Mesh, mode: str = "tp", min_dim: int = 256):
        self.mesh = mesh
        self.model_dim: dict[str, int] = {}
        self.data_dim: dict[str, int] = {}
        if not mesh.distributed:
            param_sharding((), mode)  # an unknown mode raises here too
            return
        for name, split in state_shardings(module, mode, mesh.data, mesh.model, min_dim).items():
            if MODEL_AXIS in split:
                self.model_dim[name] = split[MODEL_AXIS]
            if DATA_AXIS in split:
                self.data_dim[name] = split[DATA_AXIS]
        modules = dict(module.named_modules())
        for name, dim in self.model_dim.items():
            _tensor_parallel(modules[name.rpartition(".")[0]], mesh, dim)

    # -- layouts ---------------------------------------------------------------
    def working(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's working tensor of the whole leaf ``full`` (a view)."""
        dim = self.model_dim.get(name)
        return full if dim is None else full.chunk(self.mesh.model, dim)[self.mesh.model_index]

    def shard(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the whole leaf ``full`` (a view)."""
        local = self.working(name, full)
        dim = self.data_dim.get(name)
        return local if dim is None else local.chunk(self.mesh.data, dim)[self.mesh.data_index]

    def full(self, name: str, shard: torch.Tensor) -> torch.Tensor:
        """The whole leaf from every rank's ``shard`` (collectives: every rank calls it)."""
        mesh = self.mesh
        if name in self.data_dim:
            shard = torch.cat(mesh.all_gather(shard, DATA_AXIS).unbind(0), self.data_dim[name])
        if name in self.model_dim:
            shard = torch.cat(mesh.all_gather(shard, MODEL_AXIS).unbind(0), self.model_dim[name])
        return shard

    def masters(self, params: dict[str, torch.Tensor], device: torch.device) -> dict[str, torch.Tensor]:
        """Float32 copies of this rank's shards of the whole leaves ``params``."""
        return {k: self.shard(k, v).detach().to(device, torch.float32).clone(memory_format=torch.contiguous_format)
                for k, v in params.items()}

    def load_module(self, module: nn.Module, state_dict: dict[str, torch.Tensor], strict: bool = True) -> None:
        """``module.load_state_dict`` of whole leaves, tensor-parallel ones cut to the rank's slice."""
        module.load_state_dict({k: self.working(k, v) for k, v in state_dict.items()}, strict=strict)

    # -- the step's collectives ----------------------------------------------------
    def reduce_grads(self, names: list[str], grads: list[torch.Tensor]) -> list[torch.Tensor]:
        """The data group's mean of each working gradient: one all-reduced
        bucket for the leaves whole on ``data``, one reduce-scattered bucket
        (rank j's blocks at j's place) for the split ones, of which this rank
        keeps its blocks."""
        mesh, d = self.mesh, self.mesh.data
        out = list(grads)
        whole = [i for i, n in enumerate(names) if n not in self.data_dim]
        split = [i for i, n in enumerate(names) if n in self.data_dim]
        if whole:
            bucket = torch.cat([grads[i].reshape(-1) for i in whole])
            mesh.all_reduce_(bucket, DATA_AXIS).div_(float(d))
            for i, g in zip(whole, bucket.split([grads[i].numel() for i in whole])):
                out[i] = g.view_as(grads[i])
        if split:
            chunks = [grads[i].chunk(d, self.data_dim[names[i]]) for i in split]
            bucket = torch.cat([c[j].reshape(-1) for j in range(d) for c in chunks])
            mine = mesh.reduce_scatter(bucket, DATA_AXIS).div_(float(d))
            shapes = [c[mesh.data_index].shape for c in chunks]
            for i, g, shape in zip(split, mine.split([math.prod(s) for s in shapes]), shapes):
                out[i] = g.view(shape)
        return out

    @torch.no_grad()
    def refresh(self, names: list[str], masters: list[torch.Tensor], working: list[torch.Tensor]) -> None:
        """Working copy ← masters, in the working dtype; the split leaves'
        blocks all-gathered over the data group (one collective per dtype)."""
        split = [i for i, n in enumerate(names) if n in self.data_dim]
        whole = [i for i, n in enumerate(names) if n not in self.data_dim]
        if whole:
            torch._foreach_copy_([working[i] for i in whole], [masters[i] for i in whole])
        for dtype in dict.fromkeys(working[i].dtype for i in split):
            group = [i for i in split if working[i].dtype == dtype]
            local = torch.cat([masters[i].reshape(-1).to(dtype) for i in group])
            gathered = self.mesh.all_gather(local, DATA_AXIS)
            sizes = [masters[i].numel() for i in group]
            per_rank = [row.split(sizes) for row in gathered.unbind(0)]
            for j, i in enumerate(group):
                blocks = [parts[j].view(masters[i].shape) for parts in per_rank]
                working[i].copy_(torch.cat(blocks, self.data_dim[names[i]]))

