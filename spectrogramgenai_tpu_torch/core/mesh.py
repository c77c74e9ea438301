"""The (data, model) grid of ranks (``spectrogramgenai_tpu/core/mesh.py``) over ``torch.distributed``.

A trainer started under ``torchrun`` runs one process per rank; the ranks
form a ``data × model`` grid laid out row-major, rank = d·M + m, as
``create_mesh`` lays out the JAX devices. The ``data`` group of a rank holds
the ranks with its model index (they split the batch), the ``model`` group
the ranks with its data index (they split the wide layers' output channels,
``train/common.py``). Collectives ride NCCL on the card and gloo on the CPU.
Without ``torchrun``'s environment there is no process group: the world is
one rank, every group is absent and no collective runs.

The JAX module's ``shard_batch`` / ``batch_sharding`` / ``replicated`` have no
counterpart: there is no global array here. A rank holds its rows of every
batch as a plain local tensor (``process_local_slice``, ``rank_rows``) and
the code that needs the global batch says so with a collective.

Every collective of the port goes through a :class:`Mesh` method, which
counts its calls by name in ``Mesh.calls``. So do the operations of the
control channel (:meth:`Mesh.open_control`): a key-value store beside the
process group, over which a long-lived job (the server of ``cli/serve.py``)
tells its ranks what to run next. Its waits end after a timeout that the
caller chooses and can be made again, so a rank may sit idle for hours,
where a blocked NCCL collective would run into the process group's watchdog.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import os
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """How to carve the ranks. ``data=-1`` means "all remaining"."""

    data: int = -1
    model: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int]:
        model = max(1, self.model)
        data = self.data if self.data > 0 else n_devices // model
        if data * model > n_devices:
            raise ValueError(f"mesh {data}x{model} needs {data * model} devices, have {n_devices}")
        return data, model


def maybe_initialize_distributed(device: torch.device | str) -> bool:
    """Join the process group when ``torchrun``'s environment is present
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``);
    a run without it is untouched. NCCL for a CUDA device, whose index must
    be ``LOCAL_RANK`` and is made the current device first, so that every
    allocation and every kernel launch on ``torch.cuda.current_stream()``
    lands on this rank's card; gloo for the CPU. Returns True if the process
    is in a process group."""
    if dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ or "MASTER_ADDR" not in os.environ:
        return False
    device = torch.device(device)
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", 0))
        if device.index != local:
            raise ValueError(f"rank with LOCAL_RANK {local} was given device {device}; expected cuda:{local}")
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", device_id=device)
    else:
        dist.init_process_group("gloo")
    return True


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group whose backward is the same sum: the gradient of each
    rank's input collects every rank's use of the result."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        out = x.clone()
        mesh.all_reduce_(out, axis)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        ctx.mesh.all_reduce_(grad, ctx.axis)
        return grad, None, None


class _CopyToModel(torch.autograd.Function):
    """A tensor-parallel layer's input: identity forward, sum over the model group backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        ctx.mesh.all_reduce_(grad, MODEL_AXIS)
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    """A tensor-parallel layer's output: gather the ranks' channel slices
    along ``dim`` forward; backward keeps this rank's slice of a gradient
    that every model rank holds whole (not the sum of the ranks' copies,
    which would make it M times too large)."""

    @staticmethod
    def forward(ctx, y, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return torch.cat(mesh.all_gather(y.contiguous(), MODEL_AXIS).unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.mesh
        return grad.chunk(mesh.model, ctx.dim)[mesh.model_index].contiguous(), None, None


class Mesh:
    """This rank's place in the (data, model) grid, its two process groups and
    the collectives over them. Without a process group the grid is 1×1 and
    every collective is the identity."""

    def __init__(self, device: torch.device | str, data: int = 1, model: int = 1, device_mesh=None):
        self.device = torch.device(device)
        self.data, self.model = data, model
        self.device_mesh = device_mesh
        self.calls: collections.Counter = collections.Counter()
        self.check_in: Callable[[], None] | None = None  # run before the rows' gather (gather_rows)
        self._control = None
        if device_mesh is None:
            self.rank, self.data_index, self.model_index = 0, 0, 0
            self._groups = {DATA_AXIS: None, MODEL_AXIS: None}
        else:
            self.rank = dist.get_rank()
            self.data_index, self.model_index = device_mesh.get_coordinate()
            self._groups = {axis: device_mesh.get_group(axis) for axis in (DATA_AXIS, MODEL_AXIS)}

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def distributed(self) -> bool:
        """True if this rank is in a process group (a ``torchrun`` run, one rank included)."""
        return self.device_mesh is not None

    @property
    def world(self) -> int:
        return self.data * self.model

    @property
    def is_main(self) -> bool:
        """Rank 0: the one that logs and writes files."""
        return self.rank == 0

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def backend(self) -> str | None:
        return dist.get_backend() if self.distributed else None

    # -- collectives -----------------------------------------------------------
    def all_reduce_(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum ``t`` in place over the ``axis`` group."""
        if self.distributed:
            self.calls["all_reduce"] += 1
            dist.all_reduce(t, group=self._groups[axis])
        return t

    def all_reduce_autograd(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of ``t`` over the ``axis`` group, differentiable: its
        backward sums the gradient over the group (a plain ``all_reduce`` in
        the forward would drop the other ranks' terms from the backward)."""
        return _AllReduceSum.apply(t, self, axis) if self.distributed else t

    def all_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """(group size, *t.shape): every rank's ``t`` in group order."""
        if not self.distributed:
            return t[None]
        self.calls["all_gather"] += 1
        out = torch.empty(self.size(axis) * t.numel(), dtype=t.dtype, device=t.device)
        gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
        gather(out, t.contiguous().view(-1), group=self._groups[axis])
        return out.view(self.size(axis), *t.shape)

    def reduce_scatter(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum over the ``axis`` group of a flat ``t`` laid out as group
        size equal blocks; this rank gets its block."""
        if not self.distributed:
            return t
        self.calls["reduce_scatter"] += 1
        out = torch.empty(t.numel() // self.size(axis), dtype=t.dtype, device=t.device)
        scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
        scatter(out, t.contiguous(), group=self._groups[axis])
        return out

    def barrier(self) -> None:
        if self.distributed:
            self.calls["barrier"] += 1
            dist.barrier()

    def copy_to_model(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyToModel.apply(x, self)

    def gather_from_model(self, y: torch.Tensor, dim: int) -> torch.Tensor:
        return _GatherFromModel.apply(y, self, dim)

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The data group's rows, concatenated in data order (every rank gets
        them all). ``check_in``, where set, runs first: it raises, and no rank
        enters the gather, if a rank failed before reaching it."""
        if self.data == 1:
            return t
        if self.check_in is not None:
            self.check_in()
        return self.all_gather(t, DATA_AXIS).flatten(0, 1)

    def mean_over_data(self, metrics: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Each scalar's mean over the data group: one collective for all of them."""
        if not self.distributed or not metrics:
            return metrics
        stacked = torch.stack([v.detach().float() for v in metrics.values()])
        self.all_reduce_(stacked, DATA_AXIS)
        stacked = stacked / self.data
        return dict(zip(metrics, stacked.unbind(0)))

    # -- control channel ---------------------------------------------------------
    def open_control(self, name: str) -> None:
        """Connect to the job's key-value store, the TCP store that ``torchrun``
        (or rank 0, without its agent) serves at ``MASTER_ADDR:MASTER_PORT``,
        under the prefix ``name`` and the restart count."""
        store = dist.TCPStore(os.environ["MASTER_ADDR"], int(os.environ["MASTER_PORT"]), is_master=False)
        self._control = dist.PrefixStore(f"{name}/{os.environ.get('TORCHELASTIC_RESTART_COUNT', '0')}", store)

    def post(self, key: str, value: bytes) -> None:
        self.calls["control_post"] += 1
        self._control.set(key, value)

    def wait_posted(self, keys: list[str], timeout_s: float) -> bool:
        """True once every key is posted; False after ``timeout_s`` (the wait
        may be made again). A lost store raises."""
        self.calls["control_wait"] += 1
        try:
            self._control.wait(keys, datetime.timedelta(seconds=timeout_s))
        except dist.DistStoreError:  # the timeout; a lost store raises DistNetworkError
            return False
        return True

    def read_posted(self, key: str) -> bytes:
        self.calls["control_read"] += 1
        return self._control.get(key)

    def unpost(self, keys: list[str]) -> None:
        self.calls["control_delete"] += len(keys)
        for key in keys:
            self._control.delete_key(key)

    # -- rows --------------------------------------------------------------------
    def draw_rows(self, draw: Callable[[int], torch.Tensor], n: int) -> torch.Tensor:
        """``draw(n·data)``, a random draw for the global (micro)batch made
        alike on every rank, narrowed to this rank's ``n`` rows: an R-rank
        step sees the draws of the one-rank step."""
        full = draw(n * self.data)
        return full if self.data == 1 else full.narrow(0, self.data_index * n, n)


def create_mesh(spec: MeshSpec = MeshSpec(), device: torch.device | str = "cpu") -> Mesh:
    """The (data, model) mesh over the process group's ranks (a 1×1 mesh
    without one). Every rank must be in the mesh: a rank outside it would
    have no rows to train."""
    if not dist.is_initialized():
        try:
            spec.resolve(1)
        except ValueError as e:
            raise ValueError(f"{e}: without torchrun there is one rank") from None
        return Mesh(device)
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    data, model = spec.resolve(world)
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} leaves {world - data * model} of {world} ranks without work")
    device = torch.device(device)
    device_mesh = init_device_mesh(device.type, (data, model), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    return Mesh(device, data, model, device_mesh)


def process_local_slice(n: int, mesh: Mesh) -> slice:
    """The contiguous rows of an n-row GLOBAL batch that this rank's data
    index owns: rows [d·n/D, (d+1)·n/D)."""
    if n % mesh.data:
        raise ValueError(f"global batch {n} not divisible by data axis {mesh.data}")
    per = n // mesh.data
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)


def rank_rows(n: int, k: int, data: int, index: int) -> np.ndarray:
    """Rows of an n-row global batch that data index ``index`` of ``data``
    computes on when the batch runs as k microbatches: the JAX step reshapes
    the batch to (k, n/k) and splits the n/k axis over the data axis, so the
    rank holds rows [i·n/k + index·n/(k·data), i·n/k + (index+1)·n/(k·data))
    of each microbatch i, here concatenated in microbatch order. Splitting
    them into k equal parts gives the rank its share of each microbatch."""
    if n % (k * data):
        raise ValueError(f"global batch {n} not divisible by grad_accum {k} × data axis {data}")
    per = n // (k * data)
    return np.concatenate([np.arange(i * (n // k) + index * per, i * (n // k) + (index + 1) * per)
                           for i in range(k)])


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    if global_batch % mesh.data != 0:
        raise ValueError(f"global batch {global_batch} not divisible by data axis {mesh.data}")
    return global_batch // mesh.data
