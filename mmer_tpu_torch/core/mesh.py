"""The (data, model) device mesh over ``torch.distributed``, the port of
``mmer_tpu/core/mesh.py``.

A world of ``n`` ranks (one process per device, as ``torchrun`` launches
them) is laid out as JAX lays out ``n`` devices: ``reshape(dp, mp)``, so
rank ``r`` sits at data index ``r // mp`` and model index ``r % mp``.  The
ranks that share a model index form a *data group* (batch sharding: the
gradient all-reduce, the extractors' all-gather, BatchNorm's statistics);
the ranks that share a data index form a *model group* (tensor parallelism:
``parallel/sharding.py``).

Where JAX's partitioner inserts the collectives, the port issues them
itself, through the few methods of :class:`Mesh`.  Two differences from
JAX's mesh:

- every rank of the world must be on the mesh (``dp * mp == n``): a rank is
  a process, and a process left off the mesh would have nothing to do;
- a mesh built over a process group runs its data-axis collectives even at
  world size 1 (JAX skips them when ``mesh.size == 1``), so a one-rank NCCL
  world exercises the code a larger one runs.  A one-rank model axis issues
  nothing (its sums are the identity).  Without a process group,
  :func:`create_mesh` returns a one-rank mesh that issues no collective.

A pure data-parallel mesh (``mp == 1``) uses the world's own group; a
dp x tp mesh makes its axis groups with ``new_group``, once a call.

A CUDA world uses NCCL with rank ``r`` on ``cuda:LOCAL_RANK``; a CPU world
uses gloo.  :meth:`Mesh.check_device` refuses a device the group's backend
does not serve: nothing falls back to the CPU or to gloo.
"""

from __future__ import annotations

import os
from typing import List, Optional

import torch
import torch.distributed as dist

from mmer_tpu_torch.config import MeshConfig

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


class Mesh:
    """This rank's place on a (data, model) mesh and the process groups of
    its two axes.  ``active`` is False for the one-rank mesh of a process
    without a process group: its collectives are the identity."""

    def __init__(self, dp: int, mp: int, rank: int = 0,
                 data_group=None, model_group=None, active: bool = False,
                 axis_names=("data", "model")):
        self.dp, self.mp, self.rank = dp, mp, rank
        self.data_group, self.model_group = data_group, model_group
        self.active = active
        self.axis_names = tuple(axis_names)
        self.backend = dist.get_backend() if active else None

    # A model that holds the mesh is deep-copied (EMA, best snapshots); the
    # process groups are shared, never copied.
    def __deepcopy__(self, memo):
        return self

    @property
    def size(self) -> int:
        return self.dp * self.mp

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, (self.dp, self.mp)))

    @property
    def data_index(self) -> int:
        return self.rank // self.mp

    @property
    def model_index(self) -> int:
        return self.rank % self.mp

    def check_device(self, device: torch.device) -> None:
        """Raise unless the group's backend serves ``device`` (NCCL for
        CUDA, gloo for the CPU)."""
        if self.active and BACKENDS[torch.device(device).type] != self.backend:
            raise RuntimeError(f"a {self.backend} process group cannot serve "
                               f"{device}: launch a {device.type} world")

    def batch_rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n`` (a multiple of dp)."""
        if n % self.dp:
            raise ValueError(f"a global batch of {n} does not split over "
                             f"{self.dp} data ranks")
        per = n // self.dp
        return slice(self.data_index * per, (self.data_index + 1) * per)

    def model_cols(self, n: int) -> slice:
        """This rank's share of ``n`` columns (heads, FFN units) split over
        the model axis."""
        if n % self.mp:
            raise ValueError(f"{n} columns do not split over {self.mp} model ranks")
        per = n // self.mp
        return slice(self.model_index * per, (self.model_index + 1) * per)

    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Concatenate the data ranks' (rows, ...) blocks in data-rank
        order: one all-gather over the data group."""
        if not self.active:
            return x
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.dp)]
        dist.all_gather(parts, x, group=self.data_group)
        return torch.cat(parts)

    def all_reduce(self, x: torch.Tensor, axis: str = "data") -> torch.Tensor:
        """Sum in place over one axis's group (``"data"`` or ``"model"``);
        returns ``x``."""
        if self.active and not (axis == "model" and self.mp == 1):
            group = self.data_group if axis == "data" else self.model_group
            dist.all_reduce(x, group=group)
        return x

    def barrier(self) -> None:
        """Wait for every rank of the world (nothing without a group)."""
        if self.active:
            dist.barrier()

    def all_reduce_tensors(self, tensors: List[torch.Tensor]) -> None:
        """Sum a list of tensors over the data axis in place, as one flat
        all-reduce."""
        if not self.active or not tensors:
            return
        flat = torch.cat([t.reshape(-1) for t in tensors])
        self.all_reduce(flat)
        offset = 0
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


# The mesh of a single-device run: one rank, no process group, every
# collective the identity.
SINGLE = Mesh(1, 1)


def active_mesh(mesh: Optional[Mesh], device: torch.device) -> Optional[Mesh]:
    """``mesh`` if a process group is behind it (checked against
    ``device``), else None: the single-device path."""
    if mesh is None or not mesh.active:
        return None
    mesh.check_device(device)
    return mesh


def create_mesh(cfg: Optional[MeshConfig] = None) -> Mesh:
    """A (data, model) mesh over the ranks of the default process group
    (one rank when there is none), with JAX's arithmetic:
    ``cfg.data_parallel == -1`` puts every rank left after
    ``cfg.model_parallel`` on the data axis.  Every rank of a world must call
    it (the axis groups are made collectively)."""
    cfg = cfg or MeshConfig()
    active = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if active else 1
    mp = max(1, cfg.model_parallel)
    if n % mp != 0:
        raise ValueError(f"{n} devices not divisible by model_parallel={mp}")
    dp = cfg.data_parallel if cfg.data_parallel > 0 else n // mp
    if dp * mp > n:
        raise ValueError(f"mesh {dp}x{mp} needs more than {n} devices")
    names = (cfg.data_axis, cfg.model_axis)
    if not active:
        return Mesh(1, 1, axis_names=names)
    if dp * mp != n:
        raise ValueError(f"mesh {dp}x{mp} leaves ranks of a world of {n} "
                         "idle: launch dp*mp ranks")
    rank = dist.get_rank()
    if mp == 1:                 # the data axis is the world
        return Mesh(dp, 1, rank, None, None, active=True, axis_names=names)
    data_group = model_group = None
    # new_group is collective: every rank makes every group, in one order.
    for m in range(mp):
        g = dist.new_group([d * mp + m for d in range(dp)])
        if rank % mp == m:
            data_group = g
    for d in range(dp):
        g = dist.new_group([d * mp + m for m in range(mp)])
        if rank // mp == d:
            model_group = g
    return Mesh(dp, mp, rank, data_group, model_group, active=True,
                axis_names=names)


def init_from_env(device: torch.device | str) -> torch.device:
    """Join the process group that ``torchrun``'s environment describes
    (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) and return this rank's device: ``cuda:LOCAL_RANK`` over
    NCCL for a CUDA ``device``, the CPU over gloo otherwise.  Outside such a
    launch it does nothing and returns ``device``.  A CUDA device without
    CUDA raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda.is_available() "
                           "is False (pass --device cpu to run on the CPU)")
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return device
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    dist.init_process_group(BACKENDS[device.type])
    return device


def is_writer() -> bool:
    """True on the rank that writes a run's files: rank 0, or the only
    process."""
    return not dist.is_initialized() or dist.get_rank() == 0
