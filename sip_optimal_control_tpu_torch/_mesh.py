"""The scenario mesh: the processes whose scenarios form one batch.

JAX lays scenarios along a ``Mesh`` axis and reduces across it with
``psum`` / ``pmax`` / ``pmin`` inside ``shard_map``.  The port runs one
process per GPU (``torchrun``, or processes the caller starts), each with
its own rows of the batch; a ``ScenarioMesh`` names the process group and
this process's device, and its reductions run over the scenario axis of
the local rows and then, with ``torch.distributed.all_reduce``, over the
group.  A mesh without a group is this process alone: its reductions are
local.  The mesh uses ``all_reduce`` and no other collective, so gloo can
carry it on CUDA tensors as well as NCCL.

``parallel/sharding.py::scenario_mesh`` builds one; this module holds only
the type, so that the solver and the KKT layer can take it without
importing the sharded entry points.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

_LOCAL = {"sum": lambda v, d: v.sum(d, keepdim=True),
          "max": lambda v, d: v.amax(d, keepdim=True),
          "min": lambda v, d: v.amin(d, keepdim=True)}


def _dist_op(op: str):
    return {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
            "min": dist.ReduceOp.MIN}[op]


@dataclasses.dataclass(frozen=True)
class ScenarioMesh:
    """A process group over which a batch's scenarios are split in
    contiguous rows, rank by rank (JAX's ``P("scenario")``).

    ``group`` is the ``torch.distributed`` process group, or None for this
    process alone; ``rank`` and ``size`` are this process's place in it;
    ``device`` is where this process's rows live."""

    group: Optional[object]
    rank: int
    size: int
    device: torch.device

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``op`` ("sum", "max" or "min") of ``t`` over the ranks: a new
        tensor, the same on every rank; ``t`` itself on a mesh of this
        process alone."""
        if self.group is None:
            return t
        out = t.clone()
        dist.all_reduce(out, op=_dist_op(op), group=self.group)
        return out

    def reduce(self, v: torch.Tensor, op: str, dim: int = 0) -> torch.Tensor:
        """``op`` over the scenario axis ``dim`` of every rank's rows,
        broadcast back to ``v``'s shape."""
        out = _LOCAL[op](v, dim)
        if self.group is not None:
            dist.all_reduce(out, op=_dist_op(op), group=self.group)
        return out.expand(v.shape)

    def sum(self, v: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return self.reduce(v, "sum", dim)

    def max(self, v: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return self.reduce(v, "max", dim)

    def min(self, v: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return self.reduce(v, "min", dim)

    def any(self, flags: torch.Tensor) -> bool:
        """Whether any rank has a true entry in ``flags``: one decision
        that every rank takes alike (reads it back to the host)."""
        hit = flags.any().to(torch.int32).reshape(1)
        return bool(self.all_reduce(hit, "max"))


def local_mesh(device) -> ScenarioMesh:
    """This process alone, on ``device``."""
    return ScenarioMesh(group=None, rank=0, size=1,
                        device=torch.device(device))
