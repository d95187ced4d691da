"""Scenario sharding over processes, one per GPU (BASELINE config 5).

PyTorch port of ``sip_optimal_control_tpu/parallel/sharding.py``.  JAX
lays the scenarios along a device-mesh axis and runs ``shard_map`` over
it; here each process (started by ``torchrun`` or by the caller, one per
GPU) holds its own contiguous rows of the global batch and solves them,
and cross-scenario quantities go through ``torch.distributed.all_reduce``
over the mesh's process group (``_mesh.ScenarioMesh``).

- ``solve_batch_sharded``: data parallelism.  Every rank solves its rows
  on its own (no collective inside the interior-point loop, so ranks may
  take different numbers of trips); the statistics are reduced over the
  ranks at the end.
- ``solve_joint_theta`` with a mesh: ONE joint NLP over every rank's
  scenarios, sharing θ: each trip's scalar couplings and the θ Schur
  system are reduced over the ranks (``solve(coupled=mesh)``), and every
  rank takes the same trips.

Without ``torch.distributed`` initialized, ``scenario_mesh`` is this
process alone and every reduction is local.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from .._mesh import ScenarioMesh
from ..model import ModelSpec, build_problem
from ..solver.settings import Settings
from ..solver.sip import SolveResult, solve
from ..types import Dimensions, Topology


class BatchSolveStats(NamedTuple):
    """Cross-scenario aggregates, reduced over the mesh's ranks."""

    total_solved: torch.Tensor
    max_kkt_error: torch.Tensor
    mean_iterations: torch.Tensor


def _mesh_device(device) -> torch.device:
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"scenario_mesh: {device} asked for, but "
                               "CUDA is not available")
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("scenario_mesh: CUDA is not available; pass "
                           "device='cpu' to run the mesh on the CPU")
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else torch.cuda.current_device()
    return torch.device("cuda", index)


def scenario_mesh(group=None, device=None) -> ScenarioMesh:
    """The mesh of this process's group (JAX ``scenario_mesh``).

    With ``torch.distributed`` initialized: the given process group, or
    the default group.  Without it: this process alone (``group`` must be
    None), whose reductions are local.  ``device`` is where this rank's
    rows live: ``cuda:{LOCAL_RANK}`` (as ``torchrun`` sets it) or the
    current CUDA device by default; pass ``device="cpu"`` for the CPU (a
    machine without CUDA raises otherwise)."""
    device = _mesh_device(device)
    if dist.is_available() and dist.is_initialized():
        group = group if group is not None else dist.group.WORLD
        return ScenarioMesh(group=group, rank=dist.get_rank(group),
                            size=dist.get_world_size(group), device=device)
    if group is not None:
        raise ValueError("scenario_mesh: a process group was given but "
                         "torch.distributed is not initialized")
    return ScenarioMesh(group=None, rank=0, size=1, device=device)


def shard_scenarios(arr, mesh: ScenarioMesh) -> torch.Tensor:
    """This rank's contiguous rows of the global ``[B, ...]`` batch ``arr``
    (which every rank builds alike, e.g. from one seed), on the mesh's
    device: rank r holds rows r B / size .. (r + 1) B / size (JAX's
    ``NamedSharding(mesh, P("scenario"))``).  Raises unless the ranks
    divide B, as ``shard_map`` does."""
    arr = torch.as_tensor(arr)
    batch = arr.shape[0]
    if batch % mesh.size:
        raise ValueError(f"shard_scenarios: batch {batch} does not split "
                         f"evenly over {mesh.size} ranks")
    rows = batch // mesh.size
    return arr[mesh.rank * rows:(mesh.rank + 1) * rows].to(
        mesh.device).contiguous()


def solve_batch_sharded(spec: ModelSpec, dims: Dimensions,
                        topology: Topology, x0s,
                        settings: Optional[Settings] = None,
                        mesh: Optional[ScenarioMesh] = None,
                        lower=None, upper=None,
                        stats_collectives: bool = True):
    """Solve this rank's scenarios ``x0s`` ([B_local, n], from
    ``shard_scenarios``) on their own (JAX sharding.py:51-103).

    Returns (controls [B_local, E, m], statuses [B_local], stats): this
    rank's rows, as JAX's addressable shards.  ``stats`` holds the solved
    count (SUM), the largest KKT error (MAX) and the mean of the ranks'
    mean iteration counts (JAX's ``pmean`` of per-shard means), the same
    on every rank.  The loop holds no collective: ranks may take
    different numbers of trips, and only the statistics are reduced.

    ``stats_collectives=False`` makes no collective call at all: ``stats``
    holds this rank's own values with a leading axis of 1 (JAX stacks the
    shards' on the host; reduce them there).  ``mesh`` defaults to this
    process's (``scenario_mesh`` on ``x0s``'s device)."""
    settings = settings or Settings()
    mesh = mesh if mesh is not None else scenario_mesh(device=x0s.device)
    problem = build_problem(spec, dims, topology, initial_state=x0s,
                            lower=lower, upper=upper)
    res = solve(problem, settings)
    solved = (res.status == 0).sum().to(torch.int32)
    max_kkt = res.kkt_error.amax()
    mean_it = res.iterations.to(torch.float32).mean()
    if stats_collectives:
        stats = BatchSolveStats(
            total_solved=mesh.all_reduce(solved, "sum"),
            max_kkt_error=mesh.all_reduce(max_kkt, "max"),
            mean_iterations=mesh.all_reduce(mean_it, "sum") / mesh.size)
    else:
        stats = BatchSolveStats(total_solved=solved[None],
                                max_kkt_error=max_kkt[None],
                                mean_iterations=mean_it[None])
    return res.vars.u, res.status, stats


def solve_joint_theta(spec: ModelSpec, dims: Dimensions,
                      topology: Topology, x0s,
                      settings: Optional[Settings] = None,
                      mesh: Optional[ScenarioMesh] = None,
                      lower=None, upper=None,
                      hessian_mode: str = "exact",
                      scale_dual=1.0, scale_equality=1.0,
                      scale_bound=1.0) -> SolveResult:
    """Jointly solve S scenarios that share ONE θ (JAX sharding.py:106-161).

    Each scenario is a copy of the stagewise problem with its own initial
    state ``x0s[s]`` ([S, n]) and the shared parameter vector θ: the joint
    NLP is  min_{v_1..v_S, θ} sum_s f(v_s, θ)  s.t. per-scenario
    constraints, mathematically one star tree (a zero-state root fanning
    out to the S scenario chains).  The scenario blocks factor on their
    own; only the p x p θ Schur complement, θ's right-hand side and the
    scalar couplings are reduced over the scenarios.

    ``mesh=None`` solves the batch ``x0s`` in this process.  With a
    ``ScenarioMesh``, ``x0s`` is this rank's rows (``shard_scenarios``) of
    the global batch, every rank of the mesh must call alike, and the
    reductions also run over the ranks: each rank gets the SolveResult of
    its rows, with the joint θ, status and iterations.

    θ is identical on every scenario (read ``result.vars.theta[0]``), and
    status, iterations and KKT error are the joint problem's.  Requires
    unbounded θ."""
    settings = settings or Settings()
    problem = build_problem(spec, dims, topology, initial_state=x0s,
                            lower=lower, upper=upper,
                            hessian_mode=hessian_mode,
                            scale_dual=scale_dual,
                            scale_equality=scale_equality,
                            scale_bound=scale_bound)
    return solve(problem, settings, coupled=mesh if mesh is not None
                 else True)
