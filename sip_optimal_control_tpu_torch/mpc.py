"""Receding-horizon MPC with warm starting, batched over scenarios.

PyTorch port of the chain parts of ``sip_optimal_control_tpu/mpc.py`` plus
``mpc_steps``, the package form of the benchmark's batched MPC program
(``bench.py::build_mpc_scan`` with ``steps_per_call > 1``).  The solver
state is an explicit container the caller threads between re-solves (the
reference exposes sip_workspace.vars.{x,y} for the same purpose, reference:
tests/variable_dimensions_test.cpp:437-446).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import vmap

from ._tree import lane_view, tree_map, tree_select
from .model import ModelSpec, build_problem
from .solver.settings import Settings
from .solver.sip import Primal, YVec, solve
from .types import Dimensions, Topology

# seed of the fixed plant disturbance (bench.py::build_mpc_scan)
DISTURBANCE_SEED = 12345


class MPCSteps(NamedTuple):
    """State after ``steps`` MPC steps and per-step statistics."""

    x: torch.Tensor           # [B, n] plant states
    vars: Primal              # warm start for the next call
    y: YVec
    statuses: torch.Tensor    # [steps, B] int32
    iterations: torch.Tensor  # [steps, B] int32
    kkt_errors: torch.Tensor  # [steps, B]


def _shift_warm_start(vars: Primal, y: YVec, topology=None):
    """Shift the predicted trajectory one stage forward — the classic MPC
    warm start (duplicate the terminal stage).  Chains only."""
    if topology is not None and not topology.is_chain:
        raise NotImplementedError(
            "the tree shift warm start is not ported yet")

    def shift_nodes(a):
        return torch.cat([a[:, 1:], a[:, -1:]], dim=1)

    return (Primal(x=shift_nodes(vars.x), u=shift_nodes(vars.u),
                   theta=vars.theta),
            YVec(dyn=shift_nodes(y.dyn), nc=shift_nodes(y.nc),
                 ec=shift_nodes(y.ec)))


def mpc_disturbance(steps: int, batch: int, n: int, noise: float,
                    dtype, device) -> torch.Tensor:
    """The fixed-seed plant disturbance [steps, B, n] (rounded to float32
    first, as the benchmark builds it)."""
    if noise <= 0.0:
        return torch.zeros((steps, 1, n), dtype=dtype, device=device)
    rng = np.random.default_rng(DISTURBANCE_SEED)
    dist = (noise * rng.standard_normal((steps, batch, n))).astype(
        np.float32)
    return torch.as_tensor(dist, device=device).to(dtype)


def mpc_steps(spec: ModelSpec, dims: Dimensions, topology: Topology,
              lower: Primal, upper: Primal, settings: Settings,
              x0: torch.Tensor, warm_vars: Primal, warm_y: YVec,
              steps: int, hessian_mode: str = "exact",
              noise: float = 0.0) -> MPCSteps:
    """``steps`` receding-horizon steps for a batch of controllers.

    Each step solves every scenario's horizon problem from its plant state
    ``x`` [B, n], warm-started from (``warm_vars``, ``warm_y``); applies
    u[0] to the model dynamics; adds the fixed-seed disturbance; and
    shifts the solution into the next step's warm start.

    Divergence failsafe (production-MPC standard): SOLVED iterates, and
    MAX_ITERATIONS iterates whose KKT error is still below 1e2 (the
    real-time-iteration contract), are usable.  Any other scenario applies
    zero control and restarts next step from the constant trajectory at its
    new plant state with zero duals."""
    disturbance = mpc_disturbance(steps, x0.shape[0], x0.shape[-1], noise,
                                  x0.dtype, x0.device)
    N = dims.num_nodes
    theta0 = x0.new_zeros(dims.theta_dim)
    edge0 = torch.zeros((), dtype=torch.long, device=x0.device)
    plant = vmap(spec.dynamics, in_dims=(0, 0, None, None))

    x, wv, wy = x0, warm_vars, warm_y
    statuses, iterations, kkt_errors = [], [], []
    for k in range(steps):
        problem = build_problem(spec, dims, topology, initial_state=x,
                                lower=lower, upper=upper,
                                hessian_mode=hessian_mode)
        res = solve(problem, settings, init_vars=wv, init_y=wy)
        finite = (torch.isfinite(res.kkt_error)
                  & torch.isfinite(res.vars.x).flatten(1).all(-1)
                  & torch.isfinite(res.vars.u).flatten(1).all(-1))
        usable = ((res.status == 0)
                  | ((res.status == 1) & (res.kkt_error < 1e2))) & finite
        u0 = torch.where(lane_view(usable, res.vars.u[:, 0]),
                         res.vars.u[:, 0], 0.0)
        x_next = plant(x, u0, theta0, edge0)
        sh_vars, sh_y = _shift_warm_start(res.vars, res.y, topology)
        reset_vars = Primal(x=x_next[:, None].expand(-1, N, -1),
                            u=torch.zeros_like(sh_vars.u),
                            theta=sh_vars.theta * 0)
        wv = tree_select(usable, sh_vars, reset_vars)
        wy = tree_map(lambda a: torch.where(lane_view(usable, a), a, 0.0),
                      sh_y)
        x = x_next + disturbance[k]
        statuses.append(res.status)
        iterations.append(res.iterations)
        kkt_errors.append(res.kkt_error)
    return MPCSteps(x=x, vars=wv, y=wy, statuses=torch.stack(statuses),
                    iterations=torch.stack(iterations),
                    kkt_errors=torch.stack(kkt_errors))
