"""Receding-horizon MPC with warm starting, batched over scenarios.

PyTorch port of ``sip_optimal_control_tpu/mpc.py``: the closed loop
``run_mpc`` and its wall-clock-budgeted form ``run_mpc_timed`` (the
reference's ``timeout_callback``), each for a batch of plants at once, plus
``mpc_steps``, the package form of the benchmark's batched MPC program
(``bench.py::build_mpc_scan`` with ``steps_per_call > 1``).  The solver
state is an explicit container the caller threads between re-solves (the
reference exposes sip_workspace.vars.{x,y} for the same purpose, reference:
tests/variable_dimensions_test.cpp:437-446).
"""

from __future__ import annotations

import functools
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.func import vmap

from ._tree import lane_view, tree_map, tree_select
from .model import ModelSpec, box_bounds, build_problem, fused_probe_model
from .solver.settings import Settings
from .solver.sip import Primal, SolveResult, YVec, solve
from .types import Dimensions, Topology

# seed of the fixed plant disturbance (bench.py::build_mpc_scan)
DISTURBANCE_SEED = 12345


class MPCTrace(NamedTuple):
    """A closed loop of ``run_mpc``, step axis first, then the batch."""

    states: torch.Tensor      # [steps+1, B, n] closed-loop plant states
    controls: torch.Tensor    # [steps, B, m] applied controls
    iterations: torch.Tensor  # [steps, B] int32 solver iterations
    statuses: torch.Tensor    # [steps, B] int32
    kkt_errors: torch.Tensor  # [steps, B]


class MPCSteps(NamedTuple):
    """State after ``steps`` MPC steps and per-step statistics."""

    x: torch.Tensor           # [B, n] plant states
    vars: Primal              # warm start for the next call
    y: YVec
    statuses: torch.Tensor    # [steps, B] int32
    iterations: torch.Tensor  # [steps, B] int32
    kkt_errors: torch.Tensor  # [steps, B]
    mus: torch.Tensor         # [steps, B] barrier parameter after the solve


def _shift_warm_start(vars: Primal, y: YVec, topology=None):
    """Shift the predicted trajectory one stage forward — the classic MPC
    warm start (duplicate the terminal stage).  With a non-chain
    ``topology``, dispatches to the tree generalization."""
    if topology is not None and not topology.is_chain:
        return _shift_warm_start_tree(vars, y, topology)

    def shift_nodes(a):
        return torch.cat([a[:, 1:], a[:, -1:]], dim=1)

    return (Primal(x=shift_nodes(vars.x), u=shift_nodes(vars.u),
                   theta=vars.theta),
            YVec(dyn=shift_nodes(y.dyn), nc=shift_nodes(y.nc),
                 ec=shift_nodes(y.ec)))


def _tree_successor_maps(topology):
    """Static first-child successor maps for the tree shift warm start
    (JAX mpc.py:51-80).

    node_succ[i] = first child of node i (itself for leaves);
    edge_succ[e] = first outgoing edge of child(e) (e itself when child(e)
    is a leaf).  "First" = lowest edge index, which for the scenario-tree
    constructions used here is the lowest-numbered branch — so the shared
    prefix of a receding-horizon robust MPC tree shifts into branch 0's
    trajectory, and every branch shifts along itself (branches are chains
    past the branch point)."""
    E = topology.num_edges
    N = E + 1
    parents = np.asarray(topology.edge_parents)
    children = np.asarray(topology.edge_children)
    first_edge = np.full(N, -1, dtype=np.int64)
    for e in range(E - 1, -1, -1):      # lowest edge index wins
        first_edge[parents[e]] = e
    node_succ = np.arange(N)
    has_child = first_edge >= 0
    node_succ[has_child] = children[first_edge[has_child]]
    edge_succ = np.arange(E)
    child_first = first_edge[children]
    edge_succ[child_first >= 0] = child_first[child_first >= 0]
    return node_succ, edge_succ


@functools.lru_cache(maxsize=16)
def _successor_index(topology, device: torch.device):
    """The successor maps as int64 tensors on ``device``."""
    return tuple(torch.as_tensor(a, device=device)
                 for a in _tree_successor_maps(topology))


def _shift_warm_start_tree(vars: Primal, y: YVec, topology):
    """Tree shift warm start (JAX mpc.py:83-95): every node/edge takes its
    first-child successor's value (leaves repeat) — on a chain this
    reduces exactly to the one-stage shift.  The shared prefix of a
    scenario tree is well-defined under the receding horizon (those stages
    are common to all futures); branch stages shift along their own
    branch."""
    node_succ, edge_succ = _successor_index(topology, vars.x.device)
    return (Primal(x=vars.x[:, node_succ], u=vars.u[:, edge_succ],
                   theta=vars.theta),
            YVec(dyn=y.dyn[:, node_succ], nc=y.nc[:, node_succ],
                 ec=y.ec[:, edge_succ]))


def usable_solutions(res: SolveResult,
                     kkt_reset_threshold: float = 1e2) -> torch.Tensor:
    """Per scenario [B]: may this re-solve's solution drive the plant and
    warm-start the next one?  SOLVED iterates, and MAX_ITERATIONS iterates
    whose KKT error is still below ``kkt_reset_threshold`` (the
    real-time-iteration contract), with a finite KKT error and finite
    states and controls (JAX mpc.py:132-141)."""
    finite = (torch.isfinite(res.kkt_error)
              & torch.isfinite(res.vars.x).flatten(1).all(-1)
              & torch.isfinite(res.vars.u).flatten(1).all(-1))
    return ((res.status == 0)
            | ((res.status == 1) & (res.kkt_error < kkt_reset_threshold))) \
        & finite


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
    # the stage functions and bounds are the same every step; the fused
    # iteration's payload only when the settings take that path
    fused_model = fused_probe_model(spec, dims, topology, lower, upper,
                                    x0.dtype, x0.device, hessian_mode,
                                    settings.fused_iteration)

    x, wv, wy = x0, warm_vars, warm_y
    statuses, iterations, kkt_errors, mus = [], [], [], []
    for k in range(steps):
        problem = build_problem(spec, dims, topology, initial_state=x,
                                lower=lower, upper=upper,
                                hessian_mode=hessian_mode,
                                fused_model=fused_model)
        res = solve(problem, settings, init_vars=wv, init_y=wy)
        usable = usable_solutions(res)
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
        mus.append(res.mu)
    return MPCSteps(x=x, vars=wv, y=wy, statuses=torch.stack(statuses),
                    iterations=torch.stack(iterations),
                    kkt_errors=torch.stack(kkt_errors),
                    mus=torch.stack(mus))


def _closed_loop(spec: ModelSpec, dims: Dimensions, topology: Topology, x0,
                 settings: Optional[Settings], lower, upper,
                 plant: Optional[Callable], warm_start: bool,
                 reset_on_failure: bool, kkt_reset_threshold: float):
    """The step function of ``run_mpc`` / ``run_mpc_timed`` (JAX
    mpc.py:123-152) and its first carry (x, warm vars, warm duals,
    have_warm).  A step maps a carry to (next carry, (x_next, u0,
    iterations, status, kkt_error))."""
    settings = settings or Settings()
    x0 = torch.as_tensor(x0)
    if x0.dim() == 1:
        x0 = x0[None]
    dtype, device = x0.dtype, x0.device
    batch = x0.shape[0]
    if lower is None or upper is None:
        default_lower, default_upper = box_bounds(dims, dtype=dtype,
                                                  device=device)
        lower = lower or default_lower
        upper = upper or default_upper
    if plant is None:
        # the model dynamics at edge 0 with θ = 0, for every scenario
        theta0 = x0.new_zeros(dims.theta_dim)
        edge0 = torch.zeros((), dtype=torch.long, device=device)
        dyn = vmap(spec.dynamics, in_dims=(0, 0, None, None))

        def plant(x, u):
            return dyn(x, u, theta0, edge0)
    # the stage functions and bounds are the same every step
    fused_model = fused_probe_model(spec, dims, topology, lower, upper,
                                    dtype, device, "exact",
                                    settings.fused_iteration)
    N, E = dims.num_nodes, dims.num_edges
    n = max(dims.max_state_dim, 1)
    zeros = dict(dtype=dtype, device=device)
    zero_y = YVec(dyn=torch.zeros(batch, N, n, **zeros),
                  nc=torch.zeros(batch, N, dims.max_node_c_dim, **zeros),
                  ec=torch.zeros(batch, E, dims.max_edge_c_dim, **zeros))
    no_warm = torch.zeros(batch, dtype=torch.bool, device=device)

    def step(carry):
        x, warm_vars, warm_y, have_warm = carry
        problem = build_problem(spec, dims, topology, initial_state=x,
                                lower=lower, upper=upper,
                                fused_model=fused_model)
        if warm_start:
            # no usable warm state -> the rebuilt problem's default init
            init_vars = (problem.default_init if warm_vars is None else
                         tree_select(have_warm, warm_vars,
                                     problem.default_init))
            res = solve(problem, settings, init_vars=init_vars,
                        init_y=warm_y)
        else:
            res = solve(problem, settings)
        u0 = res.vars.u[:, 0]
        if reset_on_failure:
            usable = usable_solutions(res, kkt_reset_threshold)
            u0 = torch.where(usable[:, None], u0, 0.0)
        else:
            usable = torch.ones_like(no_warm)
        x_next = plant(x, u0)
        next_vars, next_y = _shift_warm_start(res.vars, res.y, topology)
        # an unusable scenario restarts from the default init; its dual
        # warm start (passed regardless) is scrubbed too
        next_y = tree_map(lambda a: torch.where(lane_view(usable, a), a,
                                                0.0), next_y)
        out = (x_next, u0, res.iterations, res.status, res.kkt_error)
        return (x_next, next_vars, next_y, usable), out

    return step, (x0, None, zero_y, no_warm)


def _trace(xs, outs, dims: Dimensions) -> MPCTrace:
    states = torch.stack(xs)
    if not outs:
        # no step completed: JAX's empty-prefix shapes, with the batch
        batch = states.shape[1]
        m = max(dims.max_control_dim, 1)
        empty = dict(device=states.device)
        return MPCTrace(
            states=states,
            controls=states.new_zeros(0, batch, m),
            iterations=torch.zeros(0, batch, dtype=torch.int32, **empty),
            statuses=torch.zeros(0, batch, dtype=torch.int32, **empty),
            kkt_errors=states.new_zeros(0, batch))
    _, us, iters, statuses, errs = zip(*outs)
    return MPCTrace(states=states, controls=torch.stack(us),
                    iterations=torch.stack(iters),
                    statuses=torch.stack(statuses),
                    kkt_errors=torch.stack(errs))


def run_mpc(spec: ModelSpec, dims: Dimensions, topology: Topology, x0,
            n_steps: int, settings: Optional[Settings] = None,
            lower=None, upper=None, plant: Optional[Callable] = None,
            warm_start: bool = True, reset_on_failure: bool = True,
            kkt_reset_threshold: float = 1e2) -> MPCTrace:
    """Closed-loop MPC for a batch of plants (JAX mpc.py:93-166, there one
    plant under ``vmap``): at each step solve every scenario's horizon
    problem from its plant state ``x0`` [B, n] (or [n]), apply u[0],
    advance the plant, warm start the next solve from the shifted solution.

    ``plant(x [B, n], u [B, m]) -> x_next [B, n]`` defaults to the model
    dynamics at edge 0 with θ = 0.

    ``reset_on_failure`` (production failsafe): a scenario whose re-solve
    is not usable (``usable_solutions``) applies zero control this step
    and restarts next step from the rebuilt problem's default init with
    zero duals."""
    step, carry = _closed_loop(spec, dims, topology, x0, settings, lower,
                               upper, plant, warm_start, reset_on_failure,
                               kkt_reset_threshold)
    xs, outs = [carry[0]], []
    for _ in range(n_steps):
        carry, out = step(carry)
        xs.append(carry[0])
        outs.append(out)
    return _trace(xs, outs, dims)


def run_mpc_timed(spec: ModelSpec, dims: Dimensions, topology: Topology, x0,
                  max_steps: int, time_budget_s: float,
                  settings: Optional[Settings] = None,
                  lower=None, upper=None, plant: Optional[Callable] = None,
                  warm_start: bool = True, reset_on_failure: bool = True,
                  kkt_reset_threshold: float = 1e2) -> MPCTrace:
    """Wall-clock-budgeted ``run_mpc`` (JAX mpc.py:169-254): the
    dispatch-level equivalent of the reference's user-supplied
    ``timeout_callback`` (reference: sip_optimal_control/types.hpp:139-140,
    threaded through at sip_optimal_control.cpp:196).  The clock is read
    only after a step's device work has finished (``torch.cuda.synchronize``
    on a GPU), and no new step is issued once ``time_budget_s`` has elapsed:
    a solve is never abandoned midway.  Returns the completed prefix, so
    ``len(trace.controls) <= max_steps``."""
    step, carry = _closed_loop(spec, dims, topology, x0, settings, lower,
                               upper, plant, warm_start, reset_on_failure,
                               kkt_reset_threshold)
    on_gpu = carry[0].is_cuda
    deadline = time.monotonic() + time_budget_s
    xs, outs = [carry[0]], []
    for _ in range(max_steps):
        if time.monotonic() >= deadline:
            break
        carry, out = step(carry)
        if on_gpu:
            torch.cuda.synchronize(carry[0].device)
        xs.append(carry[0])
        outs.append(out)
    return _trace(xs, outs, dims)
