"""Scenarios that share parameters, solved as one problem.

PyTorch port of ``solve_joint_theta`` of
``sip_optimal_control_tpu/parallel/sharding.py`` for one device: the
scenarios are the batch axis of one coupled solve (``solve(coupled=True)``),
whose θ Schur complement and scalar couplings reduce over the batch.
"""

from __future__ import annotations

from typing import Optional

from ..model import ModelSpec, build_problem
from ..solver.settings import Settings
from ..solver.sip import SolveResult, solve
from ..types import Dimensions, Topology


def solve_joint_theta(spec: ModelSpec, dims: Dimensions,
                      topology: Topology, x0s,
                      settings: Optional[Settings] = None,
                      lower=None, upper=None,
                      hessian_mode: str = "exact",
                      scale_dual=1.0, scale_equality=1.0,
                      scale_bound=1.0) -> SolveResult:
    """Jointly solve S scenarios that share ONE θ (JAX sharding.py:106-161
    with ``mesh=None``).

    Each scenario is a copy of the stagewise problem with its own initial
    state ``x0s[s]`` ([S, n]) and the shared parameter vector θ: the joint
    NLP is  min_{v_1..v_S, θ} sum_s f(v_s, θ)  s.t. per-scenario
    constraints, mathematically one star tree (a zero-state root fanning
    out to the S scenario chains).  The scenario blocks factor on their
    own; only the p x p θ Schur complement and θ right-hand side are
    summed over the scenarios.

    Returns the SolveResult over all S scenarios; θ is identical on every
    scenario (read ``result.vars.theta[0]``), and status, iterations and
    KKT error are the joint problem's.  Requires unbounded θ."""
    settings = settings or Settings()
    problem = build_problem(spec, dims, topology, initial_state=x0s,
                            lower=lower, upper=upper,
                            hessian_mode=hessian_mode,
                            scale_dual=scale_dual,
                            scale_equality=scale_equality,
                            scale_bound=scale_bound)
    return solve(problem, settings, coupled=True)
