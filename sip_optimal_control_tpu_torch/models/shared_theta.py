"""Shared-parameter scenario family for the coupled joint-θ solve.

PyTorch port of ``sip_optimal_control_tpu/models/shared_theta.py``.  S
double-integrator scenarios, each from its own initial state, share ONE
setpoint parameter θ that every node cost pulls toward: the joint optimum
balances θ across all scenarios, so the θ Schur complement couples every
scenario block (reference math: helpers.cpp:376-407).  The scenarios are
the batch of ``parallel.solve_joint_theta``, so this module returns the
single-scenario pieces.
"""

from __future__ import annotations

import torch

from ..model import ModelSpec, box_bounds
from ..types import Dimensions, Topology


def shared_theta_chain(horizon: int = 20, dt: float = 0.1,
                       u_limit: float = 2.0, q_vel: float = 0.05,
                       r_u: float = 0.05, w_theta: float = 1.0,
                       dtype=torch.float64, device="cuda"):
    """Returns (spec, dims, topology, lower, upper); the bounds are of
    ``dtype`` on ``device``, and the initial states are per scenario,
    supplied by the caller."""

    # 1-element slices keep forward-mode tangents in the state's dtype
    def dynamics(x, u, th, i):
        p, v = x.split(1)
        return torch.cat([p + dt * v, v + dt * u[:1]])

    def node_cost(x, th, i):
        return (0.5 * w_theta * (x[:1] - th[:1]) ** 2
                + 0.5 * q_vel * x[1:2] ** 2).sum()

    def edge_cost(x, u, th, i):
        return (0.5 * r_u * u[:1] ** 2).sum()

    spec = ModelSpec(dynamics=dynamics, node_cost=node_cost,
                     edge_cost=edge_cost)
    dims = Dimensions.uniform(num_edges=horizon, state_dim=2,
                              control_dim=1, theta_dim=1)
    lower, upper = box_bounds(dims, u_lower=-u_limit, u_upper=u_limit,
                              dtype=dtype, device=device)
    return spec, dims, Topology.chain(horizon), lower, upper
