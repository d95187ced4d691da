"""Cartpole swing-up with box input constraints (BASELINE config 3).

PyTorch port of ``sip_optimal_control_tpu/models/cartpole.py``.  State
[p, pdot, theta, thetadot] with theta measured from the UPRIGHT position
(hanging start = pi).  RK4-discretized standard cartpole dynamics.
"""

from __future__ import annotations

import math

import torch

from ..model import ModelSpec, box_bounds
from ..types import Dimensions, Topology


def _cartpole_ode(state, force, m_cart=1.0, m_pole=0.1, length=0.5,
                  gravity=9.81):
    # 1-element slices, not 0-dim scalars: under forward-mode AD a 0-dim
    # tensor times a Python float gets a float64 tangent
    p, pdot, th, thdot = state.split(1)
    total = m_cart + m_pole
    sin, cos = torch.sin(th), torch.cos(th)
    tmp = (force + m_pole * length * thdot ** 2 * sin) / total
    th_acc = (gravity * sin - cos * tmp) / (
        length * (4.0 / 3.0 - m_pole * cos ** 2 / total))
    p_acc = tmp - m_pole * length * th_acc * cos / total
    return torch.cat([pdot, p_acc, thdot, th_acc])


def cartpole_swingup(horizon: int = 50, dt: float = 0.05,
                     force_limit: float = 10.0, q_pos: float = 0.1,
                     q_angle: float = 1.0, q_vel: float = 0.05,
                     r_force: float = 0.05, qf: float = 50.0,
                     dtype=torch.float64, device=None):
    """Returns (spec, dims, topology, lower, upper, initial_state); the
    bounds and the initial state are tensors of ``dtype`` on ``device``."""

    def dynamics(x, u, th, i):
        f = u[:1]

        def ode(s):
            return _cartpole_ode(s, f)

        k1 = ode(x)
        k2 = ode(x + 0.5 * dt * k1)
        k3 = ode(x + 0.5 * dt * k2)
        k4 = ode(x + dt * k3)
        return x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)

    weights = (q_pos, q_vel, q_angle, q_vel)

    def node_cost(x, th, i):
        scale = torch.where(i == horizon, qf, 1.0).to(x.dtype)
        w = torch.stack([torch.full_like(x[0], v) for v in weights])
        return 0.5 * scale * torch.sum(w * x ** 2)

    def edge_cost(x, u, th, i):
        return 0.5 * r_force * torch.sum(u ** 2)

    spec = ModelSpec(dynamics=dynamics, node_cost=node_cost,
                     edge_cost=edge_cost)
    dims = Dimensions.uniform(num_edges=horizon, state_dim=4, control_dim=1)
    lower, upper = box_bounds(dims, u_lower=-force_limit,
                              u_upper=force_limit, dtype=dtype,
                              device=device)
    initial_state = torch.tensor([0.0, 0.0, math.pi, 0.0], dtype=dtype,
                                 device=device)
    return spec, dims, Topology.chain(horizon), lower, upper, initial_state
