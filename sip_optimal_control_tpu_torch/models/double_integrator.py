"""Double-integrator LQR benchmark model (BASELINE config 1; the problem
family of the reference's chain benchmarks, lqr_benchmark.cpp:47-99).

PyTorch port of ``sip_optimal_control_tpu/models/double_integrator.py``.
"""

from __future__ import annotations

import torch

from ..model import ModelSpec
from ..types import Dimensions, Topology


def double_integrator(horizon: int = 20, dt: float = 0.1, q: float = 1.0,
                      r: float = 0.1, qf: float = 10.0):
    """Returns (spec, dims, topology).  2 states (pos, vel), 1 control."""
    # x' = A x + B u with A = [[1, dt], [0, 1]], B = [[dt^2 / 2], [dt]]
    # 1-element slices keep forward-mode tangents in the state's dtype
    # (a 0-dim tensor times a Python float gets a float64 tangent)
    def dynamics(x, u, th, i):
        p, v = x.split(1)
        return torch.cat([p + dt * v + 0.5 * dt * dt * u[:1],
                          v + dt * u[:1]])

    spec = ModelSpec(
        dynamics=dynamics,
        node_cost=lambda x, th, i: 0.5 * torch.where(
            i == horizon, qf, q).to(x.dtype) * torch.sum(x ** 2),
        edge_cost=lambda x, u, th, i: 0.5 * r * torch.sum(u ** 2),
    )
    dims = Dimensions.uniform(num_edges=horizon, state_dim=2, control_dim=1)
    return spec, dims, Topology.chain(horizon)
