"""Plain cartpole swing-up: RK4 cartpole dynamics, quadratic costs, a box on
the force.  Written from the model's equations (BASELINE.json config 3, the
reference's cartpole swing-up); imports nothing of the program."""

from __future__ import annotations

import math

import torch

from .sip import Model


def build(args: dict, dtype, device) -> tuple:
    """(Model, start state [4]) for ``args``, the configuration's
    ``model_args`` (``horizon``; the rest at the published defaults)."""
    T = args["horizon"]
    dt = args.get("dt", 0.05)
    f_max = args.get("force_limit", 10.0)
    q_pos, q_angle = args.get("q_pos", 0.1), args.get("q_angle", 1.0)
    q_vel, r_force = args.get("q_vel", 0.05), args.get("r_force", 0.05)
    qf = args.get("qf", 50.0)
    m_cart, m_pole, length, gravity = 1.0, 0.1, 0.5, 9.81
    w = torch.tensor([q_pos, q_vel, q_angle, q_vel], dtype=dtype,
                     device=device)

    def ode(s, force):
        # state [p, pdot, theta, thetadot], theta from upright; 1-element
        # slices keep forward-mode tangents in the state's dtype
        _, pdot, th, thdot = s.split(1)
        total = m_cart + m_pole
        sin, cos = torch.sin(th), torch.cos(th)
        tmp = (force + m_pole * length * thdot ** 2 * sin) / total
        th_acc = (gravity * sin - cos * tmp) / (
            length * (4.0 / 3.0 - m_pole * cos ** 2 / total))
        p_acc = tmp - m_pole * length * th_acc * cos / total
        return torch.cat([pdot, p_acc, thdot, th_acc])

    def dynamics(x, u):
        f = u[:1]
        k1 = ode(x, f)
        k2 = ode(x + 0.5 * dt * k1, f)
        k3 = ode(x + 0.5 * dt * k2, f)
        k4 = ode(x + dt * k3, f)
        return x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)

    def node_cost(x, scale):
        return 0.5 * scale * torch.sum(w.to(x.dtype) * x ** 2)

    def edge_cost(x, u):
        return 0.5 * r_force * torch.sum(u ** 2)

    scale = torch.ones(T + 1, dtype=dtype, device=device)
    scale[T] = qf
    inf = torch.full((4,), math.inf, dtype=dtype, device=device)
    model = Model(n=4, m=1, T=T, dynamics=dynamics, node_cost=node_cost,
                  edge_cost=edge_cost, node_scale=scale, x_lower=-inf,
                  x_upper=inf,
                  u_lower=torch.full((1,), -f_max, dtype=dtype,
                                     device=device),
                  u_upper=torch.full((1,), f_max, dtype=dtype,
                                     device=device))
    start = torch.tensor([0.0, 0.0, math.pi, 0.0], dtype=dtype,
                         device=device)
    return model, start
