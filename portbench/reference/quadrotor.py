"""Plain planar quadrotor tracking: Euler-discretized rigid-body dynamics
with two rotor thrusts as deltas from hover, quadratic tracking costs, a box
on the thrusts.  Written from the model's equations (BASELINE.json config 4,
the reference's quadrotor tracking); imports nothing of the program."""

from __future__ import annotations

import math

import torch

from .sip import Model


def build(args: dict, dtype, device) -> tuple:
    """(Model, hover state [6]) for ``args``, the configuration's
    ``model_args`` (``horizon``, ``target``; the rest at the published
    defaults)."""
    T = args["horizon"]
    dt, mass = args.get("dt", 0.05), args.get("mass", 0.5)
    inertia, arm = args.get("inertia", 0.01), args.get("arm", 0.17)
    gravity, thrust_max = args.get("gravity", 9.81), args.get(
        "thrust_max", 5.0)
    q_pos, q_att = args.get("q_pos", 4.0), args.get("q_att", 1.0)
    q_vel, r_thrust = args.get("q_vel", 0.2), args.get("r_thrust", 0.05)
    qf = args.get("qf", 10.0)
    target = args.get("target") or (0.0, 0.0)
    setpoint = torch.tensor(list(target) + [0.0] * 4, dtype=dtype,
                            device=device)
    w = torch.tensor([q_pos, q_pos, q_att, q_vel, q_vel, q_vel], dtype=dtype,
                     device=device)
    hover = 0.5 * mass * gravity

    def dynamics(s, u):
        _, _, phi, vx, vz, phidot = s.split(1)
        u1, u2 = u[:1] + hover, u[1:2] + hover
        thrust = u1 + u2
        acc_x = -thrust * torch.sin(phi) / mass
        acc_z = thrust * torch.cos(phi) / mass - gravity
        acc_phi = arm * (u1 - u2) / inertia
        return s + dt * torch.cat([vx, vz, phidot, acc_x, acc_z, acc_phi])

    def node_cost(s, scale):
        err = s - setpoint.to(s.dtype)
        return 0.5 * scale * torch.sum(w.to(s.dtype) * err ** 2)

    def edge_cost(s, u):
        return 0.5 * r_thrust * torch.sum(u ** 2)

    scale = torch.ones(T + 1, dtype=dtype, device=device)
    scale[T] = qf
    inf = torch.full((6,), math.inf, dtype=dtype, device=device)
    model = Model(n=6, m=2, T=T, dynamics=dynamics, node_cost=node_cost,
                  edge_cost=edge_cost, node_scale=scale, x_lower=-inf,
                  x_upper=inf,
                  u_lower=torch.full((2,), -hover, dtype=dtype,
                                     device=device),
                  u_upper=torch.full((2,), thrust_max - hover, dtype=dtype,
                                     device=device))
    return model, torch.zeros(6, dtype=dtype, device=device)
