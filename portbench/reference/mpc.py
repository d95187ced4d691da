"""Plain reference of one warm-started MPC period for a batch of plants.

The period that ``mpc_steps(..., steps=1, noise=0)`` runs, written out
again: solve every plant's horizon problem from its state, warm-started;
apply the first control of a usable solution (SOLVED, or MAX_ITERATIONS
with a KKT error below 1e2, everything finite) and zero control otherwise;
step the plant model; shift the solution one stage forward into the next
warm start, or restart an unusable scenario from the constant trajectory at
its new state with zero multipliers.
"""

from __future__ import annotations

import torch

from .sip import MAX_ITERATIONS, SOLVED, Arith, Model, Problem, _rows, solve

KKT_RESET = 1e2


def period(model: Model, settings: dict, hessian_mode: str, x, wx, wu, wy,
           arith: Arith) -> dict:
    """One period from plant states x [B, n] and the warm start (wx, wu,
    wy); returns the next plant state (before any disturbance), the next
    warm start, and the solve's status, KKT error and iterations."""
    res = solve(Problem(model, x, hessian_mode, arith), settings, wx, wu, wy)
    usable = ((res["status"] == SOLVED)
              | ((res["status"] == MAX_ITERATIONS)
                 & (res["kkt"] < KKT_RESET))) \
        & torch.isfinite(res["kkt"]) \
        & torch.isfinite(res["x"]).flatten(1).all(-1) \
        & torch.isfinite(res["u"]).flatten(1).all(-1)
    u0 = torch.where(usable[:, None], res["u"][:, 0], 0.0)
    x_next = _rows(model.dynamics, x, u0)

    def shift(a):
        return torch.cat([a[:, 1:], a[:, -1:]], dim=1)

    keep = usable[:, None, None]
    return dict(
        x=x_next,
        wx=torch.where(keep, shift(res["x"]), x_next[:, None]),
        wu=torch.where(keep, shift(res["u"]), 0.0),
        wy=torch.where(keep, shift(res["y"]), 0.0),
        status=res["status"], kkt=res["kkt"],
        iterations=res["iterations"])
