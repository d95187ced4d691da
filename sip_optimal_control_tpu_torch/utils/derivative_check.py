"""Finite-difference derivative checker.

PyTorch port of ``sip_optimal_control_tpu/utils/derivative_check.py``.
The reference's SIP core has a built-in derivative-check mode
(settings.logging.print_derivative_check_logs,
reference: tests/variable_dimensions_test.cpp:432); this is the equivalent
for autodiff or hand-supplied models: compare eval_model's first-order
operators (gradient, C, G, Lagrangian-Hessian H) against central finite
differences of the residual-only evaluation along random directions.
Run in float64 for meaningful tolerances.

Every tensor leads with the scenario batch axis.  The directions are
JAX's: ``np.random.default_rng(seed)``, all directions' x, then u, then
θ, at one scenario's shapes, the same direction for every scenario; the
errors are the largest over the directions and the batch.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..ops.kkt import zero_kkt_vector
from ..solver.sip import OCProblem, Primal, YVec, ZVec, _fd_errors


def check_derivatives(problem: OCProblem, vars: Primal, y: YVec, z: ZVec,
                      eps: float = 1e-6, num_directions: int = 3,
                      seed: int = 0) -> Dict[str, float]:
    """Returns max abs errors for {gradient, jacobian_c, jacobian_g,
    hessian} over the directions and the scenarios of the batch."""
    rng = np.random.default_rng(seed)
    dtype, device = vars.x.dtype, vars.x.device

    def draw(t):
        d = rng.standard_normal((num_directions,) + tuple(t.shape[1:]))
        return torch.as_tensor(d, dtype=dtype, device=device)

    dx, du, dth = draw(vars.x), draw(vars.u), draw(vars.theta)
    ev = problem.eval_model(vars, y, z)
    template = zero_kkt_vector(problem.dims, vars.x.shape[0], dtype, device)
    errs = [0.0] * 4
    for k in range(num_directions):
        d = Primal(x=dx[k].expand(vars.x.shape),
                   u=du[k].expand(vars.u.shape),
                   theta=dth[k].expand(vars.theta.shape))
        errs = [max(a, float(b.max())) for a, b in zip(
            errs, _fd_errors(problem, vars, y, z, ev, template, d, eps))]
    return dict(zip(("gradient", "jacobian_c", "jacobian_g", "hessian"),
                    errs))
