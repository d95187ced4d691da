"""The port's interior-point solver against the JAX package's standard path.

Statuses and iteration counts must be identical.  Iterates are compared at
rtol = atol = 1e-7, not at fp64 roundoff: with the dual regularization
delta = gamma_reg*mu + reg_floor ~ 1e-7, W = delta^{-1/2}(I - F^{-1})
delta^{-1/2} cancels ~7 digits, so the two packages' different rounding
(XLA's contracted multiply-adds vs PyTorch's) shows at ~1e-9 relative in
every Riccati product and reaches ~1e-8 relative in the iterates (measured
on this cartpole case; on well-conditioned LQR data the packages agree to
1e-15, see test_torch_lqr.py).
"""

import numpy as np
import pytest
import jax
import torch

import sip_optimal_control_tpu as J
from sip_optimal_control_tpu.models import cartpole_swingup as j_cartpole
from sip_optimal_control_tpu.models import double_integrator as j_di
from sip_optimal_control_tpu.solver.settings import \
    LineSearchSettings as JLS
import sip_optimal_control_tpu_torch as P
from sip_optimal_control_tpu_torch.models import cartpole_swingup as p_cartpole
from sip_optimal_control_tpu_torch.models import double_integrator as p_di
from sip_optimal_control_tpu_torch.solver.settings import \
    LineSearchSettings as PLS
from sip_optimal_control_tpu_torch._tree import tree_leaves

_RTOL = _ATOL = 1e-7


def _compare(got, jax_result):
    want = P.from_jax_numpy(P.SolveResult,
                            jax.tree.map(np.asarray, jax_result))
    assert got.status.tolist() == want.status.tolist()
    assert got.iterations.tolist() == want.iterations.tolist()
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        torch.testing.assert_close(a, b.to(a.dtype), rtol=_RTOL, atol=_ATOL)


@pytest.mark.parametrize("filter_ls", [True, False])
def test_fixed_trip_cartpole_matches_jax(filter_ls):
    H, batch = 10, 3
    kw = dict(max_iterations=3, fixed_iterations=True)
    ls = dict(use_filter_line_search=filter_ls)
    if filter_ls:
        ls.update(max_steps=6, chunk=6)    # the MPC main path's probe
    rng = np.random.default_rng(0)
    x0s = np.array([0.0, 0.0, np.pi, 0.0]) + 0.1 * rng.standard_normal(
        (batch, 4))

    spec, dims, topo, lo, up, _ = j_cartpole(H)
    settings = J.Settings(**kw, line_search=JLS(**ls))

    def one(x0):
        prob = J.build_problem(spec, dims, topo, x0, lo, up,
                               hessian_mode="gauss_newton")
        return J.solve(prob, settings)

    want = jax.jit(jax.vmap(one))(x0s)

    spec, dims, topo, lo, up, _ = p_cartpole(H, device="cpu")
    prob = P.build_problem(spec, dims, topo, torch.as_tensor(x0s), lo, up,
                           hessian_mode="gauss_newton")
    got = P.solve(prob, P.Settings(**kw, line_search=PLS(**ls)))
    assert got.status.tolist() == [P.SIPStatus.MAX_ITERATIONS] * batch
    _compare(got, want)


def test_while_mode_double_integrator_matches_jax():
    H = 12
    x0s = np.array([[1.0, 0.0], [0.5, -0.2], [-1.0, 0.3]])
    spec, dims, topo = j_di(horizon=H)
    lo, up = J.box_bounds(dims, u_lower=-0.5, u_upper=0.5)

    def one(x0):
        return J.solve(J.build_problem(spec, dims, topo, x0, lo, up),
                       J.Settings())

    want = jax.jit(jax.vmap(one))(x0s)

    spec, dims, topo = p_di(horizon=H)
    lo, up = P.box_bounds(dims, u_lower=-0.5, u_upper=0.5,
                            device="cpu")
    got = P.solve(P.build_problem(spec, dims, topo, torch.as_tensor(x0s),
                                  lo, up), P.Settings())
    assert got.status.tolist() == [P.SIPStatus.SOLVED] * 3
    _compare(got, want)


def test_analytic_two_node_problem():
    """min 0.5 x0^2 + 0.5 (x1-2)^2 + 0.5 u^2  s.t. x1 = x0 + u, x0 = 1.
    Optimum: x = (1.0, 1.5), u = 0.5 (tests/test_sip.py's bar, 1e-8)."""
    dims = P.Dimensions.uniform(num_edges=1, state_dim=1, control_dim=1)
    spec = P.ModelSpec(
        dynamics=lambda x, u, th, i: x + u,
        node_cost=lambda x, th, i: torch.where(
            i == 0, 0.5 * x[0] ** 2, 0.5 * (x[0] - 2.0) ** 2),
        edge_cost=lambda x, u, th, i: 0.5 * u[0] ** 2)
    prob = P.build_problem(spec, dims, P.Topology.chain(1),
                           torch.tensor([[1.0]], dtype=torch.float64))
    result = P.solve(prob, P.Settings())
    assert result.status.tolist() == [P.SIPStatus.SOLVED]
    np.testing.assert_allclose(result.vars.x[0, :, 0].numpy(), [1.0, 1.5],
                               atol=1e-8)
    np.testing.assert_allclose(result.vars.u[0, 0, 0].item(), 0.5, atol=1e-8)


def test_settings_guards_and_logs(capsys):
    from sip_optimal_control_tpu_torch.solver.settings import LoggingSettings
    spec, dims, topo = p_di(horizon=3)
    prob = P.build_problem(spec, dims, topo,
                           torch.ones(1, 2, dtype=torch.float64))
    with pytest.raises(ValueError):
        P.solve(prob, P.Settings(fixed_iterations=True, max_iterations=0))
    # the debug channels print per-scenario values (the derivative check
    # one line per solve) and change nothing
    quiet = P.solve(prob, P.Settings(max_iterations=2,
                                     fixed_iterations=True))
    loud = P.solve(prob, P.Settings(
        max_iterations=2, fixed_iterations=True, debug_check_finite=True,
        logging=LoggingSettings(print_logs=True,
                                print_line_search_logs=True,
                                print_search_direction_logs=True,
                                print_derivative_check_logs=True)))
    out = capsys.readouterr().out
    assert out.count("it=[") == 2 and "ls: alpha=" in out \
        and "dir: |dx|=" in out and "NONFINITE" not in out
    assert out.count("derivative check (central FD") == 1
    for a, b in zip(tree_leaves(quiet), tree_leaves(loud)):
        assert torch.equal(a, b)
