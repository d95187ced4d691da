"""The port's solver on tests/test_solver_extras.py's constrained and
nonconvex cases against the JAX package.

Float64, one scenario each: the binary scenario tree with input bounds
(:106), the infeasible terminal equality that must end DIVERGED (:138) and
the double-well seeded near its saddle under both line searches (:250).
Statuses and iteration counts identical to JAX's; iterates within 1e-7 of
JAX's (tests/test_torch_solver.py's bar for the two packages' rounding
under the dual regularization), and each case's own assertions.
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import sip_optimal_control_tpu as J
from sip_optimal_control_tpu.solver.settings import \
    LineSearchSettings as JLS
import sip_optimal_control_tpu_torch as P
from sip_optimal_control_tpu_torch.models.robust_tree import _at
from sip_optimal_control_tpu_torch.solver.settings import \
    LineSearchSettings as PLS

_ATOL = 1e-7
_DT = 0.1


def _jax_run(spec, dims, topo, x0, settings, lower=None, upper=None,
             hessian_mode="exact"):
    prob = J.build_problem(spec, dims, topo, initial_state=jnp.asarray(x0),
                           lower=lower, upper=upper,
                           hessian_mode=hessian_mode)
    return jax.tree.map(np.asarray, jax.jit(lambda: J.solve(prob,
                                                            settings))())


def _port_run(spec, dims, topo, x0, settings, lower=None, upper=None,
              hessian_mode="exact"):
    prob = P.build_problem(spec, dims, topo,
                           torch.tensor([x0], dtype=torch.float64), lower,
                           upper, hessian_mode=hessian_mode)
    return P.solve(prob, settings)


def _compare(got, want):
    assert got.status.tolist() == [int(want.status)]
    assert got.iterations.tolist() == [int(want.iterations)]
    for a, b in ((got.vars.x, want.vars.x), (got.vars.u, want.vars.u)):
        np.testing.assert_allclose(a[0].numpy(), b, atol=_ATOL)


TREE_PARENTS = [0, 1, 2, 2, 3, 5, 4, 7]
TREE_CHILDREN = [1, 2, 3, 4, 5, 6, 7, 8]
DRIFT = [0.0, 0.0, 0.0, 0.0, 0.05, 0.05, -0.05, -0.05]


def test_binary_scenario_tree_with_bounds_matches_jax():
    """Branching at an interior node (shared first stage) + input bounds;
    the edge drift indexed by the stage index."""
    E = len(TREE_PARENTS)
    A = np.array([[1.0, _DT], [0.0, 1.0]])
    B1 = np.array([[0.0], [_DT]])
    jA, jB, jdrift = jnp.asarray(A), jnp.asarray(B1), jnp.asarray(DRIFT)
    jspec = J.ModelSpec(
        dynamics=lambda x, u, th, i: (jA @ x + jB @ u
                                      + jdrift[i] * jnp.asarray([1.0, 0.0])),
        node_cost=lambda x, th, i: 0.5 * jnp.sum(x ** 2),
        edge_cost=lambda x, u, th, i: 0.5 * 0.05 * jnp.sum(u ** 2))
    jdims = J.Dimensions.uniform(num_edges=E, state_dim=2, control_dim=1)
    jlo, jup = J.box_bounds(jdims, u_lower=-2.0, u_upper=2.0)
    want = _jax_run(jspec, jdims,
                    J.Topology.tree(0, TREE_PARENTS, TREE_CHILDREN),
                    [2.0, 0.0], J.Settings(max_iterations=80), jlo, jup)
    assert int(want.status) == J.SIPStatus.SOLVED

    pA, pB = torch.as_tensor(A), torch.as_tensor(B1)
    pdrift = torch.as_tensor(DRIFT, dtype=torch.float64)
    push = torch.tensor([1.0, 0.0], dtype=torch.float64)
    spec = P.ModelSpec(
        dynamics=lambda x, u, th, i: pA @ x + pB @ u + _at(pdrift, i) * push,
        node_cost=lambda x, th, i: 0.5 * (x ** 2).sum(),
        edge_cost=lambda x, u, th, i: 0.5 * 0.05 * (u ** 2).sum())
    dims = P.Dimensions.uniform(num_edges=E, state_dim=2, control_dim=1)
    lo, up = P.box_bounds(dims, u_lower=-2.0, u_upper=2.0, device="cpu")
    got = _port_run(spec, dims, P.Topology.tree(0, TREE_PARENTS,
                                                TREE_CHILDREN),
                    [2.0, 0.0], P.Settings(max_iterations=80), lo, up)
    _compare(got, want)
    assert torch.all(got.vars.u.abs() <= 2.0 + 1e-8)


INF_T = 5


def test_infeasible_problem_reports_diverged_as_jax():
    """An unreachable terminal equality under tight input bounds: DIVERGED
    well before the iteration budget, at JAX's iteration."""
    jspec = J.ModelSpec(
        dynamics=lambda x, u, th, i: jnp.stack(
            [x[0] + _DT * x[1], x[1] + _DT * u[0]]),
        node_cost=lambda x, th, i: 0.5 * jnp.sum(x ** 2),
        edge_cost=lambda x, u, th, i: 0.05 * jnp.sum(u ** 2),
        node_eq=lambda x, th, i: jnp.where(i == INF_T, x[0] - 0.1,
                                           0.0)[None])
    jdims = J.Dimensions.uniform(num_edges=INF_T, state_dim=2, control_dim=1,
                                 node_c_dim=1)
    jlo, jup = J.box_bounds(jdims, u_lower=-3.0, u_upper=3.0)
    settings = dict(max_iterations=200, diverged_kkt=1e4)
    want = _jax_run(jspec, jdims, J.Topology.chain(INF_T), [1.0, 0.0],
                    J.Settings(**settings), jlo, jup)
    assert int(want.status) == J.SIPStatus.DIVERGED

    spec = P.ModelSpec(
        dynamics=lambda x, u, th, i: torch.cat(
            [x[:1] + _DT * x[1:2], x[1:2] + _DT * u[:1]]),
        node_cost=lambda x, th, i: 0.5 * (x ** 2).sum(),
        edge_cost=lambda x, u, th, i: 0.05 * (u ** 2).sum(),
        node_eq=lambda x, th, i: torch.where(i == INF_T, x[:1] - 0.1, 0.0))
    dims = P.Dimensions.uniform(num_edges=INF_T, state_dim=2, control_dim=1,
                                node_c_dim=1)
    lo, up = P.box_bounds(dims, u_lower=-3.0, u_upper=3.0, device="cpu")
    got = _port_run(spec, dims, P.Topology.chain(INF_T), [1.0, 0.0],
                    P.Settings(**settings), lo, up)
    assert got.status.tolist() == [P.SIPStatus.DIVERGED]
    assert got.iterations.tolist() == [int(want.iterations)]
    assert int(got.iterations[0]) < 200


SADDLE_T = 12


@functools.lru_cache(maxsize=None)
def _jax_saddle(use_filter):
    spec = J.ModelSpec(
        dynamics=lambda x, u, th, i: jnp.stack(
            [x[0] + 0.2 * x[1] + 0.05 * jnp.sin(x[0]), x[1] + 0.2 * u[0]]),
        node_cost=lambda x, th, i: (0.25 * (x[0] ** 2 - 1.0) ** 2
                                    + 0.5 * x[1] ** 2),
        edge_cost=lambda x, u, th, i: 0.05 * jnp.sum(u ** 2))
    dims = J.Dimensions.uniform(num_edges=SADDLE_T, state_dim=2,
                                control_dim=1)
    return _jax_run(spec, dims, J.Topology.chain(SADDLE_T), [0.05, 0.0],
                    J.Settings(max_iterations=120, tol=1e-7,
                               line_search=JLS(
                                   use_filter_line_search=use_filter)))


@pytest.mark.parametrize("use_filter", [False, True])
def test_nonconvex_saddle_matches_jax(use_filter):
    """A double well seeded near its concave saddle, exact Hessian: the
    step-rejection safeguard drives both line searches to a well, along
    JAX's iterates."""
    want = _jax_saddle(use_filter)
    assert int(want.status) == J.SIPStatus.SOLVED
    spec = P.ModelSpec(
        dynamics=lambda x, u, th, i: torch.cat(
            [x[:1] + 0.2 * x[1:2] + 0.05 * torch.sin(x[:1]),
             x[1:2] + 0.2 * u[:1]]),
        node_cost=lambda x, th, i: (0.25 * (x[:1] ** 2 - 1.0) ** 2
                                    + 0.5 * x[1:2] ** 2).sum(),
        edge_cost=lambda x, u, th, i: 0.05 * (u ** 2).sum())
    dims = P.Dimensions.uniform(num_edges=SADDLE_T, state_dim=2,
                                control_dim=1)
    got = _port_run(spec, dims, P.Topology.chain(SADDLE_T), [0.05, 0.0],
                    P.Settings(max_iterations=120, tol=1e-7,
                               line_search=PLS(
                                   use_filter_line_search=use_filter)))
    _compare(got, want)
    # the trajectory tail settles into a well, not the saddle
    assert abs(abs(float(got.vars.x[0, -1, 0])) - 1.0) < 0.2
