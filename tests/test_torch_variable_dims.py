"""Variable stage dimensions and stage-varying constraints through the
port's model front door against the JAX package (BASELINE config 2).

The three problems of tests/test_variable_dims_frontdoor.py (:21, :86,
:131), float64, one scenario: statuses and iteration counts identical,
iterates within 1e-7 of JAX's (that file's bar between the variable-dims
problem and its uniform equivalent), the dead (padded) entries exactly 0,
and the constrained problem's cap, pin (1e-6) and bounds as that file
asserts.  The port solves each on every Riccati backend ("cuda" on CPU
tensors runs the kernels' plain twins with the padded rows' per-row
delta); JAX on its default "scan".  The growing-state and constrained
problems are chip_smoke.py's, which phase 10 runs at horizon 50 on the
card.
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import sip_optimal_control_tpu as J
import sip_optimal_control_tpu_torch as P

import chip_smoke

_ATOL = 1e-7
_DT = 0.1
BACKENDS = ("scan", "cuda", "assoc")


def _jax_dims(state_dims, control_dims, node_c=None, node_g=None):
    N, E = len(state_dims), len(control_dims)
    return J.Dimensions(theta_dim=0, state_dims=tuple(state_dims),
                        control_dims=tuple(control_dims),
                        node_c_dims=tuple(node_c or (0,) * N),
                        node_g_dims=tuple(node_g or (0,) * N),
                        edge_c_dims=(0,) * E, edge_g_dims=(0,) * E)


def _jax_solve(spec, dims, T, x0, max_iterations, lower=None, upper=None):
    prob = J.build_problem(spec, dims, J.Topology.chain(T),
                           initial_state=jnp.asarray(x0), lower=lower,
                           upper=upper)
    res = jax.jit(lambda: J.solve(prob, J.Settings(
        max_iterations=max_iterations)))()
    return jax.tree.map(np.asarray, res)


def _port_solve(problem, x0, max_iterations, backend):
    spec, dims, topo, lower, upper = problem
    prob = P.build_problem(spec, dims, topo,
                           torch.tensor([x0], dtype=torch.float64), lower,
                           upper)
    return P.solve(prob, P.Settings(max_iterations=max_iterations,
                                    riccati_backend=backend))


def _compare(got, want):
    assert got.status.tolist() == [int(want.status)]
    assert got.iterations.tolist() == [int(want.iterations)]
    np.testing.assert_allclose(got.vars.x[0].numpy(), want.vars.x,
                               atol=_ATOL)
    np.testing.assert_allclose(got.vars.u[0].numpy(), want.vars.u,
                               atol=_ATOL)


GROW_T = 6


@functools.lru_cache(maxsize=None)
def _jax_growing():
    grow_at = GROW_T // 2

    def dyn(x, u, th, i):
        return jnp.stack([x[0] + _DT * x[1], x[1] + _DT * u[0],
                          x[2] + _DT * x[0]])

    def cost_node(x, th, i):
        return 0.5 * (x[0] ** 2 + 0.1 * x[1] ** 2
                      + jnp.where(i >= grow_at, 0.5 * x[2] ** 2, 0.0))

    spec = J.ModelSpec(dynamics=dyn, node_cost=cost_node,
                       edge_cost=lambda x, u, th, i: 0.05 * jnp.sum(u ** 2))
    dims = _jax_dims([2 if k < grow_at else 3 for k in range(GROW_T + 1)],
                     [1] * GROW_T)
    return _jax_solve(spec, dims, GROW_T, [1.0, 0.0], 60)


@pytest.mark.parametrize("backend", BACKENDS)
def test_growing_state_matches_jax(backend):
    want = _jax_growing()
    assert int(want.status) == J.SIPStatus.SOLVED
    got = _port_solve(chip_smoke.growing_state_problem(GROW_T), [1.0, 0.0],
                      60, backend)
    _compare(got, want)
    # the dead z entries of the early nodes are exactly zero
    assert torch.all(got.vars.x[0, :GROW_T // 2, 2] == 0.0)


CTRL_T = 6


def _control_dims():
    return [2 if e % 2 == 1 else 1 for e in range(CTRL_T)]


@functools.lru_cache(maxsize=None)
def _jax_controls():
    def dyn(x, u, th, i):
        gain2 = jnp.where(i % 2 == 1, 1.0, 0.0)
        return jnp.stack([x[0] + _DT * x[1],
                          x[1] + _DT * (u[0] + gain2 * u[1])])

    spec = J.ModelSpec(dynamics=dyn,
                       node_cost=lambda x, th, i: 0.5 * jnp.sum(x ** 2),
                       edge_cost=lambda x, u, th, i: 0.05 * jnp.sum(u ** 2))
    dims = _jax_dims([2] * (CTRL_T + 1), _control_dims())
    return _jax_solve(spec, dims, CTRL_T, [1.0, 0.0], 60)


def _port_controls():
    def dyn(x, u, th, i):
        gain2 = torch.where(i % 2 == 1, 1.0, 0.0)
        return torch.cat([x[:1] + _DT * x[1:2],
                          x[1:2] + _DT * (u[:1] + gain2 * u[1:2])])

    spec = P.ModelSpec(dynamics=dyn,
                       node_cost=lambda x, th, i: 0.5 * (x ** 2).sum(),
                       edge_cost=lambda x, u, th, i: 0.05 * (u ** 2).sum())
    return (spec, chip_smoke._stage_dims([2] * (CTRL_T + 1), _control_dims()),
            P.Topology.chain(CTRL_T), None, None)


@pytest.mark.parametrize("backend", BACKENDS)
def test_varying_control_dims_match_jax(backend):
    want = _jax_controls()
    assert int(want.status) == J.SIPStatus.SOLVED
    got = _port_solve(_port_controls(), [1.0, 0.0], 60, backend)
    _compare(got, want)
    # the dead second controls of the even edges are exactly zero
    assert torch.all(got.vars.u[0, 0::2, 1] == 0.0)


CON_T = 5


@functools.lru_cache(maxsize=None)
def _jax_constrained():
    spec = J.ModelSpec(
        dynamics=lambda x, u, th, i: jnp.stack(
            [x[0] + _DT * x[1], x[1] + _DT * u[0]]),
        node_cost=lambda x, th, i: 0.5 * jnp.sum(x ** 2),
        edge_cost=lambda x, u, th, i: 0.05 * jnp.sum(u ** 2),
        node_ineq=lambda x, th, i: jnp.stack([x[1] - 0.6]),
        node_eq=lambda x, th, i: jnp.stack([x[0] - 0.5]))
    N = CON_T + 1
    dims = _jax_dims([2] * N, [1] * CON_T,
                     node_c=[1 if k == CON_T else 0 for k in range(N)],
                     node_g=[1 if k == 2 else 0 for k in range(N)])
    lower, upper = J.box_bounds(dims, u_lower=-20.0, u_upper=20.0)
    return _jax_solve(spec, dims, CON_T, [0.0, 0.0], 80, lower, upper)


@pytest.mark.parametrize("backend", BACKENDS)
def test_stage_varying_constraints_match_jax(backend):
    want = _jax_constrained()
    assert int(want.status) == J.SIPStatus.SOLVED
    got = _port_solve(chip_smoke.constrained_problem(
        CON_T, torch.float64, "cpu"), [0.0, 0.0], 80, backend)
    _compare(got, want)
    x = got.vars.x[0].numpy()
    assert x[2, 1] <= chip_smoke.CAP + 1e-6      # the one active-stage cap
    assert abs(x[CON_T, 0] - chip_smoke.PIN) < 1e-6   # terminal equality
    assert np.all(np.abs(got.vars.u.numpy()) <= chip_smoke.U_MAX + 1e-7)
    # the cap exists only at node 2: other nodes may exceed it
    assert np.any(x[[1, 3, 4], 1] > chip_smoke.CAP)
