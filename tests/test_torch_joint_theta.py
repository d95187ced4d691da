"""The port's coupled shared-θ solve against the JAX package.

``solve_joint_theta`` solves S scenarios sharing ONE θ as one NLP
(``solve(coupled=True)``).  On tests/test_joint_theta.py's problem (S = 3
double-integrator chains of 4 edges pulled toward a shared setpoint θ) it
must give JAX's ``solve_joint_theta(mesh=None)``: statuses and iterations
identical, θ and the controls at 1e-7 (test_torch_solver.py's bar for the
two packages' different rounding under the dual regularization), θ
bit-identical on every scenario; and it must give the port's own solve of
the equivalent star tree (a zero-state root fanning out to the S chains)
at JAX's oracle bar of 1e-6.
"""

import functools

import numpy as np
import pytest
import jax
import torch

import sip_optimal_control_tpu as J
from sip_optimal_control_tpu.parallel import \
    solve_joint_theta as j_solve_joint_theta
import sip_optimal_control_tpu_torch as P
from sip_optimal_control_tpu_torch.models import double_integrator
from sip_optimal_control_tpu_torch.models.robust_tree import _at
from sip_optimal_control_tpu_torch.solver import fused_chain
from sip_optimal_control_tpu_torch.solver.settings import \
    LineSearchSettings

from test_joint_theta import N_U, N_X, T_H
from test_joint_theta import _joint_pieces as j_joint_pieces

_RTOL = _ATOL = 1e-7
_ORACLE = 1e-6
S = 3
DT = 0.2
SETTINGS = dict(max_iterations=60, tol=1e-10)


def _x0s():
    return np.random.default_rng(0).standard_normal((S, N_X))


def _chain_dynamics(x, u, th, i):
    p, v = x.split(1)
    return torch.cat([p + DT * v, v + DT * u[:1]])


def _node_cost(x, th, i):
    return (0.5 * (x[:1] - th[:1]) ** 2 + 0.05 * x[1:2] ** 2).sum()


def _edge_cost(x, u, th, i):
    return (0.05 * u[:1] ** 2).sum()


def _joint_pieces(**bounds):
    spec = P.ModelSpec(dynamics=_chain_dynamics, node_cost=_node_cost,
                       edge_cost=_edge_cost)
    dims = P.Dimensions.uniform(num_edges=T_H, state_dim=N_X,
                                control_dim=N_U, theta_dim=1)
    lower, upper = P.box_bounds(dims, u_lower=-1.0, u_upper=1.0,
                                device="cpu", **bounds)
    return spec, dims, P.Topology.chain(T_H), lower, upper


@functools.lru_cache(maxsize=None)
def _solves():
    """(JAX's coupled solve as a port SolveResult, the port's)."""
    spec, dims, topo, lower, upper = j_joint_pieces()
    want = jax.jit(lambda b: j_solve_joint_theta(
        spec, dims, topo, b, settings=J.Settings(**SETTINGS), lower=lower,
        upper=upper))(_x0s())
    want = P.from_jax_numpy(P.SolveResult, jax.tree.map(np.asarray, want))
    spec, dims, topo, lower, upper = _joint_pieces()
    got = P.solve_joint_theta(spec, dims, topo, torch.as_tensor(_x0s()),
                              settings=P.Settings(**SETTINGS), lower=lower,
                              upper=upper)
    return want, got


def test_solve_joint_theta_matches_jax():
    want, got = _solves()
    assert got.status.tolist() == [P.SIPStatus.SOLVED] * S
    assert got.status.tolist() == want.status.tolist()
    assert got.iterations.tolist() == want.iterations.tolist()
    for a, b in ((got.vars.theta, want.vars.theta),
                 (got.vars.u, want.vars.u), (got.vars.x, want.vars.x)):
        torch.testing.assert_close(a, b, rtol=_RTOL, atol=_ATOL)


def test_theta_bit_identical_across_scenarios():
    _, got = _solves()
    th = got.vars.theta
    assert bool((th == th[:1]).all()), th
    # the joint problem's status, iterations and error on every scenario
    for t in (got.status, got.iterations, got.kkt_error):
        assert bool((t == t[:1]).all()), t


def _star_tree(x0s):
    """The S scenario chains as ONE problem (tests/test_joint_theta.py's
    oracle): a 0-state root with S edges of control dim 0 whose dynamics
    pin each chain's first node to its initial state, then the chains."""
    parents, children, state_dims, control_dims = [], [], [0], []
    root_edge, edge_x0 = [], []
    nxt = 1
    for s in range(x0s.shape[0]):
        parents.append(0)
        children.append(nxt)
        control_dims.append(0)
        root_edge.append(1.0)
        edge_x0.append(x0s[s])
        state_dims.append(N_X)
        prev, nxt = nxt, nxt + 1
        for _ in range(T_H):
            parents.append(prev)
            children.append(nxt)
            control_dims.append(N_U)
            root_edge.append(0.0)
            edge_x0.append(np.zeros(N_X))
            state_dims.append(N_X)
            prev, nxt = nxt, nxt + 1
    N, E = nxt, len(parents)
    dims = P.Dimensions(theta_dim=1, state_dims=tuple(state_dims),
                        control_dims=tuple(control_dims),
                        node_c_dims=(0,) * N, node_g_dims=(0,) * N,
                        edge_c_dims=(0,) * E, edge_g_dims=(0,) * E)
    t = functools.partial(torch.as_tensor, dtype=torch.float64)
    is_root_edge, x0_table = t(root_edge), t(np.stack(edge_x0))
    is_root_node = t(np.arange(N) == 0)

    def dynamics(x, u, th, i):
        return torch.where(_at(is_root_edge, i) > 0, _at(x0_table, i),
                           _chain_dynamics(x, u, th, i))

    def node_cost(x, th, i):
        return torch.where(_at(is_root_node, i) > 0, 0.0,
                           _node_cost(x, th, i))

    def edge_cost(x, u, th, i):
        return torch.where(_at(is_root_edge, i) > 0, 0.0,
                           _edge_cost(x, u, th, i))

    spec = P.ModelSpec(dynamics=dynamics, node_cost=node_cost,
                       edge_cost=edge_cost)
    lower, upper = P.box_bounds(dims, u_lower=-1.0, u_upper=1.0,
                                device="cpu")
    return spec, dims, P.Topology.tree(0, parents, children), lower, upper


def test_joint_theta_matches_star_tree():
    _, got = _solves()
    spec, dims, topo, lower, upper = _star_tree(_x0s())
    star = P.solve(P.build_problem(spec, dims, topo,
                                   torch.zeros(1, 0, dtype=torch.float64),
                                   lower, upper), P.Settings(**SETTINGS))
    assert star.status.tolist() == [P.SIPStatus.SOLVED]
    torch.testing.assert_close(got.vars.theta[0], star.vars.theta[0],
                               rtol=0, atol=_ORACLE)
    for s in range(S):
        first = s * (T_H + 1) + 1           # scenario s's first chain edge
        torch.testing.assert_close(got.vars.u[s],
                                   star.vars.u[0, first:first + T_H],
                                   rtol=0, atol=_ORACLE)


def test_coupled_requires_unbounded_theta():
    spec, dims, topo, lower, upper = _joint_pieces(theta_lower=-2.0,
                                                   theta_upper=2.0)
    with pytest.raises(ValueError, match="unbounded theta"):
        P.solve_joint_theta(spec, dims, topo,
                            torch.zeros(2, N_X, dtype=torch.float64),
                            settings=P.Settings(max_iterations=3),
                            lower=lower, upper=upper)


def test_coupled_solve_never_takes_the_fused_iteration(monkeypatch):
    """A float32 chain that the fused iteration takes when its scenarios
    are independent takes the standard iteration when they are coupled."""
    spec, dims, topo = double_integrator(horizon=6)
    lower, upper = P.box_bounds(dims, u_lower=-0.5, u_upper=0.5,
                                dtype=torch.float32, device="cpu")
    x0 = torch.tensor([[1.0, 0.0], [0.5, -0.2]])
    prob = P.build_problem(spec, dims, topo, x0, lower, upper)
    settings = P.Settings(max_iterations=3, fused_iteration=True,
                          line_search=LineSearchSettings(fused_probe=True))
    assert fused_chain._eligible(prob, settings)
    assert not fused_chain._eligible(prob, settings, coupled=True)

    def refuse(*args, **kwargs):
        raise AssertionError("solve_fused entered by a coupled solve")

    monkeypatch.setattr(fused_chain, "solve_fused", refuse)
    res = P.solve(prob, settings, coupled=True)
    assert res.status.tolist() == [int(res.status[0])] * 2
    assert bool(torch.isfinite(res.vars.u).all())
