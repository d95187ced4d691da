"""The port's θ (shared-parameter) path against the JAX package.

The θ Schur step of the KKT layer on the data of tests/test_kkt.py's θ
cases (a tree with variable dims and θ = 2, a chain with θ = 3): solutions
and operators against JAX's, and the round trip ||K sol - rhs||, at that
file's 1e-8.  The θ derivative blocks of ``build_problem`` at
test_torch_model.py's 1e-10.  The solve of
tests/test_solver_extras.py::test_theta_estimated_jointly: statuses and
iterations identical, iterates at rtol = atol = 1e-7, test_torch_solver.py's
bar (the dual regularization's cancellation shows the two packages'
different rounding at ~1e-8 relative).
"""

import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import sip_optimal_control_tpu as J
from sip_optimal_control_tpu.ops import kkt as JK
import sip_optimal_control_tpu_torch as P
from sip_optimal_control_tpu_torch.ops import kkt as PK
from sip_optimal_control_tpu_torch.solver.sip import ModelEval
from sip_optimal_control_tpu_torch._tree import tree_leaves

from test_kkt import make_regs, random_rhs, synthetic_model

_KKT_TOL = 1e-8
_MODEL_TOL = 1e-10
_RTOL = _ATOL = 1e-7

KKT_CASES = {
    # tests/test_kkt.py::test_schur_theta_variables
    "tree_variable_dims": (
        dict(theta_dim=2, state_dims=(2, 1, 3), control_dims=(1, 2),
             node_c_dims=(1, 0, 1), node_g_dims=(0, 1, 1),
             edge_c_dims=(1, 2), edge_g_dims=(2, 1)),
        (0, [0, 0], [1, 2]), 13),
    # tests/test_kkt.py::test_theta_on_chain
    "chain": (
        dict(theta_dim=3, state_dims=(3,) * 6, control_dims=(2,) * 5,
             node_c_dims=(1,) * 6, node_g_dims=(1,) * 6,
             edge_c_dims=(1,) * 5, edge_g_dims=(1,) * 5),
        None, 15),
}


def _stack(trees):
    """Per-scenario JAX containers -> one batched numpy container."""
    return jax.tree.map(lambda *a: np.stack([np.asarray(x) for x in a]),
                        *trees)


_OPERATORS = ("apply_H", "apply_C", "apply_CT", "apply_G", "apply_GT")


@functools.lru_cache(maxsize=None)
def _kkt_case(case):
    """The case's two scenarios (its seed and seed + 100) as port
    containers, and JAX's factor status, solution and operator products on
    them (one jitted, vmapped program)."""
    dims_kw, tree, seed = KKT_CASES[case]
    jdims, pdims = J.Dimensions(**dims_kw), P.Dimensions(**dims_kw)
    if tree is None:
        jtopo = J.Topology.chain(jdims.num_edges)
        ptopo = P.Topology.chain(jdims.num_edges)
    else:
        jtopo, ptopo = J.Topology.tree(*tree), P.Topology.tree(*tree)
    jsched = J.compile_topology(jtopo)
    jmasks = JK.ConstraintMasks.build(jdims)
    scenarios = []
    for s in (seed, seed + 100):
        rng = np.random.default_rng(s)
        scenarios.append((synthetic_model(jdims, jtopo, rng),
                          make_regs(jdims, jmasks, rng),
                          random_rhs(jdims, jmasks, rng)))
    model, regs, rhs = (_stack(parts) for parts in zip(*scenarios))

    def run(model, regs, rhs):
        fact = JK.kkt_factor(model, regs, jmasks, jsched)
        return (fact.status, JK.kkt_solve(fact, model, rhs, jsched),
                [getattr(JK, name)(model, rhs, jsched)
                 for name in _OPERATORS])

    status, sol, ops = jax.tree.map(
        np.asarray, jax.jit(jax.vmap(run))(model, regs, rhs))
    port = (P.from_jax_numpy(PK.StageModelData, model),
            P.from_jax_numpy(PK.Regularizations, regs),
            P.from_jax_numpy(PK.KKTVector, rhs))
    want = (status, P.from_jax_numpy(PK.KKTVector, sol),
            [P.from_jax_numpy(PK.KKTVector, o) for o in ops])
    return (P.compile_topology(ptopo), PK.ConstraintMasks.build(pdims),
            port, want)


@pytest.mark.parametrize("case", sorted(KKT_CASES))
def test_theta_schur_factor_solve_matches_jax(case):
    sched, masks, (model, regs, rhs), (status, want, _) = _kkt_case(case)
    assert status.tolist() == [0, 0]
    fact = PK.kkt_factor(model, regs, masks, sched)
    assert fact.status.tolist() == [0, 0]
    p = model.Hthth_node.shape[-1]
    assert tuple(fact.theta_schur_chol.shape) == (2, p, p)
    sol = PK.kkt_solve(fact, model, rhs, sched)
    for f in dataclasses.fields(sol):
        torch.testing.assert_close(getattr(sol, f.name), getattr(want, f.name),
                                   rtol=_KKT_TOL, atol=_KKT_TOL, msg=f.name)
    resid = (PK.apply_K(model, regs, sol, sched) - rhs).norm()
    assert float(resid.max()) < _KKT_TOL, resid


@pytest.mark.parametrize("case", sorted(KKT_CASES))
def test_theta_operators_match_jax(case):
    sched, _, (model, _, v), (_, _, ops) = _kkt_case(case)
    theta_only = dataclasses.replace(PK.zero_like(v), theta=v.theta)
    for name, want in zip(_OPERATORS, ops):
        got = getattr(PK, name)(model, v, sched)
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            torch.testing.assert_close(a, b, rtol=_KKT_TOL, atol=_KKT_TOL,
                                       msg=name)
        if name in ("apply_H", "apply_C", "apply_G"):
            # a θ-only direction reaches the θ columns
            assert float(getattr(PK, name)(model, theta_only, sched)
                         .norm().min()) > 0, name


def _theta_model(pkg, xp):
    """Dynamics, costs and all four constraint kinds depending on θ (p=2),
    n=2, m=1, horizon 4."""
    H = 4

    def dyn(x, u, th, i):
        return xp.concatenate([x[:1] + 0.1 * x[1:2] + 0.05 * th[:1] * u[:1],
                               x[1:2] + 0.1 * u[:1] + 0.02 * th[1:2] ** 2])

    spec = pkg.ModelSpec(
        dynamics=dyn,
        node_cost=lambda x, th, i: (0.5 * (x - th) ** 2).sum()
        + (0.3 * th[:1] * th[1:2] * x[:1]).sum(),
        edge_cost=lambda x, u, th, i: (0.05 * u ** 2 * (1.0 + th[:1] ** 2)
                                       + 0.1 * u * x[1:2] * th[1:2]).sum(),
        node_eq=lambda x, th, i: x[:1] * th[1:2] - 0.1,
        node_ineq=lambda x, th, i: xp.concatenate(
            [x[1:2] * th[:1] - 1.0, xp.sin(th[1:2]) + x[:1] ** 2 - 2.0]),
        edge_eq=lambda x, u, th, i: u[:1] * th[:1] + x[1:2] - 0.2,
        edge_ineq=lambda x, u, th, i: u[:1] ** 2 * th[1:2] - 1.0)
    dims = pkg.Dimensions.uniform(num_edges=H, state_dim=2, control_dim=1,
                                  node_c_dim=1, node_g_dim=2, edge_c_dim=1,
                                  edge_g_dim=1, theta_dim=2)
    return spec, dims, pkg.Topology.chain(H)


@pytest.mark.parametrize("mode", ["gauss_newton", "exact"])
def test_theta_model_blocks_match_jax(mode):
    js, jd, jt = _theta_model(J, jnp)
    ps, pd, pt = _theta_model(P, torch)
    B = 2
    N, E, n, m, p = jd.num_nodes, jd.num_edges, 2, 1, 2
    rng = np.random.default_rng(3)
    x0 = rng.standard_normal((B, n))
    X, U = rng.standard_normal((B, N, n)), rng.standard_normal((B, E, m))
    TH = rng.standard_normal((B, p))
    Y = rng.standard_normal((B, N, n))
    Ync, Yec = rng.standard_normal((B, N, 1)), rng.standard_normal((B, E, 1))
    Zn, Ze = rng.random((B, N, 2)), rng.random((B, E, 1))

    def jev(x0_, x, u, th, y, ync, yec, zn, ze):
        prob = J.build_problem(js, jd, jt, x0_, hessian_mode=mode)
        return prob.eval_model(J.solver.Primal(x, u, th),
                               J.YVec(y, ync, yec), J.ZVec(zn, ze))

    want = jax.jit(jax.vmap(jev))(x0, X, U, TH, Y, Ync, Yec, Zn, Ze)
    want = P.from_jax_numpy(ModelEval, jax.tree.map(np.asarray, want))
    t = torch.as_tensor
    prob = P.build_problem(ps, pd, pt, t(x0), hessian_mode=mode)
    assert tuple(prob.default_init.theta.shape) == (B, p)
    assert float(prob.default_init.theta.abs().max()) == 0.0
    got = prob.eval_model(P.Primal(t(X), t(U), t(TH)),
                          P.YVec(t(Y), t(Ync), t(Yec)), P.ZVec(t(Zn), t(Ze)))
    assert float(got.stage.Hthth_node.abs().max()) > 0
    assert float(got.grad.theta.abs().max()) > 0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=_MODEL_TOL, atol=_MODEL_TOL)
    # the probes' extra leading axis carries θ too
    f2, c2, _ = prob.eval_fcg(P.Primal(t(np.stack([X, X])),
                                       t(np.stack([U, U])),
                                       t(np.stack([TH, TH]))))
    torch.testing.assert_close(f2[1], got.f, rtol=_MODEL_TOL,
                               atol=_MODEL_TOL)
    torch.testing.assert_close(c2.ec[0], got.c.ec, rtol=_MODEL_TOL,
                               atol=_MODEL_TOL)


def _estimation_model(pkg, xp, T=8, dt=0.1):
    """tests/test_solver_extras.py::test_theta_estimated_jointly: an
    unknown constant disturbance θ (p=2) enters the dynamics, with a prior
    pulling it toward 0.3 at the root."""
    A = xp.asarray([[1.0, dt], [0.0, 1.0]], dtype=xp.float64)
    Bm = xp.asarray([[0.5 * dt * dt], [dt]], dtype=xp.float64)
    target = xp.asarray([1.0, 0.0], dtype=xp.float64)

    def node_cost(x, th, i):
        w = xp.where(i == T, 10.0, 1.0)
        return (0.5 * w * xp.sum((x - target) ** 2)
                + xp.where(i == 0, 0.5 * 5.0 * xp.sum((th - 0.3) ** 2), 0.0))

    spec = pkg.ModelSpec(
        dynamics=lambda x, u, th, i: A @ x + Bm @ u + dt * th,
        node_cost=node_cost,
        edge_cost=lambda x, u, th, i: 0.5 * 0.1 * xp.sum(u ** 2))
    dims = pkg.Dimensions.uniform(num_edges=T, state_dim=2, control_dim=1,
                                  theta_dim=2)
    return spec, dims, pkg.Topology.chain(T)


def test_theta_estimated_jointly_matches_jax():
    x0s = np.array([[0.0, 0.0], [0.4, -0.3]])
    js, jd, jt = _estimation_model(J, jnp)
    want = jax.jit(jax.vmap(lambda x0: J.solve(
        J.build_problem(js, jd, jt, x0), J.Settings(max_iterations=60))))(x0s)
    want = P.from_jax_numpy(P.SolveResult, jax.tree.map(np.asarray, want))

    ps, pd, pt = _estimation_model(P, torch)
    got = P.solve(P.build_problem(ps, pd, pt, torch.as_tensor(x0s)),
                  P.Settings(max_iterations=60))
    assert got.status.tolist() == [P.SIPStatus.SOLVED] * 2
    assert got.status.tolist() == want.status.tolist()
    assert got.iterations.tolist() == want.iterations.tolist()
    assert float(got.kkt_error.max()) < 1e-8
    th = got.vars.theta
    assert bool(torch.isfinite(th).all()) and float((th - 0.3).abs().max()) \
        > 1e-6
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        torch.testing.assert_close(a, b.to(a.dtype), rtol=_RTOL, atol=_ATOL)
