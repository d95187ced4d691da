"""The port's autodiff model front door against the JAX package.

Stage values and derivatives at random points, fp64: both packages
differentiate the same stage functions exactly (forward/reverse AD, no
finite differences), so the bar is fp64 roundoff of RK4 compositions, 1e-10.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import sip_optimal_control_tpu as J
from sip_optimal_control_tpu.models import cartpole_swingup as j_cartpole
from sip_optimal_control_tpu.models import double_integrator as j_di
import sip_optimal_control_tpu_torch as P
from sip_optimal_control_tpu_torch.models import cartpole_swingup as p_cartpole
from sip_optimal_control_tpu_torch.models import double_integrator as p_di
from sip_optimal_control_tpu_torch.solver.sip import ModelEval
from sip_optimal_control_tpu_torch._tree import tree_leaves

_TOL = 1e-10
H, BATCH = 8, 3


def _constrained(pkg, xp):
    """Double integrator plus a node equality and an edge inequality, so the
    constraint Jacobians and multiplier-weighted Hessians are exercised."""
    spec, dims, topo = (j_di if pkg is J else p_di)(horizon=H)
    spec = pkg.ModelSpec(
        dynamics=spec.dynamics, node_cost=spec.node_cost,
        edge_cost=spec.edge_cost,
        node_eq=lambda x, th, i: xp.stack([x[0] * x[1] - 0.1]),
        edge_ineq=lambda x, u, th, i: xp.stack([u[0] ** 2 + x[1] - 1.0,
                                                xp.sin(x[0]) - u[0]]))
    dims = pkg.Dimensions.uniform(num_edges=H, state_dim=2, control_dim=1,
                                  node_c_dim=1, edge_g_dim=2)
    return spec, dims, topo


def _models(name):
    if name == "cartpole":
        js, jd, jt, jl, ju, _ = j_cartpole(H)
        ps, pd, pt, pl, pu, _ = p_cartpole(H)
        return (js, jd, jt, jl, ju), (ps, pd, pt, pl, pu)
    js, jd, jt = _constrained(J, jnp)
    ps, pd, pt = _constrained(P, torch)
    return (js, jd, jt, None, None), (ps, pd, pt, None, None)


@pytest.mark.parametrize("name", ["cartpole", "constrained"])
@pytest.mark.parametrize("mode", ["gauss_newton", "exact"])
def test_eval_model_matches_jax(name, mode):
    (js, jd, jt, jl, ju), (ps, pd, pt, pl, pu) = _models(name)
    N, E = jd.num_nodes, jd.num_edges
    n, m = jd.max_state_dim, jd.max_control_dim
    cn, ge = jd.max_node_c_dim, jd.max_edge_g_dim
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((BATCH, n))
    X = rng.standard_normal((BATCH, N, n))
    U = rng.standard_normal((BATCH, E, m))
    Y = rng.standard_normal((BATCH, N, n))
    Ync = rng.standard_normal((BATCH, N, cn))
    Ze = rng.random((BATCH, E, ge))

    def jev(x0_, x, u, y, ync, ze):
        prob = J.build_problem(js, jd, jt, x0_, jl, ju, hessian_mode=mode)
        return prob.eval_model(
            J.solver.Primal(x, u, jnp.zeros(0)),
            J.YVec(y, ync, jnp.zeros((E, 0))),
            J.ZVec(jnp.zeros((N, 0)), ze))

    want = jax.jit(jax.vmap(jev))(x0, X, U, Y, Ync, Ze)
    want = P.from_jax_numpy(ModelEval, jax.tree.map(np.asarray, want))

    t = torch.as_tensor
    prob = P.build_problem(ps, pd, pt, t(x0), pl, pu, hessian_mode=mode)
    got = prob.eval_model(
        P.Primal(t(X), t(U), torch.zeros(BATCH, 0, dtype=torch.float64)),
        P.YVec(t(Y), t(Ync), torch.zeros(BATCH, E, 0, dtype=torch.float64)),
        P.ZVec(torch.zeros(BATCH, N, 0, dtype=torch.float64), t(Ze)))
    got_leaves, want_leaves = tree_leaves(got), tree_leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for a, b in zip(got_leaves, want_leaves):
        assert a.shape == b.shape and a.dtype == torch.float64
        torch.testing.assert_close(a, b, rtol=_TOL, atol=_TOL)
    # the residual-only evaluation takes extra leading axes (the line
    # search's [chunk, B] probe)
    f2, c2, g2 = prob.eval_fcg(P.Primal(t(np.stack([X, X])),
                                        t(np.stack([U, U])),
                                        torch.zeros(2, BATCH, 0,
                                                    dtype=torch.float64)))
    torch.testing.assert_close(f2[1], got.f, rtol=_TOL, atol=_TOL)
    torch.testing.assert_close(c2.dyn[0], got.c.dyn, rtol=_TOL, atol=_TOL)


def _float32_problem(name, mode, dynamics=None):
    if name == "cartpole":
        spec, dims, topo, lower, upper, x0 = p_cartpole(
            H, dtype=torch.float32)
    else:
        spec, dims, topo = p_di(horizon=H)
        lower = upper = None
        x0 = torch.ones(2)
    if dynamics is not None:
        spec = P.ModelSpec(dynamics=dynamics, node_cost=spec.node_cost,
                           edge_cost=spec.edge_cost)
    x0 = x0[None].expand(BATCH, -1).contiguous()
    prob = P.build_problem(spec, dims, topo, x0, lower, upper,
                           hessian_mode=mode)
    N, E, n = dims.num_nodes, dims.num_edges, dims.max_state_dim
    y = P.YVec(torch.ones(BATCH, N, n), torch.zeros(BATCH, N, 0),
               torch.zeros(BATCH, E, 0))
    z = P.ZVec(torch.zeros(BATCH, N, 0), torch.zeros(BATCH, E, 0))
    return prob, y, z


@pytest.mark.parametrize("name", ["cartpole", "double_integrator"])
@pytest.mark.parametrize("mode", ["gauss_newton", "exact"])
def test_float32_eval_keeps_dtype(name, mode):
    """Every value and derivative of a float32 model is computed in
    float32 (no forward-mode promotion to float64 anywhere)."""
    prob, y, z = _float32_problem(name, mode)
    ev = prob.eval_model(prob.default_init, y, z)
    for leaf in tree_leaves(ev):
        assert leaf.dtype == torch.float32


def test_promoting_stage_function_raises():
    """A 0-dim state entry times a Python float gets a float64 forward-mode
    tangent; the front door names the cause instead of computing in
    float64."""
    def scalar_dynamics(x, u, th, i):
        return torch.stack([x[0] + 0.1 * x[1], x[1] + 0.1 * u[0]])

    prob, y, z = _float32_problem("double_integrator", "gauss_newton",
                                  scalar_dynamics)
    with pytest.raises(TypeError, match="1-element slices"):
        prob.eval_model(prob.default_init, y, z)


def test_default_init_and_bounds_match_jax():
    js, jd, jt, jl, ju, jx0 = j_cartpole(H)
    ps, pd, pt, pl, pu, px0 = p_cartpole(H)
    for a, b in zip(tree_leaves(pl) + tree_leaves(pu),
                    jax.tree.leaves(jl) + jax.tree.leaves(ju)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(px0.numpy(), np.asarray(jx0), rtol=0, atol=0)
    for mode in ("constant", "rollout"):
        want = J.build_problem(js, jd, jt, jx0, jl, ju,
                               init_mode=mode).default_init
        got = P.build_problem(ps, pd, pt, px0, pl, pu,
                              init_mode=mode).default_init
        np.testing.assert_allclose(got.x[0].numpy(), np.asarray(want.x),
                                   rtol=_TOL, atol=_TOL)
        np.testing.assert_array_equal(got.u[0].numpy(), np.asarray(want.u))
