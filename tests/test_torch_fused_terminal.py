"""The terminal node inside the fused factor and eval kernels, and the eval
kernel's reduction order (ops/fused_iter.py, csrc/fused_iter.cuh), on the
CPU.

- The generated ``nhess``, ``ncost_grad`` and ``ncost`` programs at stage
  i = T (the kernels' terminal node: each model's terminal weight is a
  run-time branch of the stage index) against the JAX package's terminal
  pieces HnT (ops/fused_iter.py:678-680) and gT / fT (:889-891): cartpole
  (qf = 50), quadrotor and chain16 (x10), both Hessian modes, float64,
  within 1e-10.
- The codegen routes, with the factor's carry started from the generated
  node Hessian at stage T and the eval's terminal node, root row and
  objective order as the kernel has them, against the JAX package's
  ``_factor_solve_reference`` and ``_eval_reference``: float64 within
  1e-10, float32 at the JAX package's bars for its kernels (CASES).
- ``lane_tree_sum`` is a sum; the objective in the kernel's order against
  the sequential twin within 4 (T + 1) float32 epsilons relative (both sum
  T + 1 nonnegative terms in float32, in different orders).
- A NaN in one scenario's x stays in that scenario's res row.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import sip_optimal_control_tpu.models as jm
from sip_optimal_control_tpu.ops import fused_iter as FI
import sip_optimal_control_tpu_torch.models as pm
from sip_optimal_control_tpu_torch.ops import fused_iter as fi
from sip_optimal_control_tpu_torch.ops import stage_codegen as sc

T, B = 4, 8
MODELS = ("cartpole_swingup", "planar_quadrotor", "synthetic_chain")
MODES = ("gauss_newton", "exact")
CASES = [("cartpole_swingup", "gauss_newton", 2e-5),
         ("planar_quadrotor", "exact", 5e-5),
         ("synthetic_chain", "gauss_newton", 2e-4)]
ITERATE = ("x", "u", "y", "r1x", "r1u", "delta", "q", "r", "c")
EVAL = ("x", "u", "y", "x0", "zlx", "zlu", "zux", "zuu")
F32_EPS = float(np.finfo(np.float32).eps)


@functools.lru_cache(maxsize=None)
def _specs(name, mode, dtype, T=T):
    """(port FusedIterSpec, port bounds, JAX FusedIterSpec, JAX bounds) at
    horizon T."""
    spec, dims, _, lo, up, _ = getattr(pm, name)(horizon=T, dtype=dtype,
                                                 device="cpu")
    n, m = dims.max_state_dim, dims.max_control_dim
    ispec = fi.build_fused_iter_spec(spec.dynamics, spec.node_cost,
                                     spec.edge_cost, T, n, m, mode, dtype,
                                     "cpu")
    assert ispec is not None, (name, mode)
    bounds = tuple(b[0].numpy() for b in (lo.u, up.u, lo.x, up.x))
    spec_j, _, _, lo_j, up_j, _ = getattr(jm, name)(horizon=T)
    jspec = FI.build_fused_iter_spec(spec_j.dynamics, spec_j.node_cost,
                                     spec_j.edge_cost, T, n, m, mode)
    jbounds = tuple(np.asarray(b)[0] for b in (lo_j.u, up_j.u, lo_j.x,
                                               up_j.x))
    return ispec, bounds, jspec, jbounds


def _inputs(n, m, seed=1):
    rng = np.random.default_rng(seed)
    return dict(
        x=0.5 * rng.standard_normal((B, T + 1, n)),
        u=0.5 * rng.standard_normal((B, T, m)),
        y=0.1 * rng.standard_normal((B, T + 1, n)),
        r1x=0.5 + rng.random((B, T + 1, n)), r1u=0.5 + rng.random((B, T, m)),
        delta=np.full(B, 0.01), q=rng.standard_normal((B, T + 1, n)),
        r=rng.standard_normal((B, T, m)), c=rng.standard_normal((B, T + 1, n)),
        x0=rng.standard_normal((B, n)), zlx=rng.random((B, T + 1, n)),
        zlu=rng.random((B, T, m)), zux=rng.random((B, T + 1, n)),
        zuu=rng.random((B, T, m)))


def _torch(a, keys, dtype):
    return [torch.as_tensor(a[k], dtype=dtype) for k in keys]


def _rel(a, b):
    return float(((a - b).abs() / (1 + b.abs())).max())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", MODELS)
def test_terminal_programs_match_jax(name, mode):
    ispec, _, jspec, _ = _specs(name, mode, torch.float64)
    n = ispec.n
    X = np.random.default_rng(5).standard_normal((6, n))
    th = torch.zeros(6, 0, dtype=torch.float64)
    Ti = torch.tensor(T, dtype=torch.int32)
    th0, Tj = jnp.zeros((0,)), jnp.asarray(T, jnp.int32)
    ncost = jspec.ncost_orig
    want = (jax.vmap(lambda v: jax.hessian(ncost)(v, th0, Tj))(X)
            .reshape(6, -1),
            jax.vmap(lambda v: jax.grad(ncost)(v, th0, Tj))(X),
            jax.vmap(lambda v: ncost(v, th0, Tj))(X))
    Xt = torch.as_tensor(X)
    got = (sc.evaluate(ispec.nhess, Xt, th, Ti),
           sc.evaluate(ispec.ncost_grad, Xt, th, Ti),
           sc.evaluate(ispec.ncost, Xt, th, Ti))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-10)
    # the terminal weight really is in play: stage T differs from stage 0
    stage0 = sc.evaluate(ispec.ncost, Xt, th,
                         torch.tensor(0, dtype=torch.int32))
    assert not torch.allclose(stage0, got[2])


def _jax_refs(jspec, jbounds, a, dtype):
    step = jax.jit(jax.vmap(lambda *args: FI._factor_solve_reference(
        jspec, *args)))(*[jnp.asarray(a[k], dtype) for k in ITERATE])
    ev = jax.jit(jax.vmap(lambda *args: FI._eval_reference(
        jspec, jbounds, *args)))(*[jnp.asarray(a[k], dtype) for k in EVAL])
    return step, ev


# chain16's factor against JAX costs ~20 s of XLA compile per dtype (its
# unrolled 16 x 16 factorizations); its eval is cheap and held here, its
# factor by test_torch_fused_chain.py end to end and against the twin below
@pytest.mark.parametrize("name,mode", [("cartpole_swingup", "gauss_newton"),
                                       ("planar_quadrotor", "exact")])
def test_codegen_routes_match_jax_float64(name, mode):
    ispec, bounds, jspec, jbounds = _specs(name, mode, torch.float64)
    a = _inputs(ispec.n, ispec.m)
    step, ev = _jax_refs(jspec, jbounds, a, jnp.float64)
    got = fi.factor_solve_codegen(ispec, *_torch(a, ITERATE, torch.float64))
    for w, g in zip(step[:3], got[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-10)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(step[3]))
    got = fi.eval_codegen(ispec, bounds, *_torch(a, EVAL, torch.float64))
    for w, g in zip(ev, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-10)


def _jax_test_inputs(name):
    """The float32 inputs on which the JAX package holds its own Pallas
    kernels to CASES' bars (tests/test_fused_iter.py:76-106 for the factor
    and solve, :42-73 for the eval, at T = 6): the same draws in the same
    order, for this model's turn in those loops."""
    f32 = np.float32
    rng = np.random.default_rng(1)
    for model, dims in (("cartpole_swingup", (4, 1)),
                        ("planar_quadrotor", (6, 2)),
                        ("synthetic_chain", (16, 4))):
        n, m = dims
        it = dict(x=0.5 * rng.standard_normal((B, T + 1, n)),
                  u=0.5 * rng.standard_normal((B, T, m)),
                  y=0.1 * rng.standard_normal((B, T + 1, n)),
                  r1x=0.5 + rng.random((B, T + 1, n)),
                  r1u=0.5 + rng.random((B, T, m)), delta=np.full(B, 0.01),
                  q=rng.standard_normal((B, T + 1, n)),
                  r=rng.standard_normal((B, T, m)),
                  c=rng.standard_normal((B, T + 1, n)))
        if model == name:
            break
    rng = np.random.default_rng(0)
    Te = 6
    for model, dims in (("cartpole_swingup", (4, 1)),
                        ("planar_quadrotor", (6, 2))):
        n, m = dims
        ev = dict(x=0.5 * rng.standard_normal((B, Te + 1, n)),
                  u=0.5 * rng.standard_normal((B, Te, m)),
                  y=0.1 * rng.standard_normal((B, Te + 1, n)),
                  x0=rng.standard_normal((B, n)),
                  zlx=rng.random((B, Te + 1, n)), zlu=rng.random((B, Te, m)),
                  zux=rng.random((B, Te + 1, n)), zuu=rng.random((B, Te, m)))
        if model == name:
            break
    return ({k: v.astype(f32) for k, v in it.items()},
            {k: v.astype(f32) for k, v in ev.items()})


@pytest.mark.parametrize("name,mode,tol", CASES[:2])
def test_codegen_routes_match_jax_float32(name, mode, tol):
    """float32, on the JAX package's own kernel-test inputs, at its bars:
    the factor and solve at T = 4, the eval at T = 6 (2e-5)."""
    ispec, bounds, jspec, jbounds = _specs(name, mode, torch.float32)
    a, ev_in = _jax_test_inputs(name)
    step = jax.vmap(lambda *args: FI._factor_solve_reference(jspec, *args))(
        *[jnp.asarray(a[k]) for k in ITERATE])
    got = fi.factor_solve_codegen(ispec, *_torch(a, ITERATE, torch.float32))
    for k in range(3):
        assert _rel(got[k], torch.as_tensor(np.array(step[k]))) < tol
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(step[3]))
    ispec6, bounds6, jspec6, jbounds6 = _specs(name, mode, torch.float32, 6)
    want = jax.vmap(lambda *args: FI._eval_reference(jspec6, jbounds6,
                                                     *args))(
        *[jnp.asarray(ev_in[k]) for k in EVAL])
    got = fi.eval_codegen(ispec6, bounds6, *_torch(ev_in, EVAL,
                                                   torch.float32))
    for w, g in zip(want, got):
        assert _rel(g, torch.as_tensor(np.array(w))) < 2e-5


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 2e-5)])
def test_chain16_eval_codegen_matches_jax(dtype, tol):
    ispec, bounds, jspec, jbounds = _specs("synthetic_chain", "gauss_newton",
                                           dtype)
    a = _inputs(ispec.n, ispec.m, seed=3)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    want = jax.jit(jax.vmap(lambda *args: FI._eval_reference(
        jspec, jbounds, *args)))(*[jnp.asarray(a[k], jdt) for k in EVAL])
    got = fi.eval_codegen(ispec, bounds, *_torch(a, EVAL, dtype))
    for w, g in zip(want, got):
        assert _rel(g, torch.as_tensor(np.asarray(w))) < tol


@pytest.mark.parametrize("name,mode,tol", CASES)
def test_codegen_factor_terminal_matches_twin_float32(name, mode, tol):
    """The factor products with the carry started in the kernel's place
    (the generated node Hessian at stage T) against the plain twin's
    (torch.func's), float32, at CASES' bars."""
    ispec, _, _, _ = _specs(name, mode, torch.float32)
    a = _inputs(ispec.n, ispec.m, seed=4)
    it = _torch(a, ITERATE[:6], torch.float32)
    want = fi.factor_reference(ispec, *it)
    got = fi._factor_loop(ispec, fi._CodegenBlocks(ispec, *it[:3]), *it)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert _rel(g, w) < tol


@pytest.mark.parametrize("terms", [1, 31, 32, 33, 51, 64, 70])
def test_lane_tree_sum(terms):
    rng = np.random.default_rng(terms)
    t64 = torch.as_tensor(rng.random((5, terms)))
    got = fi.lane_tree_sum(t64)
    torch.testing.assert_close(got, t64.sum(-1), rtol=1e-14, atol=0)
    t32 = t64.float()
    seq = t32[:, 0].clone()
    for k in range(1, terms):
        seq = seq + t32[:, k]
    tree = fi.lane_tree_sum(t32)
    assert float(((tree - seq).abs() / seq).max()) <= 4 * terms * F32_EPS


@pytest.mark.parametrize("name,mode,tol", CASES)
def test_eval_objective_order_tolerance(name, mode, tol):
    """The eval route's objective (the kernel's order) against the
    sequential twin's: within 4 (T + 1) float32 epsilons relative."""
    ispec, bounds, _, _ = _specs(name, mode, torch.float32)
    a = _inputs(ispec.n, ispec.m, seed=6)
    args = _torch(a, EVAL, torch.float32)
    f_k = fi.eval_codegen(ispec, bounds, *args)[0]
    f_t = fi.eval_reference(ispec, bounds, *args)[0]
    assert float(((f_k - f_t).abs() / f_t.abs()).max()) \
        <= 4 * (T + 1) * F32_EPS


@pytest.mark.parametrize("route", ["codegen", "reference"])
def test_eval_nan_stays_in_its_scenario(route):
    ispec, bounds, _, _ = _specs("cartpole_swingup", "gauss_newton",
                                 torch.float32)
    a = _inputs(4, 1, seed=7)
    fn = fi.eval_codegen if route == "codegen" else fi.eval_reference
    clean = fn(ispec, bounds, *_torch(a, EVAL, torch.float32))
    a["x"][3, 2, 1] = np.nan
    got = fn(ispec, bounds, *_torch(a, EVAL, torch.float32))
    res = got[-1]
    assert bool(torch.isnan(res[3, :2]).all())
    others = [b for b in range(B) if b != 3]
    assert bool(torch.isfinite(res[others]).all())
    torch.testing.assert_close(res[others], clean[-1][others], rtol=0,
                               atol=0)
    torch.testing.assert_close(got[0][others], clean[0][others], rtol=0,
                               atol=0)


@pytest.mark.parametrize("n,m", [(33, 2), (4, 33)])
def test_spec_refuses_dims_beyond_the_kernels(n, m):
    """n or m above FUSED_MAX_DIM (the factor's team holds at most a warp)
    keeps the model off the fused kernels: no spec, the standard path."""
    spec_m, _, _, _, _, _ = pm.synthetic_chain(
        horizon=3, state_dim=n, control_dim=m, dtype=torch.float32,
        device="cpu")
    assert fi.build_fused_iter_spec(
        spec_m.dynamics, spec_m.node_cost, spec_m.edge_cost, 3, n, m,
        "gauss_newton", torch.float32, "cpu") is None
