"""The port's solver and closed loop at riccati_backend="assoc" against
the JAX package's associative-scan backend (the port runs its Riccati
kernels for the setting, their plain twins on the CPU).

The bounded double integrator of tests/test_lqr_parallel.py:203-220 at
that test's bar: controls (and run_mpc's states) within 1e-6 of JAX's,
with the statuses and iteration counts identical, and within 1e-6 of the
port's own "scan" solve.  Each JAX program here compiles in ~20 s on a
CPU, so the two share this file and nothing else.
"""

import functools

import numpy as np
import jax
import torch

import sip_optimal_control_tpu as J
from sip_optimal_control_tpu.models import double_integrator as j_di
from sip_optimal_control_tpu.mpc import run_mpc as j_run_mpc
import sip_optimal_control_tpu_torch as P
from sip_optimal_control_tpu_torch.models import double_integrator as p_di

H_DI = 12
X0S = np.array([[1.0, 0.0], [0.5, -0.2]])


def _jax_problem():
    spec, dims, topo = j_di(horizon=H_DI)
    lower, upper = J.box_bounds(dims, u_lower=-0.6, u_upper=0.6)
    return spec, dims, topo, lower, upper


def _port_problem():
    spec, dims, topo = p_di(horizon=H_DI)
    lower, upper = P.box_bounds(dims, u_lower=-0.6, u_upper=0.6,
                                device="cpu")
    return spec, dims, topo, lower, upper


@functools.lru_cache(maxsize=None)
def _jax_solve():
    spec, dims, topo, lo, up = _jax_problem()
    return jax.jit(jax.vmap(lambda x0: J.solve(
        J.build_problem(spec, dims, topo, x0, lo, up),
        J.Settings(max_iterations=40, riccati_backend="assoc"))))(X0S)


def test_bounded_double_integrator_solve_matches_jax():
    """End-to-end solve at "assoc" (tests/test_lqr_parallel.py:
    203-220): JAX's assoc solve's statuses and iterations, controls within
    1e-6, and the port's own scan solve's controls within 1e-6."""
    want = _jax_solve()
    spec, dims, topo, lo, up = _port_problem()
    prob = P.build_problem(spec, dims, topo, torch.as_tensor(X0S), lo, up)
    got = P.solve(prob, P.Settings(max_iterations=40,
                                   riccati_backend="assoc"))
    seq = P.solve(prob, P.Settings(max_iterations=40))
    assert got.status.tolist() == np.asarray(want.status).tolist() == [0, 0]
    assert got.iterations.tolist() == np.asarray(want.iterations).tolist()
    np.testing.assert_allclose(got.vars.u.numpy(), np.asarray(want.vars.u),
                               atol=1e-6)
    np.testing.assert_allclose(got.vars.u.numpy(), seq.vars.u.numpy(),
                               atol=1e-6)


def test_run_mpc_on_assoc_matches_jax():
    """run_mpc at "assoc": JAX's vmapped run_mpc's statuses and
    iterations, states and controls within 1e-6."""
    steps = 3
    spec, dims, topo, lo, up = _jax_problem()
    settings = dict(max_iterations=40, riccati_backend="assoc")
    want = jax.jit(jax.vmap(lambda x0: j_run_mpc(
        spec, dims, topo, x0, n_steps=steps,
        settings=J.Settings(**settings), lower=lo, upper=up)))(X0S)
    want = jax.tree.map(lambda a: np.swapaxes(np.asarray(a), 0, 1), want)
    spec, dims, topo, lo, up = _port_problem()
    got = P.run_mpc(spec, dims, topo, torch.as_tensor(X0S), steps,
                    P.Settings(**settings), lo, up)
    np.testing.assert_array_equal(got.statuses.numpy(), want.statuses)
    np.testing.assert_array_equal(got.iterations.numpy(), want.iterations)
    np.testing.assert_allclose(got.states.numpy(), want.states, atol=1e-6)
    np.testing.assert_allclose(got.controls.numpy(), want.controls,
                               atol=1e-6)
