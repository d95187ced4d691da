"""The port's closed-loop MPC entry points against the JAX package.

``run_mpc`` on a batch of two quadrotor plants against JAX's
``vmap(run_mpc)`` (as tests/test_models_mpc.py::test_mpc_batched_scenarios,
at horizon 8 and 4 steps): statuses and iterations identical, states and
controls at rtol = atol = 1e-7 (test_torch_solver.py's bar for the two
packages' different rounding under the dual regularization).  At 6
iterations per re-solve and a KKT reset threshold of 1e-4, the second
plant's first re-solve ends at MAX_ITERATIONS above the threshold: it
applies zero control and restarts from the default init, as in JAX.
``run_mpc_timed`` with an ample budget is ``run_mpc``; with none it returns
JAX's empty prefix.
"""

import functools

import numpy as np
import jax
import torch

import sip_optimal_control_tpu as J
from sip_optimal_control_tpu.models import planar_quadrotor as j_quadrotor
from sip_optimal_control_tpu.mpc import run_mpc as j_run_mpc
from sip_optimal_control_tpu.mpc import run_mpc_timed as j_run_mpc_timed
import sip_optimal_control_tpu_torch as P
from sip_optimal_control_tpu_torch.models import planar_quadrotor

_RTOL = _ATOL = 1e-7
H, STEPS = 8, 4
X0S = np.array([[0.05, 0.0, 0.0, 0.0, 0.0, 0.0],
                [-0.5, 0.3, 0.1, 0.0, 0.0, 0.0]])
KW = dict(max_iterations=6, tol=1e-6)
RESET = 1e-4


def _port(steps=STEPS, timed_budget=None):
    spec, dims, topo, lo, up, _ = planar_quadrotor(horizon=H, device="cpu")
    args = (spec, dims, topo, torch.as_tensor(X0S))
    kw = dict(settings=P.Settings(**KW), lower=lo, upper=up,
              kkt_reset_threshold=RESET)
    if timed_budget is None:
        return P.run_mpc(*args, steps, **kw)
    return P.run_mpc_timed(*args, steps, timed_budget, **kw)


@functools.lru_cache(maxsize=None)
def _jax_trace():
    spec, dims, topo, lo, up, _ = j_quadrotor(horizon=H)
    trace = jax.jit(jax.vmap(lambda x0: j_run_mpc(
        spec, dims, topo, x0, n_steps=STEPS, settings=J.Settings(**KW),
        lower=lo, upper=up, kkt_reset_threshold=RESET)))(X0S)
    # JAX's vmapped trace leads with the plant; the port's with the step
    return jax.tree.map(lambda a: np.swapaxes(np.asarray(a), 0, 1), trace)


@functools.lru_cache(maxsize=None)
def _port_trace():
    return _port()


def test_run_mpc_matches_jax():
    want, got = _jax_trace(), _port_trace()
    assert tuple(got.states.shape) == (STEPS + 1, 2, 6)
    assert tuple(got.controls.shape) == (STEPS, 2, 2)
    np.testing.assert_array_equal(got.statuses.numpy(), want.statuses)
    np.testing.assert_array_equal(got.iterations.numpy(), want.iterations)
    for a, b in ((got.states, want.states), (got.controls, want.controls)):
        torch.testing.assert_close(a, torch.as_tensor(np.array(b)),
                                   rtol=_RTOL, atol=_ATOL)


def test_failsafe_matches_jax():
    """Plant 1's first re-solve is unusable (MAX_ITERATIONS, KKT error
    above the threshold): zero control, then a cold restart; plant 0 is
    never reset."""
    want, got = _jax_trace(), _port_trace()
    for trace in (want, got):
        st, kkt = np.asarray(trace.statuses), np.asarray(trace.kkt_errors)
        assert st[0, 1] == P.SIPStatus.MAX_ITERATIONS and kkt[0, 1] > RESET
        assert np.all(np.asarray(trace.controls)[0, 1] == 0.0)
        assert np.all(st[:, 0] == P.SIPStatus.SOLVED)
    # the plant moved under zero thrust deltas (hover)
    spec, _, _, _, _, _ = planar_quadrotor(horizon=H, device="cpu")
    x0 = torch.as_tensor(X0S[1])
    hover = spec.dynamics(x0, torch.zeros(2, dtype=torch.float64),
                          torch.zeros(0, dtype=torch.float64),
                          torch.tensor(0))
    torch.testing.assert_close(got.states[1, 1], hover, rtol=0, atol=1e-15)


def test_run_mpc_timed_with_ample_budget_is_run_mpc():
    full = _port(timed_budget=600.0)
    ref = _port_trace()
    for a, b in zip(full, ref):
        assert torch.equal(a, b)


def test_run_mpc_timed_zero_budget_gives_empty_prefix():
    got = _port(timed_budget=0.0)
    spec, dims, topo, lo, up, _ = j_quadrotor(horizon=H)
    want = j_run_mpc_timed(spec, dims, topo, X0S[0], max_steps=STEPS,
                           time_budget_s=0.0, settings=J.Settings(**KW),
                           lower=lo, upper=up)
    for g, w in zip(got, want):
        # JAX's one plant, the port's batch of two in the second axis
        assert tuple(g.shape) == (w.shape[0], 2) + tuple(w.shape[1:])
        assert g.dtype == (torch.int32 if w.dtype == np.int32
                           else torch.float64)
    torch.testing.assert_close(got.states[0], torch.as_tensor(X0S))
