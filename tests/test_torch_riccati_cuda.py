"""The CUDA Riccati kernels' plain twins against the TPU kernels.

The JAX side runs ``lqr_factor``/``lqr_factor_solve`` with
``backend="pallas"`` under ``jax.vmap``, which executes the Pallas kernels in
interpret mode on the CPU exactly as tests/test_pallas_riccati.py does.  The
port's ``riccati_backend="cuda"`` takes the twins for CPU tensors.  Both are
float32 recursions in different operation orders, so the bars are the JAX
kernel's own: rtol = atol = 2e-4 on factor products, 2e-3 on solutions.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import sip_optimal_control_tpu as J
import sip_optimal_control_tpu_torch as P
from sip_optimal_control_tpu_torch.ops import riccati_cuda as rc
from sip_optimal_control_tpu_torch.ops.lqr import LQRData

from test_pallas_riccati import random_chain_f32

FACTOR_TOL, SOLVE_TOL = 2e-4, 2e-3


def _jax_pallas(data, T):
    sched = J.compile_topology(J.Topology.chain(T))
    fact = jax.jit(jax.vmap(
        lambda d: J.lqr_factor(d, sched, backend="pallas")))(data)
    sol, _ = jax.jit(jax.vmap(
        lambda d: J.lqr_factor_solve(d, sched, backend="pallas")))(data)
    return fact, sol


def _port(data):
    return P.from_jax_numpy(LQRData, jax.tree.map(np.asarray, data))


@pytest.mark.parametrize("shape", [(5, 3, 2, 4), (8, 4, 1, 3)])
def test_twins_match_pallas_kernels(shape):
    T, n, m, batch = shape
    rng = np.random.default_rng(0)
    jdata = random_chain_f32(T, n, m, rng, batch)
    jfact, jsol = _jax_pallas(jdata, T)

    rc.reset_launch_counts()
    pdata = _port(jdata)
    assert pdata.Q.dtype == torch.float32
    sched = P.compile_topology(P.Topology.chain(T))
    fact = P.lqr_factor(pdata, sched, backend="cuda")
    sol = P.lqr_solve(pdata, fact, sched, backend="cuda")

    want_f = P.from_jax_numpy(P.LQRFactorization,
                              jax.tree.map(np.asarray, jfact))
    assert fact.status.tolist() == want_f.status.tolist() == [0] * batch
    for name in ("V", "W", "K", "G_chol", "F_chol", "sqrt_delta",
                 "sqrt_delta_inv"):
        torch.testing.assert_close(getattr(fact, name),
                                   getattr(want_f, name), rtol=FACTOR_TOL,
                                   atol=FACTOR_TOL, msg=name)
    want_s = P.from_jax_numpy(P.LQRSolution, jax.tree.map(np.asarray, jsol))
    for name in P.LQRSolution._fields:
        torch.testing.assert_close(getattr(sol, name), getattr(want_s, name),
                                   rtol=SOLVE_TOL, atol=SOLVE_TOL, msg=name)
    # CPU tensors take the twins: no kernel launched
    assert rc.launch_counts == {name: 0 for name in rc.launch_counts}


def test_per_scenario_failure_status_matches_pallas():
    T, n, m, batch = 4, 3, 1, 3
    rng = np.random.default_rng(2)
    jdata = random_chain_f32(T, n, m, rng, batch)
    # scenario 1 gets a non-PD R at one stage -> failure for it only
    jdata = dataclasses.replace(
        jdata, R=jdata.R.at[1, 2].set(-jnp.eye(m, dtype=jnp.float32)))
    sched = J.compile_topology(J.Topology.chain(T))
    want = np.asarray(jax.vmap(lambda d: J.lqr_factor(
        d, sched, backend="pallas"))(jdata).status).tolist()
    got = P.lqr_factor(_port(jdata), P.compile_topology(
        P.Topology.chain(T)), backend="cuda").status.tolist()
    assert got == want
    assert got[0] == 0 and got[1] != 0 and got[2] == 0


def test_kernel_level_twins_compose_to_chain_functions():
    """The chain-level twins are the kernel-level twins plus the wrapper
    semantics (F products recomputed from V, root solve in between)."""
    T, n, m, batch = 6, 4, 1, 2
    pdata = _port(random_chain_f32(T, n, m, np.random.default_rng(4), batch))
    fact = rc.factor_chain_reference(pdata)
    v_par, W, K, G = rc.factor_kernel(pdata.Q, pdata.delta, pdata.A,
                                      pdata.B, pdata.M, pdata.R)
    torch.testing.assert_close(fact.V[:, :T], v_par, rtol=0, atol=0)
    torch.testing.assert_close(fact.K, K, rtol=0, atol=0)
    sol = rc.solve_chain_reference(pdata, fact)
    resid = P.lqr_residual_norm(pdata, sol, P.compile_topology(
        P.Topology.chain(T)))
    assert float(resid.max()) < 5e-4


def test_wrappers_never_fall_back():
    """Only CPU tensors take the twin: any other device launches or
    raises."""
    T, n, m = 3, 4, 1
    pdata = _port(random_chain_f32(T, n, m, np.random.default_rng(5), 2))
    meta = LQRData(**{f.name: getattr(pdata, f.name).to("meta")
                      for f in dataclasses.fields(pdata)})
    with pytest.raises(ValueError, match="unsupported device"):
        rc.factor_chain_cuda(meta)
    with pytest.raises(ValueError, match="shape"):
        rc.factor_kernel(pdata.Q, pdata.delta[:, :-1].contiguous(),
                         pdata.A, pdata.B, pdata.M, pdata.R)
    with pytest.raises(ValueError, match="contiguous"):
        rc.factor_kernel(pdata.Q.transpose(-1, -2), pdata.delta, pdata.A,
                         pdata.B, pdata.M, pdata.R)
