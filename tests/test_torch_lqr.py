"""The port's chain LQR against the C++ golden fixtures and the JAX package.

Tolerances: the golden fixtures come from the reference's fp64 recursion and
the JAX test pins them at 1e-12 (measured ~1e-15); the same bar holds here.
JAX parity on random well-conditioned data (delta in [0.5, 1.5]) is fp64
roundoff, so 1e-12 as well.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import sip_optimal_control_tpu as J
import sip_optimal_control_tpu_torch as P
from sip_optimal_control_tpu_torch.ops.lqr import LQRData

from test_golden_lqr import _load_cases

_TOL = 1e-12


def _port_data(data) -> LQRData:
    """A JAX LQRData of one scenario -> the port's, batch of one."""
    return P.from_jax_numpy(LQRData, jax.tree.map(
        lambda a: np.asarray(a)[None], data))


def random_chain(T, n, m, batch, seed):
    rng = np.random.default_rng(seed)

    def spd(count, d, base):
        s = 0.3 * rng.standard_normal((batch, count, d, d))
        return s @ np.swapaxes(s, -1, -2) + base * np.eye(d)

    return J.LQRData(
        Q=jnp.asarray(spd(T + 1, n, 2.0)),
        q=jnp.asarray(rng.standard_normal((batch, T + 1, n))),
        c=jnp.asarray(rng.standard_normal((batch, T + 1, n))),
        delta=jnp.asarray(0.5 + rng.random((batch, T + 1, n))),
        A=jnp.asarray(0.4 * rng.standard_normal((batch, T, n, n))),
        B=jnp.asarray(0.5 * rng.standard_normal((batch, T, n, m))),
        M=jnp.asarray(0.1 * rng.standard_normal((batch, T, n, m))),
        R=jnp.asarray(spd(T, m, 2.0)),
        r=jnp.asarray(rng.standard_normal((batch, T, m))))


@pytest.mark.parametrize("backend", ["scan", "cuda"])
def test_golden_chain_fixtures(backend):
    """"cuda" on CPU tensors runs the kernels' plain twins."""
    chains = [c for c in _load_cases() if c[3] == 0]
    assert len(chains) == 4
    for (T, n, m, kind, topo, data, x, u, y, V, K) in chains:
        sched = P.compile_topology(P.Topology.chain(T))
        pdata = _port_data(data)
        assert pdata.Q.dtype == torch.float64
        fact = P.lqr_factor(pdata, sched, backend)
        sol = P.lqr_solve(pdata, fact, sched, backend)
        assert int(fact.status[0]) == 0
        for name, got, want in (("x", sol.x, x), ("u", sol.u, u),
                                ("y", sol.y, y), ("V", fact.V, V),
                                ("K", fact.K, K)):
            err = float(np.max(np.abs(got[0].numpy() - want)))
            assert err < _TOL, (T, n, m, name, err)
        assert float(P.lqr_residual_norm(pdata, sol, sched)[0]) < 1e-11


def test_fp64_parity_with_jax_scan():
    T, n, m, batch = 8, 4, 2, 3
    jdata = random_chain(T, n, m, batch, seed=0)
    jsched = J.compile_topology(J.Topology.chain(T))
    jfact = jax.vmap(lambda d: J.lqr_factor(d, jsched))(jdata)
    jsol = jax.vmap(lambda d, f: J.lqr_solve(d, f, jsched))(jdata, jfact)

    pdata = P.from_jax_numpy(LQRData, jax.tree.map(np.asarray, jdata))
    sched = P.compile_topology(P.Topology.chain(T))
    pfact = P.lqr_factor(pdata, sched)
    psol = P.lqr_solve(pdata, pfact, sched)

    want_f = P.from_jax_numpy(P.LQRFactorization,
                              jax.tree.map(np.asarray, jfact))
    want_s = P.from_jax_numpy(P.LQRSolution, jax.tree.map(np.asarray, jsol))
    for name in P.LQRFactorization._fields:
        torch.testing.assert_close(getattr(pfact, name),
                                   getattr(want_f, name).to(
                                       getattr(pfact, name).dtype),
                                   rtol=_TOL, atol=_TOL, msg=name)
    for name in P.LQRSolution._fields:
        torch.testing.assert_close(getattr(psol, name),
                                   getattr(want_s, name), rtol=_TOL,
                                   atol=_TOL, msg=name)
    # the residual oracle: the port's KKT residual agrees with JAX's and is
    # at roundoff level
    jres = np.asarray(jax.vmap(lambda d, s: J.lqr_residual_norm(
        d, s, jsched))(jdata, jsol))
    pres = P.lqr_residual_norm(pdata, psol, sched).numpy()
    np.testing.assert_allclose(pres, jres, rtol=1e-6, atol=1e-13)
    assert pres.max() < 1e-12


def test_failure_statuses_per_scenario():
    T, n, m = 4, 3, 1
    jdata = random_chain(T, n, m, 3, seed=1)
    jdata = dataclasses.replace(
        jdata, R=jdata.R.at[1, 2].set(-100.0),        # 1: non-PD G
        delta=jdata.delta.at[2, 1, 0].set(-1.0))      # 2: invalid delta
    jsched = J.compile_topology(J.Topology.chain(T))
    want = np.asarray(jax.vmap(lambda d: J.lqr_factor(d, jsched))(
        jdata).status).tolist()
    assert want == [P.FactorStatus.SUCCESS,
                    P.FactorStatus.G_FACTORIZATION_FAILURE,
                    P.FactorStatus.INVALID_DELTA]
    pdata = P.from_jax_numpy(LQRData, jax.tree.map(np.asarray, jdata))
    sched = P.compile_topology(P.Topology.chain(T))
    assert P.lqr_factor(pdata, sched).status.tolist() == want
    # the kernel route reports the first failing F factorization after the
    # G failure's NaNs reach V, as the TPU kernel wrapper does
    got = P.lqr_factor(pdata, sched, "cuda").status.tolist()
    assert got[0] == P.FactorStatus.SUCCESS
    assert got[1] != P.FactorStatus.SUCCESS
    assert got[2] == P.FactorStatus.INVALID_DELTA


def test_tree_topology_not_ported():
    sched = P.compile_topology(P.Topology.tree(0, [0, 0], [1, 2]))
    pdata = P.from_jax_numpy(LQRData, jax.tree.map(
        np.asarray, random_chain(2, 2, 1, 1, seed=2)))
    with pytest.raises(NotImplementedError):
        P.lqr_factor(pdata, sched)
