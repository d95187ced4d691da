"""riccati_backend="assoc" and the padded variable-dimension LQR against
the JAX package.

The port accepts "assoc", the JAX package's associative-scan backend, so
that settings written for that package run unchanged, and runs the CUDA
Riccati kernels for it (their plain twins on CPU tensors:
ops/lqr.py::_check_backend).  Tolerances: on well-conditioned float64
data (delta in [0.5, 1.5]) the two orders of operation agree with JAX's
associative scan to roundoff: 1e-10.  Against the sequential recursion the
bars are tests/test_lqr_parallel.py's (factor 1e-8, solution 1e-7,
residual 1e-9); against the C++ golden fixtures
tests/test_golden_lqr.py:98-112's (1e-9).  pad_lqr_data is elementwise
masking, so port and JAX agree exactly, and dead solution entries are
exactly 0 on every backend (tests/test_lqr.py:251-257).  The end-to-end
solves on the setting are tests/test_torch_assoc_solve.py's.
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
from sip_optimal_control_tpu.ops import lqr as JQ
import sip_optimal_control_tpu_torch as P
from sip_optimal_control_tpu_torch.ops import kkt as PK
from sip_optimal_control_tpu_torch.ops import lqr as PQ

from test_golden_lqr import _load_cases
from test_kkt import make_regs, random_rhs, synthetic_model
from test_lqr import make_tree_problem
from test_torch_lqr import random_chain

_TOL = 1e-10
BACKENDS = ("scan", "assoc", "cuda")


def _port(cls, jax_obj):
    return P.from_jax_numpy(cls, jax.tree.map(np.asarray, jax_obj))


@functools.lru_cache(maxsize=None)
def _jax_case():
    """One batch through JAX's assoc factor and solve (jitted, vmapped),
    shared by the parity and status tests: scenarios 0 and 3 regular,
    1 with a non-SPD R, 2 with an invalid delta."""
    T, n, m = 8, 3, 2
    jdata = random_chain(T, n, m, 4, seed=6)
    jdata = dataclasses.replace(
        jdata, R=jdata.R.at[1, 2].set(-jnp.eye(m)),
        delta=jdata.delta.at[2, 1, 0].set(-1.0))
    jsched = J.compile_topology(J.Topology.chain(T))
    fact = jax.jit(jax.vmap(lambda d: J.lqr_factor(d, jsched, "assoc")))(
        jdata)
    sol = jax.jit(jax.vmap(lambda d, f: J.lqr_solve(d, f, jsched, "assoc")))(
        jdata, fact)
    return T, jdata, fact, sol


def test_factor_solve_match_jax():
    """"assoc" against JAX's assoc on the regular scenarios: roundoff."""
    T, jdata, jfact, jsol = _jax_case()
    data = _port(P.LQRData, jdata)
    sched = P.compile_topology(P.Topology.chain(T))
    fact = P.lqr_factor(data, sched, "assoc")
    sol = P.lqr_solve(data, fact, sched, "assoc")
    ok = [0, 3]
    want_f = _port(P.LQRFactorization, jfact)
    for name in ("V", "F_chol", "sqrt_delta", "W", "K", "G_chol"):
        torch.testing.assert_close(getattr(fact, name)[ok],
                                   getattr(want_f, name)[ok], rtol=_TOL,
                                   atol=_TOL, msg=name)
    want_s = _port(P.LQRSolution, jsol)
    for name in P.LQRSolution._fields:
        torch.testing.assert_close(getattr(sol, name)[ok],
                                   getattr(want_s, name)[ok], rtol=_TOL,
                                   atol=_TOL, msg=name)


def test_failure_statuses_per_scenario():
    """Non-SPD R and an invalid delta fail their own scenario only, the
    same scenarios as JAX's assoc factor (tests/test_lqr_parallel.py:
    186-200); the codes are the kernel route's, which reports the
    failures in the TPU kernel wrapper's order (ROADMAP Queue 3)."""
    T, jdata, jfact, _ = _jax_case()
    want = np.asarray(jfact.status).tolist()
    assert want[0] == want[3] == P.FactorStatus.SUCCESS
    assert want[1] == P.FactorStatus.G_FACTORIZATION_FAILURE
    assert want[2] != P.FactorStatus.SUCCESS
    sched = P.compile_topology(P.Topology.chain(T))
    data = _port(P.LQRData, jdata)
    got = P.lqr_factor(data, sched, "assoc").status.tolist()
    assert [g != 0 for g in got] == [w != 0 for w in want]
    assert got == P.lqr_factor(data, sched, "cuda").status.tolist()


@pytest.mark.parametrize("T,n,m", [(6, 3, 1), (33, 4, 2), (64, 6, 3)])
def test_factor_solve_match_scan(T, n, m):
    """"assoc" against the port's scan at tests/test_lqr_parallel.py's bars
    (factor 1e-8, solution 1e-7) and the KKT residual oracle (1e-9)."""
    data = _port(P.LQRData, random_chain(T, n, m, 2, seed=T))
    sched = P.compile_topology(P.Topology.chain(T))
    fact = P.lqr_factor(data, sched, "assoc")
    sol = P.lqr_solve(data, fact, sched, "assoc")
    assert fact.status.tolist() == [0, 0]
    f_seq = P.lqr_factor(data, sched, "scan")
    s_seq = P.lqr_solve(data, f_seq, sched, "scan")
    for name in ("V", "K", "W"):
        torch.testing.assert_close(getattr(fact, name), getattr(f_seq, name),
                                   rtol=1e-8, atol=1e-8, msg=name)
    for name in P.LQRSolution._fields:
        torch.testing.assert_close(getattr(sol, name), getattr(s_seq, name),
                                   rtol=0, atol=1e-7, msg=name)
    assert float(P.lqr_residual_norm(data, sol, sched).max()) < 1e-9


@pytest.mark.parametrize("factor_backend", BACKENDS)
def test_any_solve_consumes_any_factorization(factor_backend):
    """Every solve backend on every backend's factorization ("cuda" on CPU
    tensors runs the kernels' plain twins, as does "assoc"): the same
    solution."""
    T, n, m = 10, 3, 2
    data = _port(P.LQRData, random_chain(T, n, m, 2, seed=4))
    sched = P.compile_topology(P.Topology.chain(T))
    fact = P.lqr_factor(data, sched, factor_backend)
    assert fact.status.tolist() == [0, 0]
    ref = P.lqr_solve(data, P.lqr_factor(data, sched), sched)
    for solve_backend in BACKENDS:
        sol = P.lqr_solve(data, fact, sched, solve_backend)
        assert float(P.lqr_residual_norm(data, sol, sched).max()) < 1e-9
        for name in P.LQRSolution._fields:
            torch.testing.assert_close(getattr(sol, name), getattr(ref, name),
                                       rtol=0, atol=1e-9,
                                       msg=f"{solve_backend}: {name}")


def test_theta_schur_columns_on_every_backend():
    """The θ Schur step sends each θ column through lqr_solve(backend) on
    that backend's factorization (ops/kkt.py::_solve_stagewise): on
    tests/test_kkt.py::test_theta_on_chain's problem (p=3) every backend
    gives the "scan" solution, which tests/test_torch_theta.py holds to
    JAX, at its 1e-8."""
    dims_kw = dict(theta_dim=3, state_dims=(3,) * 6, control_dims=(2,) * 5,
                   node_c_dims=(1,) * 6, node_g_dims=(1,) * 6,
                   edge_c_dims=(1,) * 5, edge_g_dims=(1,) * 5)
    jdims = J.Dimensions(**dims_kw)
    jtopo = J.Topology.chain(5)
    jmasks = JK.ConstraintMasks.build(jdims)
    parts = []
    for seed in (15, 115):
        rng = np.random.default_rng(seed)
        parts.append((synthetic_model(jdims, jtopo, rng),
                      make_regs(jdims, jmasks, rng),
                      random_rhs(jdims, jmasks, rng)))
    model, regs, rhs = (P.from_jax_numpy(cls, jax.tree.map(
        lambda *a: np.stack([np.asarray(x) for x in a]), *trees))
        for cls, trees in zip((PK.StageModelData, PK.Regularizations,
                               PK.KKTVector), zip(*parts)))
    dims = P.Dimensions(**dims_kw)
    sched = P.compile_topology(P.Topology.chain(5))
    masks = PK.ConstraintMasks.build(dims)
    sols = {}
    for backend in BACKENDS:
        fact = PK.kkt_factor(model, regs, masks, sched, backend)
        assert fact.status.tolist() == [0, 0], backend
        sols[backend] = PK.kkt_solve(fact, model, rhs, sched, backend)
    for backend, sol in sols.items():
        for f in dataclasses.fields(sol):
            torch.testing.assert_close(getattr(sol, f.name),
                                       getattr(sols["scan"], f.name),
                                       rtol=1e-8, atol=1e-8,
                                       msg=f"{backend}: {f.name}")
        resid = (PK.apply_K(model, regs, sol, sched) - rhs).norm()
        assert float(resid.max()) < 1e-8, (backend, resid)


def test_batch_equals_each_scenario():
    """A scenario's result does not depend on the rest of the batch
    (JAX's vmap batching test, tests/test_lqr_parallel.py:171-183)."""
    T, n, m, B = 16, 4, 2, 3
    data = _port(P.LQRData, random_chain(T, n, m, B, seed=5))
    sched = P.compile_topology(P.Topology.chain(T))
    sols, stats = P.lqr_factor_solve(data, sched, "assoc")
    assert stats.tolist() == [0] * B
    for i in range(B):
        one = P.LQRData(**{f.name: getattr(data, f.name)[i:i + 1]
                           for f in dataclasses.fields(data)})
        sol_i, _ = P.lqr_factor_solve(one, sched, "assoc")
        torch.testing.assert_close(sols.x[i:i + 1], sol_i.x, rtol=0,
                                   atol=1e-9)


def test_golden_chain_fixtures():
    """"assoc" against the C++ reference's golden chains at 1e-9
    (tests/test_golden_lqr.py:98-112)."""
    chains = [c for c in _load_cases() if c[3] == 0]
    assert len(chains) == 4
    for (T, n, m, kind, topo, data, x, u, y, V, K) in chains:
        sched = P.compile_topology(P.Topology.chain(T))
        pdata = P.from_jax_numpy(P.LQRData, jax.tree.map(
            lambda a: np.asarray(a)[None], data))
        fact = P.lqr_factor(pdata, sched, "assoc")
        sol = P.lqr_solve(pdata, fact, sched, "assoc")
        assert fact.status.tolist() == [0]
        for name, got, want in (("x", sol.x, x), ("u", sol.u, u),
                                ("y", sol.y, y)):
            err = float(np.max(np.abs(got[0].numpy() - want)))
            assert err < 1e-9, (T, n, m, name, err)


def _dims(state_dims, control_dims):
    N, E = len(state_dims), len(control_dims)
    return dict(theta_dim=0, state_dims=state_dims, control_dims=control_dims,
                node_c_dims=(0,) * N, node_g_dims=(0,) * N,
                edge_c_dims=(0,) * E, edge_g_dims=(0,) * E)


@pytest.mark.parametrize("shape", ["tree", "chain"])
def test_pad_lqr_data_matches_jax(shape):
    """pad_lqr_data and dimension_masks against JAX's on
    tests/test_lqr.py:235-261's tree and on a chain; dead entries exactly 0
    through every backend the topology takes (trees: the level recursion;
    chains: scan, and the cuda kernels' plain twins, also as
    "assoc")."""
    rng = np.random.default_rng(6)
    if shape == "tree":
        parents, children = [0, 0, 1, 1], [1, 2, 3, 4]
        dims = _dims((2, 1, 3, 2, 1), (1, 2, 1, 1))
        backends = ("scan",)
    else:
        parents, children = list(range(6)), list(range(1, 7))
        dims = _dims(tuple(1 + k % 3 for k in range(7)),
                     tuple(1 + e % 2 for e in range(6)))
        backends = BACKENDS
    jtopo = J.Topology.tree(0, parents, children)
    jsched = J.compile_topology(jtopo)
    jdims = J.Dimensions(**dims)
    jdata = make_tree_problem(rng, jtopo, n=3, m=2)
    want = jax.tree.map(lambda a: np.asarray(a)[None],
                        J.pad_lqr_data(jdata, jdims, jsched))

    pdims = P.Dimensions(**dims)
    topo = P.Topology.tree(0, parents, children)
    sched = P.compile_topology(topo)
    for got_m, want_m in zip(PQ.dimension_masks(pdims),
                             JQ.dimension_masks(jdims)):
        np.testing.assert_array_equal(got_m, want_m)
    data = P.from_jax_numpy(P.LQRData, jax.tree.map(
        lambda a: np.asarray(a)[None], jdata))
    padded = P.pad_lqr_data(data, pdims, sched)
    for f in dataclasses.fields(padded):
        np.testing.assert_array_equal(getattr(padded, f.name).numpy(),
                                      getattr(want, f.name), err_msg=f.name)
    # the masks are made once per (dims, topology, dtype, device)
    assert PQ._pad_masks(pdims, topo, torch.float64, torch.device("cpu")) \
        is PQ._pad_masks(pdims, topo, torch.float64, torch.device("cpu"))

    ref = None
    for backend in backends:
        sol, status = P.lqr_factor_solve(padded, sched, backend)
        assert status.tolist() == [0], backend
        assert float(P.lqr_residual_norm(padded, sol, sched)[0]) < 1e-12
        for i, d in enumerate(pdims.state_dims):
            assert torch.all(sol.x[0, i, d:] == 0.0), (backend, i)
            assert torch.all(sol.y[0, i, d:] == 0.0), (backend, i)
        for e, d in enumerate(pdims.control_dims):
            assert torch.all(sol.u[0, e, d:] == 0.0), (backend, e)
        if ref is None:
            ref = sol
        for name in P.LQRSolution._fields:
            torch.testing.assert_close(getattr(sol, name), getattr(ref, name),
                                       rtol=0, atol=1e-10, msg=name)
