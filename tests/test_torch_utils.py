"""The port's utilities against the JAX package's: the derivative checker
and the solver's derivative-check channel, warm-start checkpoints and the
profiling helpers.

Derivative errors are finite-difference truncation and roundoff, so the
bars are the JAX tests' (check_derivatives < 1e-7 at eps 1e-6,
tests/test_utils_extras.py:30; the channel < 1e-6, tests/
test_solver_extras.py:245-247), with the port's values printed beside
JAX's and within 1e-8 of them (both sides are ~1e-10 and below).
Checkpoints move arrays exactly: every round trip, within and across the
packages, is compared bit for bit, and a warm re-solve from a loaded file
equals the one from the tensors in memory bit for bit.
"""

import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import sip_optimal_control_tpu as J
from sip_optimal_control_tpu.solver.settings import \
    LoggingSettings as JLog
from sip_optimal_control_tpu.solver.sip import Primal as JPrimal
from sip_optimal_control_tpu.solver.sip import YVec as JYVec
from sip_optimal_control_tpu.solver.sip import ZVec as JZVec
from sip_optimal_control_tpu.utils import check_derivatives as j_check
from sip_optimal_control_tpu.utils import load_warm_start as j_load
from sip_optimal_control_tpu.utils import save_warm_start as j_save
import sip_optimal_control_tpu_torch as P
from sip_optimal_control_tpu_torch.solver.settings import \
    LoggingSettings as PLog
from sip_optimal_control_tpu_torch.utils import (check_derivatives,
                                                 load_warm_start,
                                                 save_warm_start,
                                                 timed_block_until_ready,
                                                 trace_solve)

T_NL = 6


def _jax_nonlinear():
    dims = J.Dimensions.uniform(num_edges=T_NL, state_dim=2, control_dim=1,
                                node_g_dim=1, edge_c_dim=1)
    spec = J.ModelSpec(
        dynamics=lambda x, u, th, i: jnp.stack(
            [x[0] + 0.1 * x[1], x[1] + 0.1 * jnp.sin(x[0]) + 0.1 * u[0]]),
        node_cost=lambda x, th, i: 0.5 * jnp.sum(x ** 2)
        + 0.1 * jnp.cos(x[0]),
        edge_cost=lambda x, u, th, i: 0.5 * jnp.sum(u ** 2),
        node_ineq=lambda x, th, i: jnp.asarray([x[0] ** 2 - 4.0]),
        edge_eq=lambda x, u, th, i: jnp.asarray([0.05 * x[0] * u[0]]))
    return spec, dims, J.Topology.chain(T_NL)


def _port_nonlinear():
    """tests/test_utils_extras.py:15-27's problem."""
    dims = P.Dimensions.uniform(num_edges=T_NL, state_dim=2, control_dim=1,
                                node_g_dim=1, edge_c_dim=1)
    spec = P.ModelSpec(
        dynamics=lambda x, u, th, i: torch.cat(
            [x[:1] + 0.1 * x[1:2],
             x[1:2] + 0.1 * torch.sin(x[:1]) + 0.1 * u[:1]]),
        node_cost=lambda x, th, i: (0.5 * (x ** 2).sum()
                                    + 0.1 * torch.cos(x[:1]).sum()),
        edge_cost=lambda x, u, th, i: 0.5 * (u ** 2).sum(),
        node_ineq=lambda x, th, i: x[:1] ** 2 - 4.0,
        edge_eq=lambda x, u, th, i: 0.05 * x[:1] * u[:1])
    return spec, dims, P.Topology.chain(T_NL)


def test_check_derivatives_matches_jax():
    rng = np.random.default_rng(0)
    N, E = T_NL + 1, T_NL
    arrays = dict(x=0.3 * rng.standard_normal((N, 2)),
                  u=0.3 * rng.standard_normal((E, 1)),
                  y_dyn=0.1 * rng.standard_normal((N, 2)),
                  y_ec=0.1 * rng.standard_normal((E, 1)),
                  z_n=0.1 * rng.random((N, 1)))
    spec, dims, topo = _jax_nonlinear()
    want = j_check(
        J.build_problem(spec, dims, topo, initial_state=jnp.zeros(2)),
        JPrimal(x=jnp.asarray(arrays["x"]), u=jnp.asarray(arrays["u"]),
                theta=jnp.zeros(0)),
        JYVec(dyn=jnp.asarray(arrays["y_dyn"]), nc=jnp.zeros((N, 0)),
              ec=jnp.asarray(arrays["y_ec"])),
        JZVec(n=jnp.asarray(arrays["z_n"]), e=jnp.zeros((E, 0))), eps=1e-6)

    def t(a):
        return torch.as_tensor(a)[None]

    zeros = torch.zeros(1, N, 0, dtype=torch.float64)
    spec, dims, topo = _port_nonlinear()
    got = check_derivatives(
        P.build_problem(spec, dims, topo,
                        torch.zeros(1, 2, dtype=torch.float64)),
        P.Primal(x=t(arrays["x"]), u=t(arrays["u"]),
                 theta=torch.zeros(1, 0, dtype=torch.float64)),
        P.YVec(dyn=t(arrays["y_dyn"]), nc=zeros, ec=t(arrays["y_ec"])),
        P.ZVec(n=t(arrays["z_n"]), e=torch.zeros(1, E, 0,
                                                 dtype=torch.float64)),
        eps=1e-6)
    print(f"check_derivatives port {got} JAX {want}")
    assert set(got) == set(want)
    for name, err in got.items():
        assert err < 1e-7 and want[name] < 1e-7, (name, err, want[name])
        assert abs(err - want[name]) < 1e-8, (name, err, want[name])


CHANNEL = re.compile(r"derivative check \(central FD, eps=([\d.e+-]+)\): "
                     r"gradient=([\d.e+-]+) jacobian_c=([\d.e+-]+) "
                     r"jacobian_g=([\d.e+-]+) hessian=([\d.e+-]+)")


def _channel(out):
    lines = CHANNEL.findall(out)
    assert len(lines) == 1, out
    return [float(v) for v in lines[0]]


def test_derivative_check_channel_matches_jax(capfd):
    """settings.logging.print_derivative_check_logs prints one line per
    solve at the initial iterate (tests/test_solver_extras.py:208-247's
    problem); a batch of one prints JAX's values up to roundoff, and the
    solve itself is unchanged by the channel."""
    T = 4
    jspec = J.ModelSpec(
        dynamics=lambda x, u, th, i: jnp.stack(
            [x[0] + 0.1 * x[1], x[1] + 0.1 * jnp.sin(u[0])]),
        node_cost=lambda x, th, i: 0.5 * jnp.sum(x ** 2),
        edge_cost=lambda x, u, th, i: 0.05 * jnp.sum(u ** 2),
        node_ineq=lambda x, th, i: (x[0] - 5.0)[None])
    jdims = J.Dimensions.uniform(num_edges=T, state_dim=2, control_dim=1,
                                 node_g_dim=1)
    jprob = J.build_problem(jspec, jdims, J.Topology.chain(T),
                            initial_state=jnp.asarray([1.0, 0.0]))
    res = jax.jit(lambda: J.solve(jprob, J.Settings(
        max_iterations=20,
        logging=JLog(print_derivative_check_logs=True))))()
    jax.block_until_ready(res.vars.x)
    want = _channel(capfd.readouterr().out)

    spec = P.ModelSpec(
        dynamics=lambda x, u, th, i: torch.cat(
            [x[:1] + 0.1 * x[1:2], x[1:2] + 0.1 * torch.sin(u[:1])]),
        node_cost=lambda x, th, i: 0.5 * (x ** 2).sum(),
        edge_cost=lambda x, u, th, i: 0.05 * (u ** 2).sum(),
        node_ineq=lambda x, th, i: x[:1] - 5.0)
    dims = P.Dimensions.uniform(num_edges=T, state_dim=2, control_dim=1,
                                node_g_dim=1)
    prob = P.build_problem(spec, dims, P.Topology.chain(T),
                           torch.tensor([[1.0, 0.0]], dtype=torch.float64))
    loud = P.solve(prob, P.Settings(
        max_iterations=20, logging=PLog(print_derivative_check_logs=True)))
    got = _channel(capfd.readouterr().out)
    quiet = P.solve(prob, P.Settings(max_iterations=20))
    print(f"derivative check channel: port {got} JAX {want}")
    assert got[0] == pytest.approx(want[0])          # eps
    for g, w in zip(got[1:], want[1:]):
        assert g < 1e-6 and w < 1e-6, (got, want)
        assert abs(g - w) < 1e-8, (got, want)
    assert loud.status.tolist() == [int(res.status)] == [0]
    for a, b in zip(loud.vars, quiet.vars):
        assert torch.equal(a, b)


def _random_state(rng, B=3, N=5, E=4):
    return dict(x=rng.standard_normal((B, N, 2)),
                u=rng.standard_normal((B, E, 1)),
                theta=rng.standard_normal((B, 1)),
                y_dyn=rng.standard_normal((B, N, 2)),
                y_nc=np.zeros((B, N, 0)),
                y_ec=rng.standard_normal((B, E, 1)))


def _fields(vars, y):
    return dict(x=vars.x, u=vars.u, theta=vars.theta, y_dyn=y.dyn,
                y_nc=y.nc, y_ec=y.ec)


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("jax", "jax"),
                                           ("jax", "port"),
                                           ("port", "jax")])
def test_checkpoint_round_trips(tmp_path, writer, reader):
    """A file written by either package loads in either, bit for bit; the
    port loads tensors on the device it is asked for, in the file's
    precision unless told otherwise."""
    a = _random_state(np.random.default_rng(4))
    path = str(tmp_path / "warm.npz")
    if writer == "port":
        t = {k: torch.as_tensor(v) for k, v in a.items()}
        save_warm_start(path, P.Primal(x=t["x"], u=t["u"],
                                       theta=t["theta"]),
                        P.YVec(dyn=t["y_dyn"], nc=t["y_nc"], ec=t["y_ec"]))
    else:
        j = {k: jnp.asarray(v) for k, v in a.items()}
        j_save(path, JPrimal(x=j["x"], u=j["u"], theta=j["theta"]),
               JYVec(dyn=j["y_dyn"], nc=j["y_nc"], ec=j["y_ec"]))
    if reader == "port":
        vars, y = load_warm_start(path, device="cpu")
        assert isinstance(vars.x, torch.Tensor)
        assert vars.x.device.type == "cpu" and vars.x.dtype == torch.float64
        got = {k: v.numpy() for k, v in _fields(vars, y).items()}
        v32, _ = load_warm_start(path, device="cpu", dtype=torch.float32)
        assert v32.x.dtype == torch.float32
    else:
        got = _fields(*j_load(path))
    for k, v in a.items():
        assert got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert [p.name for p in tmp_path.iterdir()] == ["warm.npz"]  # no tmp


def test_checkpoint_rejects_other_files(tmp_path):
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, x=np.zeros(3))
    with pytest.raises(ValueError, match="not a warm-start checkpoint"):
        load_warm_start(bad, device="cpu")


def test_resume_from_checkpoint_equals_in_memory(tmp_path):
    """tests/test_utils_extras.py:81-111 on the port: a warm re-solve from
    the loaded file is bit-identical to the in-memory warm start."""
    spec, dims, topo = _port_nonlinear()
    prob = P.build_problem(spec, dims, topo,
                           torch.tensor([[0.4, -0.2]], dtype=torch.float64))
    res = P.solve(prob, P.Settings(max_iterations=40))
    assert res.status.tolist() == [P.SIPStatus.SOLVED]
    path = str(tmp_path / "warm.npz")
    save_warm_start(path, res.vars, res.y)
    vars, y = load_warm_start(path, device="cpu")
    settings = P.Settings(max_iterations=10, mu_init=1e-4)
    resumed = P.solve(prob, settings, init_vars=vars, init_y=y)
    mem = P.solve(prob, settings, init_vars=res.vars, init_y=res.y)
    assert resumed.status.tolist() == [P.SIPStatus.SOLVED]
    assert torch.equal(resumed.vars.u, mem.vars.u)
    assert torch.equal(resumed.vars.x, mem.vars.x)


def test_profiling_helpers(tmp_path):
    """trace_solve writes a Chrome trace of the block's ops;
    timed_block_until_ready returns the last result and best <= median."""
    import chip_smoke
    data = chip_smoke.random_chain(8, 3, 1, 2, 0, "cpu")
    sched = P.compile_topology(P.Topology.chain(8))
    with trace_solve(str(tmp_path / "trace")) as prof:
        P.lqr_factor_solve(data, sched)
    assert any(e.key.startswith("aten::") for e in prof.key_averages())
    trace = tmp_path / "trace" / "trace.json"
    assert trace.exists() and trace.stat().st_size > 0
    (sol, status), times = timed_block_until_ready(
        P.lqr_factor_solve, data, sched, reps=3)
    assert status.tolist() == [0, 0] and tuple(sol.x.shape) == (2, 9, 3)
    assert 0 < times["best_s"] <= times["p50_s"]
