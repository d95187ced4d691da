"""The port's joint-θ solve across processes against the JAX package.

Four gloo ranks (subprocesses that never import ``jax``, joined through a
``file://`` store under ``tmp_path``) each hold 2 of the S=8 scenarios of
tests/test_joint_theta.py's shared-θ chain (double integrators of 4
edges pulled toward one setpoint θ, float64, tol 1e-10) and solve them as
ONE joint NLP with ``solve_joint_theta(..., mesh=scenario_mesh(...))``.
θ, status and iterations must be bit-identical on every rank; the result
must lie within 1e-12 of the port's one-process ``solve_joint_theta`` of
the whole batch and within tests/test_torch_joint_theta.py's 1e-7 of
JAX's ``solve_joint_theta(mesh=None)``.  A batch whose rank-0 scenarios
start at their own optimum (x0 = 0 with θ = 0) must finish as well: the
ranks take the group's trips, not their own.  Three fixed trips at a
large prox_reg must also give the one-process iterate: θ's prox term
counts once in the joint system (on rank 0), not once per rank.
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
from sip_optimal_control_tpu_torch.models import shared_theta_chain

from test_joint_theta import _joint_pieces as j_joint_pieces
from test_torch_sharding import collect_ranks, start_ranks

WORLD = 4
S = 8
SETTINGS = dict(max_iterations=60, tol=1e-10)
FIXED = dict(max_iterations=3, fixed_iterations=True, prox_reg=1e-2)
_PORT_ATOL = 1e-12
_RTOL = _ATOL = 1e-7          # tests/test_torch_joint_theta.py's bar
# tests/test_joint_theta.py's chain: dt 0.2, 4 edges, |u| <= 1, costs
# 0.5 (p - θ)^2 + 0.05 v^2 per node and 0.05 u^2 per edge
CHAIN = dict(horizon=4, dt=0.2, u_limit=1.0, q_vel=0.1, r_u=0.1)

_WORKER = r"""
from sip_optimal_control_tpu_torch._mesh import ScenarioMesh
from sip_optimal_control_tpu_torch.models import shared_theta_chain

# count the convergence-tested loop's group decisions
decisions = []
_any = ScenarioMesh.any
ScenarioMesh.any = lambda self, flags: decisions.append(1) or _any(self, flags)

spec, dims, topo, lower, upper = shared_theta_chain(
    **%r, dtype=torch.float64, device="cpu")
settings = P.Settings(**%r)
# three trips at a large prox_reg: the iterate shows where θ's prox term
# was counted (once in the joint system, not once per rank)
fixed = P.Settings(**%r)
mesh = P.scenario_mesh(device="cpu")
x0s = torch.as_tensor(np.random.default_rng(0).standard_normal((%d, 2)))
# rank 0's scenarios at their own optimum (x0 = 0, θ = 0)
skewed = x0s.clone()
skewed[:x0s.shape[0] // world] = 0.0
for label, batch, st in (("joint", x0s, settings),
                         ("skewed", skewed, settings),
                         ("fixed", x0s, fixed)):
    decisions.clear()
    res = P.solve_joint_theta(spec, dims, topo,
                              P.shard_scenarios(batch, mesh), st, mesh,
                              lower, upper)
    result[label] = dict(theta=res.vars.theta, status=res.status,
                         it=res.iterations, kkt=res.kkt_error,
                         u=res.vars.u, x=res.vars.x,
                         decisions=len(decisions))
""" % (CHAIN, SETTINGS, FIXED, S)


def _x0s():
    return np.random.default_rng(0).standard_normal((S, 2))


def _skewed():
    x0s = _x0s()
    x0s[:S // WORLD] = 0.0
    return x0s


@functools.lru_cache(maxsize=None)
def _port_one_process(label):
    spec, dims, topo, lower, upper = shared_theta_chain(
        **CHAIN, dtype=torch.float64, device="cpu")
    x0s = _skewed() if label == "skewed" else _x0s()
    settings = P.Settings(**(FIXED if label == "fixed" else SETTINGS))
    return P.solve_joint_theta(spec, dims, topo, torch.as_tensor(x0s),
                               settings, None, lower, upper)


@functools.lru_cache(maxsize=None)
def _jax_joint():
    spec, dims, topo, lower, upper = j_joint_pieces()
    want = jax.jit(lambda b: j_solve_joint_theta(
        spec, dims, topo, b, settings=J.Settings(**SETTINGS), lower=lower,
        upper=upper))(_x0s())
    return P.from_jax_numpy(P.SolveResult, jax.tree.map(np.asarray, want))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    started = start_ranks(_WORKER, tmp_path_factory.mktemp("joint"), WORLD)
    # the references while the ranks run
    _jax_joint()
    for label in ("joint", "skewed", "fixed"):
        _port_one_process(label)
    return collect_ranks(started)


def _gathered(ranks, label, key):
    return torch.cat([res[label][key] for res in ranks])


@pytest.mark.parametrize("label", ["joint", "skewed", "fixed"])
def test_theta_status_iterations_bit_identical_across_ranks(ranks, label):
    first = ranks[0][label]
    want = (P.SIPStatus.MAX_ITERATIONS if label == "fixed"
            else P.SIPStatus.SOLVED)
    assert first["status"].tolist() == [want] * (S // WORLD)
    for res in ranks:
        assert not res["jax_imported"]
        for key in ("theta", "status", "it"):
            t = res[label][key]
            assert bool((t == first[key][:1]).all()), (key, t)


@pytest.mark.parametrize("label", ["joint", "skewed"])
def test_every_trip_takes_the_groups_decision(ranks, label):
    """The loop asks the group once before each trip and once to stop."""
    for res in ranks:
        assert res[label]["decisions"] == int(res[label]["it"][0]) + 1


@pytest.mark.parametrize("label", ["joint", "skewed", "fixed"])
def test_matches_the_one_process_solve(ranks, label):
    ref = _port_one_process(label)
    assert _gathered(ranks, label, "status").tolist() == ref.status.tolist()
    assert _gathered(ranks, label, "it").tolist() == ref.iterations.tolist()
    for key, want in (("theta", ref.vars.theta), ("u", ref.vars.u),
                      ("x", ref.vars.x)):
        torch.testing.assert_close(_gathered(ranks, label, key), want,
                                   rtol=0, atol=_PORT_ATOL)


def test_matches_jax_solve_joint_theta(ranks):
    want = _jax_joint()
    assert _gathered(ranks, "joint", "status").tolist() == \
        want.status.tolist()
    assert _gathered(ranks, "joint", "it").tolist() == \
        want.iterations.tolist()
    for key, ref in (("theta", want.vars.theta), ("u", want.vars.u),
                     ("x", want.vars.x)):
        torch.testing.assert_close(_gathered(ranks, "joint", key), ref,
                                   rtol=_RTOL, atol=_ATOL)


def test_skewed_batch_moves_theta(ranks):
    """The skewed batch is a different joint problem: its θ differs from
    the first batch's, though rank 0's scenarios alone sit at θ = 0."""
    a = float(ranks[0]["joint"]["theta"][0, 0])
    b = float(ranks[0]["skewed"]["theta"][0, 0])
    assert abs(a - b) > 1e-3 and abs(b) > 1e-3
