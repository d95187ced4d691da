"""The port's scenario sharding over processes against the JAX package.

Four gloo ranks, each a subprocess that imports the port and never
``jax``, share a ``file://`` store under ``tmp_path`` (no TCP port, so
xdist workers cannot collide).  Each rank solves its rows of
tests/test_sharding.py's batch (double integrator, horizon 10, B=16,
float64, tol 1e-8) with ``solve_batch_sharded``; the test process holds
the rows to JAX's single-device ``vmap(solve)`` (the oracle of JAX's own
sharded tests: statuses identical, controls within 1e-8) and to the port's
one-process ``solve`` of the whole batch (bit-identical: every scenario's
arithmetic is the same at 4 rows as at 16).  The statistics must equal the
host's reductions of the ranks' results; ``stats_collectives=False`` must
make no collective call; ranks that take different numbers of trips (one
rank's scenarios start at the optimum) must finish; a batch the ranks do
not divide must raise; and the group's loop decision must be one for
every rank.  A mesh without ``torch.distributed`` must equal ``solve`` bit
for bit.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import torch

from sip_optimal_control_tpu import Settings as JSettings
from sip_optimal_control_tpu.model import build_problem as j_build_problem
from sip_optimal_control_tpu.models import \
    double_integrator as j_double_integrator
from sip_optimal_control_tpu.solver.sip import solve as j_solve
import sip_optimal_control_tpu_torch as P
from sip_optimal_control_tpu_torch.models import double_integrator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
B = 16
SETTINGS = dict(max_iterations=30, tol=1e-8)
_JAX_ATOL = 1e-8
_PORT_ATOL = 1e-12
# a gloo collective that waits longer than this raises (a hang fails)
GROUP_TIMEOUT_S = 60

# the prologue every rank runs: join the group, then the body
RANK_PROLOGUE = r"""
import datetime, sys
rank, world, init, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
dist.init_process_group(
    "gloo", init_method="file://" + init, rank=rank, world_size=world,
    timeout=datetime.timedelta(seconds=%d))
import sip_optimal_control_tpu_torch as P
result = {}
""" % GROUP_TIMEOUT_S

RANK_EPILOGUE = r"""
result["jax_imported"] = any(k == "jax" or k.startswith("jax.")
                             for k in sys.modules)
torch.save(result, f"{out}/rank{rank}.pt")
dist.destroy_process_group()
"""

_WORKER = r"""
from sip_optimal_control_tpu_torch.models import double_integrator

spec, dims, topo = double_integrator(horizon=10)
settings = P.Settings(max_iterations=30, tol=1e-8)
mesh = P.scenario_mesh(device="cpu")
result["mesh"] = (mesh.rank, mesh.size, str(mesh.device))
x0s = torch.as_tensor(np.random.default_rng(0).standard_normal((%d, 2)))
local = P.shard_scenarios(x0s, mesh)
u, status, stats = P.solve_batch_sharded(spec, dims, topo, local, settings,
                                         mesh)
# the same rows through solve: kkt errors and iterations for the host
plain = P.solve(P.build_problem(spec, dims, topo, local), settings)
result["sharded"] = dict(u=u, status=status, stats=tuple(stats),
                         kkt=plain.kkt_error, it=plain.iterations,
                         plain_u=plain.vars.u)

# no collective at all without stats_collectives
calls = []
for name in ("all_reduce", "broadcast", "all_gather", "reduce",
             "all_gather_into_tensor", "reduce_scatter", "barrier"):
    real = getattr(dist, name)
    def counted(*a, _real=real, _name=name, **k):
        calls.append(_name)
        return _real(*a, **k)
    setattr(dist, name, counted)
_, _, local_stats = P.solve_batch_sharded(spec, dims, topo, local, settings,
                                          mesh, stats_collectives=False)
result["no_collectives"] = dict(calls=list(calls), stats=tuple(local_stats))
counted_calls = len(calls)
P.solve_batch_sharded(spec, dims, topo, local, settings, mesh)
result["collective_calls"] = len(calls) - counted_calls

# rank 0's scenarios start at the optimum: 0 trips there, more elsewhere
x0s_skew = x0s.clone()
x0s_skew[:x0s.shape[0] // world] = 0.0
_, status_k, stats_k = P.solve_batch_sharded(
    spec, dims, topo, P.shard_scenarios(x0s_skew, mesh), settings, mesh)
plain_k = P.solve(P.build_problem(spec, dims, topo,
                                  P.shard_scenarios(x0s_skew, mesh)),
                  settings)
result["skewed"] = dict(status=status_k, stats=tuple(stats_k),
                        it=plain_k.iterations)

try:
    P.shard_scenarios(torch.zeros(x0s.shape[0] - 1, 2), mesh)
    result["ragged_raised"] = False
except ValueError:
    result["ragged_raised"] = True

# the convergence-tested loop's decision: rank 1 alone still running
result["any"] = (mesh.any(torch.tensor([rank == 1])),
                 mesh.any(torch.tensor([False])))
""" % B


def start_ranks(body: str, out_dir, world: int = WORLD):
    """Starts ``body`` in ``world`` gloo ranks (subprocesses from the repo
    root) joined through a file store in ``out_dir``; ``collect_ranks``
    waits for them."""
    out_dir = str(out_dir)
    script = RANK_PROLOGUE + body + RANK_EPILOGUE
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    init = os.path.join(out_dir, "store")
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), str(world), init, out_dir],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=REPO) for r in range(world)]
    return procs, out_dir


def collect_ranks(started, timeout: int = 120):
    """Each rank's saved ``result`` dict; any rank's failure or timeout
    fails, and every rank is stopped."""
    procs, out_dir = started
    try:
        for r, proc in enumerate(procs):
            out, err = proc.communicate(timeout=timeout)
            assert proc.returncode == 0, (r, out, err[-4000:])
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(len(procs))]


def _x0s():
    return np.random.default_rng(0).standard_normal((B, 2))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    started = start_ranks(_WORKER, tmp_path_factory.mktemp("sharding"))
    # the references while the ranks run
    _jax_reference()
    _port_reference()
    return collect_ranks(started)


@functools.lru_cache(maxsize=None)
def _jax_reference():
    """JAX's single-device vmap(solve): (u [B, E, m], statuses [B])."""
    spec, dims, topo = j_double_integrator(horizon=10)
    settings = JSettings(**SETTINGS)

    def one(x0):
        res = j_solve(j_build_problem(spec, dims, topo, initial_state=x0),
                      settings)
        return res.vars.u, res.status

    u, status = jax.jit(jax.vmap(one))(_x0s())
    return np.asarray(u), np.asarray(status)


@functools.lru_cache(maxsize=None)
def _port_reference():
    spec, dims, topo = double_integrator(horizon=10)
    return P.solve(P.build_problem(spec, dims, topo, torch.as_tensor(_x0s())),
                   P.Settings(**SETTINGS))


def _rows(rank):
    per = B // WORLD
    return slice(rank * per, (rank + 1) * per)


def test_ranks_hold_their_rows_and_never_import_jax(ranks):
    for r, res in enumerate(ranks):
        assert res["mesh"] == (r, WORLD, "cpu")
        assert res["sharded"]["u"].shape[0] == B // WORLD
        assert not res["jax_imported"]


def test_sharded_solve_matches_jax_vmap(ranks):
    u_ref, status_ref = _jax_reference()
    u = torch.cat([res["sharded"]["u"] for res in ranks])
    status = torch.cat([res["sharded"]["status"] for res in ranks])
    assert status.tolist() == status_ref.tolist() == [0] * B
    np.testing.assert_allclose(u.numpy(), u_ref, rtol=0, atol=_JAX_ATOL)


def test_sharded_solve_matches_one_process_solve(ranks):
    """Within 1e-12 of the port's solve of the whole batch, and in fact
    bit-identical: the independent scenarios' arithmetic does not depend
    on how many rows share a process."""
    ref = _port_reference()
    for r, res in enumerate(ranks):
        u = res["sharded"]["u"]
        torch.testing.assert_close(u, ref.vars.u[_rows(r)], rtol=0,
                                   atol=_PORT_ATOL)
        assert torch.equal(u, ref.vars.u[_rows(r)])
        assert torch.equal(res["sharded"]["status"], ref.status[_rows(r)])
        assert torch.equal(u, res["sharded"]["plain_u"])


def test_stats_equal_the_host_reductions(ranks):
    statuses = torch.cat([res["sharded"]["status"] for res in ranks])
    kkt = torch.cat([res["sharded"]["kkt"] for res in ranks])
    means = [res["sharded"]["it"].float().mean() for res in ranks]
    for res in ranks:
        solved, max_kkt, mean_it = res["sharded"]["stats"]
        assert int(solved) == int((statuses == 0).sum()) == B
        assert solved.dtype == torch.int32
        assert float(max_kkt) == float(kkt.max())
        assert float(max_kkt) <= SETTINGS["tol"]
        # JAX's pmean of the per-shard means
        assert float(mean_it) == float(sum(means) / WORLD)
    # identical on every rank
    first = ranks[0]["sharded"]["stats"]
    for res in ranks[1:]:
        assert all(torch.equal(a, b)
                   for a, b in zip(res["sharded"]["stats"], first))


def test_no_collective_without_stats_collectives(ranks):
    for res in ranks:
        nc = res["no_collectives"]
        assert nc["calls"] == []
        solved, max_kkt, mean_it = nc["stats"]
        assert solved.shape == max_kkt.shape == mean_it.shape == (1,)
        sh = res["sharded"]
        assert int(solved[0]) == int((sh["status"] == 0).sum())
        assert float(max_kkt[0]) == float(sh["kkt"].max())
        assert float(mean_it[0]) == float(sh["it"].float().mean())
        # with them: one all_reduce per statistic, none in the loop
        assert res["collective_calls"] == 3


def test_ranks_taking_different_trips_finish(ranks):
    trips = [res["skewed"]["it"] for res in ranks]
    assert trips[0].tolist() == [0] * (B // WORLD)
    assert all(int(t.min()) > 0 for t in trips[1:])
    statuses = torch.cat([res["skewed"]["status"] for res in ranks])
    for res in ranks:
        solved, _, mean_it = res["skewed"]["stats"]
        assert int(solved) == int((statuses == 0).sum())
        assert float(mean_it) == float(
            sum(t.float().mean() for t in trips) / WORLD)


def test_batch_the_ranks_do_not_divide_raises(ranks):
    assert all(res["ragged_raised"] for res in ranks)


def test_loop_decision_is_the_groups(ranks):
    assert [res["any"] for res in ranks] == [(True, False)] * WORLD


def test_mesh_without_distributed_equals_solve():
    assert not torch.distributed.is_initialized()
    mesh = P.scenario_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.size) == (None, 0, 1)
    spec, dims, topo = double_integrator(horizon=10)
    x0s = P.shard_scenarios(_x0s(), mesh)
    assert torch.equal(x0s, torch.as_tensor(_x0s()))
    settings = P.Settings(**SETTINGS)
    u, status, stats = P.solve_batch_sharded(spec, dims, topo, x0s,
                                             settings, mesh)
    ref = _port_reference()
    assert torch.equal(u, ref.vars.u)
    assert torch.equal(status, ref.status)
    assert int(stats.total_solved) == B
    assert float(stats.max_kkt_error) == float(ref.kkt_error.max())
    assert float(stats.mean_iterations) == float(
        ref.iterations.float().mean())
    # the default mesh is the batch's device's
    u2, _, _ = P.solve_batch_sharded(spec, dims, topo, x0s, settings)
    assert torch.equal(u2, u)


def test_scenario_mesh_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.scenario_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.scenario_mesh(device="cuda:0")
    with pytest.raises(ValueError, match="not initialized"):
        P.scenario_mesh(group=object(), device="cpu")
    assert P.scenario_mesh(device="cpu").device == torch.device("cpu")
