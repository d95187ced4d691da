"""The port's spans and counters (utils/profiling.py) and the benchmark's
reading of them (portbench/spans.py).

Tracing is on exactly while a torch.profiler session records.  A traced
MPC step holds ``sip.mpc_step`` > ``sip.solve`` > ``sip.trip`` > the
trip's leaf spans, each with the ids of its solve and trip, and one
convergence test a trip plus one; the solver's outputs are the same bits
with tracing on and off; the counters stay at zero off and count what
they say on; and the span summary puts each device record and idle gap
under the span the host was in.  Imports no JAX; the one test marked
``gpu`` runs on the card:

    python -m pytest --noconftest -o addopts="" -m gpu \
        tests/test_torch_tracing.py
"""

import json
import os
import types
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import sip_optimal_control_tpu_torch as P
from sip_optimal_control_tpu_torch import models
from sip_optimal_control_tpu_torch._tree import tree_leaves
from sip_optimal_control_tpu_torch.solver.settings import \
    LineSearchSettings
from sip_optimal_control_tpu_torch.utils import (counters, reset_counters,
                                                 trace_solve)
from portbench import spans

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEAVES = ["sip.eval", "sip.kkt", "sip.line_search", "sip.update",
          "sip.eval", "sip.update"]
BATCH = 4


def _config(name):
    with open(os.path.join(ROOT, "portbench", "configs", name)) as fh:
        return json.load(fh)


def _settings(cfg, **over):
    st = dict(cfg["settings"], **over)
    ls = LineSearchSettings(**st.pop("line_search"))
    return P.Settings(line_search=ls, **st)


def _quadrotor(device="cpu", horizon=5):
    """The quadrotor cell's standard trip (exact Hessian, 3 factor retries,
    Armijo one candidate a round) at a small horizon and batch, cut to 2
    convergence-tested trips."""
    cfg = _config("quadrotor_h20_mpc.json")
    built = models.planar_quadrotor(horizon=horizon, target=(1.0, 1.5),
                                    dtype=torch.float32, device=device)
    start = torch.tensor([-0.5, 0, 0, 0, 0, 0.0], device=device)
    return built, _settings(cfg, max_iterations=2), "exact", start


def _cartpole(device="cpu", horizon=4):
    """The cartpole cell's fused trip (5 fixed trips, a filter search of 6
    candidates in one round) at a small horizon and batch."""
    cfg = _config("cartpole_h50_rti.json")
    built = models.cartpole_swingup(horizon=horizon, dtype=torch.float32,
                                    device=device)
    start = torch.zeros(4, device=device)
    return built, _settings(cfg), "gauss_newton", start


CASES = {"quadrotor": _quadrotor, "cartpole": _cartpole}


def _step(case, device="cpu"):
    """One MPC step of ``case`` from a fixed jittered start."""
    (spec, dims, topo, lower, upper, _), settings, mode, start = \
        CASES[case](device)
    N, E = dims.num_nodes, dims.num_edges
    n, m = dims.max_state_dim, dims.max_control_dim
    g = torch.Generator().manual_seed(3)
    x = (start.cpu() + 0.1 * torch.randn(BATCH, n, generator=g)).to(device)
    wv = P.Primal(x=x[:, None].expand(BATCH, N, n).contiguous(),
                  u=torch.zeros(BATCH, E, m, device=device),
                  theta=torch.zeros(BATCH, 0, device=device))
    wy = P.YVec(dyn=torch.zeros(BATCH, N, n, device=device),
                nc=torch.zeros(BATCH, N, 0, device=device),
                ec=torch.zeros(BATCH, E, 0, device=device))

    def run():
        return P.mpc_steps(spec, dims, topo, lower, upper, settings, x, wv,
                           wy, steps=1, hessian_mode=mode)
    return run, settings


@pytest.fixture(scope="module", params=sorted(CASES))
def step(request, tmp_path_factory):
    """One MPC step of the case untraced, then the same step under
    ``trace_solve``: both outputs, the counters after each, and the traced
    step's ``sip.*`` events."""
    run, settings = _step(request.param)
    reset_counters()
    off = run()
    off_counts = counters()
    with trace_solve(str(tmp_path_factory.mktemp("trace"))) as prof:
        on = run()
    return types.SimpleNamespace(
        settings=settings, off=off, on=on, off_counts=off_counts,
        on_counts=counters(),
        events=[e for e in prof.events() if e.name.startswith("sip.")])


def test_spans_nest_with_their_ids(step):
    ev = step.events
    steps = [e for e in ev if e.name == "sip.mpc_step"]
    solves = [e for e in ev if e.name == "sip.solve"]
    assert len(steps) == 1 and steps[0].kwinputs == {"step": 0}
    assert len(solves) == 1 and solves[0].cpu_parent is steps[0]
    sid = solves[0].kwinputs["solve"]
    trips = [e for e in ev if e.name == "sip.trip"]
    fixed = step.settings.fixed_iterations
    # a convergence-tested loop runs while any lane is RUNNING: as long as
    # the slowest
    assert len(trips) == (step.settings.max_iterations if fixed
                          else int(step.on.iterations.max()))
    for k, t in enumerate(trips):
        assert t.cpu_parent is solves[0]
        assert t.kwinputs == {"solve": sid, "trip": k}
        kids = [c for c in t.cpu_children if c.name.startswith("sip.")]
        assert [c.name for c in kids] == LEAVES
        assert all(c.kwinputs == t.kwinputs for c in kids)
        # the leaves tile the trip: every op of the trip is in a leaf
        assert len(kids) == len(t.cpu_children)
    tests = [e for e in ev if e.name == "sip.converged"]
    assert len(tests) == (0 if fixed else len(trips) + 1)
    assert all(e.cpu_parent is solves[0] and e.kwinputs == {"solve": sid}
               for e in tests)


def test_outputs_bit_identical_with_tracing_on(step):
    for a, b in zip(tree_leaves(step.off), tree_leaves(step.on),
                    strict=True):
        assert torch.equal(a, b)


def test_counters_off_zero_on_bounded(step):
    assert set(step.off_counts.values()) == {0}
    c, settings = step.on_counts, step.settings
    trips = sum(e.name == "sip.trip" for e in step.events)
    ls = settings.line_search
    rounds = -(-ls.max_steps // ls.chunk)
    assert c["ls_round_lanes"] == BATCH * rounds * trips
    assert c["factor_retry_lanes"] == (BATCH * settings.max_factor_retries
                                       * trips)
    assert 0 <= c["factor_retry_needed"] <= c["factor_retry_lanes"]
    # every RUNNING lane-trip needs its first round
    assert int(step.on.iterations.sum()) <= c["ls_round_needed"]
    assert c["ls_round_needed"] <= c["ls_round_lanes"]


def test_first_round_of_a_convex_problem_is_all_it_needs():
    """A linear-quadratic problem's Newton step passes Armijo at the first
    candidate, so the rounds needed are the RUNNING lane-trips."""
    spec, dims, topo = models.double_integrator(horizon=6)
    x0 = torch.tensor([[1.0, 0.0], [0.5, -0.3], [-1.0, 0.2]],
                      dtype=torch.float64)
    prob = P.build_problem(spec, dims, topo, x0)
    settings = P.Settings(max_iterations=20, line_search=LineSearchSettings(
        max_steps=10, chunk=1))
    reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        res = P.solve(prob, settings)
    c = counters()
    assert res.status.tolist() == [P.SIPStatus.SOLVED] * 3
    assert c["ls_round_needed"] == int(res.iterations.sum())
    assert c["ls_round_lanes"] == 3 * 10 * int(res.iterations.max())


# ----- portbench/spans.py on hand-built sessions ---------------------------

def test_summary_attributes_device_and_idle_time():
    # host (us): a solve [0, 100] holding a trip [10, 90] with leaves kkt
    # [10, 50] and update [50, 90]; the convergence test [92, 98]
    host = [("sip.solve", 0, 100), ("sip.trip", 10, 90),
            ("sip.kkt", 10, 50), ("sip.update", 50, 90),
            ("sip.converged", 92, 98)]
    # device records (start, end, launch): two kernels launched in kkt,
    # one in update, one in the solve before the trip, one before every
    # span, one whose launch is not in the session
    dev = [(20, 30, 12, "factor"), (30, 45, 40, "solve"),
           (60, 64, 55, "where"), (95, 99, 5, "add"), (-10, -5, -20, "add"),
           (120, 121, None, "copy")]
    got = spans.summarise(host, dev)
    s = got["spans"]
    assert s["sip.kkt"]["device_s"] == pytest.approx(25e-6)
    assert s["sip.update"]["device_s"] == pytest.approx(4e-6)
    assert s["sip.solve"]["device_s"] == pytest.approx(4e-6)
    assert s["sip.trip"]["device_s"] == 0.0
    assert s[spans.OUTSIDE]["device_s"] == pytest.approx(5e-6)
    assert s[spans.UNLINKED]["device_s"] == pytest.approx(1e-6)
    assert got["device_s"] == pytest.approx(39e-6)
    # gaps open at -5 (no span), 45 (kkt), 64 (update), 99 (solve)
    assert s[spans.OUTSIDE]["idle_s"] == pytest.approx(25e-6)
    assert s["sip.kkt"]["idle_s"] == pytest.approx(15e-6)
    assert s["sip.update"]["idle_s"] == pytest.approx(31e-6)
    assert s["sip.solve"]["idle_s"] == pytest.approx(21e-6)
    assert got["idle_s"] == pytest.approx(92e-6)
    assert s["sip.trip"]["count"] == 1
    assert s["sip.trip"]["host_s"] == pytest.approx(80e-6)
    for key in ("device_s", "idle_s"):
        assert sum(spans.shares(got, key).values()) == pytest.approx(100.0)
    top = spans.top_kernels(host, dev, count=1)
    assert top["sip.kkt"] == [["solve", pytest.approx(15e-6)]]
    assert top[spans.UNLINKED] == [["copy", pytest.approx(1e-6)]]


def test_innermost_span_of_repeated_and_nested_leaves():
    host = [("sip.trip", 0, 10), ("sip.eval", 0, 2), ("sip.kkt", 2, 5),
            ("sip.eval", 5, 7), ("sip.trip", 11, 20), ("sip.eval", 11, 12)]
    at = [1, 2.5, 6, 8, 10.5, 11.5, 15, 25]
    names = [host[i][0] if i >= 0 else None
             for i in spans.innermost(host, at)]
    assert names == ["sip.eval", "sip.kkt", "sip.eval", "sip.trip", None,
                     "sip.eval", "sip.trip", None]



def test_spans_cli_runs_only_on_the_card(monkeypatch, capsys):
    """``portbench/spans.py`` takes the cell's own batch on ``cuda:0``: it
    has no option to shrink the batch or leave the card, and exits 2
    without one."""
    with pytest.raises(SystemExit):
        spans.main(["--workload", "cartpole_rti_fleet", "--seed", "1",
                    "--batch", "4"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert spans.main(["--workload", "cartpole_rti_fleet", "--seed",
                       "2147483923"]) == 2
    assert "needs a CUDA card" in capsys.readouterr().err

def _syncs(fn):
    """The synchronising CUDA operations ``fn()`` calls, by the card's
    sync debug mode."""
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return [w for w in seen
            if str(w.message) == "called a synchronizing CUDA operation"]


@pytest.mark.gpu
def test_tracing_adds_no_synchronisation(tmp_path):
    """The fixed-trip paths, the fused (cartpole) and the standard
    (quadrotor), call the same synchronising operations traced as
    untraced: a span or counter never waits for the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    device = torch.device("cuda", 0)
    for case in ("cartpole", "quadrotor"):
        built, settings, mode, start = CASES[case](device)
        spec, dims, topo, lower, upper, _ = built
        if case == "quadrotor":
            settings = _settings(_config("quadrotor_h20_mpc.json"),
                                 max_iterations=3, fixed_iterations=True)
        x0 = start.expand(BATCH, -1).contiguous()
        prob = P.build_problem(spec, dims, topo, x0, lower, upper,
                               hessian_mode=mode)
        P.solve(prob, settings)          # builds the kernels
        torch.cuda.synchronize()
        untraced = _syncs(lambda: P.solve(prob, settings))
        with trace_solve(str(tmp_path / case)):
            traced = _syncs(lambda: P.solve(prob, settings))
        assert len(traced) == len(untraced), (case, len(untraced),
                                              len(traced))
        assert counters()["ls_round_lanes"] > 0
