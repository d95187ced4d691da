"""A cell whose runner and reference are new files, and a cell over several
ranks, through the harness's own paths.

The cells here are written into ``tmp_path``: a BENCHMARK.json, a
configuration, a traffic file a cell, a runner kind (``portbench/toy.py``)
and a reference with its own period (``reference/halver.py``), beside
copies of a few metric readers.  The toy runner halves each rank's plant
states every period and sleeps in place of a solve; faults are planted by
its traffic.  Runs over several ranks go through ``run.launch`` in a
subprocess, gloo ranks on the CPU (a file store under the run's
``TMPDIR``), each wait bounded; the test on the cards runs the same over
NCCL.
"""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from portbench import check, run

ROOT = run.ROOT

TOY_RUNNER = r'''"""The tests' runner: ``rows`` plant states a rank,
halved and moved by 1 each period, which sleeps ``period_s`` (``slow_s``
on ``slow_rank``)."""
import os
import sys
import time

import torch


class Runner:
    def __init__(self, cfg, traffic, seed, device, rank, ranks):
        self.t, self.rank = traffic, rank
        self.device = torch.device(device)
        marks = traffic["marks"]
        with open(os.path.join(marks, f"pid{rank}"), "w") as fh:
            fh.write(str(os.getpid()))
        if rank and not os.path.exists(os.path.join(marks, "built")):
            raise RuntimeError("rank 0 had not built")
        self.batch = traffic["rows"]
        gen = torch.Generator().manual_seed(seed % 2 ** 31 + rank)
        self.x = torch.randn(self.batch, 2, generator=gen,
                             dtype=torch.float64).to(self.device)
        self.records, self.period_s = [], []
        self.iterations = self.trips = self.failed = 0
        self.launches, self.peak_window_bytes = {"toy": 1}, None
        self._fault("init")

    def _fault(self, where):
        if (self.rank, where) != (self.t.get("fault_rank"),
                                  self.t.get("fault_at")):
            return
        if self.t["fault"] == "raises":
            raise RuntimeError("a planted fault")
        if self.t["fault"] == "hangs":
            time.sleep(3600)
        if self.t["fault"] == "loads_jax":
            sys.modules["jax"] = type(sys)("jax")

    def build(self):
        time.sleep(0.2)
        open(os.path.join(self.t["marks"], "built"), "w").close()

    def period(self, record):
        x_next = 0.5 * self.x
        time.sleep(self.t["slow_s"] if self.rank == self.t.get("slow_rank")
                   else self.t["period_s"])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if record:
            self.records.append((self.x, x_next))
        self.x = x_next + 1.0
        self.iterations += self.batch
        self.trips += 1

    def warm(self):
        for _ in range(self.t["warm_periods"]):
            self.period(record=True)
        self._fault("warm")

    def window(self, seconds, over=None):
        t_start = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            self.period(record=True)
            self._fault("window")
            done = (over(t_start) if over is not None
                    else time.perf_counter() - t_start >= seconds)
            t1 = time.perf_counter()
            self.period_s.append(t1 - t0)
            if done:
                break
        self.window_s = t1 - t_start
        if self.device.type == "cuda":
            self.peak_window_bytes = torch.cuda.max_memory_allocated(
                self.device)

    def traced(self, periods):
        for _ in range(periods):
            self.period(record=False)
        return dict(window_s=1.0, busy_s=0.1 * (self.rank + 1), trips=periods,
                    kernels={}, device_ops=[["toy", 0.1]],
                    idle_gaps=[["sleep", 0.2]])

    def checked_pairs(self):
        n = self.t["check_scenarios"]
        x = torch.cat([a[:n] for a, _ in self.records])
        zero = x.new_zeros(x.shape[0], 3, 2)
        return dict(x=x, wx=zero, wu=zero, wy=zero,
                    out_x=torch.cat([b[:n] for _, b in self.records]),
                    out_wx=zero, out_wu=zero, out_wy=zero,
                    status=torch.zeros(x.shape[0], dtype=torch.int32,
                                       device=x.device))

    def free(self):
        self.x = None

    def work(self):
        return None
'''

TOY_REFERENCE = r'''"""The toy runner's plain reference: a period halves
the plant state."""
import torch

from .sip import SOLVED


def build(args, dtype, device):
    return None, None


def period(model, settings, hessian_mode, x, wx, wu, wy, arith):
    return dict(x=0.5 * x, wx=wx, wu=wu, wy=wy,
                status=torch.full((x.shape[0],), SOLVED, dtype=torch.int32,
                                  device=x.device))
'''

RANKS_READ = '''"""ranks_read: the ranks whose figures the readers
were given."""


def read(ctx):
    return len(ctx.ranks)
'''

TRAFFIC = dict(kind="toy", rows=6, check_scenarios=2, warm_periods=2,
               trace_periods=2, period_s=0.005, slow_s=0.005)


def _toy_root(tmp_path, cells):
    """A checkout's files for ``cells`` ({name: (chips, traffic changes)})
    under ``tmp_path``; returns (root, the toy runner's marks directory)."""
    root = tmp_path / "checkout"
    marks = tmp_path / "marks"
    for d in ("configs", "traffic", "metrics", "reference"):
        os.makedirs(root / "portbench" / d)
    os.makedirs(marks)
    (root / "portbench" / "toy.py").write_text(TOY_RUNNER)
    (root / "portbench" / "reference" / "halver.py").write_text(
        TOY_REFERENCE)
    (root / "portbench" / "metrics" / "ranks_read.py").write_text(RANKS_READ)
    for name in ("solves_per_s", "step_ms_p95", "setup_s",
                 "device_idle_pct"):
        shutil.copy(os.path.join(ROOT, "portbench", "metrics", name + ".py"),
                    root / "portbench" / "metrics")
    cfg = dict(name="toy_cfg", reference_model="halver", model_args={},
               settings={}, hessian_mode="exact",
               check=dict(gap_tol=1e-9, limits=dict(off_share=0.0,
                                                    x_next_gap_p50=1e-12)))
    (root / "portbench" / "configs" / "toy_cfg.json").write_text(
        json.dumps(cfg))
    workloads = []
    for name, (chips, changes) in cells.items():
        traffic = dict(TRAFFIC, marks=str(marks), **changes)
        (root / "portbench" / "traffic" / f"{name}.json").write_text(
            json.dumps(traffic))
        workloads.append(dict(name=name, config="toy_cfg", traffic=name,
                              chips=chips, why="a test"))
    names = list(cells)
    bench = dict(
        command=["python3", "portbench/run.py"], paths=["portbench"],
        run_seconds=1,
        configs=[dict(name="toy_cfg", source="a test",
                      file="portbench/configs/toy_cfg.json", reduced=[],
                      why="a test")],
        workloads=workloads,
        end_to_end=[
            dict(name="solves_per_s", unit="solves/s", better="higher",
                 bound=0.07, source="host_clock"),
            dict(name="step_ms_p95", unit="ms", better="lower", bound=0.15,
                 source="host_clock"),
            dict(name="setup_s", unit="s", better="lower", bound=0.25,
                 source="host_clock")],
        per_layer=[
            dict(name="device_idle_pct", unit="%", better="lower",
                 source="device_trace", layer="device",
                 moves="solves_per_s", workloads=names),
            dict(name="ranks_read", unit="ranks", better="higher",
                 source="program_counter", layer="scenario sharding",
                 moves="solves_per_s", workloads=names)])
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, marks


def _launch(root, workload, ranks, tmp_path, trace=0, seconds=0.6,
            deadline_s=90, device="cpu", timeout=240):
    """``run.launch`` in a fresh interpreter: (its completed process, its
    seconds, whether the group's directory under its TMPDIR was
    removed)."""
    tmpdir = tmp_path / "tmpdir"
    os.makedirs(tmpdir, exist_ok=True)
    code = ("import sys\nfrom portbench import run\n"
            f"sys.exit(run.launch({workload!r}, 2 ** 33 + 7, {seconds!r}, "
            f"{trace}, {ranks}, root={str(root)!r}, device={device!r}, "
            f"deadline_s={deadline_s!r}))\n")
    env = dict(os.environ, PYTHONPATH=ROOT, TMPDIR=str(tmpdir),
               OMP_NUM_THREADS="1")
    if device == "cpu":
        env["CUDA_VISIBLE_DEVICES"] = ""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=timeout)
    return out, time.perf_counter() - t0, os.listdir(tmpdir) == []


def _result(out):
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.splitlines()[-1])


def _all_stopped(marks, ranks):
    for r in range(ranks):
        path = marks / f"pid{r}"
        if not path.exists():
            continue
        try:
            os.kill(int(path.read_text()), 0)
        except ProcessLookupError:
            continue
        return False
    return True


def test_a_new_runner_kind_and_reference_are_new_files(tmp_path,
                                                       monkeypatch):
    """A one-card cell of a runner kind and a reference with its own period
    written as files only: run in this process, starting no process and
    joining no process group."""
    import torch
    root, _ = _toy_root(tmp_path, {"toy_x1": (1, {})})
    assert run.runner_class("toy", str(root)).__module__ \
        == "portbench_runner_toy"
    cell, cfg, traffic, metrics = run.load_cell("toy_x1", str(root))
    x = torch.arange(6.0, dtype=torch.float64).reshape(3, 2)
    zero = x.new_zeros(3, 3, 2)
    ref = check.reference_periods(cfg, x, zero, zero, zero, root=str(root))
    assert torch.equal(ref["x"], 0.5 * x)

    def no_process(*args, **kwargs):
        raise AssertionError("a one-card cell started a process")
    monkeypatch.setattr(subprocess, "Popen", no_process)
    res = run.measure(cell, cfg, traffic, metrics, 5, 0.3, 0, "cpu",
                      root=str(root))
    assert not torch.distributed.is_initialized()
    assert res["correct"], res["check"]
    assert res["device"]["count"] == 1
    periods = res["attempted"] // TRAFFIC["rows"]
    assert res["check"]["pairs_compared"] == (
        (periods + TRAFFIC["warm_periods"]) * TRAFFIC["check_scenarios"])
    assert set(res["metrics"]) == {"solves_per_s", "step_ms_p95", "setup_s"}


@pytest.mark.parametrize("ranks", (2, 4))
def test_ranks_print_one_line(tmp_path, ranks):
    """Every rank's rows attempted and checked; rank 0's periods last as
    long as the slowest rank's."""
    slow = 0.15
    root, marks = _toy_root(tmp_path, {"toy": (ranks, dict(
        slow_rank=1, slow_s=slow))})
    out, _, removed = _launch(root, "toy", ranks, tmp_path)
    res = _result(out)
    assert len([ln for ln in out.stdout.splitlines()
                if ln.startswith("{")]) == 1
    assert res["correct"], res["check"]
    assert res["device"] == {"platform": "cpu", "kind": "cpu",
                             "count": ranks, "memory_peak_bytes": None}
    rows = ranks * TRAFFIC["rows"]
    assert res["attempted"] % rows == 0
    periods = res["attempted"] // rows
    assert periods >= 2
    assert res["check"]["pairs_compared"] == ranks * (
        (periods + TRAFFIC["warm_periods"]) * TRAFFIC["check_scenarios"])
    assert res["metrics"]["step_ms_p95"]["value"] >= 1e3 * slow
    assert res["metrics"]["solves_per_s"]["value"] <= rows / slow
    assert removed and _all_stopped(marks, ranks)


def test_traced_ranks_merge_their_busy_time(tmp_path):
    root, marks = _toy_root(tmp_path, {"toy": (2, {})})
    res = _result(_launch(root, "toy", 2, tmp_path, trace=1)[0])
    assert res["correct"]
    # each rank's busy seconds averaged over the cards; rank 0's window
    assert res["device"]["busy_s"] == pytest.approx(0.15)
    assert res["device"]["window_s"] == 1.0
    assert res["breakdown"] == {"device_ops": [["toy", 0.1]],
                                "idle_gaps": [["sleep", 0.2]]}
    assert res["metrics"]["ranks_read"]["value"] == 2
    # the readers see rank 0's trace
    assert res["metrics"]["device_idle_pct"]["value"] == pytest.approx(90.0)


@pytest.mark.parametrize("fault,at,rank,code", (
    ("raises", "window", 1, 1), ("raises", "init", 0, 1),
    ("hangs", "window", 1, 1), ("loads_jax", "window", 1, 3)))
def test_a_failed_rank_ends_the_run(tmp_path, fault, at, rank, code):
    """A rank that raises, hangs or loads JAX: the run exits non-zero
    within its deadline, prints no result line and leaves no rank
    running."""
    deadline = 30
    root, marks = _toy_root(tmp_path, {"toy": (2, dict(
        fault=fault, fault_at=at, fault_rank=rank))})
    out, seconds, removed = _launch(root, "toy", 2, tmp_path,
                                    deadline_s=deadline)
    assert out.returncode == code, out.stderr[-4000:]
    assert not any(ln.startswith("{") for ln in out.stdout.splitlines())
    assert seconds < deadline + 20
    if fault == "hangs":
        assert "deadline" in out.stderr
        assert seconds >= deadline - 1
    assert removed and _all_stopped(marks, 2)


@pytest.mark.gpu
def test_ranks_over_nccl_on_the_cards(tmp_path):
    """The multi-rank path over NCCL, one rank a card (at most 4)."""
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs at least 2 CUDA cards")
    ranks = min(4, torch.cuda.device_count())
    slow = 0.05
    root, marks = _toy_root(tmp_path, {"toy": (ranks, dict(
        slow_rank=ranks - 1, slow_s=slow))})
    out, _, removed = _launch(root, "toy", ranks, tmp_path, device="cuda",
                              seconds=2.0)
    res = _result(out)
    assert res["correct"], res["check"]
    dev = res["device"]
    assert dev["platform"] == "gpu" and dev["count"] == ranks
    assert dev["kind"] == torch.cuda.get_device_name(0)
    assert dev["memory_peak_bytes"] > 0
    assert res["metrics"]["step_ms_p95"]["value"] >= 1e3 * slow
    assert res["check"]["pairs_compared"] % ranks == 0
    assert removed and _all_stopped(marks, ranks)
