"""The output check: what the harness and the reference load, the control
in the program's place and the timed path broken underneath, each judged
not correct; a whole run on the CPU at a small size.

The runs here skip the harness's look for a card (``run.measure`` on the
CPU, where the port runs its kernels' plain twins) and shrink the batch
and the window; the judging is the harness's own, with the configuration's
limits.
"""

import json
import os
import subprocess
import sys

import pytest

from portbench import run

ROOT = run.ROOT
SMALL = dict(batch=24, check_scenarios=12, settle_periods=1,
             warm_periods=1)
# the cartpole's next-state gaps read ~3e-4 over its first 10 periods and
# ~1e-6 from its 20th on, as in the settled window its limit is set for
SETTLE = {"cartpole_rti_fleet": 30}


def small(workload):
    """SMALL, with the settle periods that bring ``workload`` to the
    regime its limits hold in."""
    return dict(SMALL, settle_periods=SETTLE.get(workload, 1))
CELLS = ("cartpole_rti_fleet", "quadrotor_mpc_fleet")


def _loaded(code):
    """Top-level module names a fresh interpreter holds after ``code``."""
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_reference_loads_nothing_of_the_program_or_jax():
    mods = _loaded("import portbench.reference.sip, portbench.reference.mpc,"
                   " portbench.reference.cartpole,"
                   " portbench.reference.quadrotor, portbench.check,"
                   " portbench.work")
    assert not mods & {"jax", "jaxlib", "flax", "sip_optimal_control_tpu",
                       "sip_optimal_control_tpu_torch"}


def test_a_whole_run_loads_no_jax():
    code = ("from portbench import run\n"
            "c, cfg, t, m = run.load_cell('cartpole_rti_fleet')\n"
            f"t = dict(t, **{SMALL!r})\n"
            "r = run.measure(c, cfg, t, m, 3, 0.5, 0, 'cpu')\n"
            "import portbench.trace, portbench.control\n"
            "for name in ('step_ms_p95', 'trip_roofline', 'kernel_roofline',"
            " 'kernel_share_pct', 'device_idle_pct', 'launches_per_trip',"
            " 'factorizations_per_trip', 'peak_mem_gib', 'trips_per_solve',"
            " 'solves_per_s', 'setup_s'):\n"
            "    run.reader(name)\n"
            "assert not run.forbidden_modules()\n")
    mods = _loaded(code)
    assert "sip_optimal_control_tpu_torch" in mods
    assert not mods & set(run.FORBIDDEN)


def _measure(workload, runner_cls, seconds=0.5, seed=11):
    cell, cfg, traffic, metrics = run.load_cell(workload)
    return run.measure(cell, cfg, dict(traffic, **small(workload)), metrics,
                       seed, seconds, 0, "cpu", runner_cls=runner_cls)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    res = _measure(workload, None, seed=2 ** 33 + 5)
    assert res["correct"], res["check"]
    assert res["attempted"] % SMALL["batch"] == 0 and res["attempted"]
    # the warm and window periods are checked, the settle periods are not
    periods = res["attempted"] // SMALL["batch"] + SMALL["warm_periods"]
    assert res["check"]["pairs_compared"] == (
        periods * SMALL["check_scenarios"])
    # the numbers compared come last, beside their limits
    assert list(res)[-1] == "check"
    for k in ("off_share", "x_next_gap_p50"):
        assert set(res["check"][k]) == {"value", "limit"}


def _broken(fault):
    from portbench import fleet

    class Broken(fleet.Fleet):
        def solve_period(self):
            out = super().solve_period()
            if fault == "unchanged":
                # the step hands back the state it was given
                return out._replace(x=self.x, vars=self.wv, y=self.wy)
            if fault == "half":
                # half of the batch left out: its rows keep their inputs
                h = self.batch // 2
                x, vx, vu, y = (t.clone() for t in (
                    out.x, out.vars.x, out.vars.u, out.y.dyn))
                x[h:], vx[h:], vu[h:], y[h:] = (
                    self.x[h:], self.wv.x[h:], self.wv.u[h:],
                    self.wy.dyn[h:])
                return out._replace(x=x, vars=out.vars._replace(x=vx, u=vu),
                                    y=out.y._replace(dyn=y))
            # the answer altered where it is produced: every next state
            # off by 0.05
            return out._replace(x=out.x + 0.05)
    return Broken


@pytest.mark.parametrize("fault", ("unchanged", "half", "altered"))
@pytest.mark.parametrize("workload", CELLS)
def test_broken_timed_path_is_not_correct(workload, fault):
    res = _measure(workload, _broken(fault))
    assert not res["correct"], (fault, res["check"])


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    """The reference at the configuration's lower precision, in the
    program's place."""
    from portbench import control
    cell, cfg, traffic, metrics = run.load_cell(workload)
    res = run.measure(cell, cfg, dict(traffic, **small(workload)), metrics,
                      7, 0.5, 0, "cpu", runner_cls=control.control_fleet(
                          cfg["check"]["control"]))
    assert not res["correct"], res["check"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_run_on_the_card(workload):
    """A short run of the real command on the card."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", str(2 ** 32 + 9), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"


def test_seed_orders_one_population():
    """One seed gives the same inputs; another seed the same plants in
    another order, and other checked scenarios."""
    from portbench import fleet
    _, cfg, traffic, _ = run.load_cell("quadrotor_mpc_fleet")
    traffic = dict(traffic, **SMALL)
    a, b, c = (fleet.Fleet(cfg, traffic, s, "cpu") for s in (5, 5, 2 ** 40))
    assert bool((a.x == b.x).all()) and bool((a.sample == b.sample).all())
    assert not bool((a.x == c.x).all())
    rows = lambda f: sorted(map(tuple, f.x.tolist()))
    assert rows(a) == rows(c)
    assert bool((a._draw(a.x.dtype).sort(0).values
                 == c._draw(c.x.dtype).sort(0).values).all())
