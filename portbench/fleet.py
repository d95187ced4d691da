"""The fleet runner: a batch of warm-started MPC controllers, one control
period per call of the port's ``mpc_steps``, back to back.

Traffic (a ``traffic/<mix>.json`` of kind ``fleet``) fixes the batch, the
start states (a start state plus ``start_jitter`` standard normals), the
plant disturbance added after each period (``disturbance`` standard
normals), the untimed settle and warm periods, the scenarios whose periods
the output check re-solves and the periods a traced run profiles.

The settle periods (``settle_periods``, none where the traffic has no such
key) run the closed loop through its start-up transient before anything is
recorded.  A fleet's failures a period fall as its plants settle (the
cartpole's from ~1,800 a period over its first 50 to a steady ~366 from
its 300th on), so a window that began at the start would count a share of
failures that depends on how many periods the program fits into it; and
its next-state gaps to the reference fall from ~3e-4 over its first 10
periods to ~1e-6 from its 20th, the regime its check's limits are set in.

The plants and their disturbances are one population, drawn on the card
from a fixed stream; ``--seed`` orders it (a permutation of the batch) and
draws the checked scenarios.  So one seed gives the same inputs, and every
seed gives the same work in another order: a convergence-tested period
lasts as long as its slowest plant, and fresh draws per seed moved the
quadrotor cell's rate by 5% between seeds against 0.1% between two runs of
one seed.  The program receives only the generated inputs.
"""

from __future__ import annotations

import time

# the population's stream
POPULATION_SEED = 0
SOLVED, MAX_ITERATIONS = 0, 1
KKT_RESET = 1e2


def program_settings(cfg: dict):
    """The port's Settings from a configuration's ``settings``."""
    from sip_optimal_control_tpu_torch import Settings
    from sip_optimal_control_tpu_torch.solver.settings import \
        LineSearchSettings
    fields = dict(cfg["settings"])
    ls = LineSearchSettings(**fields.pop("line_search"))
    return Settings(line_search=ls, **fields)


class Fleet:
    """One run of a fleet cell on ``device``; the fleet is one card's, so
    ``rank`` and ``ranks`` (run.py's runner arguments) are 0 and 1."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 rank: int = 0, ranks: int = 1):
        if ranks != 1:
            raise ValueError(f"a fleet runs on one card, not {ranks}")
        import torch
        from sip_optimal_control_tpu_torch import Primal, YVec, models
        self.torch = torch
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.batch = traffic["batch"]
        dtype = getattr(torch, cfg["dtype"])
        built = getattr(models, cfg["model"])(**cfg["model_args"],
                                              dtype=dtype, device=device)
        self.spec, self.dims, self.topo, self.lower, self.upper, _ = built
        self.settings = program_settings(cfg)
        self.hessian_mode = cfg["hessian_mode"]
        d = self.dims
        N, E = d.num_nodes, d.num_edges
        n, m = d.max_state_dim, d.max_control_dim
        self.n, self.m, self.T = n, m, E
        B = self.batch
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(POPULATION_SEED)
        cpu = torch.Generator().manual_seed(seed)
        self.order = torch.randperm(B, generator=cpu).to(device)
        self.sample = torch.randperm(B, generator=cpu)[
            :traffic["check_scenarios"]].sort().values.to(device)
        start = torch.tensor(traffic["start_state"], dtype=dtype,
                             device=device)
        x = start + traffic["start_jitter"] * self._draw(dtype)
        zeros = dict(dtype=dtype, device=device)
        self.x = x
        self.wv = Primal(x=x[:, None].expand(B, N, n).contiguous(),
                         u=torch.zeros(B, E, m, **zeros),
                         theta=torch.zeros(B, 0, **zeros))
        self.wy = YVec(dyn=torch.zeros(B, N, n, **zeros),
                       nc=torch.zeros(B, N, 0, **zeros),
                       ec=torch.zeros(B, E, 0, **zeros))
        self.records = []
        self.stats = []
        self.period_s = []

    def _draw(self, dtype):
        """The population's next [B, n] standard normals, in the seed's
        order."""
        z = self.torch.randn(self.batch, self.n, generator=self.gen,
                             device=self.device, dtype=dtype)
        return z.index_select(0, self.order)

    # ----- one control period ----------------------------------------------
    def solve_period(self):
        """The timed call: one period of the port's ``mpc_steps`` from the
        current plant states and warm start, with no disturbance of its
        own."""
        from sip_optimal_control_tpu_torch import mpc_steps
        return mpc_steps(self.spec, self.dims, self.topo, self.lower,
                         self.upper, self.settings, self.x, self.wv, self.wy,
                         steps=1, hessian_mode=self.hessian_mode, noise=0.0)

    def period(self, record: bool):
        """Re-solves every controller from its plant state, warm-started;
        applies the first controls, adds the disturbance, synchronises."""
        torch = self.torch
        out = self.solve_period()
        if record:
            idx = self.sample
            self.records.append(tuple(t.index_select(0, idx) for t in (
                self.x, self.wv.x, self.wv.u, self.wy.dyn, out.x,
                out.vars.x, out.vars.u, out.y.dyn, out.statuses[0],
                out.kkt_errors[0], out.iterations[0])))
        st, kkt, it = out.statuses[0], out.kkt_errors[0], out.iterations[0]
        usable = (st == SOLVED) | ((st == MAX_ITERATIONS) & (kkt < KKT_RESET))
        trips = (it.new_full((), self.settings.max_iterations)
                 if self.settings.fixed_iterations else it.max())
        self.stats.append(torch.stack([it.sum(), trips.to(torch.int64),
                                       (~usable).sum()]))
        noise = self.traffic["disturbance"] * self._draw(out.x.dtype)
        self.x, self.wv, self.wy = out.x + noise, out.vars, out.y
        self._sync()

    def _sync(self):
        if self.x.is_cuda:
            self.torch.cuda.synchronize(self.device)

    def warm(self):
        """The untimed periods: the settle periods, unrecorded, then the
        warm periods, in which every shape the window uses is built, loaded
        and run once.  The warm periods are checked like the window's."""
        self.settle()
        for _ in range(self.traffic["warm_periods"]):
            self.period(record=True)
        self.stats.clear()

    def settle(self):
        """The traffic's settle periods: the closed loop, unrecorded."""
        for _ in range(self.traffic.get("settle_periods", 0)):
            self.period(record=False)

    def window(self, seconds: float):
        """Back-to-back periods until ``seconds`` have passed; each period's
        host-clock time from the call to its synchronise."""
        torch = self.torch
        from sip_optimal_control_tpu_torch.ops import (fused_iter, ls_probe,
                                                       riccati_cuda)
        self.counted = (fused_iter, ls_probe, riccati_cuda)
        for mod in self.counted:
            mod.reset_launch_counts()
        on_card = self.x.is_cuda
        if on_card:
            torch.cuda.reset_peak_memory_stats(self.device)
        t_start = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            self.period(record=True)
            t1 = time.perf_counter()
            self.period_s.append(t1 - t0)
            if t1 - t_start >= seconds:
                break
        self.window_s = t1 - t_start
        self.launches = {}
        for mod in self.counted:
            self.launches.update(mod.launch_counts)
        self.peak_window_bytes = (torch.cuda.max_memory_allocated(
            self.device) if on_card else None)
        stats = torch.stack(self.stats).sum(0).tolist()
        self.iterations, self.trips, self.failed = (int(v) for v in stats)
        self.stats.clear()

    def traced(self, periods: int):
        """``periods`` more periods under the profiler, and the trips they
        ran."""
        from portbench import trace

        def run():
            for _ in range(periods):
                self.period(record=False)
        summary = trace.profile(run)
        per_session = self.torch.stack(self.stats).sum(0).tolist()
        # the sessions that held no device record ran their periods too
        summary["trips"] = int(per_session[1]) / summary["tries"]
        self.stats.clear()
        return summary

    def free(self):
        """Drops the program's state, so the reference runs in the room it
        took."""
        on_card = self.x.is_cuda
        self.x = self.wv = self.wy = None
        if on_card:
            self.torch.cuda.empty_cache()

    def work(self):
        """The work counts of portbench/work.py at this fleet's shapes."""
        import torch
        from portbench import check, work
        ref_model = check.reference_model(self.cfg, torch.float32, "cpu")
        ops = (work.scalar_ops(ref_model.dynamics, torch.zeros(self.n),
                               torch.zeros(self.m)),
               work.scalar_ops(ref_model.node_cost, torch.zeros(self.n),
                               torch.tensor(1.0)),
               work.scalar_ops(ref_model.edge_cost, torch.zeros(self.n),
                               torch.zeros(self.m)))
        ls = self.cfg["settings"]["line_search"]
        return work.CellWork(
            self.T, self.n, self.m, self.batch, max(1, int(ls["chunk"])),
            self.cfg["hessian_mode"] == "exact",
            work.finite_count(self.lower.u[0]) + work.finite_count(
                self.upper.u[0]),
            work.finite_count(self.lower.x[0]) + work.finite_count(
                self.upper.x[0]), ops)

    def checked_pairs(self):
        """The recorded (period, scenario) pairs, each field stacked:
        inputs x, wx, wu, wy; the program's outputs x_next, wx, wu, wy,
        status, kkt, iterations."""
        torch = self.torch
        names = ("x", "wx", "wu", "wy", "out_x", "out_wx", "out_wu",
                 "out_wy", "status", "kkt", "iterations")
        return {k: torch.cat([r[i] for r in self.records])
                for i, k in enumerate(names)}


Runner = Fleet
