"""Readings for the output check's limits: the check's numbers of the
program, or of a control in its place, on several seeds in one process.

    python3 portbench/control.py --workload NAME --seeds 11,12,13 \\
        --periods 5 [--mode program|tf32|bf16]

``--mode program`` runs the port as a benchmark run does (settle and warm
periods, then ``--periods`` periods); a control mode puts the plain
reference, computed in float32 at that lower precision (reference/sip.py's
Arith), in the program's place for the whole batch in every recorded
period (the program runs the settle periods), and the check compares it
with the float64 reference like the program.  One JSON line per seed.  The
benchmark's own runs never run a control.
"""

import argparse
import json
import os
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_fleet(mode: str):
    """A Fleet whose timed call is the reference at precision ``mode``."""
    from portbench import check, fleet
    from portbench.reference import mpc, sip

    class ControlFleet(fleet.Fleet):
        in_control = True

        def settle(self):
            # the program's own periods bring the fleet to where a
            # benchmark run's warm periods start; the control takes every
            # recorded period
            self.in_control = False
            super().settle()
            self.in_control = True

        def solve_period(self):
            if not self.in_control:
                return super().solve_period()
            import torch
            model = check.reference_model(self.cfg, torch.float32,
                                          self.x.device)
            r = mpc.period(model, self.cfg["settings"], self.hessian_mode,
                           self.x, self.wv.x, self.wv.u, self.wy.dyn,
                           sip.Arith(mode))
            zero = self.wy.nc
            return types.SimpleNamespace(
                x=r["x"],
                vars=self.wv._replace(x=r["wx"], u=r["wu"]),
                y=self.wy._replace(dyn=r["wy"], nc=zero),
                statuses=r["status"][None], kkt_errors=r["kkt"][None],
                iterations=r["iterations"][None])
    return ControlFleet


def readings(workload: str, seeds, periods: int, mode: str, device,
             traffic_over=None):
    """The check's numbers on each seed, as dicts."""
    from portbench import check, fleet, run
    _, cfg, traffic, _ = run.load_cell(workload)
    traffic = dict(traffic, **(traffic_over or {}))
    cls = fleet.Fleet if mode == "program" else control_fleet(mode)
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        f = cls(cfg, traffic, seed, device)
        f.warm()
        for _ in range(periods):
            f.period(record=True)
        pairs = f.checked_pairs()
        f.free()
        correct, table, n = check.judge(cfg, pairs)
        out.append(dict(workload=workload, mode=mode, seed=seed,
                        correct=correct, pairs=n,
                        seconds=time.perf_counter() - t0,
                        **{k: v for k, (v, _) in table.items()}))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--periods", type=int, default=5)
    p.add_argument("--mode", default="program",
                   choices=("program", "tf32", "bf16"))
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("control.py needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    for r in readings(args.workload, [int(s) for s in args.seeds.split(",")],
                      args.periods, args.mode, torch.device("cuda", 0)):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
