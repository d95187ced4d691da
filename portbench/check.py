"""The output check: the recorded periods re-solved by the plain reference,
and the numbers that decide ``correct``.

The reference (``reference/``) runs each recorded (period, scenario) pair
again from the inputs the program was given in that period: the plant
state and the warm start, which the program made from the previous period's
output (the first recorded period's from the last settle period's, or from
the traffic alone where it has none).  It computes in float64 and shares
nothing with the program but those inputs.  Per pair, the gap of an output
is max |program - reference| / (1 + |reference|) over its elements,
infinite where either side is not finite.

* ``off_share``: the share of pairs whose status differs from the
  reference's, or whose largest gap over the next plant state and the next
  warm start (states, controls, dynamics multipliers) exceeds the
  configuration's ``gap_tol``.
* ``x_next_gap_p50``: the median over pairs of the next plant state's gap,
  which carries the control each plant applied.

A run is correct when each number is at most its limit in the
configuration's ``check``.

The reference is ``reference/<reference_model>.py`` of the configuration:
its ``build`` makes the plain model, and its ``period``, where it defines
one, the period; ``reference/mpc.py::period`` (a chain MPC period)
otherwise.
"""

from __future__ import annotations

import importlib.util
import math
import os

NUMBERS = ("off_share", "x_next_gap_p50")
FIELDS = ("x", "wx", "wu", "wy")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reference_module(cfg: dict, root: str = ROOT):
    """``portbench/reference/<reference_model>.py`` under ``root``, loaded
    inside the reference package, so that its relative imports find
    reference/sip.py."""
    name = cfg["reference_model"]
    spec = importlib.util.spec_from_file_location(
        f"portbench.reference.{name}",
        os.path.join(root, "portbench", "reference", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_model(cfg: dict, dtype, device):
    return reference_module(cfg).build(cfg["model_args"], dtype, device)[0]


def reference_periods(cfg: dict, x, wx, wu, wy, mode: str = "full",
                      block: int = 8192, root: str = ROOT) -> dict:
    """The reference's period for every row of (x, wx, wu, wy), in blocks
    of rows; ``mode`` "full" computes in float64, a control mode in float32
    at that lower precision (reference/sip.py's Arith)."""
    import torch
    from portbench.reference import mpc, sip
    dtype = torch.float64 if mode == "full" else torch.float32
    mod = reference_module(cfg, root)
    period = getattr(mod, "period", mpc.period)
    model = mod.build(cfg["model_args"], dtype, x.device)[0]
    ar = sip.Arith(mode)
    outs = []
    for i in range(0, x.shape[0], block):
        rows = slice(i, i + block)
        outs.append(period(model, cfg["settings"], cfg["hessian_mode"],
                           *(t[rows].to(dtype) for t in (x, wx, wu, wy)),
                           ar))
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


def _gap(a, b):
    import torch
    g = ((a.double() - b.double()).abs() / (1 + b.double().abs()))
    g = torch.where(torch.isfinite(g), g, math.inf).flatten(1)
    return g.amax(-1)


def numbers(prog: dict, ref: dict, gap_tol: float) -> dict:
    """The check's numbers from the program's outputs ``prog`` (x, wx, wu,
    wy, status per pair) and the reference's."""
    import torch
    x_gap = _gap(prog["x"], ref["x"])
    worst = torch.stack([_gap(prog[k], ref[k]) for k in FIELDS]).amax(0)
    off = (prog["status"].to(ref["status"].dtype) != ref["status"]) \
        | (worst > gap_tol)
    return {"off_share": float(off.double().mean()),
            "x_next_gap_p50": float(x_gap.quantile(
                0.5, interpolation="lower"))}


def judge(cfg: dict, pairs: dict, root: str = ROOT) -> tuple:
    """(correct, {number: (value, limit)}, pairs compared) for the
    recorded pairs of a run."""
    ref = reference_periods(cfg, pairs["x"], pairs["wx"], pairs["wu"],
                            pairs["wy"], root=root)
    prog = dict(x=pairs["out_x"], wx=pairs["out_wx"], wu=pairs["out_wu"],
                wy=pairs["out_wy"], status=pairs["status"])
    got = numbers(prog, ref, cfg["check"]["gap_tol"])
    limits = cfg["check"]["limits"]
    table = {k: (got[k], limits[k]) for k in NUMBERS}
    correct = all(v <= lim for v, lim in table.values())
    return correct, table, int(pairs["x"].shape[0])
