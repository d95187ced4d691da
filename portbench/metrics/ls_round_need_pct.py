"""ls_round_need_pct: of the lanes the line search's probe rounds probed
in the traced periods, the share that needed the round (RUNNING, and no
candidate accepted before it), in %: the program's ``ls_round_needed``
over ``ls_round_lanes`` (``utils/profiling.py::counters``).  The counters
run while any profiler session records and nothing here resets them, so
the ratio spans every traced period of the run: the kept session's and
those of any session ``trace.py`` retried.  Nothing where the program
counts none."""


def read(ctx):
    if ctx.trace is None:
        return None
    from sip_optimal_control_tpu_torch.utils import profiling
    if not hasattr(profiling, "counters"):
        return None
    c = profiling.counters()
    lanes = c.get("ls_round_lanes", 0)
    return 100.0 * c["ls_round_needed"] / lanes if lanes else None
