"""retry_need_pct: of the lanes the factor retries refactored in the
traced periods, the share that needed it (RUNNING, and the previous
attempt failed), in %: the program's ``factor_retry_needed`` over
``factor_retry_lanes`` (``utils/profiling.py::counters``).  The counters
run while any profiler session records and nothing here resets them, so
the ratio spans every traced period of the run: the kept session's and
those of any session ``trace.py`` retried.  Nothing where no retry ran or
the program counts none."""


def read(ctx):
    if ctx.trace is None:
        return None
    from sip_optimal_control_tpu_torch.utils import profiling
    if not hasattr(profiling, "counters"):
        return None
    c = profiling.counters()
    lanes = c.get("factor_retry_lanes", 0)
    return 100.0 * c["factor_retry_needed"] / lanes if lanes else None
