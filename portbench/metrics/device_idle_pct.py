"""device_idle_pct: the share of the traced periods' host-clock time in
which no operation ran on the device, in %."""


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
