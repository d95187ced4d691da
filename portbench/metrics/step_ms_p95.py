"""step_ms_p95: the 95th percentile (nearest rank) over every control
period of the window of one period's time, from the call until its applied
controls have synchronised, in ms."""

import math


def read(ctx):
    times = sorted(ctx.period_s)
    return 1e3 * times[math.ceil(0.95 * len(times)) - 1]
