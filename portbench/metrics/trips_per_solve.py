"""trips_per_solve: interior-point trips per re-solve, the mean of the
solver's per-scenario iteration counts over every period of the window."""


def read(ctx):
    return ctx.iterations / (ctx.batch * len(ctx.period_s))
