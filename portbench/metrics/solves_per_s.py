"""solves_per_s: scenario re-solves completed in the window over its
seconds: the batch times the periods whose controls reached the host, over
the time from the window's start to the end of its last period."""


def read(ctx):
    return ctx.batch * len(ctx.period_s) / ctx.window_s
