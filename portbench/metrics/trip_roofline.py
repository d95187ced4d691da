"""trip_roofline: the window's loop trips, each over the whole batch, at the
least time the card could take for one trip's work (portbench/work.py:
the larger of its operations over the float32 peak and its bytes over the
memory rate), as a share of the window's seconds, in %."""

from portbench.work import bound_s


def read(ctx):
    flops, nbytes = ctx.work.trip()
    return 100.0 * ctx.trips * bound_s(flops, nbytes) / ctx.window_s
