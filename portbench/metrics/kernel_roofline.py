"""kernel_roofline: over the port's kernels in the traced periods, the sum
of each launch's least time (portbench/work.py at the cell's shapes) over
the sum of their device time, in %.  Nothing where no kernel of the port
ran or none is counted."""

from portbench.work import bound_s


def read(ctx):
    if ctx.trace is None:
        return None
    least = spent = 0.0
    for name, (count, seconds) in ctx.trace["kernels"].items():
        w = ctx.work.kernel(name)
        if w is not None:
            least += count * bound_s(*w)
            spent += seconds
    return 100.0 * least / spent if spent > 0 else None
