"""kernel_share_pct: the port's own kernels' device time over all device
time in the traced periods, in %."""

from portbench.work import is_port_kernel


def read(ctx):
    if ctx.trace is None:
        return None
    total = sum(s for _, s in ctx.trace["kernels"].values())
    own = sum(s for k, (_, s) in ctx.trace["kernels"].items()
              if is_port_kernel(k))
    return 100.0 * own / total if total > 0 else None
