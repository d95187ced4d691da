"""peak_mem_gib: the allocator's peak over the window, after a reset at its
start, in GiB."""


def read(ctx):
    if ctx.peak_window_bytes is None:
        return None
    return ctx.peak_window_bytes / 2 ** 30
