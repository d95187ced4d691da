"""setup_s: from process start to the first timed period: imports, CUDA
set-up, the kernels built or loaded from the checkout's build cache, the
problem and the traffic made, the warm periods run."""


def read(ctx):
    return ctx.setup_s
