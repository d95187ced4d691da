from .derivative_check import check_derivatives
from .profiling import timed_block_until_ready, trace_solve
from .checkpoint import load_warm_start, save_warm_start
