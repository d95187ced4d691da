from .derivative_check import check_derivatives
from .profiling import count, counters, reset_counters, span, trace_solve
from .checkpoint import load_warm_start, save_warm_start
