"""Profiling: torch.profiler sessions, the solver's spans and its counters.

PyTorch port of ``sip_optimal_control_tpu/utils/profiling.py``: the JAX
package traces with jax.profiler, this package with torch.profiler (the
reference measures performance only through its google_benchmark
binaries, SURVEY section 5).

Tracing is on exactly while a torch.profiler session records
(``torch.autograd._profiler_enabled()``); there is no other switch.  While
it is off, ``span`` and ``leaves`` hand back shared do-nothing context
managers and the solver computes no counter mask, so each span site costs
one flag check.  While it is on:

* ``span(name, **ids)`` records a host range named ``name`` in the
  session, beside the device's kernels on the same clock, with ``ids`` as
  its keyword inputs (shown when the session records shapes, as
  ``trace_solve``'s does).  The ranges are recorded at function scope,
  not as user annotations, so they add no record to the device's
  timeline; their host time is the session's own record of them.
* ``count(name, lanes)`` adds to a counter: a bool mask [B] adds 1 on each
  true lane in a per-lane int64 tensor on the mask's device (one in-place
  add, nothing read back), an int adds that many lanes on the host.
  ``counters()`` reduces them to Python ints.

The solver's spans (``solver/sip.py``, ``solver/fused_chain.py``,
``mpc.py``), each with its ids:

* ``sip.mpc_step`` (step): one step of ``mpc_steps``, from
  ``build_problem`` to the shifted warm start.
* ``sip.solve`` (solve): ``solve``, from initialisation to the result;
  ``solve`` is a process-wide count of solves.
* ``sip.converged`` (solve): the convergence test's host check, once per
  loop trip plus one (convergence-tested solves only).
* ``sip.trip`` (solve, trip): one loop trip, the body and the freeze
  select.  Its leaves, in order, tile it:
  ``sip.eval`` (the KKT residuals at the current iterate and the barrier
  update), ``sip.kkt`` (the regularizations, the Newton right-hand side,
  the factor with every retry, the solve, iterative refinement, the
  direction recovery and the scrub), ``sip.line_search`` (the maximum
  steps, the merit and its slope, every probe round, the filter update),
  ``sip.update`` (the min-alpha safeguard, the step along the direction
  and the multiplier safeguards), ``sip.eval`` again (the model
  evaluation and KKT error at the accepted iterate), ``sip.update`` again
  (the status and the freeze select).

The counters:

* ``factor_retry_lanes`` / ``factor_retry_needed``: for each factor retry,
  every lane refactored (the batch) against the RUNNING lanes whose
  previous attempt failed.
* ``ls_round_lanes`` / ``ls_round_needed``: for each line-search probe
  round, every lane probed against the RUNNING lanes not yet accepted
  before the round.
"""

from __future__ import annotations

import contextlib
import itertools
import os

import torch
from torch.profiler import ProfilerActivity, profile

COUNTERS = ("factor_retry_lanes", "factor_retry_needed", "ls_round_lanes",
            "ls_round_needed")

# a range at function scope: torch.profiler.record_function's user scope
# would also put a record of every span on the device's timeline
_record = torch._C._profiler._RecordFunctionFast
_OFF = contextlib.nullcontext()
_solves = itertools.count()
_lane_counts: dict = {}    # (name, shape, device) -> int64 tensor
_host_counts: dict = {}    # name -> int


def _synchronize() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace_solve(log_dir: str):
    """Capture a torch.profiler trace (host ops, the solver's ``sip.*``
    spans with their ids, and the card's kernels when there is one) around
    the block; on exit it is written to ``log_dir/trace.json`` in the
    Chrome trace format (chrome://tracing, Perfetto).  Yields the
    profiler, whose ``key_averages()`` sums the time by op, span and
    kernel.  The counters are reset at the start, so ``counters()`` after
    the block holds this session's."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    reset_counters()
    with profile(activities=activities, record_shapes=True) as prof:
        yield prof
        _synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def tracing() -> bool:
    """Whether a torch.profiler session records: the one switch of the
    spans and counters."""
    return torch.autograd._profiler_enabled()


def next_solve_id() -> int:
    """The process-wide number of the next solve (the spans' ``solve``)."""
    return next(_solves)


def span(name: str, **ids):
    """A context manager: the span ``name`` with ``ids`` while tracing is
    on, a shared ``nullcontext`` while it is off."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _record(name, (), ids)


class _Leaves:
    """Consecutive spans that tile a block: each call closes the open span
    and opens the next; leaving the block closes the last."""

    def __init__(self, ids: dict):
        self.ids, self.open = ids, None

    def __call__(self, name: str) -> None:
        self._close()
        self.open = _record(name, (), self.ids)
        self.open.__enter__()

    def _close(self) -> None:
        if self.open is not None:
            self.open.__exit__(None, None, None)
            self.open = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._close()


class _NoLeaves:
    def __call__(self, name: str) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


_NO_LEAVES = _NoLeaves()


def leaves(**ids):
    """A context manager yielding ``leaf(name)``, which ends the block's
    open leaf span and starts ``name`` with ``ids``; it does nothing while
    tracing is off."""
    if not torch.autograd._profiler_enabled():
        return _NO_LEAVES
    return _Leaves(ids)


def count(name: str, lanes) -> None:
    """Adds ``lanes`` to counter ``name``: a bool tensor adds 1 on each
    true lane on its device, an int adds that many on the host.  Callers
    count only while ``tracing()``."""
    if isinstance(lanes, int):
        _host_counts[name] = _host_counts.get(name, 0) + lanes
        return
    key = (name, tuple(lanes.shape), lanes.device)
    acc = _lane_counts.get(key)
    if acc is None:
        acc = _lane_counts[key] = torch.zeros(
            lanes.shape, dtype=torch.int64, device=lanes.device)
    acc.add_(lanes)


def counters() -> dict:
    """Every counter of ``COUNTERS`` (and any other counted) as a Python
    int, summed over lanes and devices; reads the devices back."""
    out = dict.fromkeys(COUNTERS, 0)
    out.update(_host_counts)
    for (name, _, _), acc in _lane_counts.items():
        out[name] = out.get(name, 0) + int(acc.sum())
    return out


def reset_counters() -> None:
    """Zeroes every counter."""
    _lane_counts.clear()
    _host_counts.clear()
