"""The solver's ``sip.*`` spans in one torch.profiler session: for each span
name, its count, its inclusive host seconds, the device seconds of the
kernels launched inside it and the device idle seconds that opened inside
it.

    python3 portbench/spans.py --workload NAME --seed N [--periods P]

runs the cell's warm periods, then ``P`` periods (the traffic's
``trace_periods`` by default) under torch.profiler, and prints one JSON
line: the summary below, each span's share of the device time and idle
time, ``trip_host_ms`` (the ``sip.trip`` spans' host milliseconds over
their count) and the program's counters.  Runs on ``cuda:0`` at the
traffic's batch, from the root of a checkout; exits 2 without a card.

A kernel belongs to the innermost span open on the host when the runtime
call that launched it started (the kernel and its launch share a
correlation id); an idle gap of the device, to the innermost span open
when the gap opened.  Spans nest (one host thread), so the innermost is
the last opened of those still open.  What no span holds goes to
``(outside sip)``; a kernel whose launch is not in the trace, to
``(unlinked)``.  The summarising functions import nothing of the program:
the spans are found by name.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import os
import sys

PREFIX = "sip."
OUTSIDE = "(outside sip)"
UNLINKED = "(unlinked)"


def innermost(spans, times):
    """For each of ``times``, the index into ``spans`` ((name, start, end)
    triples, properly nested) of the innermost span holding it, or -1."""
    order = sorted(range(len(spans)),
                   key=lambda i: (spans[i][1], -spans[i][2]))
    starts = [spans[i][1] for i in order]
    out = [-1] * len(times)
    stack, nxt = [], 0
    for q in sorted(range(len(times)), key=lambda q: times[q]):
        t = times[q]
        upto = bisect.bisect_right(starts, t)
        while nxt < upto:
            i = order[nxt]
            while stack and spans[stack[-1]][2] < spans[i][1]:
                stack.pop()
            stack.append(i)
            nxt += 1
        while stack and spans[stack[-1]][2] < t:
            stack.pop()
        out[q] = stack[-1] if stack else -1
    return out


def _holders(spans, times):
    """The name of the innermost span holding each of ``times``."""
    return [spans[i][0] if i >= 0 else OUTSIDE
            for i in innermost(spans, times)]


def owners(spans, device):
    """The span each device record of ``device`` belongs to, by name."""
    linked = [k for k, d in enumerate(device) if d[2] is not None]
    out = [UNLINKED] * len(device)
    for k, name in zip(linked, _holders(spans, [device[k][2]
                                                for k in linked])):
        out[k] = name
    return out


def top_kernels(spans, device, count=3):
    """{span name: its ``count`` costliest kernels, [name, seconds]} of
    (start, end, launch, kernel name) device records."""
    by = collections.defaultdict(lambda: collections.defaultdict(float))
    for d, name in zip(device, owners(spans, device)):
        by[name][d[3]] += (d[1] - d[0]) * 1e-6
    return {k: sorted(([n, t] for n, t in v.items()),
                      key=lambda nt: -nt[1])[:count]
            for k, v in by.items()}


def summarise(spans, device):
    """``spans``: (name, start, end) host ranges; ``device``: (start, end,
    launch, ...) device records, ``launch`` the start of the runtime call
    that launched it or None; all in microseconds on the session's clock.
    Returns ``{"spans": {name: {count, host_s, device_s, idle_s}},
    "device_s": all device seconds, "idle_s": all idle seconds}``."""
    from portbench.trace import _merge
    out = collections.defaultdict(
        lambda: dict(count=0, host_s=0.0, device_s=0.0, idle_s=0.0))
    for name, s, e in spans:
        out[name]["count"] += 1
        out[name]["host_s"] += (e - s) * 1e-6
    for d, name in zip(device, owners(spans, device)):
        out[name]["device_s"] += (d[1] - d[0]) * 1e-6
    busy = _merge(d[:2] for d in device)
    gaps = [(end, nxt) for (_, end), (nxt, _) in zip(busy, busy[1:])]
    for (s, e), name in zip(gaps, _holders(spans, [g[0] for g in gaps])):
        out[name]["idle_s"] += (e - s) * 1e-6
    return dict(spans={k: dict(v) for k, v in out.items()},
                device_s=sum(d[1] - d[0] for d in device) * 1e-6,
                idle_s=sum((e - s) for s, e in gaps) * 1e-6)


def shares(summary, key="device_s"):
    """Each span's ``key`` (``device_s`` or ``idle_s``) as a % of the
    session's; the names together cover 100."""
    total = summary[key]
    return {k: 100.0 * v[key] / total
            for k, v in summary["spans"].items() if total > 0}


def events_of(prof):
    """(spans, device) of a finished torch.profiler session, for
    ``summarise``: the host ranges named ``sip.*``, and each device record
    (user annotations left out) as (start, end, the start of the runtime
    call that launched it, kernel name)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    spans, device, launches = [], [], {}
    for e in prof.events():
        rng = (e.time_range.start, e.time_range.end)
        if e.device_type == cuda:
            if not getattr(e, "is_user_annotation", False):
                device.append((*rng, e.id, e.name))
        elif not e.is_async:
            if e.name.startswith(PREFIX):
                spans.append((e.name, *rng))
            elif e.name.startswith("cu"):
                # cudaLaunchKernel, cudaMemcpyAsync, cuLaunchKernel, ...
                launches[e.id] = rng[0]
    return spans, [(s, e, launches.get(i), name)
                   for s, e, i, name in device]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--periods", type=int, default=None)
    args = p.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench import fleet, run
    _, cfg, traffic, _ = run.load_cell(args.workload)
    if not torch.cuda.is_available():
        print(f"{args.workload} needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cells = fleet.Fleet(cfg, traffic, args.seed, device)
    cells.warm()
    from sip_optimal_control_tpu_torch.utils import profiling
    periods = args.periods or traffic["trace_periods"]
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(periods):
            cells.period(record=False)
    found = events_of(prof)
    summary = summarise(*found)
    trip = summary["spans"].get("sip.trip")
    result = dict(
        workload=args.workload, seed=args.seed, periods=periods,
        batch=cells.batch, device=torch.cuda.get_device_name(device),
        device_pct=shares(summary), idle_pct=shares(summary, "idle_s"),
        trip_host_ms=(1e3 * trip["host_s"] / trip["count"] if trip
                      else None),
        counters=profiling.counters(), top_kernels=top_kernels(*found),
        **summary)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
