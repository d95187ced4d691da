"""Device-trace reading: torch.profiler around a callable, reduced to the
device's busy time, the kernels by name and the idle gaps by host op.

A session whose trace holds no device record is traced again, up to
``tries`` sessions, and never read as an idle device: the profiler has
been seen to lose whole sessions on the card.
"""

from __future__ import annotations

import bisect
import collections
import time

# host ops searched for the one enclosing an idle gap
_LOOKBACK = 256


class TraceEmpty(RuntimeError):
    pass


def _merge(intervals):
    """Union of (start, end) intervals, as a sorted disjoint list."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profile(fn, tries: int = 3) -> dict:
    """Runs ``fn()`` (which ends in a device synchronise) under
    torch.profiler and returns a summary: ``window_s`` (host clock around
    the call), ``busy_s`` (the union of device activity), ``kernels``
    ({name: [launches, device seconds]}), ``device_ops`` and ``idle_gaps``
    (the ten largest of each, seconds), ``tries`` (sessions taken)."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    for attempt in range(1, tries + 1):
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            window_s = time.perf_counter() - t0
        dev, host = [], []
        for e in prof.events():
            rng = (e.time_range.start, e.time_range.end)
            if e.device_type == torch.autograd.DeviceType.CUDA:
                dev.append((e.name, rng))
            elif not e.is_async:
                host.append((e.name, rng))
        if dev:
            return _summary(dev, host, window_s, attempt)
    raise TraceEmpty(f"{tries} profiler sessions held no device record")


def _summary(dev, host, window_s, tries):
    kernels = collections.defaultdict(lambda: [0, 0.0])
    for name, (s, e) in dev:
        kernels[name][0] += 1
        kernels[name][1] += (e - s) * 1e-6
    busy = _merge(r for _, r in dev)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    # each idle gap between device activity, named by the innermost host
    # op running when it opened (looked for among the ops that started
    # last before it)
    host.sort(key=lambda h: h[1][0])
    starts = [h[1][0] for h in host]
    gaps = collections.defaultdict(float)
    for (_, end), (nxt, _) in zip(busy, busy[1:]):
        name, i = "(no host op)", bisect.bisect_right(starts, end) - 1
        for j in range(i, max(i - _LOOKBACK, -1), -1):
            if host[j][1][1] >= end:
                name = host[j][0]
                break
        gaps[name] += (nxt - end) * 1e-6
    top = sorted(((k, v[1]) for k, v in kernels.items()),
                 key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return dict(window_s=window_s, busy_s=busy_s,
                kernels={k: list(v) for k, v in kernels.items()},
                device_ops=[[k, v] for k, v in top],
                idle_gaps=[[k, v] for k, v in idle], tries=tries)
