"""The traced window: ``torch.profiler`` around it, and what the metric
readers take from it.

A traced run profiles its whole window (CPU and CUDA activity).  What a
rank keeps of it is plain data, so that ranks can send it to rank 0:

* ``window``: (start, end) µs of the harness's ``portbench.window`` span,
  on the profiler's clock;
* ``ops``: every device operation that overlaps the window, clipped to
  it: (name as the trace prints it, start µs, end µs, stream);
* ``gaps``: every stretch of the window in which no device operation
  ran: (what the host was doing, start µs, end µs), the host's doing
  being the shortest host event, of the profiler's, that spans the gap's
  middle, or "host (no event)".
"""

from __future__ import annotations

import heapq

import torch

WINDOW_SPAN = "portbench.window"


def profiler():
    """A profiler of host and device activity (CUDA where there is a
    card)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def keep(prof) -> dict | None:
    """The rank's record of the traced window (module docstring), or None
    where the window's span is missing."""
    dev_kind = torch.autograd.DeviceType.CUDA
    host, ops, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        a, b = e.start_ns() / 1e3, e.end_ns() / 1e3
        if e.device_type() == dev_kind:
            if e.name() != WINDOW_SPAN:  # the span's copy on the device
                ops.append((e.name(), a, b, int(e.device_resource_id())))
        else:
            if e.name() == WINDOW_SPAN:
                window = (a, b)
            host.append((a, b, e.name()))
    if window is None:
        return None
    w0, w1 = window
    ops = sorted((n, max(a, w0), min(b, w1), s) for n, a, b, s in ops
                 if a < w1 and b > w0)
    return {"window": window, "ops": ops,
            "gaps": _label(idle(ops, window), host)}


def busy(ops: list) -> list:
    """The union of the ops' intervals: sorted disjoint (start, end)."""
    out = []
    for _, a, b, _ in sorted(ops, key=lambda o: o[1]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def busy_s(rec: dict) -> float:
    return sum(b - a for a, b in busy(rec["ops"])) * 1e-6


def window_s(rec: dict) -> float:
    return (rec["window"][1] - rec["window"][0]) * 1e-6


def idle(ops: list, window: tuple) -> list:
    """The stretches of ``window`` that no op covers: (start, end)."""
    out, t = [], window[0]
    for a, b in busy(ops):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if window[1] > t:
        out.append((t, window[1]))
    return out


def _label(gaps: list, host: list) -> list:
    """Each gap with the shortest host event that spans its middle: a
    sweep over the events by start, with a heap by duration from which the
    events that ended before the current middle are dropped."""
    host = sorted(host)
    out, heap, i = [], [], 0
    for a, b in gaps:
        mid = 0.5 * (a + b)
        while i < len(host) and host[i][0] <= mid:
            s, e, name = host[i]
            heapq.heappush(heap, (e - s, e, name))
            i += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        out.append((heap[0][2] if heap else "host (no event)", a, b))
    return out


def totals(items, top: int = 10) -> list:
    """[[name, seconds], ...] of the ``top`` names with most time, from
    (name, start µs, end µs, ...) tuples."""
    by = {}
    for it in items:
        by[it[0]] = by.get(it[0], 0.0) + (it[2] - it[1]) * 1e-6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
            ][:top]
