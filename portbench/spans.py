"""The program's own spans in the traced window, for the metrics that read
them (``source: program_span``).

The program records a span (``fesom2_accelerate_tpu_torch/runtime/
tracing.py``: name, start and end ``time.time_ns()``, parent, call) only
while a profiler records, and its stamps share the profiler's clock.
:func:`per_step_us` keeps those that start inside rank 0's traced window.  A
program that keeps no spans, or recorded none in the window, gives None:
every reader then reads nothing, and raises nothing.
"""

from __future__ import annotations


def recorded() -> list:
    """The program's record of spans, or [] where it keeps none."""
    from fesom2_accelerate_tpu_torch.runtime import tracing

    spans = getattr(tracing, "spans", None)
    return [] if spans is None else spans()


def per_step_us(rec, match) -> float | None:
    """The time, µs, that a model step of rank 0's traced window spent in
    the closed spans that start inside the window and whose name
    ``match(name)`` accepts (their sum over the window's steps), or None
    where there is no such span."""
    if not rec.traces:
        return None
    t = rec.traces[0]
    w0, w1 = t["window"]
    d = [(b - a) * 1e-3 for name, a, b, _, _ in recorded()
         if b is not None and w0 <= a * 1e-3 < w1 and match(name)]
    return sum(d) / t["steps"] if d else None
