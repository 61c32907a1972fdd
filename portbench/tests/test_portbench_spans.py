"""The readers of the program's spans (``portbench/spans.py`` and the
metrics of ``source: program_span``) on synthetic records: the window
filter, the division by the traced window's steps, and None, never an
exception, where the program keeps no spans or recorded none in the
window."""

import pytest

from fesom2_accelerate_tpu_torch.runtime import tracing

from portbench import harness

READERS = ("solver.wrappers_us", "abi.copy_in_ms", "abi.copy_out_ms")


def reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py").read


def record(steps=2):
    """A traced run of one rank: the window 1000-2000 µs."""
    trace = {"window": (1000.0, 2000.0), "ops": [("kernel", 0.0, 1.0, 7)],
             "gaps": [], "steps": steps}
    return harness.Record([{"spans": [(0.0, 0.1, 0.2)], "window_s": 0.2,
                            "trace": trace, "memory_peak_bytes": 0}],
                          1.0, None)


def us(a, b, name, parent=-1, call=0):
    """A span from ``a`` to ``b`` µs, stamped in ns as the program does."""
    return tracing.Span(name, int(a * 1e3), int(b * 1e3), parent, call)


SPANS = [
    us(900, 990, "graphs.run"),  # starts before the window
    us(1000, 1100, "graphs.run"),
    us(1010, 1030, "kernels.bounds", 1, 1),
    us(1030, 1070, "kernels.update_fused", 1, 1),
    us(1100, 1120, "graphs.replay", 1, 1),
    us(1500, 1560, "graphs.run", call=5),
    us(1510, 1530, "kernels.limit", 5, 5),
    us(1530, 1536, "graphs.replay", 5, 5),
    us(1600, 1700, "abi.copy_in"),
    us(1700, 1740, "abi.copy_out"),
    us(1800, 1900, "abi.copy_in"),
    us(1990, 2100, "abi.copy_out"),  # ends after the window: kept
    us(2000, 2050, "graphs.run"),  # starts at the window's end
]


@pytest.mark.parametrize("name, want", [
    ("solver.wrappers_us", (20 + 40 + 20) / 2),
    ("abi.copy_in_ms", (100 + 100) / 2 * 1e-3),
    ("abi.copy_out_ms", (40 + 110) / 2 * 1e-3),
])
def test_per_step_in_the_window(monkeypatch, name, want):
    monkeypatch.setattr(tracing, "spans", lambda: SPANS)
    assert reader(name)(record()) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read_is_none(monkeypatch, name):
    read = reader(name)
    monkeypatch.setattr(tracing, "spans", lambda: SPANS)
    untraced = record()
    untraced.ranks[0]["trace"] = None
    assert read(untraced) is None
    monkeypatch.setattr(tracing, "spans", lambda: [])
    assert read(record()) is None
    monkeypatch.setattr(tracing, "spans", lambda: [SPANS[0], SPANS[-1]])
    assert read(record()) is None
    monkeypatch.delattr(tracing, "spans")  # a program without spans
    assert read(record()) is None
