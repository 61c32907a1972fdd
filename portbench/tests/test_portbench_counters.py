"""The reader of the program's counters (``metrics/abi.pinned_pct.py``):
the share of the ABI's bytes that went by DMA of page-locked memory, and
None, never an exception, where the program keeps no counters or counted
no ABI bytes."""

import pytest

from fesom2_accelerate_tpu_torch.runtime import tracing

from portbench import harness


def read(rec=None):
    return harness.load_module(
        harness.HERE / "metrics" / "abi.pinned_pct.py").read(rec)


@pytest.mark.parametrize("counts, want", [
    ({"abi.bytes_registered": 3000}, 100.0),
    ({"abi.bytes_registered": 3000, "abi.bytes_pageable": 1000}, 75.0),
    ({"abi.bytes_pageable": 1000, "other": 2}, 0.0),
])
def test_share_of_the_bytes(monkeypatch, counts, want):
    monkeypatch.setattr(tracing, "counters", lambda: dict(counts))
    assert read() == pytest.approx(want)


def test_nothing_to_read_is_none(monkeypatch):
    monkeypatch.setattr(tracing, "counters", lambda: {})
    assert read() is None
    monkeypatch.setattr(tracing, "counters", lambda: {"other": 5})
    assert read() is None
    monkeypatch.delattr(tracing, "counters")  # a program without counters
    assert read() is None


def test_reads_the_programs_own_counters():
    tracing.reset_counters()
    tracing.count("abi.bytes_registered", 30)
    tracing.count("abi.bytes_pageable", 10)
    try:
        assert read() == pytest.approx(75.0)
    finally:
        tracing.reset_counters()
