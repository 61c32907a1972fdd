"""The reader of the program's counters ``abi.bytes_out_early`` and
``abi.bytes_out`` (``metrics/abi.out_early_pct.py``): the share of the
ABI's result bytes whose copy back was ordered behind K2's or K3's end,
and None, never an exception, where the program keeps no counters or
wrote no result back."""

import pytest

from fesom2_accelerate_tpu_torch.runtime import tracing

from portbench import harness

# one tracer's results of the ABI cell (core2, non-iterative): the two
# fluxes after K2 and K3, stage c's two fields after it
L, N, ED = 47, 127_260, 380_335
EARLY = 8 * ((L + 1) * N + L * ED)
LATE = 8 * 2 * L * N


def read_early(rec=None):
    return harness.load_module(
        harness.HERE / "metrics" / "abi.out_early_pct.py").read(rec)


def test_early_share_of_the_results(monkeypatch):
    monkeypatch.setattr(tracing, "counters", lambda: {
        "abi.bytes_out": 2 * (EARLY + LATE),
        "abi.bytes_out_early": 2 * EARLY, "abi.bytes_registered": 7})
    assert read_early() == pytest.approx(66.7, abs=0.05)
    monkeypatch.setattr(tracing, "counters",
                        lambda: {"abi.bytes_out": LATE})  # the serial order
    assert read_early() == 0.0


def test_early_share_with_nothing_to_read_is_none(monkeypatch):
    monkeypatch.setattr(tracing, "counters", lambda: {})
    assert read_early() is None
    monkeypatch.setattr(tracing, "counters",
                        lambda: {"abi.bytes_registered": 5})
    assert read_early() is None
    monkeypatch.delattr(tracing, "counters")  # a program without counters
    assert read_early() is None


def test_early_share_reads_the_programs_own_counters():
    tracing.reset_counters()
    tracing.count("abi.bytes_out", 40)
    tracing.count("abi.bytes_out_early", 10)
    try:
        assert read_early() == pytest.approx(25.0)
    finally:
        tracing.reset_counters()
