"""The reader of the program's counters ``solver.plan_steps`` and
``solver.plans_built`` (``metrics/solver.plan_hit_pct.py``): the share of
the whole steps enqueued from a launch plan already built, and None,
never an exception, where the program keeps no counters or enqueued no
step from a plan."""

import pytest

from fesom2_accelerate_tpu_torch.runtime import tracing

from portbench import harness


def read_hits(rec=None):
    return harness.load_module(
        harness.HERE / "metrics" / "solver.plan_hit_pct.py").read(rec)


def test_hit_share_of_the_plan_steps(monkeypatch):
    # the resident cell: one plan at the first call, every later step hits
    monkeypatch.setattr(tracing, "counters", lambda: {
        "solver.plan_steps": 10_000, "solver.plans_built": 1,
        "abi.bytes_out": 7})
    assert read_hits() == pytest.approx(99.99)
    monkeypatch.setattr(tracing, "counters", lambda: {
        "solver.plan_steps": 4, "solver.plans_built": 4})  # every step new
    assert read_hits() == 0.0


def test_hit_share_with_nothing_to_read_is_none(monkeypatch):
    monkeypatch.setattr(tracing, "counters", lambda: {})
    assert read_hits() is None
    monkeypatch.setattr(tracing, "counters",
                        lambda: {"abi.bytes_out": 5})  # a program of no plan
    assert read_hits() is None
    monkeypatch.delattr(tracing, "counters")  # a program without counters
    assert read_hits() is None


def test_hit_share_reads_the_programs_own_counters():
    tracing.reset_counters()
    tracing.count("solver.plans_built")
    tracing.count("solver.plan_steps", 8)
    try:
        assert read_hits() == pytest.approx(87.5)
    finally:
        tracing.reset_counters()
