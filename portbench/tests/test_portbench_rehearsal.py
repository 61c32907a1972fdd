"""The harness end to end on the CPU at toy size (input making, the
window's accounting, the last line's shape), and the metric readers on a
synthetic trace."""

import io
import json

import pytest

from portbench import harness, run, trace
from portbench.tests.toy import run_toy, toy_cell

CELLS = [
    ("core2.fct-resident.T2", {}),
    ("core2.evp120", {}),
    ("core2.fct-abi.T2", {}),
    # the sharded path of configs/core2-4rank.json, 4 parts in one process
    ("core2.fct-resident.T2", {"parts_per_rank": 4}),
]


@pytest.mark.parametrize("name,config", CELLS)
def test_a_run_and_its_last_line(on_cpu, name, config):
    line = run_toy(name, **config)
    json.dumps(line)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    c = toy_cell(name)
    assert set(line["metrics"]) == {m["name"] for m in c.end_to_end}
    for m in c.end_to_end:
        assert line["metrics"][m["name"]]["unit"] == m["unit"]
        assert line["metrics"][m["name"]]["value"] > 0
    assert line["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                              "memory_peak_bytes": 0}
    for chk in line["checks"].values():
        assert set(chk) == {"value", "limit"} and chk["value"] < chk["limit"]


@pytest.mark.parametrize("name,config", CELLS)
def test_a_traced_run(on_cpu, name, config):
    line = run_toy(name, traced=True, **config)
    c = toy_cell(name)
    assert set(line["metrics"]) <= {m["name"] for m in c.per_layer}
    assert line["correct"] is True
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    if any(m["name"] == "solver.host_us" for m in c.per_layer):
        assert line["metrics"]["solver.host_us"]["value"] > 0


@pytest.mark.parametrize("traffic", [{"steps_per_call": 3},
                                     {"iter_yn": True}, {"tracers": 1}])
def test_other_resident_mixes(on_cpu, traffic):
    c = toy_cell("core2.fct-resident.T2")
    c.traffic = dict(c.traffic, **traffic)
    line = run.run_rank(c, 2 ** 31 + 3, 0.2, False, "cpu",
                        out=io.StringIO())
    assert line["correct"] is True


def test_window_accounting(on_cpu, monkeypatch):
    kept = {}
    real = harness.window

    def spy(*a, **k):
        kept.update(real(*a, **k))
        return kept

    monkeypatch.setattr(harness, "window", spy)
    line = run_toy("core2.fct-resident.T2", seconds=0.4)
    spans = kept["spans"]
    assert line["attempted"] == len(spans)
    assert spans[-1][2] >= 0.4 and spans[-2][2] < 0.4
    assert all(a <= b <= c for a, b, c in spans)
    assert all(x[2] <= y[0] for x, y in zip(spans, spans[1:]))
    step_ms = line["metrics"]["step_ms"]["value"]
    assert step_ms == pytest.approx(spans[-1][2] / len(spans) * 1e3)


def rank_record(ops, gaps=(), spans=((0.0, 0.1, 0.4), (0.4, 0.5, 1.0))):
    return {"spans": list(spans), "window_s": spans[-1][2],
            "memory_peak_bytes": 1,
            "trace": {"window": (0.0, 1000.0), "ops": list(ops),
                      "gaps": list(gaps), "steps": 2}}


OPS = [("void bounds_kernel<float>", 0.0, 100.0, 7),
       ("void limit_kernel<float>", 50.0, 200.0, 7),
       ("Memcpy HtoD (Pinned -> Device)", 150.0, 220.0, 9),
       ("void b3h_kernel<float, 128>", 250.0, 300.0, 7),
       ("void update_kernel<float, 128, true>", 350.0, 500.0, 7),
       ("Memcpy DtoH (Device -> Pageable)", 600.0, 680.0, 7)]


def read(name, rec):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py"
                               ).read(rec)


def test_readers_on_a_synthetic_trace():
    rec = harness.Record([rank_record(OPS)], 3.5, 10 ** 6)
    busy = 220 + 50 + 150 + 80  # µs: the union over both streams
    assert trace.busy_s(rec.traces[0]) == pytest.approx(busy * 1e-6)
    assert read("device.idle_pct", rec) == pytest.approx(100 - busy / 10)
    assert read("exchange.exposed_ms", rec) == pytest.approx(50 / 2 * 1e-3)
    assert read("abi.copy_ms", rec) == pytest.approx(150 / 2 * 1e-3)
    assert read("kernels_roofline", rec) == pytest.approx(
        100 * 2e6 / (busy * 1e-6) / 3.35e12)
    assert read("solver.host_us", rec) == pytest.approx(0.1e6)
    assert read("step_ms", rec) == pytest.approx(500.0)
    assert read("setup_s", rec) == 3.5


def test_readers_over_ranks():
    slow = [(n, a, b * 2, s) for n, a, b, s in OPS[:4]] + [
        ("void update_kernel<float, 128, true>", 700.0, 800.0, 7)]
    rec = harness.Record(
        [rank_record(OPS),
         rank_record(slow, spans=((0.0, 0.3, 0.5), (0.5, 0.6, 1.2)))],
        1.0, 10 ** 6)
    assert read("exchange.exposed_ms", rec) == pytest.approx(
        (700 - 600) / 2 * 1e-3)
    assert read("step_ms", rec) == pytest.approx(600.0)
    # a step's time is the largest over the ranks: 0.5 and 0.7 s
    assert read("step_ms_p95", rec) == pytest.approx(
        1e3 * (0.5 + 0.95 * (0.7 - 0.5)))
    assert read("solver.host_us", rec) == pytest.approx(0.2e6)
    busy = sum(trace.busy_s(t) for t in rec.traces)
    assert read("kernels_roofline", rec) == pytest.approx(
        100 * 2e6 / busy / 3.35e12)


def test_readers_find_nothing_to_read():
    rec = harness.Record([rank_record([("void bounds_kernel<float>", 0.0,
                                        10.0, 7)])], 1.0, None)
    assert read("exchange.exposed_ms", rec) is None
    assert read("abi.copy_ms", rec) is None
    assert read("kernels_roofline", rec) is None
    empty = harness.Record([dict(rank_record([]), trace=None)], 1.0, 5)
    assert read("device.idle_pct", empty) is None
    assert read("kernels_roofline", empty) is None
    wanted = [{"name": "abi.copy_ms", "unit": "ms"},
              {"name": "step_ms", "unit": "ms"}]
    assert set(harness.metrics(rec, wanted)) == {"step_ms"}


def test_idle_gaps_by_what_the_host_did():
    ops = [("k", 10.0, 20.0, 7), ("k", 50.0, 60.0, 7)]
    gaps = trace.idle(ops, (0.0, 100.0))
    assert gaps == [(0.0, 10.0), (20.0, 50.0), (60.0, 100.0)]
    host = [(0.0, 100.0, "portbench.window"), (15.0, 45.0, "launch"),
            (30.0, 40.0, "aten::empty"), (70.0, 99.0, "sync")]
    got = trace._label(gaps, host)
    assert [g[0] for g in got] == ["portbench.window", "aten::empty",
                                   "sync"]
    top = trace.totals([("a", 0.0, 2.0), ("b", 0.0, 5.0), ("a", 0, 4.0)])
    assert [n for n, _ in top] == ["a", "b"]
    assert [s for _, s in top] == pytest.approx([6e-6, 5e-6])


def test_a_failed_rank_is_seen():
    class Ended:
        def __init__(self, code):
            self.returncode = code

        def poll(self):
            return self.returncode

    procs = [(Ended(0), None), (Ended(3), None), (Ended(None), None)]
    assert run.failed_ranks(procs) == [(2, 3)]
    assert run.failed_ranks(procs[:1]) == []
