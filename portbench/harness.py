"""The harness: one cell run once, from ``BENCHMARK.json`` and the files
it names.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by name:

* ``configs/<config>.json``: the deployment (mesh, kernel settings, ranks);
* ``traffic/<traffic>.json``: the mix's parameters, among them
  ``driver``, the module of ``portbench.drivers`` that makes the
  program's inputs, builds and warms the program, takes one model step
  and checks it;
* ``metrics/<metric>.py``: ``read(rec)`` -> the metric's value, or None
  where the run holds nothing for it to read (:class:`Record`).

A run: set-up (the traffic module's), then the window: model steps, each from its
call to the ``torch.cuda.synchronize()`` after it, until ``seconds`` have
passed; over several ranks rank 0 decides every ``STOP_EVERY`` steps
whether the window has closed and tells the others.  With ``trace`` a
shorter window under ``torch.profiler`` follows.  Then the peak memory,
the traffic module's checks against the reference, and the metrics.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import pathlib
import sys
import time

import torch

from portbench import trace as tr

ROOT = pathlib.Path(__file__).resolve().parents[1]
HERE = ROOT / "portbench"
# steps between two decisions of rank 0 that the window has closed
STOP_EVERY = 64
# the longest traced window
TRACE_SECONDS = 3.0
# top-level module names no process of a run may hold once its window has
# closed: jax and the JAX package beside the program
BANNED = ("jax", "jaxlib", "flax", "fesom2_accelerate_tpu")


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: pathlib.Path):
    """The Python file ``path`` as a module (metric names hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """A cell of ``BENCHMARK.json`` with its configuration, traffic and
    the metrics it reports, each as ``BENCHMARK.json`` states it."""
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def cell(name: str, bench: dict | None = None, root=ROOT) -> Cell:
    """Cell ``name`` of ``root``'s ``BENCHMARK.json``: its configuration
    and traffic files loaded, and its metrics: the end-to-end ones that
    list it (or list no cells), the per-layer ones that list it (or list
    no cells and move a metric it reports)."""
    root = pathlib.Path(root)
    bench = bench or load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; workloads: {', '.join(cells)}")
    w = cells[name]
    config = next(c for c in bench["configs"] if c["name"] == w["config"])
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads",
                                                           [name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return Cell(name, w["chips"], load_json(root / config["file"]),
                load_json(root / "portbench" / "traffic"
                          / f"{w['traffic']}.json"), e2e, layer)


def process_age_s() -> float:
    """Seconds since this process started, from ``/proc`` (to 10 ms)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    import os

    return uptime - ticks / os.sysconf("SC_CLK_TCK")


class Ctx:
    """What a driver is given: the cell's files, the seed, the device and
    the rank, and :meth:`phase` to time its set-up."""

    def __init__(self, c: Cell, seed: int, device, rank: int = 0,
                 world: int = 1, out=sys.stdout):
        self.cell, self.config, self.traffic = c, c.config, c.traffic
        self.seed, self.device = seed, torch.device(device)
        self.rank, self.world = rank, world
        self.setup = {}
        self.out = out

    @contextlib.contextmanager
    def phase(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.setup[name] = (self.setup.get(name, 0.0)
                                + time.perf_counter() - t)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def say(self, **kv):
        """One line of what the run learned, before its result line."""
        if self.rank == 0:
            print("portbench " + json.dumps(kv), file=self.out, flush=True)


def _stop(ctx: Ctx, closed: bool) -> bool:
    """Whether the window has closed: this rank's clock alone, or rank
    0's decision, broadcast to every rank."""
    if ctx.world == 1:
        return closed
    import torch.distributed as dist

    flag = torch.tensor([int(closed)])
    dist.broadcast(flag, src=0)
    return bool(flag.item())


def _loop(ctx: Ctx, prog, seconds: float) -> tuple:
    """Model steps until ``seconds`` have passed -> (start on the
    perf_counter clock, spans: (call, return, synchronized) s from it)."""
    spans = []
    if ctx.world > 1:
        import torch.distributed as dist

        dist.barrier()
    ctx.sync()
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        prog.step()
        b = time.perf_counter()
        ctx.sync()
        c = time.perf_counter()
        spans.append((a - t0, b - t0, c - t0))
        if (ctx.world == 1 or len(spans) % STOP_EVERY == 0) and _stop(
                ctx, c - t0 >= seconds):
            return t0, spans


def window(ctx: Ctx, prog, seconds: float, traced: bool) -> dict:
    """The measured window of ``seconds``: the rank's start, spans and
    length.  With ``traced`` a second window of ``TRACE_SECONDS`` at most
    follows under the profiler (whose cost the first one does not pay):
    its trace (:func:`trace.keep`) with its count of ``steps``."""
    t0, spans = _loop(ctx, prog, seconds)
    out = {"t0": t0, "spans": spans, "window_s": spans[-1][2],
           "trace": None}
    if traced:
        with tr.profiler() as prof:
            with torch.profiler.record_function(tr.WINDOW_SPAN):
                _, more = _loop(ctx, prog, min(seconds, TRACE_SECONDS))
        out["trace"] = dict(tr.keep(prof), steps=len(more))
    return out


def banned_modules() -> list:
    """The banned top-level names (``BANNED``) that ``sys.modules``
    holds, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


@dataclasses.dataclass
class Record:
    """What the metric readers read.  ``ranks``: one dict a rank with
    ``spans`` and ``window_s`` of the measured window, ``trace`` (the
    traced window's, with its ``steps``, or None; :func:`window`) and
    ``memory_peak_bytes``; ``setup_s``; ``bytes_per_step``: the contract
    bytes of one model step over all ranks, or None where the cell moves
    more than the step's contract (copies through the host)."""
    ranks: list
    setup_s: float
    bytes_per_step: int | None

    @property
    def steps(self) -> int:
        return min(len(r["spans"]) for r in self.ranks)

    @property
    def traces(self) -> list:
        return [r["trace"] for r in self.ranks if r["trace"] is not None]


def metrics(rec: Record, wanted: list) -> dict:
    """{name: {"value", "unit"}} of each metric in ``wanted`` whose reader
    finds something to read."""
    out = {}
    for m in wanted:
        v = load_module(HERE / "metrics" / f"{m['name']}.py").read(rec)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def breakdown(rec: Record) -> dict:
    """The device ops that took most time and the longest idle gaps by
    what the host was doing, seconds a chip."""
    k = len(rec.traces)
    ops = [o for t in rec.traces for o in t["ops"]]
    gaps = [g for t in rec.traces for g in t["gaps"]]
    return {"device_ops": [[n[:200], s / k] for n, s in tr.totals(ops)],
            "idle_gaps": [[n[:200], s / k] for n, s in tr.totals(gaps)]}


def result(rec: Record, c: Cell, traced: bool, checks: list,
           device: dict) -> dict:
    """The run's last line: ``checks`` is [(name, value, limit)]."""
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in checks)
    out = {"correct": correct, "attempted": rec.steps, "failed": 0,
           "metrics": metrics(rec, c.per_layer if traced else c.end_to_end),
           "device": device}
    if traced and rec.traces:
        k = len(rec.traces)
        out["device"] = dict(device,
                             busy_s=sum(map(tr.busy_s, rec.traces)) / k,
                             window_s=sum(map(tr.window_s, rec.traces)) / k)
        out["breakdown"] = breakdown(rec)
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return out
