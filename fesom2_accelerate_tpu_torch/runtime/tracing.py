"""Device timing, and the program's spans, for one CUDA card.

The counterpart of ``fesom2_accelerate_tpu/runtime/tracing.py``:

* :func:`cuda_time_ms` -- CUDA events around ``reps`` calls;
* :func:`device_time_ms` -- the same with the stream held busy by a sleep
  kernel while the host enqueues, so that only the card's work (and the
  gaps between its kernels) is counted, not the host's time per launch;
* :func:`time_stages` -- the plain PyTorch stages of the FCT step timed one
  by one, with GB/s from the same per-stage byte terms as the JAX module;
* :func:`card_line` -- the card's name and power limit from ``nvidia-smi``;
* :func:`time_run` -- a solver's ``run`` at the bench's protocol: events,
  device and host time a step, what the run chose, a graph run's copy-in;
* :func:`span` and :func:`spanned` -- the program's spans (below), read
  back by :func:`spans`;
* :func:`count` -- the program's counters, read back by :func:`counters`.

``chip_smoke.py``, the tuning harness (``utils/tuning.py``) and the bench
(``utils/bench.py``, ``utils/scaling.py``) time with these functions.
Each raises when given, or left with, no CUDA device: a measurement does
not fall back to the CPU.

Spans.  The run path, the kernel wrappers and the host ABI mark where
their host time goes with ``with span(name):`` or ``@spanned(name)``
(``graphs.run``, ``graphs.loop``, ``graphs.copy_in``, ``graphs.replay``,
``graphs.capture``, ``solver.step``, ``kernels.<wrapper>``, ``abi.step``,
``abi.copy_in``, ``abi.copy_out``, ``solver.pre_comm``,
``solver.inter_comm``, ``solver.post_comm``; a rank's phases
``abi.pre_comm``, ``abi.post_comm``, ``abi.factors_out``,
``abi.factors_in``).  A span is on only while a
``torch.profiler`` session records (``torch.autograd.profiler.
_is_profiler_enabled``): profiling a run of steps is how it is turned on.
Off, :func:`span` reads that flag and returns a shared object that does
nothing: no torch call, no clock, no allocation.  On, a span

* puts a marker of its name on the profiler's host timeline
  (``torch._C._profiler._RecordFunctionFast``: not a user annotation,
  so the profiler gives it no copy on the device's timeline), and
* appends ``Span(name, start_ns, end_ns, parent, call)`` to the record
  that :func:`spans` returns: ``time.time_ns()`` stamps, the clock of
  the profiler's events, so each span can be set against the device's
  idle gaps; ``parent`` the index of the enclosing span (-1 for a root),
  ``call`` the index of its root, shared by every span under it.

The record holds at most ``SPAN_CAP`` spans; later ones are not recorded
and counted by :func:`dropped_spans`.  :func:`reset_spans` clears both.
Spans take no CUDA event, no synchronize and no device query, so they do
not change the pacing of host and card.  They nest on the one host thread
that steps the model.

Counters.  ``count(name, n)`` adds ``n`` to the counter ``name``, always
on, profiler or not: a dict update, a few hundred ns.  :func:`counters`
returns the totals since the process started or :func:`reset_counters`.
The host ABI counts the bytes it moves between the caller's f64 buffers
and the solver's device: ``abi.bytes_registered`` from and to memory it
page-locked, ``abi.bytes_pageable`` from and to any other, and on a CPU
solver (``host_embed.py``); ``abi.bytes_out`` those of the results written
back, and ``abi.bytes_out_early`` the part a step sent on its write-back
stream behind K2's or K3's end rather than stage c's; ``abi.bytes_cast``
the f64 bytes it cast on the device between the caller's f64 and the
solver's dtype, both ways (backend 1 casts all its traffic, backends 0 and
2 none).  The solvers' whole
step on the card counts ``solver.plans_built``, the launch plans it built
(one a mesh data, configuration and state signature),
``solver.plan_steps``, the steps it enqueued from a plan
(``ops/cuda/step.py`` ``StepPlans``), and ``solver.k12_steps``, those of
them that launched H-K12 (every one in the default form).
"""

from __future__ import annotations

import functools
import math
import subprocess
import time
from typing import NamedTuple

import numpy as np
import torch
from torch.autograd import profiler as _profiler

# timed runs of each measurement of time_run, best of them reported
TIMING_RUNS = 3
# time_run's warm-up runs that may pass before the run has chosen (a
# choice waits for a run over which the allocator's reserve held still)
CHOICE_TRIES = 5


# the most spans the record holds
SPAN_CAP = 2 ** 20


class Span(NamedTuple):
    """A recorded span: ``time.time_ns()`` stamps (``end_ns`` None while
    it is open), the index of its parent (-1: a root) and of its root."""

    name: str
    start_ns: int
    end_ns: int | None
    parent: int
    call: int


# the record: [name, start_ns, end_ns, parent, call] a span; the indices
# of the open recorded spans, innermost last; the spans past SPAN_CAP
_record: list = []
_open: list = []
_dropped = 0


class _Off:
    """The span of every name while no profiler records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "entry", "index", "marker")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _dropped
        self.entry = None
        if len(_record) < SPAN_CAP:
            self.index = len(_record)
            parent = _open[-1] if _open else -1
            call = _record[parent][4] if _open else self.index
            self.entry = [self.name, time.time_ns(), None, parent, call]
            _record.append(self.entry)
            _open.append(self.index)
        else:
            _dropped += 1
        self.marker = torch._C._profiler._RecordFunctionFast(self.name)
        self.marker.__enter__()
        return self

    def __exit__(self, *exc):
        self.marker.__exit__(*exc)
        if self.entry is not None:
            self.entry[2] = time.time_ns()
            if _open and _open[-1] == self.index:
                _open.pop()
        return False


def span(name: str):
    """A context manager that records the block as span ``name`` while a
    profiler records, and does nothing otherwise (module docstring)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _On(name)


def spanned(name: str):
    """Decorator: each call of the function is span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _On(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def spans() -> list:
    """The record: a :class:`Span` a span, in the order they opened."""
    return [Span(*e) for e in _record]


def dropped_spans() -> int:
    """The spans not recorded since the record reached ``SPAN_CAP``."""
    return _dropped


def reset_spans() -> None:
    """Clears the record and the count of dropped spans."""
    global _dropped
    _record.clear()
    _open.clear()
    _dropped = 0


# the counters: name -> total
_counts: dict = {}


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name`` (module docstring)."""
    _counts[name] = _counts.get(name, 0) + n


def counters() -> dict:
    """The counters: name -> total since the process started or
    :func:`reset_counters`."""
    return dict(_counts)


def reset_counters() -> None:
    _counts.clear()


def card_line() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them: the label every device number is kept with."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def require_cuda(device="cuda") -> torch.device:
    """``device`` as a torch.device, if it is a CUDA device that this
    process can use; else ValueError."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"a device measurement needs a CUDA device, got "
                         f"{dev}")
    if not torch.cuda.is_available():
        raise ValueError("a device measurement needs a CUDA device, and "
                         "torch.cuda.is_available() is False")
    return dev


def cuda_time_ms(fn, reps: int, device="cuda") -> float:
    """Mean device time of one fn() over reps calls, by CUDA events."""
    with torch.cuda.device(require_cuda(device)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps


@functools.cache
def _sleep_cycles_per_ms(index: int) -> float:
    with torch.cuda.device(index):
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        return 10 ** 8 / cuda_time_ms(lambda: torch.cuda._sleep(10 ** 8), 1)


def sleep_cycles_per_ms(device="cuda") -> float:
    """Cycles of ``torch.cuda._sleep`` per millisecond on the card, timed
    over a 10^8-cycle sleep after a first call has loaded the sleep kernel
    (a first call's load time would make every hold too short); measured
    once per card."""
    dev = require_cuda(device)
    return _sleep_cycles_per_ms(
        dev.index if dev.index is not None else torch.cuda.current_device())


def device_time_ms(fn, reps: int, device="cuda") -> float:
    """Device time of one fn() over reps calls, by CUDA events, with the
    stream held busy by a sleep kernel while the host enqueues the calls:
    the host's time per launch (checks, allocation, ctypes) is then not
    counted, only the work on the card and the gaps between its kernels.

    The hold is checked: if the start event has already run when the last
    call is enqueued, the sleep ended early and host gaps were counted, so
    the measurement is taken again with a 4x longer sleep.  Where fn()
    runs more launches than the stream can queue (the plain versions'
    loops), no hold is long enough; such a time includes the host's gaps
    and is returned after the second try.  Inputs that fit the 50 MB L2
    cache are read warm from the second call on."""
    dev = require_cuda(device)
    cycles = sleep_cycles_per_ms(dev)
    with torch.cuda.device(dev):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        hold_ms = 2.0 * (time.perf_counter() - t0) * 1e3 + 1.0
        for _ in range(2):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(int(hold_ms * cycles))
            start.record()
            for _ in range(reps):
                fn()
            held = not start.query()
            end.record()
            end.synchronize()
            if held:
                break
            hold_ms *= 4.0
        return start.elapsed_time(end) / reps


def time_stages(mesh, fields: dict, device="cuda",
                dtype: torch.dtype = torch.float32, iters: int = 20) -> dict:
    """Device time of each plain PyTorch stage of the FCT chain (vlimit 1,
    dt 1.0, flux_eps 1e-7), and its GB/s against the per-stage byte terms
    of the JAX module (``fesom2_accelerate_tpu/runtime/tracing.py:82-120``).

    Returns {stage: {"ms": .., "GBps": ..}}."""
    from fesom2_accelerate_tpu_torch.ops import stages
    from fesom2_accelerate_tpu_torch.ops.meshdata import build_mesh_data

    dev = require_cuda(device)
    fsize = torch.empty((), dtype=dtype).element_size()
    md = build_mesh_data(mesh, dtype, dev)
    s = {k: torch.tensor(np.asarray(v), dtype=dtype, device=dev)
         for k, v in fields.items()}
    L = mesh.n_layers
    nod = int(np.sum(mesh.nlev_nod - 1))
    elem = int(np.sum(mesh.nlev_elem - 1))
    edge = int(np.sum(mesh.nlev_edge))
    deg_e = int(np.sum(mesh.node_elems_num * (mesh.nlev_nod - 1)))
    deg_d = int(np.sum(mesh.node_edges_num * (mesh.nlev_nod - 1)))
    vint = int(np.sum(mesh.nlev_nod))

    report = {}

    def bench(name, fn, nbytes):
        out = fn()
        ms = device_time_ms(fn, iters, dev)
        report[name] = {"ms": round(ms, 4),
                        "GBps": round(nbytes / (ms * 1e-3) / 1e9, 2)}
        return out

    tmax, tmin = bench("a1", lambda: stages.a1(md, s["fct_LO"], s["ttf"]),
                       4 * nod * fsize)
    UVx, UVn = bench("a2", lambda: stages.a2(md, tmax, tmin, 1e3),
                     (6 * elem + 2 * L * mesh.n_elems) * fsize)
    t2x, t2n = bench(
        "a3", lambda: stages.a3_vlimit1(md, UVx, UVn, s["fct_LO"]),
        (2 * deg_e + 3 * nod) * fsize)
    p, m = bench("b1v", lambda: stages.b1_vertical(md, s["fct_adf_v"]),
                 (vint + 2 * nod) * fsize)
    p, m = bench(
        "b1h", lambda: stages.b1_horizontal(md, p, m, s["fct_adf_h"]),
        (deg_d + 4 * nod) * fsize)
    p, m = bench("b2", lambda: stages.b2(md, p, m, t2x, t2n, 1.0, 1e-7),
                 7 * nod * fsize)
    adf_v = bench(
        "b3v",
        lambda: stages.b3_vertical(md, p, m, s["fct_adf_v"], False)[0],
        (2 * nod + 2 * vint) * fsize)
    adf_h = bench(
        "b3h",
        lambda: stages.b3_horizontal(md, p, m, s["fct_adf_h"], False)[0],
        6 * edge * fsize)
    bench("c", lambda: stages.c_update_solution(
        md, s["ttf"], s["hnode"], s["hnode_new"], s["fct_LO"], adf_v, adf_h,
        s["del_ttf_advvert"], s["del_ttf_advhoriz"], 1.0),
        (9 * nod + vint + deg_d) * fsize)
    return report


def _tensors(state: dict) -> list:
    """A solver's state as its tensors (a sharded state holds a list of
    per-part tensors for each field)."""
    return [t for v in state.values()
            for t in (v if isinstance(v, list) else [v])]


def time_run(run, state: dict, n_steps: int = 20, *, graphs=None,
             device="cuda") -> dict:
    """``run(state, n_steps)`` (a solver's ``run``, ``run_tracers`` or a
    ``StepGraphs.run`` of a step) timed at the bench's protocol:

    * warm-up: runs of the same length until ``graphs``, the run's
      ``StepGraphs`` (None where it has none), has chosen between graphs
      and the loop (a choice waits for a run over which the allocator's
      reserve held still; ValueError after CHOICE_TRIES runs without
      one), then one more, which captures the graphs of this length
      where graphs were chosen: no timed run holds a choice or a capture;
    * ``step_ms``: CUDA events around each of TIMING_RUNS runs, over
      ``n_steps``: the best, and all of them in ``step_ms_runs``;
    * ``device_ms``: the same with the stream held while the host
      enqueues the run (:func:`device_time_ms`), best of TIMING_RUNS;
    * ``host_ms``: the host's wall time of a run to a synchronize, best of
      TIMING_RUNS, over ``n_steps``;
    * ``choice``: what the run chose, ``{"run": "graphs" | "loop",
      "dry_steps": d, "watched_steps": w}`` (d of w watched steps found
      the card run dry; None where the run has no graphs, or has made no
      choice because its runs are too short to choose, and runs the
      loop);
    * ``copy_in_ms``: where graphs were chosen, the device time (events,
      best of TIMING_RUNS) of copying the state into tensors of its
      shapes, which a graph run does once inside the events; else None.

    A ``graphs`` that serves more than one state signature raises
    ValueError: the choice reported is the run's own.  Raises ValueError
    without a CUDA device."""
    from fesom2_accelerate_tpu_torch.runtime.graphs import (
        WARM_STEPS,
        WATCHED_STEPS,
    )

    dev = require_cuda(device)
    waits = graphs is not None and n_steps > WARM_STEPS + WATCHED_STEPS
    with torch.cuda.device(dev):
        for _ in range(CHOICE_TRIES):
            run(state, n_steps)
            if not waits or graphs.choices:
                break
        else:
            raise ValueError(f"the run made no choice in {CHOICE_TRIES} "
                             f"runs of {n_steps} steps")
        run(state, n_steps)  # with the choice made: captures this length
        choice = {"run": "loop", "dry_steps": None, "watched_steps": None}
        if graphs is not None and graphs.choices:
            if len(graphs.choices) != 1:
                raise ValueError(f"the run's StepGraphs holds "
                                 f"{len(graphs.choices)} choices, not one")
            (dry, pays), = graphs.choices.values()
            choice = {"run": "graphs" if pays else "loop", "dry_steps": dry,
                      "watched_steps": WATCHED_STEPS}
        events = [cuda_time_ms(lambda: run(state, n_steps), 1, dev) / n_steps
                  for _ in range(TIMING_RUNS)]
        held = min(device_time_ms(lambda: run(state, n_steps), 1, dev)
                   for _ in range(TIMING_RUNS)) / n_steps
        wall = math.inf
        for _ in range(TIMING_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(state, n_steps)
            torch.cuda.synchronize()
            wall = min(wall, (time.perf_counter() - t0) * 1e3 / n_steps)
        copy_in = None
        if choice["run"] == "graphs":
            src = _tensors(state)
            static = [torch.empty_like(t) for t in src]

            def copies():
                for b, t in zip(static, src):
                    b.copy_(t)

            copies()
            copy_in = min(cuda_time_ms(copies, 1, dev)
                          for _ in range(TIMING_RUNS))
    return {"steps": n_steps, "step_ms": min(events), "step_ms_runs": events,
            "device_ms": held, "host_ms": wall, "choice": choice,
            "copy_in_ms": copy_in}
