"""Device timing and profiler helpers for one CUDA card.

The counterpart of ``fesom2_accelerate_tpu/runtime/tracing.py``:

* :func:`cuda_time_ms` -- CUDA events around ``reps`` calls;
* :func:`device_time_ms` -- the same with the stream held busy by a sleep
  kernel while the host enqueues, so that only the card's work (and the
  gaps between its kernels) is counted, not the host's time per launch;
* :func:`trace` -- a ``torch.profiler`` trace (CPU and CUDA activity),
  written as a Chrome trace into a directory;
* :func:`time_stages` -- the plain PyTorch stages of the FCT step timed one
  by one, with GB/s from the same per-stage byte terms as the JAX module;
* :func:`card_line` -- the card's name and power limit from ``nvidia-smi``;
* :func:`time_run` -- a solver's ``run`` at the bench's protocol: events,
  device and host time a step, what the run chose, a graph run's copy-in.

``chip_smoke.py``, the tuning harness (``utils/tuning.py``) and the bench
(``utils/bench.py``, ``utils/scaling.py``) time with these functions.
Each raises when given, or left with, no CUDA device: a measurement does
not fall back to the CPU.
"""

from __future__ import annotations

import contextlib
import functools
import math
import pathlib
import subprocess
import time

import numpy as np
import torch

# timed runs of each measurement of time_run, best of them reported
TIMING_RUNS = 3
# time_run's warm-up runs that may pass before the run has chosen (a
# choice waits for a run over which the allocator's reserve held still)
CHOICE_TRIES = 5


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


@contextlib.contextmanager
def trace(logdir, device="cuda"):
    """Profile the block with ``torch.profiler`` (CPU and CUDA activity)
    and write ``trace.json`` (Chrome trace format) into ``logdir``.
    Yields the profiler, whose ``key_averages()`` sums the device time by
    kernel."""
    require_cuda(device)
    from torch.profiler import ProfilerActivity, profile

    out = pathlib.Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof
    torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / "trace.json"))


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
