"""Runs one cell of the benchmark once and prints its result as the last
line of standard output.

Usage, from the root of a checkout, on a machine with the cards the cell
asks for::

    python3 -m portbench.run --workload core2.fct-resident.T2 --seed 7 \\
        --seconds 20 --trace 0

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics, read from a ``torch.profiler`` trace of the window.
Earlier lines give the card's name and power limit, the set-up split and
the measured triad roof; the last lines of standard error, and the result's
``checks``, each number compared with the reference beside its limit.

``--control 1`` (never a benchmark run) puts the reference, computed in
bfloat16, in the program's place for the checks: the control, which has
to come out not correct.

Without a CUDA card, or with fewer cards than the cell asks for, the run
measures nothing and exits 2.  A cell of several ranks starts one process
a rank (``--rank``, ``--port``: a rank the command started itself), one
card each, joined over gloo at ``tcp://localhost:<port>``; this process
is rank 0 and prints the result, once every other rank has ended with
exit code 0.  Exit codes: 0 with a result (correct or not), 1 on a
failure (a rank's included), 2 where nothing could be measured, 3 where
a banned module (jax, the JAX package) was loaded.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import threading
import time

from portbench import harness

# the time the process started, on the perf_counter clock
_STARTED = time.perf_counter() - harness.process_age_s()
# seconds a rank of a multi-rank cell may take, set-up, window and check
RANK_TIMEOUT = 330.0


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the cards."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def triad_roof(device, n_bytes: int = 2 ** 29, iters: int = 20) -> float:
    """The card's streaming rate, bytes/s: a triad ``c = a + 0.5 b`` over
    float32 arrays of ``n_bytes`` (far above the 50 MB L2), chained
    ``iters`` times, best of 3 by CUDA events after a warm-up."""
    import torch

    n = n_bytes // 4
    a = torch.ones(n, device=device)
    b, c = torch.ones_like(a), torch.empty_like(a)
    best = float("inf")
    for rep in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            torch.add(a, b, alpha=0.5, out=c)
            a, c = c, a
        end.record()
        end.synchronize()
        if rep:
            best = min(best, start.elapsed_time(end) * 1e-3)
    return 3.0 * 4 * n * iters / best


def run_rank(c: harness.Cell, seed: int, seconds: float, traced: bool,
             device, rank: int = 0, world: int = 1,
             started: float = _STARTED, out=sys.stdout,
             control: bool = False) -> dict | None:
    """One rank's run of cell ``c``: set-up, window, checks; rank 0
    returns the result's object, the other ranks None.  ``control``: the
    checks hold the reference in bfloat16 in the program's place (the
    control that has to come out not correct)."""
    import torch

    ctx = harness.Ctx(c, seed, device, rank, world, out=out)
    # interpreter, imports, the card's context, the ranks' rendezvous
    ctx.setup["process"] = time.perf_counter() - started
    driver = importlib.import_module(
        f"portbench.drivers.{c.traffic['driver']}")
    prog = driver.setup(ctx)
    w = harness.window(ctx, prog, seconds, traced)
    cuda = ctx.device.type == "cuda"
    mine = {"spans": w["spans"], "window_s": w["window_s"],
            "trace": w["trace"],
            "memory_peak_bytes": (torch.cuda.max_memory_allocated(
                ctx.device) if cuda else 0)}
    setup_s = w["t0"] - started
    checks = prog.checks(control)
    bytes_per_step = prog.bytes_per_step
    del prog
    if world > 1:
        import torch.distributed as dist

        ranks = [None] * world if rank == 0 else None
        dist.gather_object(mine, ranks, dst=0)
    else:
        ranks = [mine]
    if rank != 0:
        return None
    ctx.say(setup_split_s=ctx.setup, setup_s=setup_s)
    ctx.say(**window_summary(mine["spans"]))
    if cuda:
        torch.cuda.empty_cache()
        ctx.say(triad_roof_Bps=triad_roof(ctx.device),
                triad="c = a + 0.5 b, float32, 512 MiB arrays")
    rec = harness.Record(ranks, setup_s, bytes_per_step)
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": (torch.cuda.get_device_name(ctx.device) if cuda
                       else "cpu"),
              "count": world,
              "memory_peak_bytes": max(r["memory_peak_bytes"]
                                       for r in ranks)}
    return harness.result(rec, c, traced, checks, device)


def window_summary(spans: list) -> dict:
    """Rank 0's window in brief: its steps, and the quartiles, the first
    and the largest of its step times, ms."""
    import statistics

    ms = [(c - a) * 1e3 for a, _, c in spans]
    return {"window_steps": len(ms),
            "step_ms_quartiles": (statistics.quantiles(ms, n=4)
                                  if len(ms) > 1 else ms),
            "step_ms_first": ms[0], "step_ms_max": max(ms)}


def failed_ranks(procs: list) -> list:
    """[(rank, exit code)] of the ranks that ended with another code
    than 0."""
    return [(r + 1, p.returncode) for r, (p, _) in enumerate(procs)
            if p.poll() not in (None, 0)]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(args, world: int, port: int) -> list:
    """Ranks 1 .. world-1 of this run, each logging to a file in TMPDIR:
    [(process, log file)]."""
    procs = []
    for r in range(1, world):
        log = tempfile.TemporaryFile(mode="w+")
        cmd = [sys.executable, "-m", "portbench.run", "--workload",
               args.workload, "--seed", str(args.seed), "--seconds",
               str(args.seconds), "--trace", str(args.trace), "--rank",
               str(r), "--port", str(port), "--control", str(args.control)]
        procs.append((subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT, cwd=str(harness.ROOT),
            preexec_fn=_die_with_parent), log))
    return procs


def _die_with_parent() -> None:
    """In a rank before it runs: SIGKILL when rank 0 ends (Linux
    ``prctl(PR_SET_PDEATHSIG)``), so that no rank outlives the run."""
    import ctypes
    import signal

    ctypes.CDLL(None).prctl(1, signal.SIGKILL)


def print_logs(procs: list) -> None:
    """The end of each ended rank's log, on standard error."""
    for r, (p, log) in enumerate(procs):
        log.seek(0)
        print(f"rank {r + 1} (exit {p.returncode}):\n"
              f"{log.read()[-4000:]}", file=sys.stderr)


def watch(procs: list, deadline: float) -> None:
    """Ends the run, and every rank, when a rank fails or time runs out
    (a thread of rank 0's)."""
    while True:
        failed = failed_ranks(procs)
        if failed or time.monotonic() > deadline:
            for p, _ in procs:
                if p.poll() is None:
                    p.kill()
            for p, _ in procs:
                p.wait()
            print_logs(procs)
            print(f"portbench: ranks failed {failed} or the run passed "
                  f"{RANK_TIMEOUT} s", file=sys.stderr, flush=True)
            os._exit(1)
        if all(p.poll() == 0 for p, _ in procs):
            return
        time.sleep(0.2)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--control", type=int, choices=[0, 1], default=0,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    c = harness.cell(args.workload)
    world = int(c.config.get("ranks", 1))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        print(f"portbench: {args.workload} needs {c.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found: nothing measured",
              file=sys.stderr)
        return 2
    import fesom2_accelerate_tpu_torch as port

    if harness.ROOT not in pathlib.Path(port.__file__).resolve().parents:
        print(f"portbench: the program is imported from {port.__file__}, "
              f"not from this checkout {harness.ROOT}", file=sys.stderr)
        return 2
    if args.rank == 0:
        print("portbench " + json.dumps({"card": card_line(),
                                         "torch": torch.__version__,
                                         "cuda": torch.version.cuda}),
              flush=True)
    procs = []
    if world > 1:
        from fesom2_accelerate_tpu_torch.parallel import distributed

        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        port_no = args.port
        if args.rank == 0:
            port_no = free_port()
            procs = spawn(args, world, port_no)
            threading.Thread(target=watch, daemon=True, args=(
                procs, time.monotonic() + RANK_TIMEOUT)).start()
        distributed.init_distributed(f"tcp://localhost:{port_no}", world,
                                     args.rank)
        device = distributed.bind_device()
    else:
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    try:
        line = run_rank(c, args.seed, args.seconds, bool(args.trace),
                        device, args.rank, world, control=bool(args.control))
        if world > 1:
            torch.distributed.destroy_process_group()
        for p, _ in procs:
            p.wait(timeout=60)
        failed = failed_ranks(procs)
        if failed:
            print_logs(procs)
            print(f"portbench: ranks {failed} failed: no result",
                  file=sys.stderr, flush=True)
            return 1
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    banned = harness.banned_modules()
    if banned:
        print(f"portbench: the run loaded {banned}: no result",
              file=sys.stderr)
        return 3
    if line is None:
        return 0
    for name, chk in line["checks"].items():
        print(f"check {name} {chk['value']!r} limit {chk['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
