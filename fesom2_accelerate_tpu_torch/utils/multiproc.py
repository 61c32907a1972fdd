"""Runs of the sharded FCT-ALE step over several OS processes.

The counterpart of ``tests/multiproc_worker.py`` and of the launch in
``tests/test_multiprocess.py``, in the package because ``chip_smoke.py``
and ``utils/scaling.py`` launch it as well as the tests.

:func:`launch` starts ``nprocs`` processes of::

    python -m fesom2_accelerate_tpu_torch.utils.multiproc worker \\
        --rank R --world N --init-method M --out DIR [case options]

Each worker joins the group (``distributed.init_distributed``, gloo),
binds its device (``distributed.bind_device``), builds
``ShardedFctAleSolver(devices=global_devices([dev] * parts_per_rank))``
and takes ``--steps`` steps of one case (:func:`worker_args` lists its
options): ``step`` for one step (the output with its diagnostic fields),
else ``run``.  With ``--checkpoint`` it saves a collective checkpoint
after ``--checkpoint-at`` steps and goes on to ``--steps``.  It writes
the gathered global state (``gather_state``, a collective, so every rank
holds it; rank 0 writes it to ``DIR/rank0.npz``) and one JSON line to
``DIR/rank<R>.json``: its parts, the transport, kernel launches, the
digest of each field it gathered (:func:`digest`), the
cross-process messages and bytes it sent a step, and, with ``--time`` on a
CUDA device, the step time of a second run of the same steps from the
same state, by CUDA events on the rank's stream and by host wall, the
time of one exchange of both limiter factors alone, and in split mode a
profiler trace of one step: whether the staging of the slabs ran while K3
did.

A worker runs on the card (``--device cuda``) unless it is asked for
the CPU (``--device cpu``).  ``--mode split`` or ``fused`` on the CPU
gives the CPU solver the CUDA step functions
(``ShardedFctAleSolver.set_step``: every kernel wrapper runs its plain
version on CPU tensors), as the CPU tests of the one-process solver do.

The case's inputs and config are :func:`case_config` and
:func:`case_fields`, so that a one-process run to compare with is built
alike.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# the package's parent, on the workers' PYTHONPATH
ROOT = pathlib.Path(__file__).resolve().parents[2]
MODES = ("torch", "split", "fused")


def case_config(dtype: str, iter_yn: bool):
    """The config of every multi-process case: ``dt=0.5``, vlimit 1, and
    in float32 ``flux_eps=1e-7``, as ``tests/test_multiprocess.py``."""
    from fesom2_accelerate_tpu_torch.config import FctAleConfig

    if dtype == "f32":
        return FctAleConfig(dt=0.5, iter_yn=iter_yn, dtype=torch.float32,
                            flux_eps=1e-7)
    return FctAleConfig(dt=0.5, iter_yn=iter_yn, dtype=torch.float64)


@functools.cache
def case_mesh(preset: str):
    from fesom2_accelerate_tpu_torch.mesh import generate_planar_mesh

    return generate_planar_mesh(preset=preset)


def case_fields(preset: str, tracers: int = 1) -> dict:
    """float64 numpy fields: tracer t from ``random_fields(seed=t)``, at
    ``tracers`` > 1 stacked [Tb, ...] with ``hnode``, ``hnode_new`` of
    tracer 0 shared (``utils/bench.py`` ``Inputs.fields``)."""
    from fesom2_accelerate_tpu_torch.utils.bench import Inputs

    return Inputs({preset: case_mesh(preset)}).fields(preset, tracers)


def build_solver(devices: list, preset: str, dtype: str, mode: str,
                 iter_yn: bool, exchange: str = "auto", tracers: int = 1):
    """The sharded solver of a case on ``devices`` (plain devices in one
    process, ``PartDevice``s across processes)."""
    from fesom2_accelerate_tpu_torch.parallel import ShardedFctAleSolver

    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    cpu = all(torch.device(getattr(d, "device", d)).type == "cpu"
              for d in devices)
    backend = "torch" if mode == "torch" or cpu else "cuda"
    cuda = backend == "cuda"
    sh = ShardedFctAleSolver(
        case_mesh(preset), case_config(dtype, iter_yn), backend,
        devices=devices, exchange=exchange, tracers=tracers if cuda else 1,
        fused=mode == "fused" and cuda)
    if cpu and mode != "torch":
        sh.set_step(True, mode == "fused", tracers)
    return sh


def digest(a: np.ndarray) -> str:
    """sha256 of an array's dtype, shape and bytes: what a rank that
    writes no npz reports of the fields it gathered."""
    h = hashlib.sha256(f"{a.dtype} {a.shape}".encode())
    h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def take_steps(sh, state: dict, steps: int) -> dict:
    """One ``step`` (its output keeps the diagnostic fields), else
    ``run``."""
    return sh.step(state) if steps == 1 else sh.run(state, steps)


def worker_args(preset: str = "tiny", dtype: str = "f32",
                mode: str = "torch", exchange: str = "auto",
                tracers: int = 1, iter_yn: bool = False, steps: int = 1,
                parts_per_rank: int = 2, device: str = "cuda",
                checkpoint: str | None = None, checkpoint_at: int = 0,
                time_steps: bool = False) -> list:
    """The command-line options of one case, on the card unless
    ``device="cpu"``."""
    args = ["--preset", preset, "--dtype", dtype, "--mode", mode,
            "--exchange", exchange, "--tracers", str(tracers),
            "--iter", str(int(iter_yn)), "--steps", str(steps),
            "--parts-per-rank", str(parts_per_rank), "--device", device]
    if checkpoint is not None:
        args += ["--checkpoint", str(checkpoint),
                 "--checkpoint-at", str(checkpoint_at)]
    if time_steps:
        args.append("--time")
    return args


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("role", choices=["worker"])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init-method", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--preset", default="tiny")
    ap.add_argument("--dtype", default="f32", choices=["f32", "f64"])
    ap.add_argument("--mode", default="torch", choices=MODES)
    ap.add_argument("--exchange", default="auto")
    ap.add_argument("--tracers", type=int, default=1)
    ap.add_argument("--iter", type=int, default=0)
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--parts-per-rank", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--checkpoint-at", type=int, default=0)
    ap.add_argument("--time", action="store_true",
                    help="time a second run of the steps (CUDA only)")
    return ap


def _timed_run(sh, state: dict, steps: int, device: torch.device,
               fills: int = 20) -> dict:
    """A run of ``steps`` steps from ``state`` on this rank, after a
    barrier: ms a step by CUDA events on the current stream and by host
    wall to a synchronize; then ``fills`` halo fills of the limiter
    factors' pair (``fct_LO``'s parts stacked twice, the [2, ...] shape of
    a step's one exchange of both factors), ms a fill by host wall: the
    exchange alone, staging, the sends and the index ops.  In split mode
    also :func:`_staging_trace` of one step."""
    import torch.distributed as dist

    dist.barrier()
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    sh.run(state, steps)
    end.record()
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    xs = [torch.stack([t, t]) for t in state["fct_LO"]]
    dist.barrier()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(fills):
        sh.halo_fill(xs)
    torch.cuda.synchronize(device)
    row = {"step_ms": start.elapsed_time(end) / steps,
           "host_ms": wall * 1e3 / steps,
           "exchange_ms": (time.perf_counter() - t0) * 1e3 / fills}
    if sh.owned is not None:
        row["staging_trace"] = _staging_trace(sh, state, device)
    return row


def _staging_trace(sh, state: dict, device: torch.device) -> dict:
    """One split step of this rank under torch.profiler, after a barrier:
    its device events in the order they ran, each (name: our kernels'
    template name or the first word before a template list, else the
    event's name; "compute" for the stream K3 (``b3h_kernel``) ran on,
    else "side"; µs from the step's first device event), and how many of
    the side stream's ops, the staging of the slabs that leave the rank
    (their gather and device-to-host copy), ran while some K3 ran.  What
    the trace shows, not a time to hold."""
    import re

    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    dist.barrier()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sh.step(state)
        torch.cuda.synchronize(device)
    spans = sorted((e.start_ns() / 1e3, e.end_ns() / 1e3, e.name(),
                    e.device_resource_id())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA
                   and not e.name().startswith("gloo"))
    compute = {r for _, _, n, r in spans if re.search(r"\bb3h_kernel<", n)}
    t0 = spans[0][0] if spans else 0.0
    events = []
    for a, b, name, stream in spans:
        m = re.search(r"(\w+)<", name)
        events.append((m.group(1) if m else name[:24],
                       "compute" if stream in compute else "side",
                       a - t0, b - t0))
    k3 = [(a, b) for n, _, a, b in events if n == "b3h_kernel"]
    staging = [(a, b) for _, s, a, b in events if s == "side"]
    during = [s for s in staging
              if any(s[0] < b and a < s[1] for a, b in k3)]
    return {"events": events, "k3": len(k3), "staging": len(staging),
            "staging_during_k3": len(during)}


def worker(argv=None) -> int:
    args = _parser().parse_args(argv)
    from fesom2_accelerate_tpu_torch.ops.cuda import kernels
    from fesom2_accelerate_tpu_torch.parallel import distributed

    if args.device == "cpu":
        torch.set_num_threads(1)
    distributed.init_distributed(args.init_method, args.world, args.rank)
    dev = distributed.bind_device(device=args.device)
    devices = distributed.global_devices([dev] * args.parts_per_rank)
    sh = build_solver(devices, args.preset, args.dtype, args.mode,
                      bool(args.iter), args.exchange, args.tracers)
    state0 = sh.init_state(case_fields(args.preset, args.tracers))
    kernels.reset_launch_counts()
    sh.halo_fill.messages = sh.halo_fill.nbytes = 0
    if args.checkpoint:
        state = sh.run(state0, args.checkpoint_at)
        wrote = sh.save_checkpoint(args.checkpoint, state,
                                   step=args.checkpoint_at)
        state = sh.run(state, args.steps - args.checkpoint_at)
    else:
        wrote = False
        state = take_steps(sh, state0, args.steps)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launches = kernels.launch_counts()
    row = {"rank": args.rank, "world": args.world,
           "parts": sh.local_parts, "n_parts": sh.n_parts,
           "devices": [str(d) for d in sh.devices],
           "transport": sh.transport, "mode": args.mode,
           "exchange": sh.exchange_mode, "steps": args.steps,
           "launches_per_step": sum(launches.values()) / args.steps,
           "launches": launches,
           "messages_per_step": sh.halo_fill.messages / args.steps,
           "bytes_per_step": sh.halo_fill.nbytes / args.steps,
           "wrote_checkpoint": wrote}
    gathered = sh.gather_state(state)
    row["digest"] = {k: digest(v) for k, v in gathered.items()}
    if args.time:
        if dev.type != "cuda":
            raise ValueError("--time measures the card: --device cuda")
        row.update(_timed_run(sh, state0, args.steps, dev),
                   card=torch.cuda.get_device_name(dev))
    out = pathlib.Path(args.out)
    if args.rank == 0:
        np.savez(out / "rank0.npz", **gathered)
    (out / f"rank{args.rank}.json").write_text(json.dumps(row) + "\n")
    print(json.dumps(row), flush=True)
    torch.distributed.destroy_process_group()
    return 0


def launch(nprocs: int, worker_args: list, init_method: str,
           timeout: float = 120.0, out=None) -> tuple[int, list]:
    """Starts ``nprocs`` workers of one case and waits for them: (status,
    each rank's output).  The status is 0 when every rank exited 0; on the
    first rank that fails, or when ``timeout`` seconds pass, every rank
    still running is killed and the status is that rank's exit code, or
    124 for the timeout.  ``out`` is the workers' ``--out`` directory
    (made if missing)."""
    out = pathlib.Path(out if out is not None else tempfile.mkdtemp())
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    # gloo's TCP pairs on the loopback device: every rank is on this host
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    logs, procs = [], []
    for rank in range(nprocs):
        log = tempfile.TemporaryFile(mode="w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-m",
             "fesom2_accelerate_tpu_torch.utils.multiproc", "worker",
             "--rank", str(rank), "--world", str(nprocs), "--init-method",
             init_method, "--out", str(out), *worker_args],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=str(ROOT)))
    status = 0
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            failed = [p.returncode for p in procs
                      if p.returncode not in (None, 0)]
            if failed:
                status = failed[0]
                break
            if time.monotonic() > deadline:
                status = 124
                break
            time.sleep(0.05)
        else:
            status = next((p.returncode for p in procs if p.returncode),
                          0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    text = []
    for log in logs:
        log.seek(0)
        text.append(log.read())
        log.close()
    return status, text


if __name__ == "__main__":
    sys.exit(worker(sys.argv[1:]))
