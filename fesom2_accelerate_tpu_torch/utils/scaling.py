"""Scaling harness: grid-points/s a card at P = 1, 2, 4 parts, and the
decomposition's tax against the single-device solver.

The counterpart of ``bench_scaling.py`` and of the ``sharded_1dev`` half of
``scripts/sharded_overhead.py``.  At each part count P part p runs on card
p mod n_cards (``torch.cuda.device_count()``), so on one card all P parts
share it, as the JAX harness's virtual devices share one host.  Each row:

* the exactness gate of ``bench_scaling.py``: ``fct_LO`` on the owned nodes
  (``gather_node``) after ``--steps`` steps of ``ShardedFctAleSolver.run``
  against ``FctAleSolver`` over the same steps, relerr (max |a - b| /
  max(max |b|, 1)) under ``--check-rtol``; a row that misses it makes the
  command exit 1;
* on a CUDA device, the run timed by ``runtime/tracing.py:time_run`` (best
  of 3 CUDA-event runs, device and host time a step, what the run chose):
  grid-points/s, a card's share of it, the efficiency against the P = 1
  row of the same mode, and the step time against the single-device
  solver's, timed alike: at P = 1 that is the decomposition's tax (its
  partition, exchange and fixup, on one card), split and fused.

The configuration is ``bench_scaling.py``'s: ``random_fields(seed=0)``,
f32, ``dt=0.5``, ``flux_eps=1e-7``, iterative FCT.  The CUDA backend runs
each P in both sharded modes, split (K1, K2, K3, exchange, K4-fix) and
fused (K1, K2, exchange, K34); the torch backend runs its one mode.

``--device cpu --backend torch`` runs the gate on the CPU, as the JAX
harness does on a virtual CPU mesh: its rows say ``"device": "cpu"`` and
carry no times (a CPU time is no measurement of the card).

``--procs 1,2`` adds rows at 2 processes (``utils/multiproc.py``, gloo):
at each P > 1 that 2 divides, P / 2 parts a rank, rank r on card r mod
n_cards, so on one card both ranks share ``cuda:0``.  Such a row holds the
same gate, the bits of ``fct_LO`` against the one-process run at the same
P and mode (``bits_vs_1proc``), each rank's ms a step of a second run of
the steps (CUDA events on its stream and host wall; the host's loop, as a
run across processes is; the slower rank counts), the time of one
exchange of both limiter factors alone (``exchange_ms``: staging, sends,
index ops), the messages and bytes that cross between processes a step
over every rank (``messages_per_step``: one exchange of both factors and,
iterative, one of ``fct_LO``; ``bytes_per_step``), the transport and the
cards.  On one card it
measures the staging through host memory and two CUDA contexts sharing a
card, not scaling.

The other half of ``sharded_overhead.py``, the Pallas chain on the whole
mesh with a synthetic halo mask (``fixup_overlap``), has no Hopper
counterpart: the port's fixup (K4-fix, H-K4's FIX form) runs only on the
parts of a sharded step, whose real halo the P > 1 rows time.

Usage::

    python -m fesom2_accelerate_tpu_torch.utils.scaling [--preset core2] \\
        [--steps 20] [--parts 1,2,4] [--procs 1,2] [--device cuda] \\
        [--backend torch] [--check-rtol 2e-6] [--out path.json]

It prints one JSON line a row and a final summary line.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile

import numpy as np
import torch

from fesom2_accelerate_tpu_torch.config import FctAleConfig, resolve_backend
from fesom2_accelerate_tpu_torch.mesh import (
    generate_planar_mesh,
    random_fields,
)
from fesom2_accelerate_tpu_torch.model import FctAleSolver
from fesom2_accelerate_tpu_torch.parallel import ShardedFctAleSolver
from fesom2_accelerate_tpu_torch.runtime import profiling
from fesom2_accelerate_tpu_torch.runtime.tracing import (
    card_line,
    require_cuda,
    time_run,
)

CHECK_RTOL = 2e-6
PARTS = (1, 2, 4)
PROCS = (1,)
# seconds a 2-process row may take before its ranks are killed
LAUNCH_TIMEOUT = 300.0


def relerr(a: np.ndarray, b: np.ndarray) -> float:
    """max |a - b| / max(max |b|, 1), as bench_scaling.py's gate."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1.0))


def _cards(device: torch.device) -> list:
    """The devices parts go on: every card there is, or the CPU."""
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def two_process_row(name: str, mode: str, p: int, steps: int, device,
                    timed: bool, ref_lo: np.ndarray,
                    one_proc_lo: np.ndarray) -> dict:
    """The row of P = ``p`` parts over 2 processes (``utils.multiproc``,
    ``name`` a planar preset); raises if a rank fails."""
    from fesom2_accelerate_tpu_torch.utils import multiproc

    with tempfile.TemporaryDirectory() as out:
        status, logs = multiproc.launch(
            2, multiproc.worker_args(
                name, "f32", mode, iter_yn=True, steps=steps,
                parts_per_rank=p // 2, device=device.type,
                time_steps=timed),
            f"file://{out}/rdv", LAUNCH_TIMEOUT, out=out)
        if status != 0:
            raise RuntimeError(f"2 processes, {p} parts {mode}: status "
                               f"{status}\n" + "\n".join(
                                   log[-3000:] for log in logs))
        with np.load(f"{out}/rank0.npz") as z:
            got = z["fct_LO"]
        ranks = [json.loads(open(f"{out}/rank{r}.json").read())
                 for r in range(2)]
    row = {"procs": 2, "transport": ranks[0]["transport"],
           "cards": len({d for r in ranks for d in r["devices"]}),
           "relerr_vs_single": relerr(got, ref_lo),
           "bits_vs_1proc": bool(np.array_equal(got, one_proc_lo)),
           "launches_per_step_rank": [r["launches_per_step"] for r in ranks],
           "messages_per_step": sum(r["messages_per_step"] for r in ranks),
           "bytes_per_step": sum(r["bytes_per_step"] for r in ranks)}
    if timed:
        row.update(step_ms=max(r["step_ms"] for r in ranks),
                   step_ms_ranks=[r["step_ms"] for r in ranks],
                   host_ms=max(r["host_ms"] for r in ranks),
                   exchange_ms=max(r["exchange_ms"] for r in ranks),
                   choice="loop",
                   note="one card: the staging through host memory and two "
                        "CUDA contexts sharing a card, not scaling"
                   if row["cards"] == 1 else None)
    return row


def scaling(mesh, name: str, parts=PARTS, steps: int = 20, device="cuda",
            backend: str | None = None, check_rtol: float = CHECK_RTOL,
            procs=PROCS) -> tuple[list, dict]:
    """(rows, summary) of the harness on ``mesh`` (its metric
    ``fct_ale_sharded_<name>``); ``summary["failures"]`` lists the rows
    that missed the gate.  ``device`` "cuda" needs a card (ValueError
    otherwise).  ``procs`` containing 2 adds the 2-process rows
    (:func:`two_process_row`; ``name`` must then be a planar preset)."""
    device = torch.device(device)
    if device.type == "cuda":
        device = require_cuda(device)
    cards = _cards(device)
    backend = resolve_backend(backend, cards)
    timed = device.type == "cuda"
    card = card_line() if timed else None
    cfg = FctAleConfig(dt=0.5, iter_yn=True, dtype=torch.float32,
                       flux_eps=1e-7)
    fields = random_fields(mesh, seed=0, dtype=np.float64)
    gp = profiling.grid_points(mesh)

    # the single-device reference over the same steps, and its time
    ref = FctAleSolver(mesh, cfg, backend, device=cards[0])
    ref_state = ref.init_state(fields)
    ref_lo = ref.run(ref_state, steps)["fct_LO"].cpu().numpy()
    single = (time_run(ref.run, ref_state, steps, graphs=ref._graphs,
                       device=cards[0]) if timed else None)
    del ref, ref_state

    modes = ("split", "fused") if backend == "cuda" else ("torch",)
    if 2 in procs and timed:
        from fesom2_accelerate_tpu_torch.ops.cuda import build

        build.build()  # once here, not once a rank
    rows, failures, base = [], [], {}
    for mode in modes:
        for p in parts:
            devices = [cards[i % len(cards)] for i in range(p)]
            sh = ShardedFctAleSolver(mesh, cfg, backend, devices=devices,
                                     fused=mode == "fused")
            state = sh.init_state(fields)
            got = sh.gather_node(sh.run(state, steps)["fct_LO"])
            err = relerr(got, ref_lo)
            ok = err < check_rtol
            if not ok:
                failures.append(f"parts={p} {mode}: fct_LO relerr "
                                f"{err:.3e} >= {check_rtol:.0e}")
            row = {"metric": f"fct_ale_sharded_{name}", "parts": p,
                   "mode": mode, "procs": 1, "cards": len(set(devices)),
                   "device": device.type, "steps": steps,
                   "exact_vs_single": ok, "relerr_vs_single": err}
            if timed and 1 in procs:
                t = time_run(sh.run, state, steps, graphs=sh._graphs,
                             device=devices[0])
                gps = gp / (t["step_ms"] * 1e-3)
                per_card = gps / row["cards"]
                base.setdefault(mode, per_card)
                row.update(
                    value=gps, unit="grid-points/s",
                    per_card=per_card,
                    efficiency_vs_1=per_card / base[mode],
                    step_ms=t["step_ms"], step_ms_runs=t["step_ms_runs"],
                    device_ms=t["device_ms"], host_ms=t["host_ms"],
                    choice=t["choice"], copy_in_ms=t["copy_in_ms"],
                    single_step_ms=single["step_ms"],
                    overhead_ms_vs_single=t["step_ms"] - single["step_ms"],
                    efficiency_vs_single=single["step_ms"] / t["step_ms"],
                    card=card)
            if 1 in procs:
                rows.append(row)
            del sh, state
            if timed:
                torch.cuda.empty_cache()
            if 2 not in procs or p < 2 or p % 2:
                continue
            two = {k: row[k] for k in ("metric", "parts", "mode", "device",
                                       "steps")}
            two.update(two_process_row(name, mode, p, steps, device, timed,
                                       ref_lo, got))
            two["exact_vs_single"] = two["relerr_vs_single"] < check_rtol
            if not two["exact_vs_single"]:
                failures.append(f"parts={p} {mode} 2 procs: fct_LO relerr "
                                f"{two['relerr_vs_single']:.3e}")
            if not two["bits_vs_1proc"]:
                failures.append(f"parts={p} {mode} 2 procs: fct_LO differs "
                                f"from 1 process in its bits")
            if timed:
                two.update(
                    value=gp / (two["step_ms"] * 1e-3),
                    unit="grid-points/s",
                    step_ms_1proc=row.get("step_ms"),
                    single_step_ms=single["step_ms"],
                    overhead_ms_vs_single=two["step_ms"] - single["step_ms"],
                    efficiency_vs_single=single["step_ms"] / two["step_ms"],
                    card=card)
            rows.append(two)
    summary = {"summary": "scaling", "preset": name, "backend": backend,
               "device": device.type, "parts": list(parts),
               "modes": list(modes), "procs": list(procs),
               "cards": len(cards),
               "all_exact": not failures, "failures": failures}
    if timed:
        summary.update(single_step_ms=single["step_ms"],
                       single_step_ms_runs=single["step_ms_runs"],
                       single_choice=single["choice"], card=card)
    return rows, summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="core2")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--parts", default=",".join(map(str, PARTS)))
    ap.add_argument("--procs", default=",".join(map(str, PROCS)),
                    help="process counts: 1, 2 or 1,2")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, choices=["torch", "cuda"])
    ap.add_argument("--check-rtol", type=float, default=CHECK_RTOL,
                    help="sharded-vs-single tolerance (f32 summation order)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rows, summary = scaling(
        generate_planar_mesh(preset=args.preset), args.preset,
        tuple(int(p) for p in args.parts.split(",")), args.steps,
        args.device, args.backend, args.check_rtol,
        tuple(int(n) for n in args.procs.split(",")))
    for row in rows:
        print(json.dumps(row), flush=True)
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)
    return 1 if summary["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
