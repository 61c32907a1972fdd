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

The other half of ``sharded_overhead.py``, the Pallas chain on the whole
mesh with a synthetic halo mask (``fixup_overlap``), has no Hopper
counterpart: the port's fixup (K4-fix, H-K4's FIX form) runs only on the
parts of a sharded step, whose real halo the P > 1 rows time.

Usage::

    python -m fesom2_accelerate_tpu_torch.utils.scaling [--preset core2] \\
        [--steps 20] [--parts 1,2,4] [--device cuda] [--backend torch] \\
        [--check-rtol 2e-6] [--out path.json]

It prints one JSON line a row and a final summary line.
"""

from __future__ import annotations

import argparse
import json
import sys

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


def scaling(mesh, name: str, parts=PARTS, steps: int = 20, device="cuda",
            backend: str | None = None,
            check_rtol: float = CHECK_RTOL) -> tuple[list, dict]:
    """(rows, summary) of the harness on ``mesh`` (its metric
    ``fct_ale_sharded_<name>``); ``summary["failures"]`` lists the rows
    that missed the gate.  ``device`` "cuda" needs a card (ValueError
    otherwise)."""
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
                   "mode": mode, "cards": len(set(devices)),
                   "device": device.type, "steps": steps,
                   "exact_vs_single": ok, "relerr_vs_single": err}
            if timed:
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
            rows.append(row)
            del sh, state
            if timed:
                torch.cuda.empty_cache()
    summary = {"summary": "scaling", "preset": name, "backend": backend,
               "device": device.type, "parts": list(parts),
               "modes": list(modes), "cards": len(cards),
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
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, choices=["torch", "cuda"])
    ap.add_argument("--check-rtol", type=float, default=CHECK_RTOL,
                    help="sharded-vs-single tolerance (f32 summation order)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rows, summary = scaling(
        generate_planar_mesh(preset=args.preset), args.preset,
        tuple(int(p) for p in args.parts.split(",")), args.steps,
        args.device, args.backend, args.check_rtol)
    for row in rows:
        print(json.dumps(row), flush=True)
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)
    return 1 if summary["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
