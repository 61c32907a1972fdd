"""f32 drift over N iterative steps, and b2's sensitivity to ``flux_eps``.

The counterpart of ``scripts/accuracy_study.py``, on the same inputs
(``random_fields(seed=0)``, ``dt=0.5``, iterative FCT, vlimit 1) and the
same two tables:

* the f32 drift over N = 1, 5, 10, 25, 50, 100 steps: ``fct_LO``,
  ``fct_adf_v`` and ``fct_adf_h`` of an f32 run at ``flux_eps=1e-7``
  against the plain f64 step at ``flux_eps=1e-16`` (the f64 gate, which
  the CPU tests hold to the JAX package's f64 step and its numpy oracle),
  relerr = max |a - b| / max(max |b|, 1);
* the sensitivity of b2's Zalesak division to ``flux_eps``: one f32 step
  at 1e-5 .. 1e-9 against the same f64 step, in ``fct_plus``,
  ``fct_minus`` and ``fct_LO``.

Each f32 row has a column group for the plain f32 stages
(``backend="torch"``) and, on a CUDA device, one for the CUDA kernels
(``backend="cuda"``, the default step K12 -> K3 -> K4).  On the CPU
(``--device cpu``) only the plain stages run.  Every run goes through
``FctAleSolver.run`` (``step`` for the one-step table, whose factors the
run's carry drops), on the device given; ``--device cuda`` without a card
raises ValueError.

Usage::

    python -m fesom2_accelerate_tpu_torch.utils.accuracy [--preset small] \\
        [--device cuda] [--steps 1 5 10 25 50 100] [--out path.json]

It prints both tables in markdown, then one JSON line holding both.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from fesom2_accelerate_tpu_torch.config import FctAleConfig
from fesom2_accelerate_tpu_torch.mesh import (
    generate_planar_mesh,
    random_fields,
)
from fesom2_accelerate_tpu_torch.model import FctAleSolver
from fesom2_accelerate_tpu_torch.runtime.tracing import card_line, require_cuda

STEPS = (1, 5, 10, 25, 50, 100)
EPS = (1e-5, 1e-6, 1e-7, 1e-8, 1e-9)
DRIFT_KEYS = ("fct_LO", "fct_adf_v", "fct_adf_h")
EPS_KEYS = ("fct_plus", "fct_minus", "fct_LO")
F32_EPS, F64_EPS = 1e-7, 1e-16


def relerr(a, b) -> float:
    """max |a - b| / max(max |b|, 1), as the JAX study's."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1.0))


def _solver(mesh, dtype, eps: float, backend: str, device) -> FctAleSolver:
    cfg = FctAleConfig(dt=0.5, iter_yn=True, dtype=dtype, flux_eps=eps)
    return FctAleSolver(mesh, cfg, backend, device=device)


def trajectory(mesh, fields: dict, dtype, eps: float, steps, *,
               backend: str = "torch", device) -> dict:
    """{N: {key: float64 numpy}} of the iterative run's state after each N
    of ``steps`` (ascending), one run from ``fields`` through
    ``FctAleSolver.run``: the state after N steps, as the JAX study's
    separate N-step runs give it."""
    solver = _solver(mesh, dtype, eps, backend, device)
    state = solver.init_state(fields)
    out, done = {}, 0
    for n in sorted(steps):
        state = solver.run(state, n - done)
        done = n
        out[n] = {k: v.double().cpu().numpy() for k, v in state.items()}
    return out


def one_step(mesh, fields: dict, dtype, eps: float, *,
             backend: str = "torch", device) -> dict:
    """The full output of one ``FctAleSolver.step`` (with the factors
    ``fct_plus``/``fct_minus``), as float64 numpy."""
    solver = _solver(mesh, dtype, eps, backend, device)
    out = solver.step(solver.init_state(fields))
    return {k: v.double().cpu().numpy() for k, v in out.items()}


def study(mesh, device="cuda", steps=STEPS) -> dict:
    """Both tables on ``mesh``: {"drift": [{"steps": N, <backend>: {key:
    relerr}}], "flux_eps": [{"flux_eps": e, <backend>: {key: relerr}}],
    "backends": [...], "device": ...}.  On a CUDA device (ValueError
    without one) the f32 rows run the plain stages and the kernels; on the
    CPU the plain stages."""
    device = torch.device(device)
    if device.type == "cuda":
        device = require_cuda(device)
    backends = ("torch", "cuda") if device.type == "cuda" else ("torch",)
    fields = random_fields(mesh, seed=0, dtype=np.float64)
    ref = trajectory(mesh, fields, torch.float64, F64_EPS, steps,
                     device=device)
    f32 = {b: trajectory(mesh, fields, torch.float32, F32_EPS, steps,
                         backend=b, device=device) for b in backends}
    drift = [{"steps": n, **{b: {k: relerr(f32[b][n][k], ref[n][k])
                                 for k in DRIFT_KEYS} for b in backends}}
             for n in sorted(steps)]
    ref1 = one_step(mesh, fields, torch.float64, F64_EPS, device=device)
    sens = []
    for eps in EPS:
        row = {"flux_eps": eps}
        for b in backends:
            got = one_step(mesh, fields, torch.float32, eps, backend=b,
                           device=device)
            row[b] = {k: relerr(got[k], ref1[k]) for k in EPS_KEYS}
        sens.append(row)
    return {"nodes": mesh.n_nodes, "layers": mesh.n_layers,
            "device": device.type, "backends": list(backends),
            "drift": drift, "flux_eps": sens}


def markdown(tables: dict, name: str) -> str:
    """Both tables in the JAX study's markdown layout, one column group a
    backend ("torch": the plain f32 stages, "cuda": the kernels)."""
    bs = tables["backends"]
    lines = [f"## f32 N-step drift vs the plain f64 step (iterative FCT, "
             f"{name}: {tables['nodes']} nodes x {tables['layers']} "
             f"layers, {tables['device']})", "",
             "| N steps | " + " | ".join(f"{k} ({b} f32)" for b in bs
                                        for k in DRIFT_KEYS) + " |",
             "|" + "---|" * (1 + len(DRIFT_KEYS) * len(bs))]
    for row in tables["drift"]:
        lines.append(f"| {row['steps']} | " + " | ".join(
            f"{row[b][k]:.2e}" for b in bs for k in DRIFT_KEYS) + " |")
    lines += ["", "## b2 flux_eps sensitivity (1 step, f32 vs f64 "
              "eps=1e-16)", "",
              "| flux_eps | " + " | ".join(f"{k} ({b})" for b in bs
                                         for k in EPS_KEYS) + " |",
              "|" + "---|" * (1 + len(EPS_KEYS) * len(bs))]
    for row in tables["flux_eps"]:
        lines.append(f"| {row['flux_eps']:.0e} | " + " | ".join(
            f"{row[b][k]:.2e}" for b in bs for k in EPS_KEYS) + " |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="small")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, nargs="*", default=list(STEPS))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    tables = study(generate_planar_mesh(preset=args.preset), args.device,
                   args.steps)
    if tables["device"] == "cuda":
        tables["card"] = card_line()
    print(markdown(tables, args.preset), flush=True)
    print(json.dumps(tables), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(tables, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
