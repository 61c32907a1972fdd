"""Autotuning harness for the CUDA kernels.

The counterpart of ``fesom2_accelerate_tpu/utils/tuning.py``.  The JAX
harness sweeps the Pallas launch configuration (form, tile, chunk); here
the launch configuration is the CUDA block size, ``threads`` (one of
``ops.cuda.kernels.THREADS``), and the forms of the step are the four
single-device chains ``fuse_k12 x fuse_k34``.  One entry per family:

* :func:`tune_kernels` -- H-K1 ``bounds``, H-K2 ``limit``, H-K12
  ``limit_fused``, H-K3 ``b3h``, H-K4 ``update`` and H-K34
  ``update_fused`` over ``threads``;
* :func:`tune_a2` -- the standalone a2 (H-A2) over ``threads``;
* :func:`tune_step` -- the whole step over ``fuse_k12 x fuse_k34 x
  threads``;
* :func:`tune_stress2rhs` -- H-S2R over ``threads``;
* :func:`perf_kernels` -- each kernel and each form of the step at one
  block size (the counterpart of ``scripts/perf_kernels.py``).

Every configuration is validated before it is timed, as the JAX harness
does (the reference's ``answer=`` discipline): against the port's float64
gate, ``fct_ale_step`` (``FctAleSolver(backend="torch")``) in float64 on
the same device, which the CPU tests hold to the numpy oracle at 1e-12.
The tolerances are the JAX harness's: rtol 2e-5 per kernel, 1e-4 per
step, 1e-5 for a2 and stress2rhs.  The validating functions (``check_*``)
run on any device, so the CPU tests reach them; every ``tune_*`` times with
``runtime.tracing.device_time_ms`` and raises on a device that is not a
CUDA device.  Each result carries the card's name and power limit, as
``nvidia-smi`` prints them, and GB/s against the JAX harness's byte models
(``runtime/profiling.py``).  ``utils/tune.py`` is the command line.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from fesom2_accelerate_tpu_torch.config import FctAleConfig
from fesom2_accelerate_tpu_torch.mesh.generate import random_fields
from fesom2_accelerate_tpu_torch.model.fct_ale import fct_ale_step
from fesom2_accelerate_tpu_torch.ops import stages
from fesom2_accelerate_tpu_torch.ops.cuda import kernels
from fesom2_accelerate_tpu_torch.ops.cuda.step import fct_ale_step_cuda
from fesom2_accelerate_tpu_torch.ops.meshdata import MeshData, build_mesh_data
from fesom2_accelerate_tpu_torch.runtime import profiling
from fesom2_accelerate_tpu_torch.runtime.tracing import (
    card_line,
    device_time_ms,
    require_cuda,
)

FAMILIES = ("bounds", "limit", "limit_fused", "b3h", "update",
            "update_fused")
# (fuse_k12, fuse_k34): K1->K2->K34 (the default), K12->K34, K1->K2->K3->K4,
# K12->K3->K4
FORMS = ((False, True), (True, True), (False, False), (True, False))
# the step's outputs validated against the f64 gate, as the JAX tune_step
STEP_KEYS = ("fct_plus", "fct_minus", "del_ttf_advvert", "del_ttf_advhoriz",
             "fct_adf_h")
DT, FLUX_EPS, BIGNUMBER = 0.5, 1e-7, 1e3


@dataclasses.dataclass
class TuneResult:
    params: dict
    ms: float
    gbps: float
    max_relerr: float
    ok: bool
    card: str  # the card's name and power limit, as nvidia-smi prints them


def best(results):
    ok = [r for r in results if r.ok]
    return min(ok, key=lambda r: r.ms) if ok else None


def store(results, path):
    with open(path, "w") as f:
        json.dump([dataclasses.asdict(r) for r in results], f, indent=2)


def default_configs():
    """The swept launch configurations: every instantiated block size."""
    return [dict(threads=t) for t in kernels.THREADS]


def _relerr(a, b) -> float:
    a = a.double()
    b = b.double()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1.0))


def _maxerr(pairs) -> float:
    return max(_relerr(a, b) for a, b in pairs)


# --------------------------------------------------------------------------
# inputs and the f64 gate
# --------------------------------------------------------------------------


@dataclasses.dataclass
class FctCase:
    """One mesh's float32 inputs on a device and the float64 gate's step
    output on the same inputs (vlimit 1, non-iterative, dt 0.5,
    flux_eps 1e-7, ``random_fields(seed=0)``, as the JAX harness)."""
    md: MeshData
    cfg: FctAleConfig
    state: dict
    ref: dict


def fct_case(mesh, device) -> FctCase:
    device = torch.device(device)
    fields = random_fields(mesh, seed=0, dtype=np.float32)
    cfg64 = FctAleConfig(dt=DT, flux_eps=FLUX_EPS, dtype=torch.float64)
    md64 = build_mesh_data(mesh, torch.float64, device)
    ref = fct_ale_step(md64, cfg64, {
        k: torch.tensor(v.astype(np.float64), device=device)
        for k, v in fields.items()})
    cfg = FctAleConfig(dt=DT, flux_eps=FLUX_EPS, dtype=torch.float32)
    state = {k: torch.tensor(v, device=device) for k, v in fields.items()}
    return FctCase(build_mesh_data(mesh, torch.float32, device), cfg, state,
                   ref)


def check_kernels(case: FctCase, threads: int) -> tuple[dict, dict]:
    """Run every kernel family once at ``threads`` on the case's inputs
    (K2, K3, K4 and K34 fed the upstream kernels' outputs) -> ({family:
    relerr against the f64 gate}, {family: a call of that kernel on the
    same inputs, for timing})."""
    md, cfg, s, ref = case.md, case.cfg, case.state, case.ref
    k = dict(threads=threads)
    lo, ttf, av, ah = s["fct_LO"], s["ttf"], s["fct_adf_v"], s["fct_adf_h"]
    node = (ttf, s["hnode"], s["hnode_new"], lo, s["del_ttf_advvert"],
            s["del_ttf_advhoriz"], cfg.dt, False)
    tmax, tmin = kernels.bounds(md, lo, ttf, cfg.vlimit, **k)
    plus, minus, avl, _ = kernels.limit(md, av, tmax, tmin, ah, cfg.dt,
                                        cfg.flux_eps, False, **k)
    fused = kernels.limit_fused(md, lo, ttf, av, ah, cfg.vlimit, cfg.dt,
                                cfg.flux_eps, False, **k)
    ahl, _ = kernels.b3h(md, plus, minus, ah, False, **k)
    o1, o2 = kernels.update(md, avl, ahl, *node, **k)
    u1, u2, uh, _ = kernels.update_fused(md, plus, minus, avl, ah, *node,
                                         **k)
    bounds_ref = (ref["fct_ttf_max"], ref["fct_ttf_min"])
    limit_ref = (ref["fct_plus"], ref["fct_minus"], ref["fct_adf_v"])
    update_ref = (ref["del_ttf_advvert"], ref["del_ttf_advhoriz"])
    errs = {
        "bounds": _maxerr(zip((tmax, tmin), bounds_ref)),
        "limit": _maxerr(zip((plus, minus, avl), limit_ref)),
        "limit_fused": _maxerr(zip(fused[:5], bounds_ref + limit_ref)),
        "b3h": _relerr(ahl, ref["fct_adf_h"]),
        "update": _maxerr(zip((o1, o2), update_ref)),
        "update_fused": _maxerr(zip((u1, u2, uh),
                                    update_ref + (ref["fct_adf_h"],))),
    }
    calls = {
        "bounds": lambda: kernels.bounds(md, lo, ttf, cfg.vlimit, **k),
        "limit": lambda: kernels.limit(md, av, tmax, tmin, ah, cfg.dt,
                                       cfg.flux_eps, False, **k),
        "limit_fused": lambda: kernels.limit_fused(
            md, lo, ttf, av, ah, cfg.vlimit, cfg.dt, cfg.flux_eps, False,
            **k),
        "b3h": lambda: kernels.b3h(md, plus, minus, ah, False, **k),
        "update": lambda: kernels.update(md, avl, ahl, *node, **k),
        "update_fused": lambda: kernels.update_fused(md, plus, minus, avl,
                                                     ah, *node, **k),
    }
    return errs, calls


def check_step(case: FctCase, fuse_k12: bool, fuse_k34: bool,
               threads: int) -> float:
    """One step of ``fct_ale_step_cuda`` in the given form -> its largest
    relerr against the f64 gate over ``STEP_KEYS``."""
    out = fct_ale_step_cuda(case.md, case.cfg, case.state,
                            fuse_k12=fuse_k12, fuse_k34=fuse_k34,
                            threads=threads)
    return _maxerr((out[k], case.ref[k]) for k in STEP_KEYS)


@dataclasses.dataclass
class A2Case:
    """The standalone a2's inputs as the JAX ``tune_a2`` builds them: a1's
    bounds computed in float64 from ``random_fields(seed=0)`` in float32,
    rounded to float32; the f64 gate's a2 on the unrounded bounds."""
    md: MeshData
    tmax: torch.Tensor
    tmin: torch.Tensor
    ref: tuple


def a2_case(mesh, device) -> A2Case:
    device = torch.device(device)
    fields = random_fields(mesh, seed=0, dtype=np.float32)
    md64 = build_mesh_data(mesh, torch.float64, device)
    tmax64, tmin64 = stages.a1(
        md64, torch.tensor(fields["fct_LO"].astype(np.float64),
                           device=device),
        torch.tensor(fields["ttf"].astype(np.float64), device=device))
    ref = stages.a2(md64, tmax64, tmin64, BIGNUMBER)
    return A2Case(build_mesh_data(mesh, torch.float32, device),
                  tmax64.float(), tmin64.float(), ref)


def check_a2(case: A2Case, threads: int) -> float:
    got = kernels.a2(case.md, case.tmax, case.tmin, BIGNUMBER,
                     threads=threads)
    return _maxerr(zip(got, case.ref))


@dataclasses.dataclass
class S2rCase:
    """stress2rhs inputs as the JAX ``tune_stress2rhs`` makes them (seed 7),
    packed in float32, and the f64 gate's U, V."""
    md: MeshData
    slab: torch.Tensor
    node: tuple
    ref: tuple


def s2r_case(mesh, device) -> S2rCase:
    from fesom2_accelerate_tpu_torch.model.stress2rhs import Stress2RhsSolver

    rng = np.random.default_rng(7)
    E, N = mesh.n_elems, mesh.n_nodes
    host = (np.abs(rng.standard_normal(E)) + 0.1, rng.standard_normal(E),
            *rng.standard_normal((3, E)), rng.standard_normal((6, E)),
            rng.standard_normal(E), rng.standard_normal(N),
            *rng.standard_normal((2, N)))
    ref = Stress2RhsSolver(mesh, torch.float64, backend="torch",
                           device=device)(*host)
    sv = Stress2RhsSolver(mesh, torch.float32, backend="torch",
                          device=device)
    node = tuple(sv._tensor(a) for a in host[7:])
    return S2rCase(sv.md, sv.pack_elem_inputs(*host[:7]), node, ref)


def check_stress2rhs(case: S2rCase, threads: int) -> float:
    got = kernels.stress2rhs(case.md, case.slab, *case.node, threads=threads)
    return _maxerr(zip(got, case.ref))


# --------------------------------------------------------------------------
# sweeps (CUDA only)
# --------------------------------------------------------------------------


def _result(params, ms, nbytes, err, rtol, card) -> TuneResult:
    return TuneResult(params=params, ms=round(ms, 4),
                      gbps=round(nbytes / (ms * 1e-3) / 1e9, 2),
                      max_relerr=float(err), ok=bool(err < rtol), card=card)


def tune_kernels(mesh, configs=None, iters=30, rtol=2e-5, preset_name="",
                 device="cuda"):
    """Sweep each kernel family over the launch configurations; validate
    every family of a configuration against the f64 gate, then time each
    kernel (device time, stream held).

    Returns {family: [TuneResult, ...]}."""
    dev = require_cuda(device)
    card = card_line()
    case = fct_case(mesh, dev)
    nb = profiling.kernel_bytes(mesh)
    out = {f: [] for f in FAMILIES}
    for config in configs or default_configs():
        errs, calls = check_kernels(case, config["threads"])
        for fam in FAMILIES:
            ms = device_time_ms(calls[fam], iters, dev)
            out[fam].append(_result(dict(config, preset=preset_name),
                                    ms, nb[fam], errs[fam], rtol, card))
    return out


def tune_a2(mesh, threads=kernels.THREADS, iters=20, rtol=1e-5,
            preset_name="", device="cuda"):
    """Sweep H-A2 over ``threads``; validate against the f64 gate's a2,
    then time it back to back (the 47.9 MB of core2's bounds nearly fit
    the 50 MB L2, so later calls read part of them warm)."""
    dev = require_cuda(device)
    card = card_line()
    case = a2_case(mesh, dev)
    nbytes = profiling.a2_bytes(mesh)
    results = []
    for t in threads:
        err = check_a2(case, t)
        ms = device_time_ms(
            lambda t=t: kernels.a2(case.md, case.tmax, case.tmin, BIGNUMBER,
                                   threads=t), iters, dev)
        results.append(_result(dict(threads=t, preset=preset_name), ms,
                               nbytes, err, rtol, card))
    return results


def tune_step(mesh, threads=kernels.THREADS, forms=FORMS, steps=10,
              rtol=1e-4, preset_name="", device="cuda"):
    """Sweep the single-device step over ``forms`` (fuse_k12, fuse_k34) x
    ``threads``; validate one step of each against the f64 gate, then time
    a step (device time over ``steps`` steps, stream held)."""
    dev = require_cuda(device)
    card = card_line()
    case = fct_case(mesh, dev)
    nbytes = profiling.fct_ale_step_bytes(mesh, 4)
    results = []
    for fuse_k12, fuse_k34 in forms:
        for t in threads:
            err = check_step(case, fuse_k12, fuse_k34, t)
            ms = device_time_ms(
                lambda f12=fuse_k12, f34=fuse_k34, t=t: fct_ale_step_cuda(
                    case.md, case.cfg, case.state, fuse_k12=f12,
                    fuse_k34=f34, threads=t), steps, dev)
            results.append(_result(
                dict(fuse_k12=fuse_k12, fuse_k34=fuse_k34, threads=t,
                     preset=preset_name), ms, nbytes, err, rtol, card))
    return results


def tune_stress2rhs(mesh, threads=kernels.THREADS, iters=50, rtol=1e-5,
                    preset_name="", device="cuda"):
    """Sweep H-S2R over ``threads``; validate against the f64 gate, then
    time it (device time, stream held)."""
    dev = require_cuda(device)
    card = card_line()
    case = s2r_case(mesh, dev)
    nbytes = profiling.stress2rhs_bytes(mesh, 4)
    results = []
    for t in threads:
        err = check_stress2rhs(case, t)
        ms = device_time_ms(
            lambda t=t: kernels.stress2rhs(case.md, case.slab, *case.node,
                                           threads=t), iters, dev)
        results.append(_result(dict(threads=t, preset=preset_name), ms,
                               nbytes, err, rtol, card))
    return results


def perf_kernels(mesh, threads=kernels.DEFAULT_THREADS, iters=100,
                 preset_name="", device="cuda") -> list[dict]:
    """Each kernel and each form of the step at one block size, as
    ``scripts/perf_kernels.py`` times the Pallas chain: one record per
    kernel and per form ({"kernel": .., "ms": .., "card": ..}), then a
    summary with the production chain's sum (K1 + K2 + K34) beside the
    default form's whole step.  Inputs are validated first (the kernel
    families at 2e-5, a2 at 1e-5); a failed validation raises."""
    dev = require_cuda(device)
    card = card_line()
    case = fct_case(mesh, dev)
    errs, calls = check_kernels(case, threads)
    a2c = a2_case(mesh, dev)
    errs["a2"] = check_a2(a2c, threads)
    bad = {f: e for f, e in errs.items() if e >= (1e-5 if f == "a2"
                                                  else 2e-5)}
    if bad:
        raise AssertionError(f"perf inputs failed validation: {bad}")
    calls["a2"] = lambda: kernels.a2(a2c.md, a2c.tmax, a2c.tmin, BIGNUMBER,
                                     threads=threads)
    records = []
    for name, fn in calls.items():
        records.append(dict(kernel=name, ms=round(
            device_time_ms(fn, iters, dev), 4), card=card))
    for fuse_k12, fuse_k34 in FORMS:
        ms = device_time_ms(
            lambda f12=fuse_k12, f34=fuse_k34: fct_ale_step_cuda(
                case.md, case.cfg, case.state, fuse_k12=f12, fuse_k34=f34,
                threads=threads), iters, dev)
        records.append(dict(kernel=f"step[fuse_k12={fuse_k12},"
                                   f"fuse_k34={fuse_k34}]",
                            ms=round(ms, 4), card=card))
    ms = {r["kernel"]: r["ms"] for r in records}
    records.append(dict(
        sum_kernels_ms=round(ms["bounds"] + ms["limit"]
                             + ms["update_fused"], 4),
        whole_ms=ms["step[fuse_k12=False,fuse_k34=True]"],
        threads=threads, preset=preset_name, card=card))
    return records
