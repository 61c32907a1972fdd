#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU (written for an H100).

Usage, from the root of a checkout:  python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):
1. versions of torch, CUDA, nvcc and Triton, the card's name and power
   limit; no CUDA device is a failure (there is no CPU fallback);
2. build the CUDA kernels from ``ops/cuda/csrc`` with nvcc (sm_90a), one
   nvcc per source, in parallel, and print each kernel instance's
   registers and spills;
3. hold each FCT kernel against its plain PyTorch version on the card, on
   the ``small`` and ``core2`` meshes: vlimit 1/2/3 x iter_yn in float32,
   vlimit 1 x iter_yn in float64, and one K2 case with a nonzero vertical
   flux at each node's bottom interface z = nlev_nod - 1 (the b3v mask);
   then the full CUDA step against the plain step in float64 on ``small``;
3b. hold H-S2R (stress2rhs) against its plain version on the ``small`` and
   ``core2`` planar meshes, the core2-size RCM cylinder and the FESOM2
   mesh files of ``tests/data/polar_cap`` (RCM-renumbered and as read), in
   float32 and float64, plus an all-ice-free case (exactly rhs where
   inv_areamass > 0) and an all-massless case (exact zeros);
3c. the FCT kernels on the RCM cylinder and polar_cap, the orderings on
   which the JAX package runs its one-hot kernels: the checks of phase 3
   (vlimit 1/2/3 x iter_yn in float32, vlimit 1 in float64), then 20
   steps of ``FctAleSolver(backend="cuda")`` against ``backend="torch"``;
4. the FCT main path: 20 steps of ``FctAleSolver(backend="cuda")`` on
   core2, float32, dt=0.5, flux_eps=1e-7, vlimit 1, against the same 20
   steps of ``backend="torch"`` on the card, with each kernel's launch
   count, and the time per step of both paths (CUDA events, best of 3);
5. the stress2rhs path: ``Stress2RhsSolver`` packs the element inputs once
   and runs a 120-substep EVP loop of ``call_packed`` on core2, float32,
   with ``backend="cuda"`` and ``backend="torch"``; the launch count, the
   final U, V against each other, device and host time per substep,
   nodes/s and modeled GB/s; then the same loop on the RCM cylinder.
The last three lines are the per-kernel JSON summary, the card's name and
power limit as nvidia-smi prints them, and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import functools
import json
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import torch

MAIN_STEPS = 20
# after 20 steps the two paths have limited their fluxes 20 times in f32
# with different summation orders and FMA contraction; rounding differences
# (~1e-7 per step) accumulate in del_ttf_* but stay far below this bound
MAIN_RELERR = 1e-5
TIMING_RUNS = 3
S2R_SUBSTEPS = 120
# each substep feeds rhs_a + 1e-30 * U into the next call; in float32 that
# increment is below rhs_a's rounding for all but vanishing rhs_a, so the
# two paths' final U, V differ by one call's rounding (FMA contraction)
S2R_RELERR = 1e-6
POLAR_CAP = pathlib.Path(__file__).resolve().parent / "tests" / "data" / \
    "polar_cap"
# core2-size RCM cylinder: 126,976 nodes, 252,928 elements
CYLINDER = (512, 248, 48)


def relerr(a: torch.Tensor, b: torch.Tensor) -> float:
    """max|a-b| / max(max|b|, 1), as tests/test_packed.py defines it."""
    a = a.double()
    b = b.double()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1.0))


def abserr(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def phase_env() -> str:
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke "
                           "run needs a CUDA GPU")
    from fesom2_accelerate_tpu_torch.ops.cuda import build

    nv = subprocess.run([build.nvcc(), "--version"], capture_output=True,
                        text=True, check=True).stdout.strip().splitlines()
    print("nvcc:", nv[-1] if nv else "?")
    try:
        import triton
        print("triton", triton.__version__)
    except ImportError:
        print("triton: not importable")
    card = card_line()
    print("card:", card, "| torch:", torch.cuda.get_device_name(0),
          "x", torch.cuda.device_count(), flush=True)
    return card


def phase_build() -> None:
    from fesom2_accelerate_tpu_torch.ops.cuda import build

    paths, seconds = build.build()
    build.library()
    print(f"build: {', '.join(p.name for p in paths)} in {seconds:.2f} s "
          f"(nvcc, sm_90a, one process per source)")
    for path in paths:
        log = path.with_suffix(".log")
        if not log.exists():
            continue
        # one line per kernel instance: registers and spills from ptxas -v
        name, spill = None, ""
        for line in log.read_text().splitlines():
            m = re.search(r"Compiling entry function '.*?((?:bounds|limit|"
                          r"update_fused|stress2rhs)_kernel)I([fd])Li(\d+)E",
                          line)
            if m:
                dtype = "float" if m.group(2) == "f" else "double"
                name = f"{m.group(1)}<{dtype},{m.group(3)}>"
            elif "spill" in line and name:
                spill = line.strip()
            elif "registers" in line and name:
                print(f"  ptxas: {name}: "
                      f"{line.split(':', 1)[1].strip()}; {spill}")
                name = None
    sys.stdout.flush()


class Errors:
    """Largest absolute error seen per kernel over every checked case."""

    def __init__(self):
        self.max_abs = {"bounds": 0.0, "limit": 0.0, "update_fused": 0.0,
                        "stress2rhs": 0.0}

    def check(self, kernel, name, got, ref, tol, case):
        if ref is None:
            if got is not None:
                raise AssertionError(f"{kernel}.{name} {case}: expected None")
            return
        if got.shape != ref.shape or got.dtype != ref.dtype:
            raise AssertionError(f"{kernel}.{name} {case}: {got.shape} "
                                 f"{got.dtype} vs {ref.shape} {ref.dtype}")
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{kernel}.{name} {case}: non-finite")
        self.max_abs[kernel] = max(self.max_abs[kernel], abserr(got, ref))
        if tol == 0.0:
            if not torch.equal(got, ref):
                raise AssertionError(
                    f"{kernel}.{name} {case}: not bit-exact "
                    f"(max abs err {abserr(got, ref):.3e})")
        else:
            e = relerr(got, ref)
            if e > tol:
                raise AssertionError(f"{kernel}.{name} {case}: relerr "
                                     f"{e:.3e} > {tol:.0e}")


def check_kernels(md, state, cfg, errs: Errors, case: str) -> None:
    """Each wrapper against its plain version on the same inputs; K2 and
    K34 are fed the plain upstream outputs, so each is checked alone."""
    from fesom2_accelerate_tpu_torch.ops.cuda import kernels as K

    tol = K.TOLERANCE[cfg.dtype]
    s = state
    ref_b = K.bounds_ref(md, s["fct_LO"], s["ttf"], cfg.vlimit)
    got_b = K.bounds(md, s["fct_LO"], s["ttf"], cfg.vlimit)
    for i, name in enumerate(("fct_ttf_max", "fct_ttf_min")):
        errs.check("bounds", name, got_b[i], ref_b[i], 0.0, case)

    args = (md, s["fct_adf_v"], ref_b[0], ref_b[1], s["fct_adf_h"], cfg.dt,
            cfg.flux_eps, cfg.iter_yn)
    ref_l = K.limit_ref(*args)
    got_l = K.limit(*args)
    for i, name in enumerate(("fct_plus", "fct_minus", "adf_v_lim",
                              "adf_v_res")):
        errs.check("limit", name, got_l[i], ref_l[i], tol, case)

    args = (md, ref_l[0], ref_l[1], ref_l[2], s["fct_adf_h"], s["ttf"],
            s["hnode"], s["hnode_new"], s["fct_LO"], s["del_ttf_advvert"],
            s["del_ttf_advhoriz"], cfg.dt, cfg.iter_yn)
    ref_u = K.update_fused_ref(*args)
    got_u = K.update_fused(*args)
    for i, name in enumerate(("o1", "o2", "adf_h_lim", "adf_h_res")):
        errs.check("update_fused", name, got_u[i], ref_u[i], tol, case)


FCT_KERNELS = ("bounds", "limit", "update_fused")
# phase 3 / 3c cases: (dtype, vlimit, iter_yn)
FCT_CASES = ([(torch.float32, v, it) for v in (1, 2, 3)
              for it in (False, True)]
             + [(torch.float64, 1, it) for it in (False, True)])


def build_meshes() -> dict:
    """Every mesh the phases run on, built once from the checkout."""
    from fesom2_accelerate_tpu_torch.mesh import (
        generate_cylinder_mesh,
        generate_planar_mesh,
        read_fesom_mesh,
    )

    t0 = time.perf_counter()
    meshes = {
        "small": generate_planar_mesh(preset="small"),
        "core2": generate_planar_mesh(preset="core2"),
        "cylinder": generate_cylinder_mesh(*CYLINDER)[0],
        "polar_cap": read_fesom_mesh(str(POLAR_CAP))[0],
        "polar_cap_raw": read_fesom_mesh(str(POLAR_CAP), reorder=False)[0],
    }
    for name, m in meshes.items():
        print(f"mesh {name}: {m.n_nodes} nodes, {m.n_elems} elements, "
              f"{m.n_edges} edges, {m.n_layers} layers, node-element "
              f"degree <= {m.node_elems.shape[1]}")
    print(f"meshes built in {time.perf_counter() - t0:.2f} s (numpy)",
          flush=True)
    return meshes


def phase_kernel_checks(errs: Errors, meshes: dict) -> None:
    from fesom2_accelerate_tpu_torch import FctAleConfig, FctAleSolver
    from fesom2_accelerate_tpu_torch.mesh import random_fields
    from fesom2_accelerate_tpu_torch.ops.cuda import kernels as K

    for preset in ("small", "core2"):
        mesh = meshes[preset]
        fields = random_fields(mesh, seed=3, dtype=np.float64)
        n_cases = 0
        for dtype, vlimit, iter_yn in FCT_CASES:
            cfg = FctAleConfig(vlimit=vlimit, iter_yn=iter_yn, dt=0.5,
                               flux_eps=1e-7 if dtype == torch.float32
                               else 1e-16, dtype=dtype)
            solver = FctAleSolver(mesh, cfg, backend="cuda", device="cuda")
            state = solver.init_state(fields)
            check_kernels(solver.md, state, cfg, errs,
                          f"{preset} {dtype} vlimit={vlimit} iter={iter_yn}")
            n_cases += 1
        # b3v mask: a nonzero flux at each node's bottom interface
        # z = nlev_nod - 1 must pass through unlimited, as in the oracle
        cfg = FctAleConfig(dt=0.5, flux_eps=1e-7, iter_yn=True)
        solver = FctAleSolver(mesh, cfg, backend="cuda", device="cuda")
        state = solver.init_state(fields)
        md = solver.md
        rows = (md.nlev_nod - 1).long()
        cols = torch.arange(md.n_nodes, device="cuda")
        av = state["fct_adf_v"].clone()
        av[rows, cols] = torch.linspace(-1.0, 1.0, md.n_nodes,
                                        device="cuda") + 0.5
        state["fct_adf_v"] = av
        check_kernels(md, state, cfg, errs, f"{preset} b3v-mask")
        tmax, tmin = K.bounds_ref(md, state["fct_LO"], state["ttf"], 1)
        lim = K.limit(md, av, tmax, tmin, state["fct_adf_h"], cfg.dt,
                      cfg.flux_eps, True)
        if not torch.equal(lim[2][rows, cols], av[rows, cols]):
            raise AssertionError("b3v-mask: bottom interface flux changed")
        torch.cuda.synchronize()
        print(f"kernels vs plain: {preset} ({mesh.n_nodes} nodes, "
              f"{mesh.n_layers} layers): {n_cases + 1} cases ok "
              f"(bounds bit-exact; limit, update_fused relerr <= "
              f"{K.TOLERANCE[torch.float32]:.0e} f32, "
              f"{K.TOLERANCE[torch.float64]:.0e} f64)", flush=True)

    # the whole CUDA step against the plain step, float64, every mode
    mesh = meshes["small"]
    fields = random_fields(mesh, seed=5, dtype=np.float64)
    for vlimit in (1, 2, 3):
        for iter_yn in (False, True):
            cfg = FctAleConfig(vlimit=vlimit, iter_yn=iter_yn, dt=0.7,
                               dtype=torch.float64)
            sc = FctAleSolver(mesh, cfg, backend="cuda", device="cuda")
            st = FctAleSolver(mesh, cfg, backend="torch", device="cuda")
            oc = sc.step(sc.init_state(fields))
            ot = st.step(st.init_state(fields))
            if set(oc) != set(ot):
                raise AssertionError(f"step keys differ: {set(oc) ^ set(ot)}")
            for k in ot:
                e = relerr(oc[k], ot[k])
                if e > K.TOLERANCE[torch.float64]:
                    raise AssertionError(
                        f"f64 step vlimit={vlimit} iter={iter_yn} {k}: "
                        f"relerr {e:.3e}")
    print("cuda step vs torch step: small f64, vlimit 1/2/3 x iter_yn ok "
          "(relerr <= 1e-12)", flush=True)


def cuda_time_ms(fn, reps: int) -> float:
    """Mean device time of one fn() over reps calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


@functools.cache
def sleep_cycles_per_ms() -> float:
    """Cycles of ``torch.cuda._sleep`` per millisecond on this card,
    timed over a 10^8-cycle sleep after a first call has loaded the sleep
    kernel (a first call's load time would make every hold too short)."""
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    return 10 ** 8 / cuda_time_ms(lambda: torch.cuda._sleep(10 ** 8), 1)


def device_time_ms(fn, reps: int) -> float:
    """Device time of one fn() over reps calls, by CUDA events, with the
    stream held busy by a sleep kernel while the host enqueues the calls:
    the host's time per launch (checks, allocation, ctypes) is then not
    counted, only the work on the card and the gaps between its kernels.

    The hold is checked: if the start event has already run when the last
    call is enqueued, the sleep ended early and host gaps were counted, so
    the measurement is taken again with a 4x longer sleep.  Where fn()
    runs more launches than the stream can queue (the plain versions'
    loops), no hold is long enough; such a time includes the host's gaps
    and is returned after the second try."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    hold_ms = 2.0 * (time.perf_counter() - t0) * 1e3 + 1.0
    for _ in range(2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(hold_ms * sleep_cycles_per_ms()))
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


def best_times(calls: dict, reps: int, timer=device_time_ms) -> dict:
    """Best of TIMING_RUNS of ``timer`` for each callable, after one
    warm-up call each, measured in turns."""
    for fn in calls.values():
        fn()
    best = {name: float("inf") for name in calls}
    for _ in range(TIMING_RUNS):
        for name, fn in calls.items():
            best[name] = min(best[name], timer(fn, reps))
    return best


def check_counts(counts: dict, expect: dict, what: str) -> None:
    """Every kernel's launch count in a run is what that run must show."""
    for name, n in counts.items():
        if n != expect.get(name, 0):
            raise AssertionError(f"{what}: {name} launched {n} times, "
                                 f"expected {expect.get(name, 0)}")


def fct_cuda_vs_torch(mesh, fields, cfg, steps: int, label: str):
    """``steps`` steps of ``FctAleSolver(backend="cuda")`` against
    ``backend="torch"`` on the card: the cuda run's launch counts (set to 0
    just before it, read just after), and both final states within
    MAIN_RELERR.  Returns the counts, both solvers and their initial
    states."""
    from fesom2_accelerate_tpu_torch import FctAleSolver
    from fesom2_accelerate_tpu_torch.ops.cuda import kernels as K

    sc = FctAleSolver(mesh, cfg, backend="cuda", device="cuda")
    st = FctAleSolver(mesh, cfg, backend="torch", device="cuda")
    state_c = sc.init_state(fields)
    state_t = st.init_state(fields)
    torch.cuda.synchronize()

    K.reset_launch_counts()
    out_c = sc.run(state_c, steps)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    out_t = st.run(state_t, steps)
    torch.cuda.synchronize()
    check_counts(counts, {k: steps for k in FCT_KERNELS}, label)
    if set(out_c) != set(state_c) or set(out_t) != set(state_t):
        raise AssertionError(f"{label}: run() changed the state's keys")
    for k, v in out_t.items():
        c = out_c[k]
        if c.shape != v.shape or not bool(torch.isfinite(c).all()):
            raise AssertionError(f"{label} {k}: bad shape or non-finite")
        e = relerr(c, v)
        if e > MAIN_RELERR:
            raise AssertionError(f"{label} {k}: relerr {e:.3e} > "
                                 f"{MAIN_RELERR:.0e}")
    print(f"{label}: {mesh.n_nodes} nodes, {mesh.n_edges} edges, "
          f"{mesh.n_layers} layers, {cfg.dtype} vlimit {cfg.vlimit}, "
          f"{steps} steps, launches {counts}, final state within relerr "
          f"{MAIN_RELERR:.0e} of backend=torch", flush=True)
    return counts, sc, st, state_c, state_t


def s2r_inputs(mesh, seed: int = 7) -> tuple:
    """stress2rhs inputs as bench.py makes them: elem_area, ice_strength,
    sigma11, sigma12, sigma22 [E], gradient_sca [6, E], metric_factor [E],
    inv_areamass, rhs_a, rhs_m [N] (numpy, float64)."""
    rng = np.random.default_rng(seed)
    E, N = mesh.n_elems, mesh.n_nodes
    return (np.abs(rng.standard_normal(E)) + 0.1, rng.standard_normal(E),
            *rng.standard_normal((3, E)), rng.standard_normal((6, E)),
            rng.standard_normal(E), rng.standard_normal(N),
            *rng.standard_normal((2, N)))


def phase_s2r_checks(errs: Errors, meshes: dict) -> None:
    """H-S2R against stress2rhs_ref on every mesh and ordering, f32/f64."""
    from fesom2_accelerate_tpu_torch import Stress2RhsSolver
    from fesom2_accelerate_tpu_torch.ops.cuda import kernels as K

    for key, mesh in meshes.items():
        host = s2r_inputs(mesh)
        for dtype in (torch.float32, torch.float64):
            case = f"{key} {dtype}"
            solver = Stress2RhsSolver(mesh, dtype, backend="cuda",
                                      device="cuda")
            md = solver.md
            iam, ra, rm = (torch.tensor(a, dtype=dtype, device="cuda")
                           for a in host[7:])
            slab = solver.pack_elem_inputs(*host[:7])
            ref = K.stress2rhs_ref(md, slab, iam, ra, rm)
            got = K.stress2rhs(md, slab, iam, ra, rm)
            for i, name in enumerate("UV"):
                errs.check("stress2rhs", name, got[i], ref[i],
                           K.TOLERANCE[dtype], case)
            # every element ice-free: exactly rhs where inv_areamass > 0
            ice_free = solver.pack_elem_inputs(host[0], -np.abs(host[1]),
                                               *host[2:7])
            want = (torch.where(iam > 0.0, ra, 0.0),
                    torch.where(iam > 0.0, rm, 0.0))
            for fn in (K.stress2rhs, K.stress2rhs_ref):
                out = fn(md, ice_free, iam, ra, rm)
                for i, name in enumerate("UV"):
                    errs.check("stress2rhs", name, out[i], want[i], 0.0,
                               f"{case} ice-free ({fn.__name__})")
            # every node massless: exact zeros
            zero = torch.zeros_like(iam)
            for fn in (K.stress2rhs, K.stress2rhs_ref):
                out = fn(md, slab, -iam.abs(), ra, rm)
                for i, name in enumerate("UV"):
                    errs.check("stress2rhs", name, out[i], zero, 0.0,
                               f"{case} massless ({fn.__name__})")
        torch.cuda.synchronize()
        print(f"stress2rhs vs plain: {key} ({mesh.n_nodes} nodes, "
              f"{mesh.n_elems} elements): f32 and f64 ok (relerr <= "
              f"{K.TOLERANCE[torch.float32]:.0e} f32, "
              f"{K.TOLERANCE[torch.float64]:.0e} f64; ice-free and "
              f"massless cases exact)", flush=True)


def phase_fct_on_rcm(errs: Errors, meshes: dict) -> None:
    """The FCT kernels on the orderings where the JAX package runs its
    one-hot kernels: kernel checks, then 20 steps cuda vs torch."""
    from fesom2_accelerate_tpu_torch import FctAleConfig
    from fesom2_accelerate_tpu_torch.mesh import random_fields
    from fesom2_accelerate_tpu_torch.ops.meshdata import build_mesh_data

    for key in ("cylinder", "polar_cap"):
        mesh = meshes[key]
        fields = random_fields(mesh, seed=3, dtype=np.float64)
        md = {dt: build_mesh_data(mesh, dt, "cuda")
              for dt in (torch.float32, torch.float64)}
        for dtype, vlimit, iter_yn in FCT_CASES:
            cfg = FctAleConfig(vlimit=vlimit, iter_yn=iter_yn, dt=0.5,
                               flux_eps=1e-7 if dtype == torch.float32
                               else 1e-16, dtype=dtype)
            state = {k: torch.tensor(v, dtype=dtype, device="cuda")
                     for k, v in fields.items()}
            check_kernels(md[dtype], state, cfg, errs,
                          f"{key} {dtype} vlimit={vlimit} iter={iter_yn}")
        torch.cuda.synchronize()
        print(f"kernels vs plain: {key} ({mesh.n_nodes} nodes, "
              f"{mesh.n_layers} layers): {len(FCT_CASES)} cases ok",
              flush=True)
        cfg = FctAleConfig(dt=0.5, flux_eps=1e-7, vlimit=1, iter_yn=False,
                           dtype=torch.float32)
        fct_cuda_vs_torch(mesh, fields, cfg, MAIN_STEPS,
                          f"fct cuda vs torch on {key}")


def phase_main_path(card: str, meshes: dict) -> tuple:
    from fesom2_accelerate_tpu_torch import FctAleConfig
    from fesom2_accelerate_tpu_torch.mesh import random_fields
    from fesom2_accelerate_tpu_torch.ops.cuda import kernels as K

    mesh = meshes["core2"]
    fields = random_fields(mesh, seed=0, dtype=np.float64)
    cfg = FctAleConfig(dt=0.5, flux_eps=1e-7, vlimit=1, iter_yn=False,
                       dtype=torch.float32)
    counts, sc, st, state_c, state_t = fct_cuda_vs_torch(
        mesh, fields, cfg, MAIN_STEPS, "main path (core2)")

    # step time of both paths: warm-up, then best of 3, in turns
    best = best_times({"cuda": lambda: sc.run(state_c, MAIN_STEPS),
                       "torch": lambda: st.run(state_t, MAIN_STEPS)}, 1,
                      timer=cuda_time_ms)
    gp = int(np.sum(mesh.nlev_nod - 1))
    for path, ms in best.items():
        ms /= MAIN_STEPS
        print(f"step time backend={path}: {ms:.4f} ms/step, "
              f"{gp / (ms * 1e-3):.4e} grid-points/s "
              f"(core2 f32, {gp} grid points; card {card})")

    # per-kernel time beside its plain version, at the main path's shapes
    s = state_c
    md = sc.md
    tmax, tmin = K.bounds(md, s["fct_LO"], s["ttf"], 1)
    plus, minus, avl, _ = K.limit(md, s["fct_adf_v"], tmax, tmin,
                                  s["fct_adf_h"], cfg.dt, cfg.flux_eps, False)
    calls = {
        "bounds": (
            lambda: K.bounds(md, s["fct_LO"], s["ttf"], 1),
            lambda: K.bounds_ref(md, s["fct_LO"], s["ttf"], 1)),
        "limit": (
            lambda: K.limit(md, s["fct_adf_v"], tmax, tmin, s["fct_adf_h"],
                            cfg.dt, cfg.flux_eps, False),
            lambda: K.limit_ref(md, s["fct_adf_v"], tmax, tmin,
                                s["fct_adf_h"], cfg.dt, cfg.flux_eps,
                                False)),
        "update_fused": (
            lambda: K.update_fused(md, plus, minus, avl, s["fct_adf_h"],
                                   s["ttf"], s["hnode"], s["hnode_new"],
                                   s["fct_LO"], s["del_ttf_advvert"],
                                   s["del_ttf_advhoriz"], cfg.dt, False),
            lambda: K.update_fused_ref(md, plus, minus, avl, s["fct_adf_h"],
                                       s["ttf"], s["hnode"], s["hnode_new"],
                                       s["fct_LO"], s["del_ttf_advvert"],
                                       s["del_ttf_advhoriz"], cfg.dt, False)),
    }
    times = {}
    for name, (kern, plain) in calls.items():
        t = best_times({"kernel": kern, "plain": plain}, 5)
        times[name] = t
        print(f"kernel {name}: {t['kernel']:.4f} ms, plain "
              f"{t['plain']:.4f} ms (core2 f32; card {card})")
    return counts, times


def s2r_loop(solver, packed, inv_areamass, rhs_a, rhs_m):
    """S2R_SUBSTEPS EVP substeps: each call's U feeds the next call's
    rhs_a (rhs_a + 1e-30 * U), so every call depends on the one before, as
    in bench.py's scan."""
    for _ in range(S2R_SUBSTEPS):
        u, v = solver.call_packed(packed, inv_areamass, rhs_a, rhs_m)
        rhs_a = rhs_a + 1e-30 * u
    return u, v


def s2r_path(card: str, mesh, label: str) -> tuple:
    """The EVP substep loop on one mesh, f32, cuda against torch: launch
    count, agreement, device and host time per substep, rates, and the
    kernel's time beside its plain version's."""
    from fesom2_accelerate_tpu_torch import Stress2RhsSolver
    from fesom2_accelerate_tpu_torch.ops.cuda import kernels as K
    from fesom2_accelerate_tpu_torch.runtime.profiling import (
        stress2rhs_bytes,
    )

    host = s2r_inputs(mesh)
    sc = Stress2RhsSolver(mesh, torch.float32, backend="cuda", device="cuda")
    st = Stress2RhsSolver(mesh, torch.float32, backend="torch",
                          device="cuda")
    pc = sc.pack_elem_inputs(*host[:7])
    pt = st.pack_elem_inputs(*host[:7])
    node = [torch.tensor(a, dtype=torch.float32, device="cuda")
            for a in host[7:]]
    torch.cuda.synchronize()

    K.reset_launch_counts()
    uc, vc = s2r_loop(sc, pc, *node)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    ut, vt = s2r_loop(st, pt, *node)
    torch.cuda.synchronize()
    check_counts(counts, {"stress2rhs": S2R_SUBSTEPS}, label)
    for name, c, t in (("U", uc, ut), ("V", vc, vt)):
        if c.shape != (mesh.n_nodes,) or not bool(torch.isfinite(c).all()):
            raise AssertionError(f"{label} {name}: bad shape or non-finite")
        e = relerr(c, t)
        if e > S2R_RELERR:
            raise AssertionError(f"{label} {name}: relerr {e:.3e} > "
                                 f"{S2R_RELERR:.0e}")
    print(f"{label}: {mesh.n_nodes} nodes, {mesh.n_elems} elements, f32, "
          f"{S2R_SUBSTEPS} substeps, launches {counts}, final U, V within "
          f"relerr {S2R_RELERR:.0e} of backend=torch", flush=True)

    # device time per substep (CUDA events over the loop, device_time_ms)
    # and host wall time per substep (loop + final synchronize), best of 3,
    # in turns; the card idles for the difference
    loops = {"cuda": lambda: s2r_loop(sc, pc, *node),
             "torch": lambda: s2r_loop(st, pt, *node)}
    dev = best_times(loops, 1)
    wall = {name: float("inf") for name in loops}
    for _ in range(TIMING_RUNS):
        for name, fn in loops.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall[name] = min(wall[name], (time.perf_counter() - t0) * 1e3)
    nbytes = stress2rhs_bytes(mesh, 4)
    for name in loops:
        ms = dev[name] / S2R_SUBSTEPS
        host_ms = wall[name] / S2R_SUBSTEPS
        print(f"stress2rhs backend={name} on {label}: device "
              f"{ms:.4f} ms/substep, host wall {host_ms:.4f} ms/substep "
              f"(card idle {max(0.0, 1.0 - ms / host_ms):.1%}), "
              f"{mesh.n_nodes / (ms * 1e-3):.4e} nodes/s, modeled "
              f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s ({nbytes / 1e6:.2f} MB "
              f"modeled per call; card {card})")
    md = sc.md
    t = best_times({"kernel": lambda: K.stress2rhs(md, pc, *node),
                    "plain": lambda: K.stress2rhs_ref(md, pc, *node)}, 5)
    print(f"kernel stress2rhs on {label}: {t['kernel']:.4f} ms "
          f"({nbytes / (t['kernel'] * 1e-3) / 1e9:.1f} GB/s modeled), plain "
          f"{t['plain']:.4f} ms (f32; card {card})", flush=True)
    return counts, t


def phase_s2r_path(card: str, meshes: dict) -> tuple:
    counts, times = s2r_path(card, meshes["core2"], "stress2rhs path (core2)")
    s2r_path(card, meshes["cylinder"], "stress2rhs path (RCM cylinder)")
    return counts, times


SOURCE = "fesom2_accelerate_tpu_torch/ops/cuda/csrc/"
KERNEL_SOURCES = {"bounds": "fct_ale.cu", "limit": "fct_ale.cu",
                  "update_fused": "fct_ale.cu", "stress2rhs": "stress2rhs.cu"}
PALLAS = "fesom2_accelerate_tpu/ops/pallas/"
REPLACES = {
    "bounds": PALLAS + "kernels.py:545",
    "limit": PALLAS + "kernels_packed.py:247",
    "update_fused": PALLAS + "kernels_packed.py:744",
    "stress2rhs": (PALLAS + "kernels.py:1091, " + PALLAS
                   + "kernels_packed.py:1064"),
}


def main() -> int:
    card = phase_env()
    phase_build()
    meshes = build_meshes()
    errs = Errors()
    phase_kernel_checks(errs, meshes)
    phase_s2r_checks(errs, meshes)
    phase_fct_on_rcm(errs, meshes)
    counts, times = phase_main_path(card, meshes)
    s2r_counts, times["stress2rhs"] = phase_s2r_path(card, meshes)
    counts["stress2rhs"] = s2r_counts["stress2rhs"]
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE + src,
         "replaces": REPLACES[name], "launches": counts[name],
         "max_abs_err": errs.max_abs[name], "ms": times[name]["kernel"],
         "plain_ms": times[name]["plain"]}
        for name, src in KERNEL_SOURCES.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
