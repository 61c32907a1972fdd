#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU (written for an H100).

Usage, from the root of a checkout:  python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):
1. versions of torch, CUDA, nvcc and Triton, the card's name and power
   limit; no CUDA device is a failure (there is no CPU fallback);
2. build the three CUDA kernels from ``ops/cuda/csrc`` with nvcc (sm_90a);
3. hold each kernel against its plain PyTorch version on the card, on the
   ``small`` and ``core2`` meshes: vlimit 1/2/3 x iter_yn in float32,
   vlimit 1 x iter_yn in float64, and one K2 case with a nonzero vertical
   flux at each node's bottom interface z = nlev_nod - 1 (the b3v mask);
   then the full CUDA step against the plain step in float64 on ``small``;
4. the main path: 20 steps of ``FctAleSolver(backend="cuda")`` on core2,
   float32, dt=0.5, flux_eps=1e-7, vlimit 1, against the same 20 steps of
   ``backend="torch"`` on the card, with each kernel's launch count, and
   the time per step of both paths (CUDA events, best of 3).
The line before the last is the per-kernel JSON summary; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
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

    path, seconds = build.build()
    build.library()
    print(f"build: {path.name} in {seconds:.2f} s (nvcc, sm_90a)")
    log = path.with_suffix(".log")
    if log.exists():
        # one line per kernel instance: registers and spills from ptxas -v
        name, spill = None, ""
        for line in log.read_text().splitlines():
            m = re.search(r"Compiling entry function '.*?((?:bounds|limit|"
                          r"update_fused)_kernel)I([fd])Li(\d+)E", line)
            if m:
                dtype = "float" if m.group(2) == "f" else "double"
                name = f"{m.group(1)}<{dtype},{m.group(3)}>"
            elif "spill" in line and name:
                spill = line.strip()
            elif "registers" in line and name:
                print(f"  ptxas: {name}: {line.split(':', 1)[1].strip()}; "
                      f"{spill}")
                name = None
    sys.stdout.flush()


class Errors:
    """Largest absolute error seen per kernel over every checked case."""

    def __init__(self):
        self.max_abs = {"bounds": 0.0, "limit": 0.0, "update_fused": 0.0}

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


def phase_kernel_checks(errs: Errors) -> None:
    from fesom2_accelerate_tpu_torch import FctAleConfig, FctAleSolver
    from fesom2_accelerate_tpu_torch.mesh import (
        generate_planar_mesh,
        random_fields,
    )
    from fesom2_accelerate_tpu_torch.ops.cuda import kernels as K

    cases = [(torch.float32, v, it) for v in (1, 2, 3) for it in (False, True)]
    cases += [(torch.float64, 1, it) for it in (False, True)]
    for preset in ("small", "core2"):
        mesh = generate_planar_mesh(preset=preset)
        fields = random_fields(mesh, seed=3, dtype=np.float64)
        n_cases = 0
        for dtype, vlimit, iter_yn in cases:
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
    mesh = generate_planar_mesh(preset="small")
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


def phase_main_path(card: str) -> list:
    from fesom2_accelerate_tpu_torch import FctAleConfig, FctAleSolver
    from fesom2_accelerate_tpu_torch.mesh import (
        generate_planar_mesh,
        random_fields,
    )
    from fesom2_accelerate_tpu_torch.ops.cuda import kernels as K

    mesh = generate_planar_mesh(preset="core2")
    fields = random_fields(mesh, seed=0, dtype=np.float64)
    cfg = FctAleConfig(dt=0.5, flux_eps=1e-7, vlimit=1, iter_yn=False,
                       dtype=torch.float32)
    sc = FctAleSolver(mesh, cfg, backend="cuda", device="cuda")
    st = FctAleSolver(mesh, cfg, backend="torch", device="cuda")
    state_c = sc.init_state(fields)
    state_t = st.init_state(fields)
    torch.cuda.synchronize()

    K.reset_launch_counts()
    out_c = sc.run(state_c, MAIN_STEPS)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    out_t = st.run(state_t, MAIN_STEPS)
    torch.cuda.synchronize()
    for name, n in counts.items():
        if n != MAIN_STEPS:
            raise AssertionError(f"{name} launched {n} times in "
                                 f"{MAIN_STEPS} steps")
    if set(out_c) != set(state_c) or set(out_t) != set(state_t):
        raise AssertionError("run() changed the state's keys")
    for k, v in out_t.items():
        c = out_c[k]
        if c.shape != v.shape or not bool(torch.isfinite(c).all()):
            raise AssertionError(f"main path {k}: bad shape or non-finite")
        e = relerr(c, v)
        if e > MAIN_RELERR:
            raise AssertionError(f"main path {k}: relerr {e:.3e} > "
                                 f"{MAIN_RELERR:.0e}")
    print(f"main path: core2 ({mesh.n_nodes} nodes, {mesh.n_edges} edges, "
          f"{mesh.n_layers} layers) f32 vlimit 1, {MAIN_STEPS} steps, "
          f"launches {counts}, final state within relerr {MAIN_RELERR:.0e} "
          f"of backend=torch", flush=True)

    # step time of both paths: warm-up, then best of 3, in turns
    def run_c():
        sc.run(state_c, MAIN_STEPS)

    def run_t():
        st.run(state_t, MAIN_STEPS)

    run_c()
    run_t()
    best = {"cuda": float("inf"), "torch": float("inf")}
    for _ in range(TIMING_RUNS):
        best["cuda"] = min(best["cuda"], cuda_time_ms(run_c, 1) / MAIN_STEPS)
        best["torch"] = min(best["torch"],
                            cuda_time_ms(run_t, 1) / MAIN_STEPS)
    gp = int(np.sum(mesh.nlev_nod - 1))
    for path, ms in best.items():
        print(f"step time backend={path}: {ms:.4f} ms/step, "
              f"{gp / (ms * 1e-3):.4e} grid-points/s "
              f"(core2 f32, {gp} grid points; card {card})")

    # per-kernel time beside its plain version, at the main path's shapes
    s = state_c
    tmax, tmin = K.bounds(sc.md, s["fct_LO"], s["ttf"], 1)
    plus, minus, avl, _ = K.limit(sc.md, s["fct_adf_v"], tmax, tmin,
                                  s["fct_adf_h"], cfg.dt, cfg.flux_eps, False)
    md = sc.md
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
        kern()
        plain()
        t = {"kernel": float("inf"), "plain": float("inf")}
        for _ in range(TIMING_RUNS):
            t["kernel"] = min(t["kernel"], cuda_time_ms(kern, 10))
            t["plain"] = min(t["plain"], cuda_time_ms(plain, 10))
        times[name] = t
        print(f"kernel {name}: {t['kernel']:.4f} ms, plain "
              f"{t['plain']:.4f} ms (core2 f32; card {card})")
    return counts, times


REPLACES = {
    "bounds": "fesom2_accelerate_tpu/ops/pallas/kernels.py:545",
    "limit": "fesom2_accelerate_tpu/ops/pallas/kernels_packed.py:247",
    "update_fused": "fesom2_accelerate_tpu/ops/pallas/kernels_packed.py:744",
}


def main() -> int:
    card = phase_env()
    phase_build()
    errs = Errors()
    phase_kernel_checks(errs)
    counts, times = phase_main_path(card)
    kernels = [
        {"name": name, "route": "cuda",
         "source": "fesom2_accelerate_tpu_torch/ops/cuda/csrc/fct_ale.cu",
         "replaces": REPLACES[name], "launches": counts[name],
         "max_abs_err": errs.max_abs[name], "ms": times[name]["kernel"],
         "plain_ms": times[name]["plain"]}
        for name in ("bounds", "limit", "update_fused")
    ]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
