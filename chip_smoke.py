#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU (written for an H100).

Usage, from the root of a checkout:  python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):
1. versions of torch, CUDA, nvcc and Triton, the card's name and power
   limit; no CUDA device is a failure (there is no CPU fallback);
2. build the CUDA kernels from ``ops/cuda/csrc`` with nvcc (sm_90a), one
   nvcc per source, in parallel, and print each kernel instance's
   registers and spills, then those of the redesigned kernels (H-K2,
   H-K4 in both forms, the FIX form being K4-fix, H-K12, H-S2R) at 8
   slots and 128 threads, f32 and f64;
3. hold each FCT kernel against its plain PyTorch version on the card, on
   the ``small`` and ``core2`` meshes: vlimit 1/2/3 x iter_yn in float32,
   vlimit 1 x iter_yn in float64, and one K2 case with a nonzero vertical
   flux at each node's bottom interface z = nlev_nod - 1 (the b3v mask);
   a second launch of H-K2 must give the same bits;
   in every case H-K34 must also be bit-identical to H-K3 -> H-K4 on the
   same factors (max difference printed); then the full CUDA step against
   the plain step in float64 on ``small``;
3b. hold H-S2R (stress2rhs) against its plain version on the ``small`` and
   ``core2`` planar meshes, the core2-size RCM cylinder and the FESOM2
   mesh files of ``tests/data/polar_cap`` (RCM-renumbered and as read), in
   float32 and float64, plus an all-ice-free case (exactly rhs where
   inv_areamass > 0) and an all-massless case (exact zeros); a second
   launch on the same inputs must give the same bits (no atomics);
3c. the FCT kernels on the RCM cylinder and polar_cap, the orderings on
   which the JAX package runs its one-hot kernels: the checks of phase 3
   (vlimit 1/2/3 x iter_yn in float32, vlimit 1 in float64, H-K34 against
   H-K3 -> H-K4), then 20 steps of ``FctAleSolver(device="cuda")``
   against ``backend="torch"``;
4. the FCT main path: 20 steps of ``FctAleSolver(device="cuda")`` (no
   backend: the default on a CUDA device, which must be "cuda") on core2,
   float32, dt=0.5, flux_eps=1e-7, vlimit 1, against the same 20 steps of
   ``backend="torch"`` on the card, with each kernel's launch count, and
   the time per step of both paths (CUDA events, best of 3); H-K12, H-K3
   and H-K4, the kernels of that step, each beside its plain version at
   the main path's state (device time, stream held); one line per
   kernel of the default step, of the split chain and H-K12 (H-K1, H-K2,
   H-K34, H-K3, H-K4, H-K12, K4-fix) at 128 threads, at core2's shapes and at
   those of its part 1 of 4 (the sharded step's): registers
   (ptxas), resident blocks per SM (cudaOccupancyMaxActiveBlocksPerMulti-
   processor), grid blocks and waves over the card's SMs, the warps each
   SM holds while the first wave runs, and for H-K34
   the edges that cross a node tile (each limited twice);
5. the stress2rhs path: ``Stress2RhsSolver`` packs the element inputs once
   and runs a 120-substep EVP loop of ``call_packed`` on core2, float32,
   with the default backend on the card ("cuda") and ``backend="torch"``;
   the launch count, the final U, V against each other, device and host
   time per substep, nodes/s and modeled GB/s; the cuda loop also as a
   ``graphs.StepGraphs`` run (``runtime/graphs.py``, the counterpart of
   bench.py's ``lax.scan`` of substeps), which must choose graphs (the
   host sets the pace of a substep): bit for bit against the host's loop,
   with its launches, its timed substep, first-run and capture time, the
   copy of the carry, and device, events and host wall per substep beside
   the loop's; then the same on the RCM cylinder;
6. the sharded path, 4 parts of one mesh on the one card:
   a. H-K3 (b3h), H-K3fix (b3h_fixup) and H-K4 (update) against their plain
      versions on ``small`` and core2, as one mesh and on each of its 4
      parts with the part's fix-edge list, iter_yn both ways, float32 and
      float64 (H-K3 and H-K3fix bit-exact, also with a duplicated id list;
      H-K4 to relerr 1e-6 / 1e-12, a second launch bit-identical); H-K34
      on each part, every edge output
      bit-exact against its plain version (the tiles' edge ranges), and
      every output bit-identical to H-K3 -> H-K4 on the same factors, for
      vlimit 1/2/3 x iter_yn in float32 and vlimit 1 in float64 on
      core2's parts; K4-fix (update_fixup, H-K4's FIX form: K3fix folded
      into K4) on every part of core2 and small at 4 parts and of small
      and the multi-hop mesh at 8, after K1 -> K2 -> K3 and the exchange
      at 3 tracers, vlimit 1/2/3 x iter_yn, float32 and float64: every
      output, the full limited-flux arrays included, bit-identical to
      H-K3fix -> H-K4 (largest difference printed), to a second launch
      and, tracer by tracer, to 3 launches at Tb = 1; within 1e-6 / 1e-12
      of update_fixup_ref (edge outputs bit-exact).  H-K3fix runs in no
      path any more: it is the fold's witness;
   b. 20 steps of ``ShardedFctAleSolver(devices=["cuda:0"] * 4)`` (the
      default backend, "cuda"; ``run`` replays CUDA graphs) on core2
      (float32, dt=0.5, flux_eps=1e-7, vlimit 1, seed 0), split and fused,
      each against 20 steps of
      ``FctAleSolver(device="cuda")``: gathered node fields and
      ``fct_adf_h`` within MAIN_RELERR,
      and the launch counts (split 4 x K1, K2, K3, K4-fix per step: 16,
      no K3fix and no plain K4; fused 4 x K1, K2, K34); the time per step
      of split, fused and the single-device run (CUDA events, device time
      with the stream held, host wall and the host's enqueue time), the
      exchange alone, and each kernel of the split step (H-K1, H-K2, H-K3,
      K4-fix), the witness H-K3fix and H-K4, and H-K34 beside its plain
      version and its bound at one part's shapes and at the whole mesh's
      (K4-fix at part 1's only), and K4-fix beside H-K3fix + H-K4;
   c. float64 against the single-device CUDA step at 1e-12: the multi-hop
      mesh ``generate_planar_mesh(nx=4, ny=7, nl=5)`` at 8 parts (exchange
      radius >= 2) and ``small`` at 8 parts in iterative mode, 3 steps,
      split and fused, both exchange forms;
7. the last two kernels, the step's forms and the tuner:
   a. H-K12 (limit_fused) against its plain version (bounds_ref then
      limit_ref) on planar meshes whose layer counts straddle its level
      chunk LC (L = 2, LC - 1, LC, LC + 1, 2 LC + 1) and on small, core2,
      the cylinder and polar_cap: vlimit 1/2/3 x iter_yn in float32 and
      float64 and a b3v-mask case (bounds bit-exact, the rest 1e-6 /
      1e-12), and every output bit-identical to H-K1 -> H-K2 on the same
      inputs (largest difference printed);
      H-A2 (a2) against a2_ref on core2 and the cylinder, f32 and f64,
      bit-exact; H-K2 (limit) and H-K4 (update) against their plain
      versions on planar meshes whose layer counts straddle their level
      chunks (L = 2, LC - 1, LC, LC + 1, 2 LC + 1 for each), vlimit 1/2/3
      x iter_yn in float32 and float64, a second launch bit-identical;
   b. 20 core2 f32 steps of ``FctAleSolver(backend="cuda")`` in each of the
      four forms (``fuse_k12`` x ``fuse_k34``) against the default
      K12 -> K3 -> K4, within MAIN_RELERR, with 2, 3 or 4 launches per
      step; the step time of each form (events around 20 steps, best of
      3); H-K12 beside H-K1 + H-K2 and its plain version, H-A2 beside its
      plain version (device time, stream held); the plain stages of the
      step one by one (``runtime/tracing.time_stages``), with GB/s;
   c. a short run of the tuning harness (``utils/tuning.py``): ``tune_a2``
      and ``tune_step`` at 128 and 256 threads on core2, every
      configuration validated against the float64 gate before it is timed;
8. the multi-tracer path (the tracer axis of H-K1, H-K2, H-K12, H-K3,
   H-K3fix, H-K4 in both forms and H-K34; tracer t from ``random_fields(seed=t)``,
   ``hnode`` and ``hnode_new`` shared, as ``bench.py`` makes them):
   a. each of the eight wrappers at 3 tracers on small and core2 (f32
      vlimit 1 both ways and vlimit 3, f64 iterative; K4-fix with every
      column owned, a whole mesh's case, where it is K4) against 3
      launches at Tb = 1, bit for bit (largest difference printed), and
      against its batched plain version at phase 3's tolerances;
   b. 20 core2 f32 steps of ``FctAleSolver(backend="cuda").run_tracers`` at
      4 tracers, in the default form K12 -> K3 -> K4, in K1 -> K2 -> K34
      and in K1 -> K2 -> K3 -> K4, against 20 single-tracer CUDA runs of
      each tracer, bit for bit, with 3 (or 4) launches a step;
   c. a float64 ``step_tracers`` on small (vlimit 1/3 x iter_yn x those
      three forms) against the plain step per tracer, 1e-12;
   d. ``ShardedFctAleSolver(backend="cuda", devices=["cuda:0"] * 4,
      tracers=4)`` on core2, split and fused, 20 steps, against the
      single-device batched run within MAIN_RELERR, with 16 (split) and 12
      (fused) launches and as many exchange ops a step as at Tb = 1
      (EXCHANGE_OPS, 12: one exchange of both limiter factors);
   e. ms a tracer a step at Tb = 1, 2, 4, 8 on core2 f32, single device and
      4 parts split and fused (CUDA events around the solver's run, device
      time with the stream held, host enqueue); at Tb = 1 and 8 also the
      choice each run made from its watched steps (graphs or the loop), each
      first run's capture time, the memory of its graphs' pool and static
      carry, the copy of the state into the static carry (a run) and of
      the fields a step changes back into it (a block), and the run
      against the host's loop of the same steps and, on one device, graph
      replays (events, host wall, the card's idle share); on one device
      the three at 1, 20 and 300 steps (bench.py's default); and each
      kernel a tracer at Tb = 8 and at Tb = 1 beside its bound
      (``profiling.kernel_io(tracers=8)``);
9. the on-device run (CUDA graphs, ``runtime/graphs.py``) and checkpoints:
   a. graph runs against the host's loop of their steps (``graphs.loop``),
      bit for bit in every column (largest difference printed, 0 so far),
      with their launches: graph replays (``StepGraphs.replay``) of core2
      f32 in the four single-device forms, of a run of ODD_STEPS (no
      multiple of a block) and of ``step_tracers`` at 4 tracers; the
      sharded ``run``, which must choose graphs, at 4 parts split and
      fused with both exchange forms; small f64 iterative at vlimit 1 and
      3 (replays and the solver's ``run`` on one device, 4 parts split and
      fused);
   b. the launch counts of graph runs (3 / 16 / 12 a step), a run that
      captures a block length (its calls rolled back, its replays added)
      and a run of replays only, held against the kernel events
      torch.profiler records, and the exchange ops of a sharded step (12);
   c. 10 split steps at 4 parts on core2, ``save_checkpoint``, loaded at 2
      parts and on one device, 10 more steps each, against 20 steps without
      a break (MAIN_RELERR); the same at 4 tracers, resumed at 2 parts.
10. the bench and its measurement tools (``utils/bench.py``,
   ``utils/scaling.py``, ``utils/accuracy.py``), each cell's solver freed
   before the next: the triad roof (``profiling.measure_stream_bandwidth``,
   at most 1.05 x the data sheet's 3.35 TB/s); every bench cell at 20 steps
   (120 EVP substeps), one JSON line each, each run bit for bit against
   ``graphs.loop`` of its steps with its launches, and its ``step_io``
   share of the measured roof at most 1; the scaling harness on core2 at
   P = 1, 2, 4, split and fused, whose exactness gate must pass; the f32
   drift and ``flux_eps`` tables on small, kernels and plain stages;
11. the sharded step over 2 OS processes (``utils/multiproc.py``), both
   ranks on cuda:0 over gloo (each slab staged through pinned host
   memory), 2 parts each: core2 f32 split and fused, 20 steps, small f64
   iterative (3 steps) and core2 split at 4 tracers, each bit for bit on
   the owned nodes (node fields and ``fct_adf_h``, both ranks' gathers)
   against ``ShardedFctAleSolver(devices=["cuda:0"] * 4)`` in this
   process, with 8 (split) / 6 (fused) launches a rank a step and the
   cross-process sends and bytes a step; a collective checkpoint at 10
   split steps (rank 0 writes), resumed here at 2 parts, bit for bit
   against 20 steps without a break; the messages and bytes each rank
   sends a step equal to one exchange of both limiter factors' slabs (and
   one of fct_LO's when iterative), from the partition (``mp_sent``: 1
   message and 113,928 B a rank on core2, where one exchange a factor
   sent 2); ms a step on each rank (CUDA events, host wall) of core2
   split and fused beside those of one exchange a factor
   (MP_TWO_EXCHANGE_STEP_MS), the time of one exchange of both factors
   alone, and a torch.profiler trace of one split step on each rank:
   whether the staging of its slabs (the gather and device-to-host copy
   on the side stream) ran while its K3 ran, printed, not asserted;
12. the host-embedding ABI: the shim (``native/fesom2_torch_host.cpp``)
   and its C demo host built with g++; the demo runs one step through
   ``f2t_*_`` on core2 with backend 1 (the CUDA kernels, f32), bit for bit
   against ``FctAleSolver(device="cuda")`` on the same f64 fields; on
   core2 with backend 0 (the plain stages, f64) on the card, bit for bit
   against ``FctAleSolver(backend="torch", device="cuda")`` and within
   1e-12 of the port's oracle (phase 13's step on its fields); and on
   small with backend 0 asked for on the CPU (``FESOM2_TORCH_DEVICE=cpu``)
   bit for bit against ``FctAleSolver(device="cpu")``; then 5 steps each
   of backend 1 and backend 0 on core2 through ``host_embed``'s calls on
   ctypes-addressed buffers, timed as copy-in, step and copy-out, with the
   launch counts (backend 0 launches no kernel of the port, its solver on
   the card) and backend 0's peak device memory;
13. the ground truth: the port's numpy oracle (``ops/oracle.py``) and C++
   golden reference (``mesh/native.py`` over
   ``native/fesom2_torch_core.cpp``, built here with g++), neither of
   them written with the kernels; every check raises:
   a. the native mesh core (edges, edge_tri, the node -> element and node
      -> edge incidences with counts, positions and signs) array-equal to
      the numpy topology on core2, the cylinder and polar_cap, both builds
      timed on the host;
   b. on core2 and the cylinder, f64, inputs from ``random_fields``: H-K1
      (vlimit 1/2/3) and H-A2 bit-exact against ``a1 -> a2 -> a3_vlimit*``
      and ``oracle.a2``; H-K2, H-K12 (its bounds bit-exact), H-K3, H-K3fix
      (every edge), H-K4, H-K34 and K4-fix (every column owned) within
      1e-12 (``masked_allclose``, rtol = atol = 1e-12, as
      tests/conftest.py) of the oracle's stages, iter_yn both ways, at the
      vlimits of c, each fed the oracle's upstream outputs; H-S2R within
      1e-12 of ``oracle.stress2rhs`` and of ``f2t_stress2rhs``;
   c. one f64 step of ``FctAleSolver(device="cuda")``, the default form
      K12 -> K3 -> K4, K1 -> K2 -> K34 and K1 -> K2 -> K3 -> K4, against
      ``oracle.fct_ale_step`` for vlimit 1
      x iter_yn on core2 (and against ``NativeReference.step``) and vlimit
      2/3 x iter_yn on the cylinder (a core2-size oracle step takes about
      7 s on the host), every output within 1e-12; one f64 4-part split
      step of ``ShardedFctAleSolver(devices=["cuda:0"] * 4)`` (K1, K2,
      K3, K4-fix 4 times each), gathered, against the oracle;
   d. the f32 production path from ``random_fields(seed=0)`` rounded to
      f32: one step against the f64 oracle (bounds compared with the
      oracle's rounded to f32, every output within relerr 1e-6); 20
      iterative ``NativeReference`` steps with ``graphs.loop``'s carry (on
      a host thread, beside the cylinder's checks), each also taken in
      f32 by the kernels from the reference's state: ``fct_LO`` within
      relerr 1e-5 of the reference's next state (the plain f32 path's
      error printed beside); then 20 steps of ``run`` free of the
      reference, launches 20 each of K1, K2, K34, their drift from it and
      the plain path's printed;
   e. a core2 step of the golden reference (C++, one thread) and of the
      oracle (numpy) on the host, with the CPU's model, beside the f64 and
      f32 CUDA steps (events, best of 3), and the topology builds.
Every kernel instance's ptxas report is printed, and a spill fails the
build phase.  The last three lines are the per-kernel JSON summary (each
kernel's launches on its path (H-K12's, H-K3's and H-K4's in phase 4's
main path, K4-fix's in phase 6b's split step, H-K3fix's in phase 6a's
witness checks, H-K1's, H-K2's and H-K34's in phase 7b's K1 -> K2 ->
K34 form, H-A2's in the tuner), max abs error, ms and plain ms at the
shapes of that path (K4-fix and H-K3fix at core2's part 1, the others at
the whole core2 mesh), the byte bound
at the H100 SXM data-sheet rate of ``runtime/profiling.py``, and
``library_ms``: null, since no single PyTorch call computes any of these
functions; ``oracle_max_abs_err_f64``, the largest f64 difference from the
oracle in phase 13 (b, and for K4-fix also the 4-part step of c); the
eight with a tracer axis also carry
``ms_per_tracer_tb8`` and ``bound_ms_tb8``, a tracer's share of one launch
at 8 tracers and of its bound), the card's name and power limit as
nvidia-smi prints them, and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from fesom2_accelerate_tpu_torch.runtime import graphs, profiling
from fesom2_accelerate_tpu_torch.runtime.tracing import (
    card_line,
    cuda_time_ms,
    device_time_ms,
    time_stages,
)

MAIN_STEPS = 20
# the kernels whose registers phase 2 sums up (the latest redesigns; the
# update lines include H-K4's FIX form, K4-fix)
REDESIGNED = ("limit", "update", "limit_fused", "stress2rhs")
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


def phase_build() -> list:
    """Builds the kernels; returns every instance's ptxas report."""
    from fesom2_accelerate_tpu_torch.ops.cuda import build, kernels

    paths, seconds = build.build()
    build.library()
    print(f"build: {', '.join(p.name for p in paths)} in {seconds:.2f} s "
          f"(nvcc, sm_90a, one process per source)")
    # one line per kernel instance: registers and spills from ptxas -v
    spills, reports = [], []
    for path in paths:
        log = path.with_suffix(".log")
        if not log.exists():
            continue
        for r in build.ptxas_report(log.read_text()):
            reports.append(r)
            name = (f"{r['kernel']}<{r['dtype']},"
                    f"{','.join(map(str, r['params']))}"
                    f"{',tracers' if r['tracers'] else ''}"
                    f"{',fix' if r['fix'] else ''}>")
            print(f"  ptxas: {name}: {r['registers']} registers, stack "
                  f"{r['stack']}, spill stores {r['spill_stores']}, spill "
                  f"loads {r['spill_loads']}")
            if r["spill_stores"] or r["spill_loads"]:
                spills.append(name)
    # the kernels redesigned last, at the default block size and 8 slots
    th = kernels.DEFAULT_THREADS
    for name in REDESIGNED:
        for r in reports:
            if r["kernel"] == name + "_kernel" and r["params"] == (8, th):
                tr = ((",tracers" if r["tracers"] else "")
                      + (",fix" if r["fix"] else ""))
                print(f"registers {name}<{r['dtype']},8,{th}{tr}>: "
                      f"{r['registers']}, stack {r['stack']}, spill stores "
                      f"{r['spill_stores']}, spill loads {r['spill_loads']}")
    sys.stdout.flush()
    if spills:
        raise AssertionError(f"kernel instances spill registers: {spills}")
    return reports


class Errors:
    """Largest absolute error seen per kernel over every checked case."""

    def __init__(self):
        self.max_abs = {name: 0.0 for name in KERNEL_SOURCES}

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


def k34_vs_k3_k4(md, s, cfg, plus, minus, adf_v_lim, case: str) -> float:
    """H-K34 against H-K3 -> H-K4 on the same factors: every output must be
    bit-identical.  Returns the largest absolute difference (0.0)."""
    from fesom2_accelerate_tpu_torch.ops.cuda import kernels as K

    node = (s["ttf"], s["hnode"], s["hnode_new"], s["fct_LO"],
            s["del_ttf_advvert"], s["del_ttf_advhoriz"], cfg.dt, cfg.iter_yn)
    fused = K.update_fused(md, plus, minus, adf_v_lim, s["fct_adf_h"], *node)
    lim, res = K.b3h(md, plus, minus, s["fct_adf_h"], cfg.iter_yn)
    chain = K.update(md, adf_v_lim, lim, *node) + (lim, res)
    diff = 0.0
    for name, a, b in zip(("o1", "o2", "adf_h_lim", "adf_h_res"), fused,
                          chain):
        if b is None:
            if a is not None:
                raise AssertionError(f"K34 {name} {case}: expected None")
            continue
        d = abserr(a, b)
        diff = max(diff, d)
        if not torch.equal(a, b):
            raise AssertionError(f"K34 {name} {case}: not bit-identical to "
                                 f"K3 -> K4 (max abs diff {d:.3e})")
    return diff


def check_kernels(md, state, cfg, errs: Errors, case: str) -> float:
    """Each wrapper against its plain version on the same inputs; K2 and
    K34 are fed the plain upstream outputs, so each is checked alone.
    Returns K34's largest difference from K3 -> K4 on those factors."""
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
    again = K.limit(*args)
    for i, name in enumerate(LIMIT_OUTPUTS):
        errs.check("limit", name, got_l[i], ref_l[i], tol, case)
        errs.check("limit", name, again[i], got_l[i], 0.0,
                   f"{case} second launch")

    args = (md, ref_l[0], ref_l[1], ref_l[2], s["fct_adf_h"], s["ttf"],
            s["hnode"], s["hnode_new"], s["fct_LO"], s["del_ttf_advvert"],
            s["del_ttf_advhoriz"], cfg.dt, cfg.iter_yn)
    ref_u = K.update_fused_ref(*args)
    got_u = K.update_fused(*args)
    for i, name in enumerate(("o1", "o2", "adf_h_lim", "adf_h_res")):
        errs.check("update_fused", name, got_u[i], ref_u[i], tol, case)
    return k34_vs_k3_k4(md, s, cfg, *ref_l[:3], case)


# the kernels of the solvers' default single-device step (ops/cuda/step.py
# DEFAULT_FORM: K12 -> K3 -> K4)
FCT_KERNELS = ("limit_fused", "b3h", "update")
LIMIT_OUTPUTS = ("fct_plus", "fct_minus", "adf_v_lim", "adf_v_res")
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
        n_cases, k34 = 0, 0.0
        for dtype, vlimit, iter_yn in FCT_CASES:
            cfg = FctAleConfig(vlimit=vlimit, iter_yn=iter_yn, dt=0.5,
                               flux_eps=1e-7 if dtype == torch.float32
                               else 1e-16, dtype=dtype)
            solver = FctAleSolver(mesh, cfg, backend="cuda", device="cuda")
            state = solver.init_state(fields)
            k34 = max(k34, check_kernels(
                solver.md, state, cfg, errs,
                f"{preset} {dtype} vlimit={vlimit} iter={iter_yn}"))
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
        k34 = max(k34, check_kernels(md, state, cfg, errs,
                                     f"{preset} b3v-mask"))
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
              f"{K.TOLERANCE[torch.float64]:.0e} f64); max |K34 - "
              f"(K3 -> K4)| {k34:.3e}", flush=True)

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


def host_wall_ms(calls: dict) -> dict:
    """Best of TIMING_RUNS host wall times of each callable, to a final
    synchronize, measured in turns."""
    wall = {name: float("inf") for name in calls}
    for _ in range(TIMING_RUNS):
        for name, fn in calls.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall[name] = min(wall[name], (time.perf_counter() - t0) * 1e3)
    return wall


def first_runs(run) -> tuple:
    """(ms of the first call, capture ms) of ``run``, a run that no call
    has captured yet, by the host wall of its first three calls (to a
    synchronize): the first takes its first steps eagerly (a solver's run
    also times one, ``graphs.StepGraphs.run``) and captures the blocks of
    the others, the second captures the run's whole length if it fits one
    block, the third only replays.  Capture ms = first - third: the first
    run's captures and its eager steps.  The capture, like a JAX compile,
    is left out of every timed run."""
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls[0], walls[0] - walls[2]


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal shapes, dtypes and bits (a NaN equals the same NaN: the 0/0
    of a part's pad columns, which hold no node)."""
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.view(ints[a.dtype]), b.view(ints[b.dtype])))


def bits_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| where both are numbers (NaNs of pad columns left out)."""
    return float(torch.nan_to_num((a.double() - b.double()).abs(),
                                  nan=0.0).max())


def copy_ms(tensors: list) -> float:
    """Device time (CUDA events, best of TIMING_RUNS) of copying
    ``tensors`` into tensors of their shapes: what a graph run adds
    around its replays (all the state's tensors: the copy into the static
    carry a run; the fields a step changes: the copy back a block)."""
    static = [torch.empty_like(t) for t in tensors]

    def copies():
        for b, t in zip(static, tensors):
            b.copy_(t)

    return best_times({"copies": copies}, 1, timer=cuda_time_ms)["copies"]


def changed_fields(state: dict, new: dict) -> list:
    """The tensors of ``state`` (a flat dict) whose fields a step's result
    ``new`` (flat too) holds anew."""
    return [v for k, v in state.items() if new[k] is not v]


def chose_graphs(sg) -> str:
    """A StepGraphs' choices (graphs.StepGraphs.run) as text."""
    from fesom2_accelerate_tpu_torch.runtime.graphs import WATCHED_STEPS

    return "; ".join(f"the card ran dry at {d} of {WATCHED_STEPS} steps: "
                     f"{'graphs' if p else 'loop'}"
                     for d, p in sg.choices.values()) or "no choice yet"


def decide(run, state, sg, label: str, tries: int = 5) -> None:
    """Runs ``run(state, n)``, n the fewest steps a choice needs, until
    the StepGraphs ``sg`` has made its choice (a choice waits for a run
    over which the allocator's reserve held still: graphs.StepGraphs.run);
    raises after ``tries`` runs without one."""
    from fesom2_accelerate_tpu_torch.runtime.graphs import (
        WARM_STEPS,
        WATCHED_STEPS,
    )

    for _ in range(tries):
        if sg.choices:
            return
        run(state, WARM_STEPS + WATCHED_STEPS + 1)
    if not sg.choices:
        raise AssertionError(f"{label}: no choice after {tries} runs")


def require_graphs(sg, label: str) -> None:
    """Raises unless every run of ``sg`` has chosen graphs."""
    if not sg.choices or not all(p for _, p in sg.choices.values()):
        raise AssertionError(f"{label}: the host sets the pace, yet the run "
                             f"has not chosen graphs ({chose_graphs(sg)})")


def flat_state(state: dict) -> dict:
    """A solver's state as one dict of tensors (a sharded state's lists
    keyed (field, part))."""
    out = {}
    for k, v in state.items():
        if isinstance(v, list):
            out.update({(k, p): t for p, t in enumerate(v)})
        else:
            out[k] = v
    return out


def fct_cuda_vs_torch(mesh, fields, cfg, steps: int, label: str):
    """``steps`` steps of ``FctAleSolver(device="cuda")`` (no backend: the
    default, which must resolve to "cuda") against ``backend="torch"`` on
    the card: the cuda run's launch counts (set to 0 just before it, read
    just after), and both final states within MAIN_RELERR.  Returns the
    counts, both solvers and their initial states."""
    from fesom2_accelerate_tpu_torch import FctAleSolver
    from fesom2_accelerate_tpu_torch.ops.cuda import kernels as K

    # no backend: on a CUDA device the default runs the kernels
    sc = FctAleSolver(mesh, cfg, device="cuda")
    st = FctAleSolver(mesh, cfg, backend="torch", device="cuda")
    if sc.backend != "cuda":
        raise AssertionError(f"{label}: default backend {sc.backend!r}")
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
            again = K.stress2rhs(md, slab, iam, ra, rm)
            for i, name in enumerate("UV"):
                errs.check("stress2rhs", name, got[i], ref[i],
                           K.TOLERANCE[dtype], case)
                # no atomics: a second launch gives the same bits
                errs.check("stress2rhs", name, again[i], got[i], 0.0,
                           f"{case} second launch")
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
              f"{K.TOLERANCE[torch.float64]:.0e} f64; a second launch "
              f"bit-identical; ice-free and massless cases exact)",
              flush=True)


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
        k34 = 0.0
        for dtype, vlimit, iter_yn in FCT_CASES:
            cfg = FctAleConfig(vlimit=vlimit, iter_yn=iter_yn, dt=0.5,
                               flux_eps=1e-7 if dtype == torch.float32
                               else 1e-16, dtype=dtype)
            state = {k: torch.tensor(v, dtype=dtype, device="cuda")
                     for k, v in fields.items()}
            k34 = max(k34, check_kernels(
                md[dtype], state, cfg, errs,
                f"{key} {dtype} vlimit={vlimit} iter={iter_yn}"))
        torch.cuda.synchronize()
        print(f"kernels vs plain: {key} ({mesh.n_nodes} nodes, "
              f"{mesh.n_layers} layers, {md[torch.float32].nd_idx.shape[1]} "
              f"incidence slots, {md[torch.float32].tile_edges} edges in the "
              f"largest K34 tile): {len(FCT_CASES)} cases ok; max |K34 - "
              f"(K3 -> K4)| {k34:.3e}", flush=True)
        cfg = FctAleConfig(dt=0.5, flux_eps=1e-7, vlimit=1, iter_yn=False,
                           dtype=torch.float32)
        fct_cuda_vs_torch(mesh, fields, cfg, MAIN_STEPS,
                          f"fct cuda vs torch on {key}")


def phase_main_path(card: str, meshes: dict, reports: list) -> tuple:
    from fesom2_accelerate_tpu_torch import FctAleConfig
    from fesom2_accelerate_tpu_torch.mesh import random_fields
    from fesom2_accelerate_tpu_torch.ops.cuda import kernels as K
    from fesom2_accelerate_tpu_torch.ops.meshdata import (
        TILE_NODES,
        build_mesh_data,
    )
    from fesom2_accelerate_tpu_torch.parallel.partition import partition_mesh

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

    # each kernel of the main path's step (FCT_KERNELS) beside its plain
    # version, at the main path's state
    s = state_c
    md = sc.md
    k12 = (md, s["fct_LO"], s["ttf"], s["fct_adf_v"], s["fct_adf_h"],
           cfg.vlimit, cfg.dt, cfg.flux_eps, False)
    _, _, plus, minus, avl, _ = K.limit_fused(*k12)
    ah = s["fct_adf_h"]
    lim, _ = K.b3h(md, plus, minus, ah, False)
    node = (s["ttf"], s["hnode"], s["hnode_new"], s["fct_LO"],
            s["del_ttf_advvert"], s["del_ttf_advhoriz"], cfg.dt, False)
    calls = {
        "limit_fused": (lambda: K.limit_fused(*k12),
                        lambda: K.limit_fused_ref(*k12)),
        "b3h": (lambda: K.b3h(md, plus, minus, ah, False),
                lambda: K.b3h_ref(md, plus, minus, ah, False)),
        "update": (lambda: K.update(md, avl, lim, *node),
                   lambda: K.update_ref(md, avl, lim, *node)),
    }
    times = {}
    for name, (kern, plain) in calls.items():
        t = best_times({"kernel": kern, "plain": plain}, 5)
        times[name] = t
        print(f"kernel {name}: {t['kernel']:.4f} ms, plain "
              f"{t['plain']:.4f} ms (core2 f32; card {card})")

    # how each kernel of the default step and of the split chain fills the
    # card at the default block size, at core2's shapes and at those of
    # part 1 of SHARD_PARTS (the sharded step's)
    pm = partition_mesh(mesh, SHARD_PARTS)
    part = build_mesh_data(pm.local_meshes[1], torch.float32, "cuda")
    th = K.DEFAULT_THREADS
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for where, omd in (("core2", md), ("core2 part 1", part)):
        for name in K.OCCUPANCY:
            occ = K.occupancy(omd, name, threads=th)
            fix = name == "update_fixup"  # H-K4's FIX form
            regs = [r["registers"] for r in reports
                    if r["kernel"] == ("update" if fix else name) + "_kernel"
                    and r["dtype"] == "float" and r["fix"] == fix
                    and r["params"] in ((8, th), (th,)) and not r["tracers"]]
            extra = ""
            if name == "update_fused":
                # edges limited twice: they start in another tile than the
                # one of their second endpoint, which sums them
                e = omd.edges.long()
                real = e[:, 0] != e[:, 1]
                cross = ((e[:, 0] // TILE_NODES != e[:, 1] // TILE_NODES)
                         & real)
                extra = (f", {omd.tile_edges} edges in the largest tile, "
                         f"{int(cross.sum())} of {int(real.sum())} edges "
                         f"({100 * float(cross.sum()) / float(real.sum()):.1f}"
                         f"%) cross a tile and are limited twice")
            # warps each SM holds while the first wave runs
            warps = (min(occ["grid_blocks"], occ["blocks_per_sm"] * sms)
                     * th / 32 / sms)
            print(f"occupancy {name}: {regs[0]} registers, "
                  f"{occ['blocks_per_sm']} blocks of {th} a SM, "
                  f"{occ['grid_blocks']} blocks, {occ['waves']:.2f} waves on "
                  f"{sms} SMs, {warps:.1f} warps an SM at launch{extra} "
                  f"({where}, {omd.n_nodes} nodes, f32; card {card})",
                  flush=True)
    return counts, times, md


def s2r_loop(solver, packed, inv_areamass, rhs_a, rhs_m):
    """S2R_SUBSTEPS EVP substeps: each call's U feeds the next call's
    rhs_a (rhs_a + 1e-30 * U), so every call depends on the one before, as
    in bench.py's scan."""
    for _ in range(S2R_SUBSTEPS):
        u, v = solver.call_packed(packed, inv_areamass, rhs_a, rhs_m)
        rhs_a = rhs_a + 1e-30 * u
    return u, v


def s2r_substep(solver, packed, inv_areamass, rhs_m):
    """One substep of s2r_loop as a step of a graph's carry (rhs_a, u, v):
    the call, then rhs_a + 1e-30 * U for the next call (the counterpart of
    the body of bench.py's 120-substep scan)."""
    def step(c):
        u, v = solver.call_packed(packed, inv_areamass, c["rhs_a"], rhs_m)
        return {"rhs_a": c["rhs_a"] + 1e-30 * u, "u": u, "v": v}
    return step


def s2r_path(card: str, mesh, label: str) -> tuple:
    """The EVP substep loop on one mesh, f32, cuda against torch: launch
    count, agreement, device and host time per substep, rates, and the
    kernel's time beside its plain version's.  The cuda loop also as CUDA
    graphs (runtime/graphs.py): bit for bit against the host's loop, with
    its capture time and its times beside the loop's."""
    from fesom2_accelerate_tpu_torch import Stress2RhsSolver
    from fesom2_accelerate_tpu_torch.ops.cuda import kernels as K
    from fesom2_accelerate_tpu_torch.runtime.profiling import (
        stress2rhs_bytes,
    )

    host = s2r_inputs(mesh)
    # no backend: on a CUDA device the default runs H-S2R
    sc = Stress2RhsSolver(mesh, torch.float32, device="cuda")
    st = Stress2RhsSolver(mesh, torch.float32, backend="torch",
                          device="cuda")
    if sc.backend != "cuda":
        raise AssertionError(f"{label}: default backend {sc.backend!r}")
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

    # the same loop as graph replays: bit for bit against the host's loop,
    # with the launches of a run (set to 0 just before it, read just after)
    sg = graphs.StepGraphs("cuda")
    step = s2r_substep(sc, pc, node[0], node[2])
    carry = dict(rhs_a=node[1], u=torch.zeros_like(node[1]),
                 v=torch.zeros_like(node[1]))
    graph_loop = lambda: sg.run(step, carry, S2R_SUBSTEPS)  # noqa: E731
    first, capture = first_runs(graph_loop)
    require_graphs(sg, f"{label} EVP loop")
    choice = chose_graphs(sg)
    K.reset_launch_counts()
    out = graph_loop()
    torch.cuda.synchronize()
    check_counts(K.launch_counts(), {"stress2rhs": S2R_SUBSTEPS},
                 f"{label} graph")
    diff = max(abserr(out["u"], uc), abserr(out["v"], vc))
    if not (same_bits(out["u"], uc) and same_bits(out["v"], vc)):
        raise AssertionError(f"{label}: graph loop not bit-identical to the "
                             f"host loop (max abs diff {diff:.3e})")
    print(f"{label} as CUDA graphs ({graphs.BLOCK_STEPS}-substep blocks): "
          f"final U, V bit-identical to the host loop (max |graph - loop| "
          f"{diff:.3e}); watched substeps: {choice}; first run "
          f"{first:.1f} ms, its captures and eager substeps {capture:.1f} "
          f"ms (host wall), copy-in (and copy back a block) "
          f"{copy_ms(list(carry.values())):.4f} ms (events; card {card})",
          flush=True)

    # device time per substep (CUDA events over the loop, device_time_ms),
    # CUDA events alone and host wall time per substep (loop + final
    # synchronize), best of 3, in turns; the card idles for the difference
    loops = {"cuda": lambda: s2r_loop(sc, pc, *node),
             "cuda graph": graph_loop,
             "torch": lambda: s2r_loop(st, pt, *node)}
    dev = best_times(loops, 1)
    events = best_times(loops, 1, timer=cuda_time_ms)
    wall = host_wall_ms(loops)
    nbytes = stress2rhs_bytes(mesh, 4)
    for name in loops:
        ms = dev[name] / S2R_SUBSTEPS
        host_ms = wall[name] / S2R_SUBSTEPS
        print(f"stress2rhs backend={name} on {label}: device "
              f"{ms:.4f} ms/substep, events "
              f"{events[name] / S2R_SUBSTEPS:.4f} ms/substep, host wall "
              f"{host_ms:.4f} ms/substep "
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
    # the kernel's inputs, for its data-dependent bytes (profiling.kernel_io)
    return counts, t, (md, dict(slab=pc, inv_areamass=node[0]))


def phase_s2r_path(card: str, meshes: dict) -> tuple:
    counts, times, shape = s2r_path(card, meshes["core2"],
                                    "stress2rhs path (core2)")
    s2r_path(card, meshes["cylinder"], "stress2rhs path (RCM cylinder)")
    return counts, times, shape


SHARD_PARTS = 4
# the halo fill's device ops a sharded step at SHARD_PARTS parts of core2,
# at any Tb: 6 slabs, an index_select and an index_copy_ each, in the one
# exchange of both limiter factors (24 when each factor had its own)
EXCHANGE_OPS = 12


def part_targets(mesh, dtype, fields) -> list:
    """(label, mesh data, state, fix-edge ids) on the card: the whole mesh
    (every third edge as its id list) and each of its SHARD_PARTS parts
    (its own fix-edge list)."""
    from fesom2_accelerate_tpu_torch.ops.meshdata import build_mesh_data
    from fesom2_accelerate_tpu_torch.parallel import partition as part_mod
    from fesom2_accelerate_tpu_torch.parallel.step_sharded import (
        EDGE_FIELDS,
        fix_edge_ids,
    )

    def tensors(d):
        return {k: torch.tensor(v, dtype=dtype, device="cuda")
                for k, v in d.items()}

    whole = build_mesh_data(mesh, dtype, "cuda")
    out = [("whole", whole, tensors(fields),
            torch.arange(0, mesh.n_edges, 3, dtype=torch.int32,
                         device="cuda"))]
    pm = part_mod.partition_mesh(mesh, SHARD_PARTS)
    local = {k: (part_mod.scatter_edge_field if k in EDGE_FIELDS
                 else part_mod.scatter_node_field)(pm, v)
             for k, v in fields.items()}
    for p, m in enumerate(pm.local_meshes):
        state = {k: v[p] for k, v in local.items()}
        # columns that hold no node get hnode_new = 1, so that iterative
        # stage c (a division by hnode_new) is finite there and every
        # output can be checked; in a run they hold 0/0, which no gather
        # reads
        state["hnode_new"][..., pm.local_nodes_global[p] < 0] = 1.0
        out.append((f"part {p}", build_mesh_data(m, dtype, "cuda"),
                    tensors(state),
                    torch.tensor(fix_edge_ids(pm, p), device="cuda")))
    return out


def plain_factors(md, s, cfg) -> tuple:
    """fct_plus, fct_minus and the limited vertical flux from the plain
    K1 -> K2."""
    from fesom2_accelerate_tpu_torch.ops.cuda import kernels as K

    tmax, tmin = K.bounds_ref(md, s["fct_LO"], s["ttf"], cfg.vlimit)
    return K.limit_ref(md, s["fct_adf_v"], tmax, tmin, s["fct_adf_h"],
                       cfg.dt, cfg.flux_eps, cfg.iter_yn)[:3]


def check_split_kernels(md, s, fix_ids, cfg, errs: Errors,
                        case: str) -> float:
    """H-K3, H-K3fix (also with duplicated ids), H-K4 and H-K34 against
    their plain versions, fed the plain K1/K2 outputs.  The fixup gets
    other factors than K3 (scaled by 3/4), as after an exchange.  Returns
    K34's largest difference from K3 -> K4 on the plain factors."""
    from fesom2_accelerate_tpu_torch.ops.cuda import kernels as K

    it = cfg.iter_yn
    plus, minus, avl = plain_factors(md, s, cfg)
    ah = s["fct_adf_h"]
    ref_e = K.b3h_ref(md, plus, minus, ah, it)
    got_e = K.b3h(md, plus, minus, ah, it)
    for i, name in enumerate(("adf_h_lim", "adf_h_res")):
        errs.check("b3h", name, got_e[i], ref_e[i], 0.0, case)

    px, mx = 0.75 * plus, 0.75 * minus
    dup = torch.cat([fix_ids, fix_ids.flip(0), fix_ids[: len(fix_ids) // 2]])

    def fixed(fn, ids):
        return fn(md, px, mx, ah, ref_e[0].clone(),
                  ref_e[1].clone() if it else None, ids, it)

    ref_f = fixed(K.b3h_fixup_ref, fix_ids)
    for ids, what in ((fix_ids, ""), (dup, " duplicated ids")):
        got_f = fixed(K.b3h_fixup, ids)
        for i, name in enumerate(("adf_h_lim", "adf_h_res")):
            errs.check("b3h_fixup", name, got_f[i], ref_f[i], 0.0,
                       case + what)

    tol = K.TOLERANCE[cfg.dtype]
    node = (s["ttf"], s["hnode"], s["hnode_new"], s["fct_LO"],
            s["del_ttf_advvert"], s["del_ttf_advhoriz"], cfg.dt, it)
    ref_u = K.update_ref(md, avl, ref_f[0], *node)
    got_u = K.update(md, avl, ref_f[0], *node)
    again = K.update(md, avl, ref_f[0], *node)
    for i, name in enumerate(("o1", "o2")):
        errs.check("update", name, got_u[i], ref_u[i], tol, case)
        errs.check("update", name, again[i], got_u[i], 0.0,
                   f"{case} second launch")

    args = (md, plus, minus, avl, ah, *node)
    ref_k = K.update_fused_ref(*args)
    got_k = K.update_fused(*args)
    for i, name in enumerate(("o1", "o2", "adf_h_lim", "adf_h_res")):
        errs.check("update_fused", name, got_k[i], ref_k[i],
                   tol if i < 2 else 0.0, case)
    return k34_vs_k3_k4(md, s, cfg, plus, minus, avl, case)


def phase_sharded_checks(errs: Errors, meshes: dict) -> None:
    from fesom2_accelerate_tpu_torch import FctAleConfig
    from fesom2_accelerate_tpu_torch.mesh import random_fields

    for preset in ("small", "core2"):
        mesh = meshes[preset]
        fields = random_fields(mesh, seed=3, dtype=np.float64)
        n, k34 = 0, 0.0
        for dtype in (torch.float32, torch.float64):
            targets = part_targets(mesh, dtype, fields)
            for iter_yn in (False, True):
                cfg = FctAleConfig(iter_yn=iter_yn, dt=0.5,
                                   flux_eps=1e-7 if dtype == torch.float32
                                   else 1e-16, dtype=dtype)
                for label, md, state, ids in targets:
                    k34 = max(k34, check_split_kernels(
                        md, state, ids, cfg, errs,
                        f"{preset} {label} {dtype} iter={iter_yn}"))
                    n += 1
            if preset != "core2" or dtype != torch.float32:
                continue
            # H-K34 = H-K3 -> H-K4 on core2's parts for the other vlimits
            for vlimit in (2, 3):
                for iter_yn in (False, True):
                    cfg = FctAleConfig(vlimit=vlimit, iter_yn=iter_yn,
                                       dt=0.5, flux_eps=1e-7, dtype=dtype)
                    for label, md, state, _ in targets[1:]:
                        k34 = max(k34, k34_vs_k3_k4(
                            md, state, cfg, *plain_factors(md, state, cfg),
                            f"{preset} {label} vlimit={vlimit} "
                            f"iter={iter_yn}"))
        torch.cuda.synchronize()
        print(f"split kernels vs plain: {preset}, whole and {SHARD_PARTS} "
              f"parts, {n} cases ok (b3h, b3h_fixup bit-exact, also with "
              f"duplicated ids; update relerr <= 1e-6 f32, 1e-12 f64; "
              f"update_fused edge outputs bit-exact on every part); max "
              f"|K34 - (K3 -> K4)| {k34:.3e} (core2's parts also at vlimit "
              f"2/3)", flush=True)


# phase 6a's fold checks: (mesh, parts), every part of each
FOLD_MESHES = (("core2", 4), ("small", 4), ("small", 8), ("multihop", 8))
FOLD_TRACERS = 3


def fold_vs_witness(md, s, pre, edges, owned, ids, cfg, errs: Errors,
                    case: str) -> float:
    """K4-fix (update_fixup) on one part at FOLD_TRACERS tracers, after the
    exchange: bit-identical to H-K3fix -> H-K4 (b3h_fixup on the part's
    fix-edge ids, then update) on the same inputs in every output, the
    full adf_h_lim / adf_h_res arrays included; a second launch
    bit-identical; each tracer bit-identical to a Tb = 1 launch; within
    TOLERANCE of update_fixup_ref (edge outputs bit-exact).  Returns the
    largest difference from the witness (0.0)."""
    from fesom2_accelerate_tpu_torch.ops.cuda import kernels as K

    it = cfg.iter_yn
    node = (pre["adf_v_lim"], s["ttf"], s["hnode"], s["hnode_new"],
            s["fct_LO"], s["del_ttf_advvert"], s["del_ttf_advhoriz"],
            cfg.dt, it)

    def k3(x):  # a copy of K3's outputs, written in place
        return x[0].clone(), x[1].clone() if it else None

    def fold(fn, p, k3_out, n):
        return fn(md, p["fct_plus"], p["fct_minus"], n[0], *k3(k3_out),
                  owned, p["adf_v_lim"], *n[1:])

    lim, res = K.b3h_fixup(md, pre["fct_plus"], pre["fct_minus"],
                           s["fct_adf_h"], *k3(edges), ids, it)
    witness = K.update(md, node[0], lim, *node[1:]) + (lim, res)
    n = (s["fct_adf_h"],) + node[1:]
    got = fold(K.update_fixup, pre, edges, n)
    again = fold(K.update_fixup, pre, edges, n)
    ref = fold(K.update_fixup_ref, pre, edges, n)
    tol = K.TOLERANCE[cfg.dtype]
    diff = 0.0
    for i, name in enumerate(("o1", "o2", "adf_h_lim", "adf_h_res")):
        errs.check("update_fixup", name, got[i], ref[i],
                   tol if i < 2 else 0.0, case)
        errs.check("update_fixup", name, again[i], got[i], 0.0,
                   f"{case} second launch")
        if witness[i] is None:
            continue
        d = abserr(got[i], witness[i])
        diff = max(diff, d)
        if not torch.equal(got[i], witness[i]):
            raise AssertionError(f"K4-fix {name} {case}: not bit-identical "
                                 f"to K3fix -> K4 (max abs diff {d:.3e})")
    for t in range(got[0].shape[0]):
        one = one_tracer(s, t)
        pt = {k: None if v is None else v[t] for k, v in pre.items()}
        et = tuple(None if x is None else x[t] for x in edges)
        for i, w in enumerate(fold(K.update_fixup, pt, et,
                                   (one["fct_adf_h"], one["ttf"],
                                    s["hnode"], s["hnode_new"],
                                    one["fct_LO"], one["del_ttf_advvert"],
                                    one["del_ttf_advhoriz"], cfg.dt, it))):
            if w is not None and not torch.equal(got[i][t], w):
                raise AssertionError(
                    f"K4-fix out{i} {case} tracer {t}: not bit-identical to "
                    f"a Tb = 1 launch (max abs diff "
                    f"{abserr(got[i][t], w):.3e})")
    return diff


def phase_fold_checks(errs: Errors, meshes: dict) -> dict:
    """Phase 6a: K4-fix against H-K3fix -> H-K4 and its plain version on
    every part of FOLD_MESHES (core2 and small at 4 parts, small and the
    multi-hop mesh at 8), vlimit 1/2/3 x iter_yn in float32 and float64,
    FOLD_TRACERS tracers (tracer t from random_fields(seed=t), hnode and
    hnode_new shared), with K1 -> K2 -> K3 -> exchange run by the kernels
    of a ShardedFctAleSolver's parts.  Returns the launch counts of these
    checks, where H-K3fix's are counted: no path runs it any more, it is
    the witness."""
    from fesom2_accelerate_tpu_torch import FctAleConfig, ShardedFctAleSolver
    from fesom2_accelerate_tpu_torch.mesh import (
        generate_planar_mesh,
        random_fields,
    )
    from fesom2_accelerate_tpu_torch.ops.cuda import kernels as K
    from fesom2_accelerate_tpu_torch.ops.cuda.step import (
        BATCH_SHARED,
        pre_exchange,
    )
    from fesom2_accelerate_tpu_torch.parallel.step_sharded import (
        fix_edge_ids,
    )

    # exchange radius >= 2 at 8 parts, as in phase 6c
    meshes = dict(meshes, multihop=generate_planar_mesh(nx=4, ny=7, nl=5))
    K.reset_launch_counts()
    for key, n_parts in FOLD_MESHES:
        mesh = meshes[key]
        per = [random_fields(mesh, seed=t, dtype=np.float64)
               for t in range(FOLD_TRACERS)]
        batched = {k: per[0][k] if k in BATCH_SHARED
                   else np.stack([f[k] for f in per]) for k in per[0]}
        diff, n = 0.0, 0
        for dtype in (torch.float32, torch.float64):
            sh = ShardedFctAleSolver(mesh, FctAleConfig(dtype=dtype),
                                     devices=["cuda:0"] * n_parts,
                                     tracers=FOLD_TRACERS)
            state = sh.init_state(batched)
            # columns that hold no node get hnode_new = 1, so that
            # iterative stage c is finite there and every output can be
            # checked (in a run they hold 0/0, which no gather reads)
            for p, h in enumerate(state["hnode_new"]):
                h[..., sh.pm.local_nodes_global[p] < 0] = 1.0
            parts = [{k: v[p] for k, v in state.items()}
                     for p in range(n_parts)]
            ids = [torch.tensor(fix_edge_ids(sh.pm, p), device="cuda")
                   for p in range(n_parts)]
            for vlimit in (1, 2, 3):
                for iter_yn in (False, True):
                    cfg = FctAleConfig(vlimit=vlimit, iter_yn=iter_yn,
                                       dt=0.5, dtype=dtype,
                                       flux_eps=1e-7 if dtype == torch.float32
                                       else 1e-16)
                    pres = [pre_exchange(md, cfg, st)
                            for md, st in zip(sh.mds, parts)]
                    edges = [K.b3h(md, pre["fct_plus"], pre["fct_minus"],
                                   st["fct_adf_h"], iter_yn)
                             for md, st, pre in zip(sh.mds, parts, pres)]
                    sh.halo_fill([K.factor_pair(pre["fct_plus"],
                                                pre["fct_minus"])
                                  for pre in pres])
                    for p in range(n_parts):
                        diff = max(diff, fold_vs_witness(
                            sh.mds[p], parts[p], pres[p], edges[p],
                            sh.owned, ids[p], cfg, errs,
                            f"{key}/{n_parts} part {p} {dtype} "
                            f"vlimit={vlimit} iter={iter_yn}"))
                        n += 1
        torch.cuda.synchronize()
        print(f"K4-fix vs K3fix -> K4: {key} at {n_parts} parts "
              f"(radius {sh.pm.neighbor_radius}), {n} part cases (vlimit "
              f"1/2/3 x iter_yn x f32/f64, Tb={FOLD_TRACERS} against "
              f"{FOLD_TRACERS} launches at Tb=1, a second launch, the plain "
              f"version at 1e-6 / 1e-12, edge outputs bit-exact) ok; max "
              f"|K4-fix - (K3fix -> K4)| {diff:.3e}", flush=True)
    return K.launch_counts()


def sharded_vs_single(mesh, fields, cfg, n_parts: int, steps: int,
                      label: str, tol: float, **kw) -> tuple:
    """``steps`` steps of ShardedFctAleSolver(devices=["cuda:0"] * n_parts)
    (the default backend, "cuda"), split and fused, each against the same
    steps of FctAleSolver(device="cuda"): every gathered field within
    ``tol``.
    Returns the launch counts of each mode's run, the solvers and their
    initial states."""
    from fesom2_accelerate_tpu_torch import FctAleSolver, ShardedFctAleSolver
    from fesom2_accelerate_tpu_torch.ops.cuda import kernels as K

    single = FctAleSolver(mesh, cfg, device="cuda")
    s0 = single.init_state(fields)
    ref = {k: v.cpu().numpy() for k, v in single.run(s0, steps).items()}
    counts, solvers = {}, {"single": (single, s0)}
    for mode in ("split", "fused"):
        # no backend: on CUDA devices the default runs the kernels
        sh = ShardedFctAleSolver(mesh, cfg, devices=["cuda:0"] * n_parts,
                                 fused=(mode == "fused"), **kw)
        if sh.backend != "cuda":
            raise AssertionError(f"{label}: default backend {sh.backend!r}")
        state = sh.init_state(fields)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        out = sh.run(state, steps)
        torch.cuda.synchronize()
        counts[mode] = K.launch_counts()
        got = sh.gather_state(out)
        if set(got) != set(ref):
            raise AssertionError(f"{label} {mode}: keys {set(got) ^ set(ref)}")
        for k, v in ref.items():
            if got[k].shape != v.shape or not np.isfinite(got[k]).all():
                raise AssertionError(f"{label} {mode} {k}: bad shape or "
                                     f"non-finite")
            e = float(np.abs(got[k].astype(np.float64) - v).max()
                      / max(float(np.abs(v).max()), 1.0))
            if e > tol:
                raise AssertionError(f"{label} {mode} {k}: relerr {e:.3e} "
                                     f"> {tol:.0e}")
        solvers[mode] = (sh, state)
    print(f"{label}: {mesh.n_nodes} nodes, {n_parts} parts (exchange "
          f"{sh.exchange_mode}, radius {sh.pm.neighbor_radius}), "
          f"{cfg.dtype} iter={cfg.iter_yn}, {steps} steps, split and fused "
          f"within relerr {tol:.0e} of the single-device cuda run; launches "
          f"{counts}", flush=True)
    return counts, solvers


def phase_sharded_small() -> None:
    from fesom2_accelerate_tpu_torch import FctAleConfig
    from fesom2_accelerate_tpu_torch.mesh import (
        generate_planar_mesh,
        random_fields,
    )

    tol = 1e-12
    multihop = generate_planar_mesh(nx=4, ny=7, nl=5)
    small = generate_planar_mesh(preset="small")
    for mesh, iters, label in ((multihop, (False, True), "multi-hop"),
                               (small, (True,), "small")):
        fields = random_fields(mesh, seed=2, dtype=np.float64)
        for iter_yn in iters:
            cfg = FctAleConfig(dt=0.7, iter_yn=iter_yn, dtype=torch.float64)
            for exchange in ("ppermute", "allgather"):
                _, solvers = sharded_vs_single(
                    mesh, fields, cfg, 8, 3,
                    f"sharded f64 {label} ({exchange})", tol,
                    exchange=exchange)
                if label == "multi-hop" and \
                        solvers["split"][0].pm.neighbor_radius < 2:
                    raise AssertionError("multi-hop mesh has radius < 2")


def phase_sharded_path(card: str, meshes: dict) -> tuple:
    from fesom2_accelerate_tpu_torch import FctAleConfig
    from fesom2_accelerate_tpu_torch.mesh import random_fields
    from fesom2_accelerate_tpu_torch.ops.cuda import kernels as K
    from fesom2_accelerate_tpu_torch.parallel.step_sharded import (
        fix_edge_ids,
    )

    mesh = meshes["core2"]
    fields = random_fields(mesh, seed=0, dtype=np.float64)
    cfg = FctAleConfig(dt=0.5, flux_eps=1e-7, vlimit=1, iter_yn=False,
                       dtype=torch.float32)
    steps = MAIN_STEPS
    counts, solvers = sharded_vs_single(
        mesh, fields, cfg, SHARD_PARTS, steps, "sharded path (core2)",
        MAIN_RELERR)
    per = {k: SHARD_PARTS * steps for k in ("bounds", "limit")}
    check_counts(counts["split"], dict(per, b3h=SHARD_PARTS * steps,
                                       update_fixup=SHARD_PARTS * steps),
                 "sharded split")
    print(f"sharded split: {sum(counts['split'].values()) // steps} "
          f"launches a step (K1, K2, K3, K4-fix on each of {SHARD_PARTS} "
          f"parts; no K3fix, no plain K4); fused: "
          f"{sum(counts['fused'].values()) // steps}", flush=True)
    check_counts(counts["fused"], dict(per, update_fused=SHARD_PARTS * steps),
                 "sharded fused")

    # time per step of each mode, warm-up then best of 3, in turns: CUDA
    # events around a 20-step run (graph replays, as phase 4), device time
    # of one step
    # with the stream held while the host enqueues (device_time_ms), and
    # host wall time of the run; the card idles for the difference
    runs = {mode: (lambda sv=sv: sv[0].run(sv[1], steps))
            for mode, sv in solvers.items()}
    best = best_times(runs, 1, timer=cuda_time_ms)
    dev = best_times({mode: (lambda sv=sv: sv[0].step(sv[1]))
                      for mode, sv in solvers.items()}, 5)
    # host wall of the run (to its final synchronize), and the host's own
    # time to enqueue 5 steps (no synchronize inside: 5 steps stay well
    # inside the launch queue, so the host never waits for the card)
    wall = {mode: float("inf") for mode in runs}
    enq = {mode: float("inf") for mode in runs}
    for _ in range(TIMING_RUNS):
        for mode, fn in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall[mode] = min(wall[mode], (time.perf_counter() - t0) * 1e3)
            sv = solvers[mode]
            t0 = time.perf_counter()
            for _ in range(5):
                sv[0].step(sv[1])
            enq[mode] = min(enq[mode], (time.perf_counter() - t0) * 1e3 / 5)
            torch.cuda.synchronize()
    gp = int(np.sum(mesh.nlev_nod - 1))
    for mode, ms in best.items():
        ms /= steps
        host_ms = wall[mode] / steps
        print(f"step time {mode}: {ms:.4f} ms/step, "
              f"{gp / (ms * 1e-3):.4e} grid-points/s; device "
              f"{dev[mode]:.4f} ms/step, host wall {host_ms:.4f} ms/step "
              f"(card idle {max(0.0, 1.0 - dev[mode] / host_ms):.1%}), "
              f"host enqueue {enq[mode]:.4f} ms/step "
              f"(core2 f32, {SHARD_PARTS} parts on one card; card {card})")

    sh, state = solvers["split"]
    both = [torch.rand(2, mesh.n_layers, sh.pm.n_local, device="cuda")
            for _ in range(SHARD_PARTS)]
    t = best_times({"exchange": lambda: sh.halo_fill(both)}, 20)
    print(f"exchange alone ({sh.exchange_mode}, a step's one exchange of "
          f"both limiter factors, [2, L, 2H+B], "
          f"{SHARD_PARTS} parts, H={sh.pm.H}, B={sh.pm.B}): "
          f"{t['exchange']:.4f} ms (card {card})")

    # each kernel of the split step, the witness H-K3fix and H-K4, and H-K34,
    # beside its plain version and its bound: at the shapes of part 1 (an
    # interior part) and of the whole mesh (K4-fix on part 1 only: on a
    # whole mesh it is K4); by label
    times = {"part 1": {}, "whole": {}}
    whole = solvers["single"]
    ids1 = torch.tensor(fix_edge_ids(sh.pm, 1), device="cuda")
    for label, md, s, ids in (
            ("part 1", sh.mds[1], {k: v[1] for k, v in state.items()},
             ids1),
            ("whole", whole[0].md, whole[1],
             torch.arange(0, mesh.n_edges, 3, dtype=torch.int32,
                          device="cuda"))):
        tmax, tmin = K.bounds(md, s["fct_LO"], s["ttf"], 1)
        plus, minus, avl, _ = K.limit(md, s["fct_adf_v"], tmax, tmin,
                                      s["fct_adf_h"], cfg.dt, cfg.flux_eps,
                                      False)
        ah = s["fct_adf_h"]
        lim, _ = K.b3h(md, plus, minus, ah, False)
        node = (s["ttf"], s["hnode"], s["hnode_new"], s["fct_LO"],
                s["del_ttf_advvert"], s["del_ttf_advhoriz"], cfg.dt, False)
        calls = {
            "bounds": (lambda: K.bounds(md, s["fct_LO"], s["ttf"], 1),
                       lambda: K.bounds_ref(md, s["fct_LO"], s["ttf"], 1)),
            "limit": (
                lambda: K.limit(md, s["fct_adf_v"], tmax, tmin, ah, cfg.dt,
                                cfg.flux_eps, False),
                lambda: K.limit_ref(md, s["fct_adf_v"], tmax, tmin, ah,
                                    cfg.dt, cfg.flux_eps, False)),
            "b3h": (lambda: K.b3h(md, plus, minus, ah, False),
                    lambda: K.b3h_ref(md, plus, minus, ah, False)),
            "b3h_fixup": (
                lambda: K.b3h_fixup(md, plus, minus, ah, lim, None, ids,
                                    False),
                lambda: K.b3h_fixup_ref(md, plus, minus, ah, lim, None, ids,
                                        False)),
            "update": (lambda: K.update(md, avl, lim, *node),
                       lambda: K.update_ref(md, avl, lim, *node)),
            "update_fused": (
                lambda: K.update_fused(md, plus, minus, avl, ah, *node),
                lambda: K.update_fused_ref(md, plus, minus, avl, ah,
                                           *node)),
        }
        if label == "part 1":
            # in place into lim: it rewrites the same values each call
            calls["update_fixup"] = (
                lambda: K.update_fixup(md, plus, minus, ah, lim, None,
                                       sh.owned, avl, *node),
                lambda: K.update_fixup_ref(md, plus, minus, ah, lim, None,
                                           sh.owned, avl, *node))
        for name, (kern, plain) in calls.items():
            tk = best_times({"kernel": kern, "plain": plain}, 5)
            times[label][name] = tk
            nbytes, ops = profiling.kernel_io(md, name, ids=ids,
                                              owned=sh.owned)
            bound, _ = profiling.bound_ms(nbytes, ops, md.dtype)
            print(f"kernel {name} on core2 {label} ({md.n_nodes} nodes, "
                  f"{md.n_edges} edges, {len(ids)} fix ids): "
                  f"{tk['kernel']:.4f} ms, plain {tk['plain']:.4f} ms, "
                  f"{nbytes / 1e6:.1f} MB, bound {bound:.4f} ms "
                  f"(f32; card {card})", flush=True)
        if label != "part 1":
            continue
        # the fold beside the two launches it replaces, timed in turns
        t = best_times({"K4-fix": calls["update_fixup"][0],
                        "K3fix + K4": lambda: (calls["b3h_fixup"][0](),
                                               calls["update"][0]())}, 5)
        nbytes, ops = profiling.kernel_io(md, "update_fixup",
                                          owned=sh.owned)
        bound, _ = profiling.bound_ms(nbytes, ops, md.dtype)
        alone = (times[label]["b3h_fixup"]["kernel"],
                 times[label]["update"]["kernel"])
        print(f"K4-fix on core2 part 1: {t['K4-fix']:.4f} ms against "
              f"K3fix + K4 {t['K3fix + K4']:.4f} ms back to back "
              f"({alone[0]:.4f} + {alone[1]:.4f} alone); bound "
              f"{bound:.4f} ms ({nbytes / 1e6:.1f} MB; f32; card {card})",
              flush=True)
    md = sh.mds[1]
    shapes = {"b3h_fixup": (md, dict(ids=ids1)),
              "update_fixup": (md, dict(owned=sh.owned)),
              **{name: (whole[0].md, {})
                 for name in ("bounds", "limit", "update_fused")}}
    return counts["split"], times, shapes


# the four single-device forms (fuse_k12, fuse_k34), the default
# (DEFAULT_FORM) first, and each one's launches per step
DEFAULT_FORM = (True, False)
FORMS = {
    (True, False): {"limit_fused": 1, "b3h": 1, "update": 1},
    (False, True): {"bounds": 1, "limit": 1, "update_fused": 1},
    (True, True): {"limit_fused": 1, "update_fused": 1},
    (False, False): {"bounds": 1, "limit": 1, "b3h": 1, "update": 1},
}
TUNE_THREADS = (128, 256)


def form_name(fuse_k12: bool, fuse_k34: bool) -> str:
    return ("K12" if fuse_k12 else "K1->K2") + ("->K34" if fuse_k34
                                                 else "->K3->K4")


def check_limit_fused(md, state, cfg, errs: Errors, case: str) -> float:
    """H-K12 against its plain version (bounds_ref then limit_ref): the
    bounds bit-exact, the other outputs within TOLERANCE; and against
    H-K1 -> H-K2 on the same inputs, every output bit-identical.  Returns
    the largest absolute difference from H-K1 -> H-K2 (0.0)."""
    from fesom2_accelerate_tpu_torch.ops.cuda import kernels as K

    s = state
    args = (md, s["fct_LO"], s["ttf"], s["fct_adf_v"], s["fct_adf_h"],
            cfg.vlimit, cfg.dt, cfg.flux_eps, cfg.iter_yn)
    ref = K.limit_fused_ref(*args)
    got = K.limit_fused(*args)
    for i, name in enumerate(K12_OUTPUTS):
        errs.check("limit_fused", name, got[i], ref[i],
                   0.0 if i < 2 else K.TOLERANCE[cfg.dtype], case)
    chain = K.bounds(md, s["fct_LO"], s["ttf"], cfg.vlimit)
    chain += K.limit(md, s["fct_adf_v"], *chain, s["fct_adf_h"], cfg.dt,
                     cfg.flux_eps, cfg.iter_yn)
    diff = 0.0
    for name, g, c in zip(K12_OUTPUTS, got, chain):
        if c is None:
            continue
        d = abserr(g, c)
        diff = max(diff, d)
        if not torch.equal(g, c):
            raise AssertionError(f"K12 {name} {case}: not bit-identical to "
                                 f"K1 -> K2 (max abs diff {d:.3e})")
    return diff


K12_OUTPUTS = ("fct_ttf_max", "fct_ttf_min", "fct_plus", "fct_minus",
               "adf_v_lim", "adf_v_res")
# H-K12's cases: (dtype, vlimit, iter_yn), every vlimit both ways in f32
# and f64
K12_CASES = [(dtype, v, it) for dtype in (torch.float32, torch.float64)
             for v in (1, 2, 3) for it in (False, True)]


def chunk_meshes(*chunks: int) -> dict:
    """Planar meshes of small's 24 x 16 nodes whose layer counts straddle
    each level chunk LC of ``chunks``: L = 2, LC - 1, LC, LC + 1 and
    2 LC + 1 (the generator's synthetic bathymetry; L = 2, below what the
    generator takes, from small's elements with every element 3 levels
    deep)."""
    from fesom2_accelerate_tpu_torch.mesh import (
        build_mesh_from_elements,
        generate_planar_mesh,
    )

    small = generate_planar_mesh(preset="small")
    out = {}
    layers = {n for lc in chunks for n in (2, lc - 1, lc, lc + 1, 2 * lc + 1)}
    for n_layers in sorted(layers):
        nl = n_layers + 1
        out[f"L={n_layers}"] = (
            generate_planar_mesh(nx=24, ny=16, nl=nl) if nl >= 4 else
            build_mesh_from_elements(small.elem_nodes,
                                     np.full(small.n_elems, nl), nl,
                                     small.node_xy))
    return out


def phase_chunk_checks(errs: Errors) -> None:
    """H-K2 and H-K4 on planar meshes whose layer counts straddle their
    level chunks (LIMIT_LEVELS, UPDATE_SPLIT_LEVELS): vlimit 1/2/3 x
    iter_yn in f32 and f64, each against its plain version (K4 fed the
    plain K2 and K3 outputs) at phase 3's tolerances, and a second launch
    bit-identical."""
    from fesom2_accelerate_tpu_torch import FctAleConfig
    from fesom2_accelerate_tpu_torch.mesh import random_fields
    from fesom2_accelerate_tpu_torch.ops.cuda import kernels as K
    from fesom2_accelerate_tpu_torch.ops.meshdata import (
        LIMIT_LEVELS,
        UPDATE_SPLIT_LEVELS,
        build_mesh_data,
    )

    for key, mesh in chunk_meshes(LIMIT_LEVELS, UPDATE_SPLIT_LEVELS).items():
        fields = random_fields(mesh, seed=3, dtype=np.float64)
        md = {dt: build_mesh_data(mesh, dt, "cuda")
              for dt in (torch.float32, torch.float64)}
        for dtype, vlimit, iter_yn in K12_CASES:
            cfg = FctAleConfig(vlimit=vlimit, iter_yn=iter_yn, dt=0.5,
                               flux_eps=1e-7 if dtype == torch.float32
                               else 1e-16, dtype=dtype)
            s = {k: torch.tensor(v, dtype=dtype, device="cuda")
                 for k, v in fields.items()}
            m = md[dtype]
            tol = K.TOLERANCE[dtype]
            case = f"{key} {dtype} vlimit={vlimit} iter={iter_yn}"
            tmax, tmin = K.bounds_ref(m, s["fct_LO"], s["ttf"], vlimit)
            args = (m, s["fct_adf_v"], tmax, tmin, s["fct_adf_h"], cfg.dt,
                    cfg.flux_eps, iter_yn)
            ref_l = K.limit_ref(*args)
            got, again = K.limit(*args), K.limit(*args)
            for i, name in enumerate(LIMIT_OUTPUTS):
                errs.check("limit", name, got[i], ref_l[i], tol, case)
                errs.check("limit", name, again[i], got[i], 0.0,
                           f"{case} second launch")
            lim, _ = K.b3h_ref(m, ref_l[0], ref_l[1], s["fct_adf_h"],
                               iter_yn)
            args = (m, ref_l[2], lim, s["ttf"], s["hnode"], s["hnode_new"],
                    s["fct_LO"], s["del_ttf_advvert"], s["del_ttf_advhoriz"],
                    cfg.dt, iter_yn)
            ref_u = K.update_ref(*args)
            got, again = K.update(*args), K.update(*args)
            for i, name in enumerate(("o1", "o2")):
                errs.check("update", name, got[i], ref_u[i], tol, case)
                errs.check("update", name, again[i], got[i], 0.0,
                           f"{case} second launch")
        torch.cuda.synchronize()
        print(f"limit, update vs plain: {key} ({mesh.n_nodes} nodes, "
              f"{mesh.n_layers} layers, {-(-mesh.n_layers // LIMIT_LEVELS)} "
              f"level chunk(s) of {LIMIT_LEVELS} for H-K2, "
              f"{-(-mesh.n_layers // UPDATE_SPLIT_LEVELS)} of "
              f"{UPDATE_SPLIT_LEVELS} for H-K4): {len(K12_CASES)} cases ok "
              f"(relerr <= 1e-6 f32, 1e-12 f64; a second launch "
              f"bit-identical)", flush=True)


def phase_new_kernel_checks(errs: Errors, meshes: dict) -> None:
    """H-K12 on meshes whose layer counts straddle its level chunk, and on
    small, core2, the cylinder and polar_cap: vlimit 1/2/3 x iter_yn in
    f32 and f64 and a b3v-mask case, each against its plain version and
    bit for bit against H-K1 -> H-K2; H-A2 on core2 and the cylinder."""
    from fesom2_accelerate_tpu_torch import FctAleConfig
    from fesom2_accelerate_tpu_torch.mesh import random_fields
    from fesom2_accelerate_tpu_torch.ops.cuda import kernels as K
    from fesom2_accelerate_tpu_torch.ops.meshdata import (
        LIMIT_FUSED_LEVELS,
        build_mesh_data,
    )

    k12_meshes = chunk_meshes(LIMIT_FUSED_LEVELS)
    k12_meshes.update((k, meshes[k])
                      for k in ("small", "core2", "cylinder", "polar_cap"))
    for key, mesh in k12_meshes.items():
        fields = random_fields(mesh, seed=3, dtype=np.float64)
        md = {dt: build_mesh_data(mesh, dt, "cuda")
              for dt in (torch.float32, torch.float64)}
        diff = 0.0
        for dtype, vlimit, iter_yn in K12_CASES:
            cfg = FctAleConfig(vlimit=vlimit, iter_yn=iter_yn, dt=0.5,
                               flux_eps=1e-7 if dtype == torch.float32
                               else 1e-16, dtype=dtype)
            state = {k: torch.tensor(v, dtype=dtype, device="cuda")
                     for k, v in fields.items()}
            diff = max(diff, check_limit_fused(
                md[dtype], state, cfg, errs,
                f"{key} {dtype} vlimit={vlimit} iter={iter_yn}"))
        # b3v mask: a nonzero flux at each node's bottom interface passes
        # through unlimited, as in H-K2 and the oracle
        cfg = FctAleConfig(dt=0.5, flux_eps=1e-7, iter_yn=True)
        m32 = md[torch.float32]
        state = {k: torch.tensor(v, dtype=torch.float32, device="cuda")
                 for k, v in fields.items()}
        rows = (m32.nlev_nod - 1).long()
        cols = torch.arange(m32.n_nodes, device="cuda")
        state["fct_adf_v"][rows, cols] = torch.linspace(
            -1.0, 1.0, m32.n_nodes, device="cuda") + 0.5
        diff = max(diff, check_limit_fused(m32, state, cfg, errs,
                                           f"{key} b3v-mask"))
        got = K.limit_fused(m32, state["fct_LO"], state["ttf"],
                            state["fct_adf_v"], state["fct_adf_h"], 1,
                            cfg.dt, cfg.flux_eps, True)
        if not torch.equal(got[4][rows, cols], state["fct_adf_v"][rows, cols]):
            raise AssertionError("limit_fused b3v-mask: bottom interface "
                                 "flux changed")
        torch.cuda.synchronize()
        chunks = -(-mesh.n_layers // LIMIT_FUSED_LEVELS)
        print(f"limit_fused vs plain: {key} ({mesh.n_nodes} nodes, "
              f"{mesh.n_layers} layers, {chunks} level chunk(s) of "
              f"{LIMIT_FUSED_LEVELS}): {len(K12_CASES) + 1} cases ok (bounds "
              f"bit-exact, the rest relerr <= 1e-6 f32, 1e-12 f64); max "
              f"|K12 - (K1 -> K2)| on the card: {diff:.3e}", flush=True)

    for key in ("core2", "cylinder"):
        mesh = meshes[key]
        fields = random_fields(mesh, seed=3, dtype=np.float64)
        for dtype in (torch.float32, torch.float64):
            md = build_mesh_data(mesh, dtype, "cuda")
            s = {k: torch.tensor(fields[k], dtype=dtype, device="cuda")
                 for k in ("fct_LO", "ttf")}
            tmax, tmin = K.bounds_ref(md, s["fct_LO"], s["ttf"], 1)
            ref = K.a2_ref(md, tmax, tmin, 1e3)
            got = K.a2(md, tmax, tmin, 1e3)
            for i, name in enumerate(("UV_max", "UV_min")):
                errs.check("a2", name, got[i], ref[i], 0.0, f"{key} {dtype}")
        torch.cuda.synchronize()
        print(f"a2 vs plain: {key} ({mesh.n_elems} elements): f32 and f64 "
              f"bit-exact", flush=True)


def phase_forms(card: str, meshes: dict) -> tuple:
    """20 core2 f32 steps of FctAleSolver(backend="cuda") in each of the
    four forms against the default form (MAIN_RELERR, launches per step),
    the step time of each form, H-K12 beside H-K1 + H-K2 and its plain
    version, and H-A2 beside its plain version.  Returns each form's launch
    counts (by form_name), H-A2's times and the mesh data they were taken
    on."""
    from fesom2_accelerate_tpu_torch import FctAleConfig, FctAleSolver
    from fesom2_accelerate_tpu_torch.mesh import random_fields
    from fesom2_accelerate_tpu_torch.ops.cuda import kernels as K

    mesh = meshes["core2"]
    fields = random_fields(mesh, seed=0, dtype=np.float64)
    cfg = FctAleConfig(dt=0.5, flux_eps=1e-7, vlimit=1, iter_yn=False,
                       dtype=torch.float32)
    runs, counts, ref = {}, {}, None
    for (f12, f34), per_step in FORMS.items():
        name = form_name(f12, f34)
        sv = FctAleSolver(mesh, cfg, backend="cuda", device="cuda",
                          fuse_k12=f12, fuse_k34=f34)
        state = sv.init_state(fields)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        out = sv.run(state, MAIN_STEPS)
        torch.cuda.synchronize()
        counts[name] = K.launch_counts()
        check_counts(counts[name], {k: n * MAIN_STEPS
                                    for k, n in per_step.items()}, name)
        ref = out if ref is None else ref
        err = 0.0
        for k, v in ref.items():
            if out[k].shape != v.shape or not bool(
                    torch.isfinite(out[k]).all()):
                raise AssertionError(f"{name} {k}: bad shape or non-finite")
            err = max(err, relerr(out[k], v))
        if err > MAIN_RELERR:
            raise AssertionError(f"{name}: relerr {err:.3e} against the "
                                 f"default form > {MAIN_RELERR:.0e}")
        runs[name] = lambda sv=sv, state=state: sv.run(state, MAIN_STEPS)
        print(f"form {name}: {MAIN_STEPS} core2 f32 steps, launches "
              f"{ {k: v for k, v in counts[name].items() if v} }, "
              f"{sum(per_step.values())} per step, relerr {err:.3e} "
              f"against {form_name(*DEFAULT_FORM)}", flush=True)
    best = best_times(runs, 1, timer=cuda_time_ms)
    for name, ms in best.items():
        print(f"step time {name}: {ms / MAIN_STEPS:.4f} ms/step (core2 f32, "
              f"events around {MAIN_STEPS} steps, best of {TIMING_RUNS}; "
              f"card {card})")

    sv = FctAleSolver(mesh, cfg, backend="cuda", device="cuda")
    md, s = sv.md, sv.init_state(fields)
    args = (md, s["fct_LO"], s["ttf"], s["fct_adf_v"], s["fct_adf_h"], 1,
            cfg.dt, cfg.flux_eps, False)

    def chain():
        tmax, tmin = K.bounds(md, s["fct_LO"], s["ttf"], 1)
        return K.limit(md, s["fct_adf_v"], tmax, tmin, s["fct_adf_h"],
                       cfg.dt, cfg.flux_eps, False)

    t12 = best_times({"kernel": lambda: K.limit_fused(*args),
                      "K1+K2": chain,
                      "plain": lambda: K.limit_fused_ref(*args)}, 5)
    print(f"kernel limit_fused: {t12['kernel']:.4f} ms against K1 + K2 "
          f"{t12['K1+K2']:.4f} ms, plain {t12['plain']:.4f} ms (core2 f32; "
          f"card {card})")
    tmax, tmin = K.bounds(md, s["fct_LO"], s["ttf"], 1)
    ta2 = best_times({"kernel": lambda: K.a2(md, tmax, tmin, 1e3),
                      "plain": lambda: K.a2_ref(md, tmax, tmin, 1e3)}, 5)
    print(f"kernel a2: {ta2['kernel']:.4f} ms, plain {ta2['plain']:.4f} ms "
          f"(core2 f32, back to back: the 47.9 MB of bounds nearly fit the "
          f"50 MB L2; card {card})", flush=True)
    for stage, r in time_stages(mesh, fields, "cuda").items():
        print(f"plain stage {stage}: {r['ms']:.4f} ms, {r['GBps']} GB/s "
              f"modeled (core2 f32, time_stages; card {card})")
    return counts, {"a2": ta2}, md


def phase_tuner(meshes: dict) -> dict:
    """A short run of the tuning harness on core2: tune_a2 and tune_step at
    TUNE_THREADS, every configuration validated before it is timed.
    Returns the a2 run's launch counts (the path H-A2 runs on)."""
    from fesom2_accelerate_tpu_torch.ops.cuda import kernels as K
    from fesom2_accelerate_tpu_torch.utils import tuning

    mesh = meshes["core2"]
    K.reset_launch_counts()
    a2 = tuning.tune_a2(mesh, TUNE_THREADS, preset_name="core2")
    torch.cuda.synchronize()
    counts = K.launch_counts()
    step = tuning.tune_step(mesh, TUNE_THREADS, preset_name="core2")
    for family, results in (("a2", a2), ("step", step)):
        for r in results:
            print(f"tune {family} {r.params}: {r.ms:.4f} ms, {r.gbps} GB/s "
                  f"modeled, relerr {r.max_relerr:.3e}, ok {r.ok} "
                  f"({r.card})")
        bad = [r.params for r in results if not r.ok]
        if bad:
            raise AssertionError(f"tune {family}: failed validation {bad}")
        b = tuning.best(results)
        print(f"tune {family} best: {b.params} {b.ms:.4f} ms", flush=True)
    return counts


# the kernels with a tracer axis (K4-fix: H-K4's FIX form); phase 8's runs
# (4 tracers) and its sweep
TRACER_KERNELS = ("bounds", "limit", "limit_fused", "update_fused", "b3h",
                  "b3h_fixup", "update", "update_fixup")
TRACERS = 4
TB_SWEEP = (1, 2, 4, 8)
# the tracer counts at which phase 8e times the graph runs against the
# host's loop, with capture time and the graphs' memory
GRAPH_TB = (1, 8)
# steps of each timed run of the sweep (phase 8e)
TRACER_STEPS = 10
# phase 8e's longest single-device runs: bench.py's default --steps
LONG_STEPS = 300
# phase 8a's cases: (dtype, vlimit, iter_yn) at 3 tracers
TRACER_CASES = ((torch.float32, 1, False), (torch.float32, 1, True),
                (torch.float32, 3, False), (torch.float64, 1, True))


class TracerFields:
    """Phase 8's inputs, numpy float64, as bench.py makes them: tracer t of
    a mesh from random_fields(seed=t), hnode and hnode_new from tracer 0
    and shared.  ``counts[key]`` tracers of each mesh are made and stacked
    once (random_fields takes 0.7 s a tracer on core2)."""

    def __init__(self, meshes: dict, counts: dict):
        from fesom2_accelerate_tpu_torch.mesh import random_fields
        from fesom2_accelerate_tpu_torch.ops.cuda.step import BATCH_SHARED

        self.meshes = meshes
        self._per, self._stacked = {}, {}
        for key, tb in counts.items():
            per = [random_fields(meshes[key], seed=t, dtype=np.float64)
                   for t in range(tb)]
            for f in per[1:]:
                f.update({k: per[0][k] for k in BATCH_SHARED})
            self._per[key] = per
            self._stacked[key] = {
                k: v if k in BATCH_SHARED else np.stack([f[k] for f in per])
                for k, v in per[0].items()}

    def __call__(self, key: str, tb: int) -> tuple:
        """(per-tracer fields, batched fields) of the first ``tb`` tracers
        of mesh ``key``."""
        from fesom2_accelerate_tpu_torch.ops.cuda.step import BATCH_SHARED

        return self._per[key][:tb], {
            k: v if k in BATCH_SHARED else v[:tb]
            for k, v in self._stacked[key].items()}


def tracer_calls(md, cfg, ids, owned, plain: bool,
                 copy: bool = True) -> dict:
    """Each kernel with a tracer axis (or its plain version) as a function
    of a state that holds its inputs, batched or one tracer's.  K3fix
    (on the edges ``ids``) and K4-fix (owned columns ``owned``) write into
    a copy of K3's outputs, or in place when not ``copy`` (to time them
    alone: they rewrite the same values)."""
    from fesom2_accelerate_tpu_torch.ops.cuda import kernels as K

    def fn(name):
        return getattr(K, name + "_ref" if plain else name)

    it = cfg.iter_yn

    def node(x):
        return (x["ttf"], x["hnode"], x["hnode_new"], x["fct_LO"],
                x["del_ttf_advvert"], x["del_ttf_advhoriz"], cfg.dt, it)

    def k3(x):
        return (x["lim"].clone() if copy else x["lim"],
                (x["res"].clone() if copy else x["res"]) if it else None)

    return {
        "bounds": lambda x: fn("bounds")(md, x["fct_LO"], x["ttf"],
                                         cfg.vlimit),
        "limit": lambda x: fn("limit")(md, x["fct_adf_v"], x["tmax"],
                                       x["tmin"], x["fct_adf_h"], cfg.dt,
                                       cfg.flux_eps, it),
        "limit_fused": lambda x: fn("limit_fused")(
            md, x["fct_LO"], x["ttf"], x["fct_adf_v"], x["fct_adf_h"],
            cfg.vlimit, cfg.dt, cfg.flux_eps, it),
        "update_fused": lambda x: fn("update_fused")(
            md, x["plus"], x["minus"], x["avl"], x["fct_adf_h"], *node(x)),
        "b3h": lambda x: fn("b3h")(md, x["plus"], x["minus"], x["fct_adf_h"],
                                   it),
        "b3h_fixup": lambda x: fn("b3h_fixup")(
            md, x["px"], x["mx"], x["fct_adf_h"], *k3(x), ids, it),
        "update": lambda x: fn("update")(md, x["avl"], x["lim"], *node(x)),
        "update_fixup": lambda x: fn("update_fixup")(
            md, x["px"], x["mx"], x["fct_adf_h"], *k3(x), owned, x["avl"],
            *node(x)),
    }


def tracer_inputs(md, state: dict, cfg) -> dict:
    """A batched state with every kernel's inputs added, from the plain
    versions: bounds, factors (and 3/4 of them, as after an exchange), the
    limited vertical flux, K3's outputs."""
    from fesom2_accelerate_tpu_torch.ops.cuda import kernels as K

    s = dict(state)
    s["tmax"], s["tmin"] = K.bounds_ref(md, s["fct_LO"], s["ttf"],
                                        cfg.vlimit)
    s["plus"], s["minus"], s["avl"], _ = K.limit_ref(
        md, s["fct_adf_v"], s["tmax"], s["tmin"], s["fct_adf_h"], cfg.dt,
        cfg.flux_eps, cfg.iter_yn)
    s["px"], s["mx"] = 0.75 * s["plus"], 0.75 * s["minus"]
    s["lim"], s["res"] = K.b3h_ref(md, s["plus"], s["minus"], s["fct_adf_h"],
                                   cfg.iter_yn)
    return s


def one_tracer(state: dict, t: int) -> dict:
    """Tracer t's part of a batched state (shared fields and None as they
    are)."""
    from fesom2_accelerate_tpu_torch.ops.cuda.step import BATCH_SHARED

    return {k: v if k in BATCH_SHARED or v is None else v[t]
            for k, v in state.items()}


def phase_tracer_kernels(errs: Errors, tf: TracerFields) -> None:
    """Phase 8a: each kernel with a tracer axis at 3 tracers against 3
    launches at Tb = 1 (bit-identical) and against its batched plain
    version (phase 3's tolerances; edge outputs bit-exact), on small and
    core2."""
    from fesom2_accelerate_tpu_torch import FctAleConfig
    from fesom2_accelerate_tpu_torch.ops.cuda import kernels as K
    from fesom2_accelerate_tpu_torch.ops.meshdata import build_mesh_data

    tb = 3
    for key in ("small", "core2"):
        mesh = tf.meshes[key]
        _, batched = tf(key, tb)
        ids = torch.arange(0, mesh.n_edges, 3, dtype=torch.int32,
                           device="cuda")
        diff = {name: 0.0 for name in TRACER_KERNELS}
        mds = {dt: build_mesh_data(mesh, dt, "cuda")
               for dt in {case[0] for case in TRACER_CASES}}
        for dtype, vlimit, iter_yn in TRACER_CASES:
            cfg = FctAleConfig(vlimit=vlimit, iter_yn=iter_yn, dt=0.5,
                               flux_eps=1e-7 if dtype == torch.float32
                               else 1e-16, dtype=dtype)
            md = mds[dtype]
            s = tracer_inputs(md, {k: torch.tensor(v, dtype=dtype,
                                                   device="cuda")
                                   for k, v in batched.items()}, cfg)
            # a whole mesh: every node has a row, so K4-fix takes all
            # columns as owned and is K4
            own = (0, mesh.n_nodes)
            kern = tracer_calls(md, cfg, ids, own, plain=False)
            plain = tracer_calls(md, cfg, ids, own, plain=True)
            tol = K.TOLERANCE[dtype]
            case = f"{key} Tb={tb} {dtype} vlimit={vlimit} iter={iter_yn}"
            for name in TRACER_KERNELS:
                got = kern[name](s)
                ref = plain[name](s)
                for i, (g, r) in enumerate(zip(got, ref)):
                    exact = name in ("bounds", "b3h", "b3h_fixup") or (
                        name in ("update_fused", "update_fixup")
                        and i >= 2) or (name == "limit_fused" and i < 2)
                    errs.check(name, f"out{i}", g, r, 0.0 if exact else tol,
                               case)
                for t in range(tb):
                    for i, w in enumerate(kern[name](one_tracer(s, t))):
                        if w is None:
                            continue
                        d = abserr(got[i][t], w)
                        diff[name] = max(diff[name], d)
                        if not torch.equal(got[i][t], w):
                            raise AssertionError(
                                f"{name} out{i} {case} tracer {t}: not "
                                f"bit-identical to a Tb = 1 launch "
                                f"(max abs diff {d:.3e})")
        torch.cuda.synchronize()
        print(f"tracer kernels: {key} ({mesh.n_nodes} nodes), Tb={tb}, "
              f"{len(TRACER_CASES)} cases, each kernel against its batched "
              f"plain version ok; max |Tb=3 - 3 launches at Tb=1|: "
              + ", ".join(f"{n} {d:.3e}" for n, d in diff.items()),
              flush=True)


# the single-device forms of a batched step that phase 8 runs (fuse_k12,
# fuse_k34): the default, K1 -> K2 -> K34 and K1 -> K2 -> K3 -> K4, with
# their launches per step
TRACER_FORMS = {form: FORMS[form]
                for form in (DEFAULT_FORM, (False, True), (False, False))}


def phase_tracer_runs(tf: TracerFields) -> None:
    """Phase 8b: 20 core2 f32 steps of FctAleSolver(backend="cuda").
    run_tracers at 4 tracers, in the forms of TRACER_FORMS, against 20
    single-tracer CUDA runs per tracer, bit for bit, with the launches of
    the batched run (set to 0 just before it, read just after).  Phase 8c:
    one float64 batched CUDA step on small against the plain step per
    tracer (backend="torch"), 1e-12."""
    from fesom2_accelerate_tpu_torch import FctAleConfig, FctAleSolver
    from fesom2_accelerate_tpu_torch.ops.cuda import kernels as K
    from fesom2_accelerate_tpu_torch.ops.cuda.step import BATCH_SHARED

    mesh = tf.meshes["core2"]
    per, batched = tf("core2", TRACERS)
    cfg = FctAleConfig(dt=0.5, flux_eps=1e-7, vlimit=1, iter_yn=False,
                       dtype=torch.float32)
    for (fuse_k12, fuse_k34), per_step in TRACER_FORMS.items():
        sv = FctAleSolver(mesh, cfg, backend="cuda", device="cuda",
                          fuse_k12=fuse_k12, fuse_k34=fuse_k34)
        state = sv.init_state_tracers(batched)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        out = sv.run_tracers(state, MAIN_STEPS)
        torch.cuda.synchronize()
        counts = K.launch_counts()
        label = (f"run_tracers (core2, Tb={TRACERS}, "
                 f"{form_name(fuse_k12, fuse_k34)})")
        check_counts(counts, {k: n * MAIN_STEPS for k, n in per_step.items()},
                     label)
        if set(out) != set(state):
            raise AssertionError(f"{label}: run_tracers changed the keys")
        for t in range(TRACERS):
            ref = sv.run(sv.init_state(per[t]), MAIN_STEPS)
            for k, v in ref.items():
                got = out[k] if k in BATCH_SHARED else out[k][t]
                if not bool(torch.isfinite(got).all()):
                    raise AssertionError(f"{label} {k}: non-finite")
                if not torch.equal(got, v):
                    raise AssertionError(
                        f"{label} {k} tracer {t}: not bit-identical to the "
                        f"single-tracer run (max abs diff "
                        f"{abserr(got, v):.3e})")
        print(f"{label}: {MAIN_STEPS} steps, launches "
              f"{ {k: v for k, v in counts.items() if v} } "
              f"({sum(per_step.values())} a step, as at Tb=1), every tracer "
              f"bit-identical to its single-tracer run", flush=True)

    mesh = tf.meshes["small"]
    per, batched = tf("small", 3)
    n = 0
    for vlimit in (1, 3):
        for iter_yn in (False, True):
            cfg = FctAleConfig(vlimit=vlimit, iter_yn=iter_yn, dt=0.7,
                               dtype=torch.float64)
            st = FctAleSolver(mesh, cfg, backend="torch", device="cuda")
            for fuse_k12, fuse_k34 in TRACER_FORMS:
                sc = FctAleSolver(mesh, cfg, backend="cuda", device="cuda",
                                  fuse_k12=fuse_k12, fuse_k34=fuse_k34)
                out = sc.step_tracers(sc.init_state_tracers(batched))
                for t in range(3):
                    ref = st.step(st.init_state(per[t]))
                    if set(ref) != set(out):
                        raise AssertionError("step_tracers keys differ")
                    for k, v in ref.items():
                        got = out[k] if k in BATCH_SHARED else out[k][t]
                        e = relerr(got, v)
                        if e > K.TOLERANCE[torch.float64]:
                            raise AssertionError(
                                f"f64 step_tracers vlimit={vlimit} "
                                f"iter={iter_yn} "
                                f"{form_name(fuse_k12, fuse_k34)} {k} "
                                f"tracer {t}: relerr {e:.3e}")
                n += 1
    print(f"step_tracers f64 on small, Tb=3: {n} cases (vlimit 1/3 x "
          f"iter_yn x {len(TRACER_FORMS)} forms) within 1e-12 of the plain "
          f"step per tracer",
          flush=True)


def exchange_ops(sh, state: dict) -> int:
    """The halo fills' device ops in one step of the sharded solver ``sh``
    (index_select and index_copy_ calls, counted by torch.profiler on the
    host; the CUDA path calls neither elsewhere)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sh.step(state)
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.key in ("aten::index_select", "aten::index_copy_"))


def phase_tracer_sharded(tf: TracerFields) -> None:
    """Phase 8d: ShardedFctAleSolver(backend="cuda", devices=["cuda:0"] *
    4, tracers=4) on core2, split and fused, 20 steps, against the
    single-device batched run within MAIN_RELERR, with the launches of each
    run (16 split, 12 fused a step, as at Tb=1) and the exchange ops of a
    step (as many as at Tb=1: EXCHANGE_OPS, one exchange of both limiter
    factors)."""
    from fesom2_accelerate_tpu_torch import (
        FctAleConfig,
        FctAleSolver,
        ShardedFctAleSolver,
    )
    from fesom2_accelerate_tpu_torch.ops.cuda import kernels as K

    mesh = tf.meshes["core2"]
    _, batched = tf("core2", TRACERS)
    cfg = FctAleConfig(dt=0.5, flux_eps=1e-7, vlimit=1, iter_yn=False,
                       dtype=torch.float32)
    single = FctAleSolver(mesh, cfg, backend="cuda", device="cuda")
    ref = {k: v.cpu().numpy() for k, v in single.run_tracers(
        single.init_state_tracers(batched), MAIN_STEPS).items()}
    steps = MAIN_STEPS
    one = ShardedFctAleSolver(mesh, cfg, backend="cuda",
                              devices=["cuda:0"] * SHARD_PARTS)
    ops1 = exchange_ops(one, one.init_state(tf("core2", 1)[0][0]))
    if ops1 != EXCHANGE_OPS:
        raise AssertionError(f"sharded split (core2, {SHARD_PARTS} parts, "
                             f"Tb=1): {ops1} exchange ops a step, expected "
                             f"{EXCHANGE_OPS}")
    per = {"split": ("bounds", "limit", "b3h", "update_fixup"),
           "fused": ("bounds", "limit", "update_fused")}
    for mode, names in per.items():
        sh = ShardedFctAleSolver(mesh, cfg, backend="cuda",
                                 devices=["cuda:0"] * SHARD_PARTS,
                                 tracers=TRACERS, fused=(mode == "fused"))
        state = sh.init_state(batched)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        out = sh.run(state, steps)
        torch.cuda.synchronize()
        counts = K.launch_counts()
        label = f"sharded {mode} (core2, {SHARD_PARTS} parts, Tb={TRACERS})"
        check_counts(counts, {k: SHARD_PARTS * steps for k in names}, label)
        ops = exchange_ops(sh, state)
        if ops != EXCHANGE_OPS:
            raise AssertionError(f"{label}: {ops} exchange ops a step, "
                                 f"{ops1} at Tb=1")
        got = sh.gather_state(out)
        if set(got) != set(ref):
            raise AssertionError(f"{label}: keys {set(got) ^ set(ref)}")
        err = 0.0
        for k, v in ref.items():
            if got[k].shape != v.shape or not np.isfinite(got[k]).all():
                raise AssertionError(f"{label} {k}: bad shape or non-finite")
            e = float(np.abs(got[k].astype(np.float64) - v).max()
                      / max(float(np.abs(v).max()), 1.0))
            err = max(err, e)
            if e > MAIN_RELERR:
                raise AssertionError(f"{label} {k}: relerr {e:.3e} > "
                                     f"{MAIN_RELERR:.0e}")
        print(f"{label}: {steps} steps within relerr {MAIN_RELERR:.0e} of "
              f"the single-device batched run (largest {err:.3e}); "
              f"launches {len(names) * SHARD_PARTS} a step, {ops} exchange "
              f"ops a step ({ops1} at Tb=1)", flush=True)


def tracer_solvers(tf: TracerFields, cfg, tb: int) -> tuple:
    """(form -> {"step": one step, "run": a run of TRACER_STEPS steps (the
    solver's run), "loop": the same steps as the host's loop, "sg": the
    StepGraphs of the solver's run, "state": the state's tensors (a flat
    dict), "changed": those of the fields a step writes; one device also
    "graph": the same steps as graph replays, whether they pay or not, and
    "n": (step, state, that StepGraphs) for runs of other lengths}, (the
    split solver, its state)) on core2 at ``tb`` tracers: the
    single-device default form (the single-tracer entry points at tb = 1)
    and 4 parts on the card, split and fused."""
    from fesom2_accelerate_tpu_torch import FctAleSolver, ShardedFctAleSolver

    mesh = tf.meshes["core2"]
    per, batched = tf("core2", tb)
    sv = FctAleSolver(mesh, cfg, backend="cuda", device="cuda")
    if tb == 1:
        s = sv.init_state(per[0])
        step, run = sv.step, sv.run
    else:
        s = sv.init_state_tracers(batched)
        step, run = sv.step_tracers, sv.run_tracers
    sg = graphs.StepGraphs("cuda")
    forms = {"single": {
        "step": lambda: step(s), "run": lambda: run(s, TRACER_STEPS),
        "loop": lambda: graphs.loop(step, s, TRACER_STEPS),
        "graph": lambda: sg.replay(step, s, TRACER_STEPS),
        "sg": sv._graphs, "state": s, "changed": changed_fields(s, step(s)),
        "n": (step, s, sg, run)}}
    for mode in ("split", "fused"):
        sh = ShardedFctAleSolver(mesh, cfg, backend="cuda",
                                 devices=["cuda:0"] * SHARD_PARTS,
                                 tracers=tb, fused=(mode == "fused"))
        st = sh.init_state(batched if tb > 1 else per[0])
        forms[mode] = {
            "step": lambda sh=sh, st=st: sh.step(st),
            "run": lambda sh=sh, st=st: sh.run(st, TRACER_STEPS),
            "loop": lambda sh=sh, st=st: graphs.loop(sh.step, st,
                                                     TRACER_STEPS),
            "sg": sh._graphs, "state": flat_state(st),
            "changed": changed_fields(flat_state(st),
                                      flat_state(sh.step(st)))}
        if mode == "split":
            split = (sh, st)
    return forms, split


def phase_tracer_times(card: str, tf: TracerFields) -> dict:
    """Phase 8e: ms a tracer a step at Tb = 1, 2, 4, 8 on core2 f32 for the
    single-device default form and 4 parts split and fused (CUDA events
    around 10 steps, best of 3; device time of a step with the stream
    held; the host's enqueue of a step), then each kernel with a tracer
    axis at Tb = 8 against Tb = 1, a tracer, beside its bound a tracer
    (profiling.kernel_io(tracers=8)).  Returns {kernel: (ms a tracer at
    Tb = 8, bound ms a tracer at Tb = 8)} at the shapes of each kernel's
    timed path (whole core2 for K1, K2, K34; part 1 for K3, K3fix, K4,
    K4-fix)."""
    from fesom2_accelerate_tpu_torch import FctAleConfig
    from fesom2_accelerate_tpu_torch.ops.meshdata import build_mesh_data
    from fesom2_accelerate_tpu_torch.parallel.step_sharded import (
        fix_edge_ids,
    )

    mesh = tf.meshes["core2"]
    cfg = FctAleConfig(dt=0.5, flux_eps=1e-7, vlimit=1, iter_yn=False,
                       dtype=torch.float32)
    for tb in TB_SWEEP:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        forms, (sh, state) = tracer_solvers(tf, cfg, tb)
        if tb in GRAPH_TB:
            # the first runs of each form (the solver's run, and on one
            # device the graph replays): capture time, and the memory the
            # graphs hold (their pool and the static carry); the copies a
            # graph run adds
            for f, fm in forms.items():
                where = ("" if f == "single" else f", {SHARD_PARTS} parts")
                for v in ("run", "graph"):
                    if v not in fm:
                        continue
                    torch.cuda.synchronize()
                    torch.cuda.empty_cache()
                    held = torch.cuda.memory_reserved()
                    first, capture = first_runs(fm[v])
                    torch.cuda.empty_cache()
                    held = torch.cuda.memory_reserved() - held
                    what = (f"the solver's run, watched steps: "
                            f"{chose_graphs(fm['sg'])}" if v == "run"
                            else "graph replays")
                    print(f"first run Tb={tb} {f} ({what}): {first:.1f} "
                          f"ms, its captures and eager steps {capture:.1f} "
                          f"ms (host wall), graphs' pool and static carry "
                          f"{held / 2**20:.0f} MiB (core2 f32{where}; card "
                          f"{card})", flush=True)
                print(f"graph run copies Tb={tb} {f}: the state into the "
                      f"static carry {copy_ms(list(fm['state'].values())):.4f}"
                      f" ms a run, the fields a step changes back into it "
                      f"{copy_ms(fm['changed']):.4f} ms a block of "
                      f"{graphs.BLOCK_STEPS} steps (events; core2 f32"
                      f"{where}; card {card})", flush=True)
        runs = {f: fm["run"] for f, fm in forms.items()}
        events = best_times(runs, 1, timer=cuda_time_ms)
        dev = best_times({f: fm["step"] for f, fm in forms.items()}, 5)
        if tb in GRAPH_TB:
            # in turns: the solver's run, the host's loop, graph replays
            both = {(f, v): fm[v] for f, fm in forms.items()
                    for v in ("run", "loop", "graph") if v in fm}
            other = best_times({k: fn for k, fn in both.items()
                                if k[1] != "run"}, 1, timer=cuda_time_ms)
            run_dev = best_times(runs, 1)
            wall = host_wall_ms(both)
        enq = {f: float("inf") for f in forms}
        for _ in range(TIMING_RUNS):
            for f, fm in forms.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(5):
                    fm["step"]()
                enq[f] = min(enq[f], (time.perf_counter() - t0) * 1e3 / 5)
                torch.cuda.synchronize()
        for f, fm in forms.items():
            ms = events[f] / TRACER_STEPS
            where = ("" if f == "single" else f", {SHARD_PARTS} parts")
            print(f"tracers Tb={tb} {f}: {ms / tb:.4f} ms a tracer a step "
                  f"({ms:.4f} a step, CUDA events around the solver's run); "
                  f"device {dev[f] / tb:.4f} "
                  f"a tracer ({dev[f]:.4f} a step, stream held); host "
                  f"enqueue {enq[f]:.4f} ms a step (core2 f32{where}; "
                  f"card {card})", flush=True)
            if tb in GRAPH_TB:
                n = TRACER_STEPS
                idle = lambda v: max(0.0, 1.0 - dev[f] * n  # noqa: E731
                                     / wall[f, v])
                graph = (f"; graph replays: events "
                         f"{other[f, 'graph'] / n:.4f}, host wall "
                         f"{wall[f, 'graph'] / n:.4f} ms a step (card idle "
                         f"{idle('graph'):.1%})" if "graph" in fm else "")
                print(f"run vs loop Tb={tb} {f}: the solver's run "
                      f"({chose_graphs(fm['sg'])}): events "
                      f"{events[f] / n:.4f}, host wall {wall[f, 'run'] / n:.4f}"
                      f" ms a step (card idle {idle('run'):.1%}), device "
                      f"{run_dev[f] / n:.4f} a step in it (stream held); the "
                      f"host's loop: events {other[f, 'loop'] / n:.4f}, host "
                      f"wall {wall[f, 'loop'] / n:.4f} ms a step (card idle "
                      f"{idle('loop'):.1%}){graph}; a step alone "
                      f"{dev[f]:.4f} ms ({n}-step runs; core2 f32{where}; "
                      f"card {card})", flush=True)
        if tb in GRAPH_TB:
            # one device: the solver's run, graph replays and the host's
            # loop at 1 step, MAIN_STEPS and bench.py's default LONG_STEPS
            step, s, sg, run = forms["single"]["n"]
            for n in (1, MAIN_STEPS, LONG_STEPS):
                t = best_times({"run": lambda: run(s, n),
                                "graph": lambda: sg.replay(step, s, n),
                                "loop": lambda: graphs.loop(step, s, n)}, 1,
                               timer=cuda_time_ms)
                print(f"one device Tb={tb}, {n}-step runs: the solver's "
                      f"run {t['run'] / n:.4f}, graph replays "
                      f"{t['graph'] / n:.4f}, the host's loop "
                      f"{t['loop'] / n:.4f} ms a step (events, best of "
                      f"{TIMING_RUNS}; core2 f32; card {card})", flush=True)
            del both, other, wall, run_dev
        del forms, runs

    # each kernel at Tb = 8 and Tb = 1, a tracer, on the whole mesh and on
    # part 1 of 4 (the last sweep's split solver, at Tb = 8)
    tb = sh.tracers
    _, batched = tf("core2", tb)
    whole = build_mesh_data(mesh, torch.float32, "cuda")
    targets = (
        ("whole", whole, {k: torch.tensor(v, dtype=torch.float32,
                                          device="cuda")
                          for k, v in batched.items()},
         torch.arange(0, mesh.n_edges, 3, dtype=torch.int32, device="cuda"),
         (0, mesh.n_nodes)),
        ("part 1", sh.mds[1], {k: v[1] for k, v in state.items()},
         torch.tensor(fix_edge_ids(sh.pm, 1), device="cuda"), sh.owned))
    out = {}
    for label, md, st, ids, own in targets:
        sb = tracer_inputs(md, st, cfg)
        s1 = one_tracer(sb, 0)
        kern = tracer_calls(md, cfg, ids, own, plain=False, copy=False)
        for name in TRACER_KERNELS:
            t = best_times({tb: lambda: kern[name](sb),
                            1: lambda: kern[name](s1)}, 5)
            bb, ob = profiling.kernel_io(md, name, ids=ids, owned=own,
                                         tracers=tb)
            b1, o1 = profiling.kernel_io(md, name, ids=ids, owned=own)
            bound = profiling.bound_ms(bb, ob, md.dtype)[0] / tb
            bound1 = profiling.bound_ms(b1, o1, md.dtype)[0]
            print(f"kernel {name} on core2 {label}: Tb={tb} "
                  f"{t[tb] / tb:.4f} ms a tracer ({t[tb]:.4f} a launch), "
                  f"bound {bound:.4f} a tracer ({bb / tb / 1e6:.1f} MB); "
                  f"Tb=1 {t[1]:.4f} ms, bound {bound1:.4f} "
                  f"({b1 / 1e6:.1f} MB) (f32; card {card})", flush=True)
            split = name in ("b3h", "b3h_fixup", "update", "update_fixup")
            if split == (label == "part 1"):
                out[name] = (t[tb] / tb, bound)
    return out


# phase 9a's run whose length is no multiple of a graph's block
ODD_STEPS = 2 * graphs.BLOCK_STEPS + 5
# each kernel's name in a profiler trace -> its wrapper (H-K4's FIX form,
# K4-fix, is update_kernel with its last template flag set)
KERNEL_NAMES = {"bounds_kernel": "bounds", "limit_kernel": "limit",
                "limit_fused_kernel": "limit_fused",
                "update_fused_kernel": "update_fused", "b3h_kernel": "b3h",
                "b3h_fixup_kernel": "b3h_fixup", "update_kernel": "update",
                "a2_kernel": "a2", "stress2rhs_kernel": "stress2rhs"}
SHARDED_STEP = {"split": ("bounds", "limit", "b3h", "update_fixup"),
                "fused": ("bounds", "limit", "update_fused")}
# phase 9c: steps before the checkpoint, and after it
CKPT_STEPS = 10
# phase 9b: sleep kernels that open each profiled window
MARKERS = 64


def graph_vs_loop(label: str, run, step, state: dict, n: int,
                  per_step: dict, gather=None) -> tuple:
    """``run(state, n)`` (a solver's run: CUDA graph replays) against
    ``graphs.loop(step, state, n)`` (the host's loop of the same steps),
    bit for bit in every column, finite where ``gather`` (a sharded
    solver's gather_state) reads, and the graph run's launches (set to 0
    just before it, read just after) against ``per_step`` x n.  Returns
    (the largest difference, the launch counts)."""
    from fesom2_accelerate_tpu_torch.ops.cuda import kernels as K

    torch.cuda.synchronize()
    K.reset_launch_counts()
    out = run(state, n)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    check_counts(counts, {k: v * n for k, v in per_step.items()}, label)
    real = (gather(out) if gather
            else {k: v.cpu().numpy() for k, v in out.items()})
    for k, v in real.items():
        if not np.isfinite(v).all():
            raise AssertionError(f"{label} {k}: non-finite")
    got, want = flat_state(out), flat_state(graphs.loop(step, state, n))
    if got.keys() != flat_state(state).keys() or got.keys() != want.keys():
        raise AssertionError(f"{label}: run changed the state's keys")
    diff = 0.0
    for k, v in want.items():
        diff = max(diff, bits_diff(got[k], v))
        if not same_bits(got[k], v):
            raise AssertionError(f"{label} {k}: graph run not bit-identical "
                                 f"to the loop (max abs diff "
                                 f"{bits_diff(got[k], v):.3e})")
    print(f"{label}: {n} steps as graph replays bit-identical to the host's "
          f"loop (max |graph - loop| {diff:.3e}), launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    return diff, counts


def phase_graph_runs(tf: TracerFields, meshes: dict) -> dict:
    """Phase 9a: runs as CUDA graphs on the card against the host's loop
    of their steps, bit for bit, with their launches: graph replays
    (``graphs.StepGraphs.replay``) of core2 f32 in the four single-device
    forms, a run of ODD_STEPS steps and run_tracers' step at TRACERS
    tracers; the sharded solvers' run (which must choose graphs: the
    host's enqueue of the parts' launches sets the pace) at 4 parts split
    and fused with both exchange forms; small f64 iterative (vlimit 1/3;
    the single-device solver's run, replays, and 4 parts split and
    fused).  Returns {path: (a maker of (a new run with nothing captured,
    a priming that makes its choice or None), its state, launches a step,
    the sharded solver if any)} for phase 9b."""
    from fesom2_accelerate_tpu_torch import (
        FctAleConfig,
        FctAleSolver,
        ShardedFctAleSolver,
    )
    from fesom2_accelerate_tpu_torch.mesh import random_fields

    def replays(step):
        sg = graphs.StepGraphs("cuda")
        return lambda state, n: sg.replay(step, state, n)

    def sharded_run(label, sh):
        def run(state, n):
            out = sh.run(state, n)
            require_graphs(sh._graphs, label)
            return out
        return run

    def fresh_sharded(label, sh):
        """(a new sharded solver's run, which must choose graphs; a
        priming that makes the choice)"""
        return sharded_run(label, sh), lambda state: decide(
            sh.run, state, sh._graphs, label)

    paths = {}
    cfg = FctAleConfig(dt=0.5, flux_eps=1e-7, vlimit=1, iter_yn=False,
                       dtype=torch.float32)
    mesh = tf.meshes["core2"]
    fields = tf("core2", 1)[0][0]
    for (k12, k34), per_step in FORMS.items():
        sv = FctAleSolver(mesh, cfg, device="cuda", fuse_k12=k12,
                          fuse_k34=k34)
        s = sv.init_state(fields)
        name = form_name(k12, k34)
        graph_vs_loop(f"graph replays core2 {name}", replays(sv.step),
                      sv.step, s, MAIN_STEPS, per_step)
        if (k12, k34) == DEFAULT_FORM:
            paths["single"] = (lambda sv=sv: (replays(sv.step), None), s,
                               per_step)
            graph_vs_loop(f"graph replays core2 {name}, blocks "
                          f"{graphs.blocks(ODD_STEPS - 2)} and 2 eager "
                          f"steps", replays(sv.step), sv.step, s, ODD_STEPS,
                          per_step)
    sv = FctAleSolver(mesh, cfg, device="cuda")
    graph_vs_loop(f"graph replays core2 Tb={TRACERS} (step_tracers)",
                  replays(sv.step_tracers), sv.step_tracers,
                  sv.init_state_tracers(tf("core2", TRACERS)[1]),
                  MAIN_STEPS, TRACER_FORMS[DEFAULT_FORM])
    for mode, names in SHARDED_STEP.items():
        for exchange in ("ppermute", "allgather"):
            make = lambda m=mode, e=exchange: ShardedFctAleSolver(  # noqa
                mesh, cfg, devices=["cuda:0"] * SHARD_PARTS,
                fused=(m == "fused"), exchange=e)
            sh = make()
            st = sh.init_state(fields)
            per_step = {k: SHARD_PARTS for k in names}
            label = f"graph run core2 {SHARD_PARTS} parts {mode} ({exchange})"
            decide(sh.run, st, sh._graphs, label)
            graph_vs_loop(label, sharded_run(label, sh), sh.step, st,
                          MAIN_STEPS, per_step, sh.gather_state)
            print(f"{label}: watched steps {chose_graphs(sh._graphs)}",
                  flush=True)
            if exchange == "ppermute":
                paths[mode] = (lambda make=make, label=label:
                               fresh_sharded(label, make()), st, per_step,
                               sh)
    small = meshes["small"]
    fields = random_fields(small, seed=2, dtype=np.float64)
    for vlimit in (1, 3):
        c64 = FctAleConfig(vlimit=vlimit, iter_yn=True, dt=0.7,
                           dtype=torch.float64)
        sv = FctAleSolver(small, c64, device="cuda")
        s = sv.init_state(fields)
        label = f"small f64 iterative vlimit {vlimit}"
        graph_vs_loop(f"graph replays {label}", replays(sv.step), sv.step,
                      s, MAIN_STEPS, FORMS[DEFAULT_FORM])
        graph_vs_loop(f"run {label}", sv.run, sv.step, s, MAIN_STEPS,
                      FORMS[DEFAULT_FORM])
        print(f"run {label}: watched steps {chose_graphs(sv._graphs)}",
              flush=True)
        for mode, names in SHARDED_STEP.items():
            sh = ShardedFctAleSolver(small, c64,
                                     devices=["cuda:0"] * SHARD_PARTS,
                                     fused=(mode == "fused"))
            tag = f"graph run {label} {SHARD_PARTS} parts {mode}"
            st = sh.init_state(fields)
            decide(sh.run, st, sh._graphs, tag)
            graph_vs_loop(tag, sharded_run(tag, sh), sh.step, st,
                          MAIN_STEPS, {k: SHARD_PARTS for k in names},
                          sh.gather_state)
    return paths


def kernel_sequence(prof) -> str:
    """The CUDA kernels of a torch.profiler trace in the order they ran,
    ours by wrapper and the others as "-"."""
    ev = sorted((e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA),
                key=lambda e: e.time_range.start)
    names = []
    for e in ev:
        m = re.search(r"\b(\w+_kernel)<", e.name)
        names.append(KERNEL_NAMES.get(m.group(1), "-") if m else "-")
    return " ".join(names)


def profiled_launches(prof) -> tuple:
    """({wrapper: kernel launches}, launches of other kernels) that
    torch.profiler's CUDA kernel events show."""
    ours, other = {}, 0
    for e in prof.key_averages():
        m = re.search(r"\b(\w+_kernel)<([^>]*)>", e.key)
        if m and m.group(1) in KERNEL_NAMES:
            name = KERNEL_NAMES[m.group(1)]
            if name == "update" and m.group(2).split(",")[-1].strip() \
                    == "true":
                name = "update_fixup"
            ours[name] = ours.get(name, 0) + e.count
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            other += e.count
    return ours, other


def phase_graph_counts(paths: dict) -> None:
    """Phase 9b: the launch counts of graph runs (a capture's own calls
    rolled back, kernels.capturing; each capture's calls added once per
    replay, kernels.count_replay) held against the kernel events
    torch.profiler records (CUPTI sees the kernels of a replay), for the
    single-device step's replays (3 a step), the 4-part split (16) and
    fused (12) steps' runs: a new run's run that captures a block length
    (after a short run that primes the step and, for the solvers' run,
    makes its choice) and a run of replays only; and the exchange ops of a
    sharded step (EXCHANGE_OPS).  CUPTI has lost the first kernels of a
    profiled window in long processes, so each window opens after a
    warm-up cycle of the profiler with MARKERS sleep kernels, and the
    priming steps run before it."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from fesom2_accelerate_tpu_torch.ops.cuda import kernels as K
    from fesom2_accelerate_tpu_torch.runtime.graphs import (
        WARM_STEPS,
        WATCHED_STEPS,
    )

    for path, (fresh, state, per_step, *sh) in paths.items():
        run, choose = fresh()
        if choose is not None:
            choose(state)
        # primes the step, captures a short block
        run(state, WARM_STEPS + WATCHED_STEPS + 3)
        for when in ("run that captures", "run of replays only"):
            torch.cuda.synchronize()
            K.reset_launch_counts()
            # a warm-up cycle of the profiler (tracing, results dropped),
            # then the recorded one: MARKERS sleep kernels, then the run
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1,
                                           repeat=1)) as prof:
                for _ in range(MARKERS):
                    torch.cuda._sleep(1000)
                torch.cuda.synchronize()
                prof.step()
                for _ in range(MARKERS):
                    torch.cuda._sleep(1000)
                torch.cuda.synchronize()
                run(state, MAIN_STEPS)
                torch.cuda.synchronize()
                prof.step()
            counts = {k: v for k, v in K.launch_counts().items() if v}
            label = f"graph run {path}, its {when}"
            check_counts(counts,
                         {k: v * MAIN_STEPS for k, v in per_step.items()},
                         label)
            seen, other = profiled_launches(prof)
            marks = sum(e.count for e in prof.key_averages()
                        if "spin_kernel" in e.key)
            if seen != counts:
                raise AssertionError(f"{label}: counters {counts}, "
                                     f"profiler's kernel events {seen}; "
                                     f"kernels in order: "
                                     f"{kernel_sequence(prof)}")
            ops = ""
            if sh:
                n_ops = exchange_ops(sh[0], state)
                if n_ops != EXCHANGE_OPS:
                    raise AssertionError(f"{label}: {n_ops} exchange ops a "
                                         f"step, expected {EXCHANGE_OPS}")
                ops = f", {n_ops} exchange ops a step"
            print(f"{label} (core2): counters = torch.profiler's kernel "
                  f"events over {MAIN_STEPS} steps, "
                  f"{sum(counts.values()) // MAIN_STEPS} launches a step "
                  f"{seen}{ops}; {other - marks} other kernels in the run "
                  f"(halo fills, carry copies); {marks} of {MARKERS} "
                  f"marker kernels before it", flush=True)


def phase_checkpoint(tf: TracerFields) -> None:
    """Phase 9c: CKPT_STEPS split steps at 4 parts on core2 (f32, the
    solvers' run), save_checkpoint, load at 2 parts and on one device,
    CKPT_STEPS more steps each, against 2 x CKPT_STEPS steps at 4 parts
    without a break, within MAIN_RELERR (other partitions sum in other
    orders); the same at TRACERS tracers (solvers built with tracers=),
    resumed at 2 parts."""
    from fesom2_accelerate_tpu_torch import (
        FctAleConfig,
        FctAleSolver,
        ShardedFctAleSolver,
    )
    from fesom2_accelerate_tpu_torch.runtime import checkpoint

    mesh = tf.meshes["core2"]
    cfg = FctAleConfig(dt=0.5, flux_eps=1e-7, vlimit=1, iter_yn=False,
                       dtype=torch.float32)
    path = pathlib.Path(__file__).resolve().parent / "chip_scratch" / "ckpt"
    for tb in (1, TRACERS):
        sharded = lambda parts, tb=tb: ShardedFctAleSolver(  # noqa: E731
            mesh, cfg, devices=["cuda:0"] * parts, tracers=tb)
        sh4 = sharded(SHARD_PARTS)
        per, batched = tf("core2", tb)
        s0 = sh4.init_state(per[0] if tb == 1 else batched)
        full = sh4.gather_state(sh4.run(s0, 2 * CKPT_STEPS))
        try:
            t0 = time.perf_counter()
            sh4.save_checkpoint(path, sh4.run(s0, CKPT_STEPS),
                                step=CKPT_STEPS)
            save_s = time.perf_counter() - t0
            sh2 = sharded(2)
            st, step = sh2.load_checkpoint(path)
            resumed = {"2 parts": (sh2.gather_state(sh2.run(st, CKPT_STEPS)),
                                   step)}
            if tb == 1:
                one = FctAleSolver(mesh, cfg, device="cuda")
                host, step1 = checkpoint.load_checkpoint(path, mesh, cfg)
                resumed["one device"] = (
                    {k: v.cpu().numpy() for k, v in
                     one.run(one.init_state(host), CKPT_STEPS).items()},
                    step1)
        finally:
            shutil.rmtree(path, ignore_errors=True)
        for where, (got, step) in resumed.items():
            if step != CKPT_STEPS:
                raise AssertionError(f"Tb={tb} at {where}: checkpoint step "
                                     f"{step}")
            if got.keys() != full.keys():
                raise AssertionError(f"Tb={tb} resumed at {where}: keys "
                                     f"differ")
            err = 0.0
            for k, v in full.items():
                if got[k].shape != v.shape or not np.isfinite(got[k]).all():
                    raise AssertionError(f"Tb={tb} resumed at {where} {k}: "
                                         f"bad shape or non-finite")
                err = max(err, float(np.abs(got[k].astype(np.float64)
                                            - v).max()
                                     / max(float(np.abs(v).max()), 1.0)))
            if err > MAIN_RELERR:
                raise AssertionError(f"Tb={tb} resumed at {where}: relerr "
                                     f"{err:.3e} > {MAIN_RELERR:.0e}")
            print(f"checkpoint Tb={tb}: {CKPT_STEPS} split steps at "
                  f"{SHARD_PARTS} parts, saved ({save_s:.2f} s), resumed at "
                  f"{where} for {CKPT_STEPS} more: within relerr {err:.3e} "
                  f"of {2 * CKPT_STEPS} steps without a break (core2 f32)",
                  flush=True)


SOURCE = "fesom2_accelerate_tpu_torch/ops/cuda/csrc/"
KERNEL_SOURCES = {"bounds": "fct_ale.cu", "limit": "fct_ale.cu",
                  "update_fused": "fct_ale.cu", "stress2rhs": "stress2rhs.cu",
                  "b3h": "fct_ale.cu", "b3h_fixup": "fct_ale.cu",
                  "update": "fct_ale.cu", "update_fixup": "fct_ale.cu",
                  "limit_fused": "fct_ale.cu", "a2": "fct_ale.cu"}
# every Pallas function (file:line of its def) that each kernel covers:
# between them, the 16 functions of the repo that reach pl.pallas_call
# (K4-fix: the split chain's fixup and K4, which it does in one launch on
# the sharded split step)
PALLAS = "fesom2_accelerate_tpu/ops/pallas/"
REPLACES = {
    "bounds": ("kernels.py:545", "kernels.py:348", "kernels.py:465"),
    "limit": ("kernels_packed.py:247", "kernels.py:686"),
    "update_fused": ("kernels_packed.py:744",),
    "stress2rhs": ("kernels.py:1091", "kernels_packed.py:1064"),
    "b3h": ("kernels_packed.py:359", "kernels.py:769"),
    "b3h_fixup": ("kernels_packed.py:410", "kernels.py:820"),
    "update": ("kernels_packed.py:537", "kernels.py:940"),
    "update_fixup": ("kernels_packed.py:410", "kernels.py:820",
                     "kernels_packed.py:537", "kernels.py:940"),
    "limit_fused": ("kernels_packed.py:895",),
    "a2": ("kernels.py:1015",),
}


def phase_bench(card: str, meshes: dict) -> None:
    """Phase 10: the bench's cells, the measured roof, the scaling
    harness and the drift study, through the port's modules; each raises
    where its check fails."""
    from fesom2_accelerate_tpu_torch.utils import accuracy, bench, scaling

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    roof = profiling.measure_stream_bandwidth()
    print(json.dumps({"measured_roof_Bps": roof,
                      "roof_kernel": bench.ROOF_KERNEL, "card": card}),
          flush=True)
    bench.check_roof(roof)
    inputs = bench.Inputs({"core2": meshes["core2"],
                           "cyl512": meshes["cylinder"]})
    for name in bench.CELLS:
        print(json.dumps(bench.run_cell(name, inputs, MAIN_STEPS, roof,
                                        card)), flush=True)
    del inputs
    rows, summary = scaling.scaling(meshes["core2"], "core2", (1, 2, 4),
                                    MAIN_STEPS)
    for row in rows:
        print(json.dumps(row), flush=True)
    print(json.dumps(summary), flush=True)
    if summary["failures"]:
        raise AssertionError(f"scaling gate: {summary['failures']}")
    tables = accuracy.study(meshes["small"], "cuda")
    print(accuracy.markdown(tables, "small"))
    print(json.dumps(tables), flush=True)


# phase 11: parts a rank of the 2-process runs, their launch timeout, and
# each mode's kernel launches a rank a step (K1, K2, K3, K4-fix or K1, K2,
# K34 on each of its 2 parts)
MP_PARTS_PER_RANK = 2
MP_TIMEOUT = 300.0
MP_LAUNCHES = {"split": 8, "fused": 6}
# ms a rank a step of phase 11's core2 runs in two calls on an H100
# ("NVIDIA H100 80GB HBM3, 700.00 W") when each limiter factor had its own
# exchange, after K3 (PERF.md §5): printed beside this run's
MP_TWO_EXCHANGE_STEP_MS = {"split": (2.3368, 2.9713),
                           "fused": (3.2403, 4.4185)}
# phase 12: the ABI steps timed on core2
ABI_STEPS = 5


def mp_sent(preset: str, dtype: str, tracers: int, iter_yn: bool) -> list:
    """(messages, bytes) each rank sends a step in phase 11's layout (4
    parts, ranks 0, 0, 1, 1), from the partition: one message a slab that
    leaves the rank in the one exchange of both limiter factors ([2, Tb,
    L, slab] each) and, iterative, one more in fct_LO's ([Tb, L, slab])."""
    from fesom2_accelerate_tpu_torch.parallel import partition as part_mod
    from fesom2_accelerate_tpu_torch.parallel.step_sharded import (
        exchange_pairs,
    )
    from fesom2_accelerate_tpu_torch.utils import multiproc

    mesh = multiproc.case_mesh(preset)
    owners = [r for r in range(2) for _ in range(MP_PARTS_PER_RANK)]
    pm = part_mod.partition_mesh(mesh, len(owners))
    size = 4 if dtype == "f32" else 8
    out = []
    for r in range(2):
        cols = [len(c) for p, q, _, c, _ in exchange_pairs(pm)
                if owners[q] == r != owners[p]]
        out.append((len(cols) * (1 + iter_yn), sum(cols) * mesh.n_layers
                    * size * tracers * (2 + iter_yn)))
    return out


def mp_case(label: str, preset: str, dtype: str, mode: str, steps: int,
            iter_yn: bool = False, tracers: int = 1, timed: bool = False,
            checkpoint=None, checkpoint_at: int = 0) -> tuple:
    """One run of ``utils.multiproc`` on 2 ranks, both on cuda:0 over gloo,
    2 parts each, bit for bit on the owned nodes (node fields and
    ``fct_adf_h``; both ranks' gathers) against the one-process
    ShardedFctAleSolver(devices=["cuda:0"] * 4) of the same case; each
    rank's launches a step must be MP_LAUNCHES[mode].  Returns (the rows
    of both ranks, the gathered state)."""
    from fesom2_accelerate_tpu_torch.utils import multiproc

    out = pathlib.Path(__file__).resolve().parent / "chip_scratch" / "mp" / \
        label
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    status, logs = multiproc.launch(
        2, multiproc.worker_args(
            preset, dtype, mode, tracers=tracers, iter_yn=iter_yn,
            steps=steps, parts_per_rank=MP_PARTS_PER_RANK, device="cuda",
            checkpoint=checkpoint, checkpoint_at=checkpoint_at,
            time_steps=timed),
        f"file://{out}/rdv", MP_TIMEOUT, out=out)
    wall = time.perf_counter() - t0
    if status != 0:
        raise AssertionError(f"{label}: 2 processes, status {status}\n"
                             + "\n".join(f"rank {r}:\n{log[-4000:]}"
                                         for r, log in enumerate(logs)))
    with np.load(out / "rank0.npz") as z:
        got = {k: z[k] for k in z.files}
    rows = [json.loads((out / f"rank{r}.json").read_text())
            for r in range(2)]
    shutil.rmtree(out, ignore_errors=True)
    sh = multiproc.build_solver(["cuda:0"] * 2 * MP_PARTS_PER_RANK, preset,
                                dtype, mode, iter_yn, tracers=tracers)
    state = sh.init_state(multiproc.case_fields(preset, tracers))
    ref = sh.gather_state(multiproc.take_steps(sh, state, steps))
    del sh, state
    torch.cuda.empty_cache()
    if got.keys() != ref.keys():
        raise AssertionError(f"{label}: keys {set(got) ^ set(ref)}")
    diff = 0.0
    for k, v in ref.items():
        if not np.isfinite(v).all() or not np.array_equal(got[k], v):
            diff = max(diff, float(np.abs(got[k].astype(np.float64)
                                          - v).max()))
            raise AssertionError(f"{label} {k}: 2 processes differ from "
                                 f"one process, max |diff| {diff:.3e}")
    for row in rows:
        if row["digest"] != {k: multiproc.digest(v) for k, v in
                             got.items()}:
            raise AssertionError(f"{label}: rank {row['rank']} gathered "
                                 f"other bits than rank 0")
        if row["launches_per_step"] != MP_LAUNCHES[mode]:
            raise AssertionError(f"{label}: rank {row['rank']} launched "
                                 f"{row['launches']} in {steps} steps")
    sent = mp_sent(preset, dtype, tracers, iter_yn)
    got_sent = [(r["messages_per_step"], r["bytes_per_step"]) for r in rows]
    if got_sent != sent:
        raise AssertionError(f"{label}: (messages, bytes) a rank a step "
                             f"{got_sent}, expected {sent}: one exchange of "
                             f"both limiter factors (and of fct_LO when "
                             f"iterative)")
    print(f"{label}: 2 ranks x {MP_PARTS_PER_RANK} parts on "
          f"{rows[0]['devices'][0]} ({rows[0]['transport']}), {steps} "
          f"steps: bit for bit against one process at "
          f"{2 * MP_PARTS_PER_RANK} parts (max diff {diff:.1e}, both "
          f"ranks' gathers); launches a rank a step "
          f"{[r['launches_per_step'] for r in rows]}; cross-process sends a "
          f"rank a step {[r['messages_per_step'] for r in rows]}, bytes "
          f"{[r['bytes_per_step'] for r in rows]}; launch wall "
          f"{wall:.1f} s", flush=True)
    return rows, got


def phase_multiprocess(card: str) -> None:
    """Phase 11: the sharded step over 2 OS processes (utils/multiproc.py),
    both ranks on cuda:0 over gloo (slabs staged through pinned host
    memory), 2 parts each: core2 f32 split (with a collective checkpoint
    at CKPT_STEPS, resumed in this process at 2 parts) and fused, small
    f64 iterative, core2 split at TRACERS tracers; each bit for bit
    against one process at 4 parts, with launches and cross-process bytes
    a step, and on core2 ms a step on each rank (events, host wall)."""
    from fesom2_accelerate_tpu_torch import ShardedFctAleSolver
    from fesom2_accelerate_tpu_torch.utils import multiproc

    ck = pathlib.Path(__file__).resolve().parent / "chip_scratch" / "mpck"
    shutil.rmtree(ck, ignore_errors=True)
    try:
        rows, full = mp_case("mp core2 f32 split", "core2", "f32", "split",
                             MAIN_STEPS, timed=True, checkpoint=ck,
                             checkpoint_at=CKPT_STEPS)
        if [r["wrote_checkpoint"] for r in rows] != [True, False]:
            raise AssertionError(f"checkpoint writers {rows}")
        sh2 = ShardedFctAleSolver(multiproc.case_mesh("core2"),
                                  multiproc.case_config("f32", False),
                                  devices=["cuda:0"] * 2)
        st, step = sh2.load_checkpoint(ck)
        resumed = sh2.gather_state(sh2.run(st, MAIN_STEPS - step))
        del sh2, st
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    if step != CKPT_STEPS or resumed.keys() != full.keys():
        raise AssertionError(f"checkpoint step {step}, keys "
                             f"{set(resumed) ^ set(full)}")
    diff = max(float(np.abs(resumed[k].astype(np.float64) - v).max())
               for k, v in full.items())
    if diff != 0.0:
        raise AssertionError(f"collective checkpoint resumed at 2 parts: "
                             f"max |diff| {diff:.3e} against "
                             f"{MAIN_STEPS} steps without a break")
    print(f"mp checkpoint: saved at {CKPT_STEPS} steps by 2 ranks (rank 0 "
          f"wrote), resumed in one process at 2 parts for "
          f"{MAIN_STEPS - CKPT_STEPS} more: bit for bit against "
          f"{MAIN_STEPS} steps without a break", flush=True)
    timed = {"split": rows}
    timed["fused"], _ = mp_case("mp core2 f32 fused", "core2", "f32",
                                "fused", MAIN_STEPS, timed=True)
    mp_case("mp small f64 iterative split", "small", "f64", "split", 3,
            iter_yn=True)
    mp_case(f"mp core2 f32 split Tb={TRACERS}", "core2", "f32", "split",
            MAIN_STEPS, tracers=TRACERS)
    for r in timed["split"]:
        tr = r["staging_trace"]
        seq = ", ".join(f"{n} ({s}) {a:.1f}-{b:.1f}"
                        for n, s, a, b in tr["events"])
        print(f"mp core2 f32 split rank {r['rank']}, one step's device "
              f"events (µs): {seq}; {tr['k3']} K3 launches, "
              f"{tr['staging']} staging ops on the side stream (the "
              f"gather and DtoH copy of the slab that leaves the rank), "
              f"{tr['staging_during_k3']} of them while a K3 ran",
              flush=True)
    for mode, rows in timed.items():
        print(json.dumps({
            "phase": 11, "mode": mode, "procs": 2, "parts": 4,
            "steps": MAIN_STEPS, "transport": rows[0]["transport"],
            "step_ms_ranks": [r["step_ms"] for r in rows],
            "two_exchange_step_ms_runs": MP_TWO_EXCHANGE_STEP_MS[mode],
            "host_ms_ranks": [r["host_ms"] for r in rows],
            "exchange_ms_ranks": [r["exchange_ms"] for r in rows],
            "exchange": "both limiter factors in one exchange",
            "messages_per_step_ranks": [r["messages_per_step"]
                                        for r in rows],
            "bytes_per_step_ranks": [r["bytes_per_step"] for r in rows],
            "staging_during_k3_ranks": [
                r["staging_trace"]["staging_during_k3"] for r in rows]
            if mode == "split" else None,
            "card": card}), flush=True)


def abi_ptrs(bufs: dict) -> list:
    from fesom2_accelerate_tpu_torch.native import demo

    return [bufs[k].ctypes.data for k, _ in demo.FIELD_FILES]


def abi_demo_case(exe, mesh, key: str, backend: int, device: str,
                  seed: int, env: dict) -> dict:
    """The C demo host's one step of ``backend`` through ``f2t_*_`` on
    ``mesh``, bit for bit against the solver ``host_embed`` builds for it
    (the plain stages for backend 0, the kernels for 1 and 2) on
    ``device``, on ``random_fields(seed)``; ``env`` is added to the demo's
    environment.
    Returns the fields the demo wrote back."""
    import tempfile

    from fesom2_accelerate_tpu_torch import FctAleSolver, host_embed
    from fesom2_accelerate_tpu_torch.mesh import random_fields
    from fesom2_accelerate_tpu_torch.native import demo

    fields = random_fields(mesh, seed=seed, dtype=np.float64)
    with tempfile.TemporaryDirectory() as d:
        demo.write_inputs(d, mesh, fields, 500, 1, False, backend)
        t0 = time.perf_counter()
        p = demo.run(exe, d, env=env)
        wall = time.perf_counter() - t0
        if p.returncode != 0:
            raise AssertionError(f"demo {key} backend {backend}: exit "
                                 f"{p.returncode}\n{p.stdout}\n"
                                 f"{p.stderr[-4000:]}")
        got = demo.outputs(d, mesh, False)
    solver = FctAleSolver(mesh, host_embed.config(backend, 500, 1, 0),
                          "torch" if backend == 0 else "cuda", device=device)
    ref = solver.step(solver.init_state(fields))
    for k, v in got.items():
        want = ref[k].double().cpu().numpy()
        if not np.isfinite(v).all() or not np.array_equal(v, want):
            raise AssertionError(
                f"demo {key} backend {backend} {k}: max |diff| "
                f"{float(np.abs(v - want).max()):.3e} against "
                f"FctAleSolver(backend={solver.backend!r}, "
                f"device={device!r})")
    del solver, ref
    print(f"C demo host, {key}, backend {backend} ({device}"
          f"{''.join(f', {k}={v}' for k, v in env.items())}): one step "
          f"through f2t_*_ bit for bit against FctAleSolver(backend="
          f"{'torch' if backend == 0 else 'cuda'!r}, device={device!r}) on "
          f"{sorted(got)}; {wall:.1f} s with the interpreter's start "
          f"({p.stdout.strip()})", flush=True)
    return got


def abi_timed(mesh, fields: dict, backend: int) -> tuple:
    """ABI_STEPS calls of ``host_embed.step`` of ``backend`` on
    ctypes-addressed buffers (as the C host makes them), each timed whole
    (its copies in, the solver's three phases, its copies out and its
    wait), the port's launch counts across the calls, and the device
    memory a call takes above what the process held before it.  Backend
    0's solver must hold its mesh on the card and run the plain stages.
    -> (times ms {"step": [...]}, launch counts, the host buffers after the
    last call, the device memory the process had allocated before a call
    (the session's mesh and what earlier phases still hold), the most
    allocated during one and the difference, {"before_step_MB",
    "step_peak_MB", "step_MB"})."""
    from fesom2_accelerate_tpu_torch import host_embed
    from fesom2_accelerate_tpu_torch.native import demo
    from fesom2_accelerate_tpu_torch.ops.cuda import kernels as K

    en = np.ascontiguousarray(mesh.elem_nodes, np.int32)
    nl = np.ascontiguousarray(mesh.nlev_elem, np.int32)
    xy = np.ascontiguousarray(mesh.node_xy, np.float64)
    if host_embed.setup(mesh.n_elems, mesh.nl, en.ctypes.data,
                        nl.ctypes.data, mesh.n_nodes, xy.ctypes.data, 500, 1,
                        0, backend) != 0:
        raise AssertionError(f"host_embed.setup(backend={backend}) failed "
                             f"on core2")
    try:
        solver = host_embed.session().solver
        want = {0: ("torch", torch.float64), 1: ("cuda", torch.float32),
                2: ("cuda", torch.float64)}[backend]
        devs = {t.device.type for t in vars(solver.md).values()
                if isinstance(t, torch.Tensor)}
        if (solver.backend, solver.cfg.dtype) != want or devs != {"cuda"} \
                or solver.device.type != "cuda":
            raise AssertionError(
                f"backend {backend}: solver {solver.backend!r} "
                f"{solver.cfg.dtype} on {solver.device}, mesh tensors on "
                f"{sorted(devs)}; expected {want} on cuda")
        times = {"step": []}
        mem = {"before_step_MB": 0.0, "step_peak_MB": 0.0, "step_MB": 0.0}
        K.reset_launch_counts()
        # the host's buffers live until reset, as the ABI's contract asks
        # of page-locked buffers; each call starts from the same fields
        bufs = {k: np.array(fields[k], np.float64)
                for k, _ in demo.FIELD_FILES}
        for _ in range(ABI_STEPS):
            for k, _ in demo.FIELD_FILES:
                np.copyto(bufs[k], fields[k])
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            if host_embed.step(*abi_ptrs(bufs)) != 0:
                raise AssertionError(f"host_embed.step(backend={backend}) "
                                     f"failed on core2")
            t1 = time.perf_counter()
            peak = torch.cuda.max_memory_allocated()
            if peak <= base:
                raise AssertionError(f"backend {backend}: the step took no "
                                     f"device memory ({peak} <= {base} B)")
            mem = {"before_step_MB": base / 1e6,
                   "step_peak_MB": max(mem["step_peak_MB"], peak / 1e6),
                   "step_MB": max(mem["step_MB"], (peak - base) / 1e6)}
            times["step"].append((t1 - t0) * 1e3)
        counts = K.launch_counts()
    finally:
        host_embed.reset()
    return times, counts, bufs, mem


def abi_row(mesh, backend: int, times: dict, mem: dict, card: str) -> dict:
    """The line of one backend's ABI calls on ``mesh``: min and all of
    their times, the bytes a call copies at the caller's f64 both ways and
    their rate over the whole call."""
    L, N, Ed = mesh.n_layers, mesh.n_nodes, mesh.n_edges
    nbytes = (8 * (6 * L * N + (L + 1) * N + L * Ed)
              + 8 * (2 * L * N + (L + 1) * N + L * Ed))
    row = {"phase": 12, "mesh": "core2", "backend": backend,
           "steps": ABI_STEPS, "card": card,
           "step_ms": min(times["step"]), "step_ms_runs": times["step"],
           "copied_MB": nbytes / 1e6,
           "copied_GBps": nbytes / (min(times["step"]) * 1e6)}
    row.update(mem)
    return row


def phase_host_abi(card: str, meshes: dict) -> None:
    """Phase 12: the host-embedding ABI.  Builds the shim and its C demo
    host (g++); the demo runs one step of each of ABI_CASES through
    ``f2t_*_``, bit for bit against the solver of its backend and device:
    backend 1 (the CUDA kernels, f32) on core2; backends 0 (the plain
    stages, f64) and 2 (the CUDA kernels, f64) on core2 on the card, each
    also within GT_TOL of the port's oracle (phase 13's step, on its
    fields); backend 0 on small on the CPU, asked for with
    FESOM2_TORCH_DEVICE=cpu.  Then ABI_STEPS calls of ``host_embed.step``
    of backends 1 and 2 (K1, K2, K3, K4-fix a call) and of backend 0 on
    core2, each timed whole; backend 0's on the card, launching no kernel
    of the port; the buffers bit for bit the demo's."""
    from fesom2_accelerate_tpu_torch.mesh import random_fields
    from fesom2_accelerate_tpu_torch.native import build

    t0 = time.perf_counter()
    lib, exe = build.build()
    print(f"host shim: {lib.name}, demo {exe.name} built in "
          f"{time.perf_counter() - t0:.1f} s (g++)", flush=True)
    outs = {}
    for key, backend, device, seed, env in ABI_CASES:
        outs[key, backend] = abi_demo_case(exe, meshes[key], key, backend,
                                           device, seed, env)
    mesh = meshes["core2"]
    gt_fields = random_fields(mesh, seed=GT_SEED, dtype=np.float64)
    ref, _ = gt_oracle_step("core2", mesh, gt_fields, 1, False)
    for backend in (0, 2):
        worst = max(masked_allclose(v, ref[k], msg=f"demo core2 backend "
                                    f"{backend} {k} vs the oracle")
                    for k, v in outs["core2", backend].items())
        print(f"C demo host, core2, backend {backend} (cuda): "
              f"{sorted(outs['core2', backend])} within {GT_TOL:.0e} of the "
              f"port's oracle (max abs diff {worst:.3e})", flush=True)

    fields = {0: gt_fields, 1: random_fields(mesh, seed=0, dtype=np.float64),
              2: gt_fields}
    kernels = {"bounds": ABI_STEPS, "limit": ABI_STEPS, "b3h": ABI_STEPS,
               "update_fixup": ABI_STEPS}
    expect = {0: {}, 1: kernels, 2: kernels}
    for backend in (1, 2, 0):
        times, counts, bufs, mem = abi_timed(mesh, fields[backend], backend)
        check_counts(counts, expect[backend], f"ABI steps, backend "
                     f"{backend}")
        for k, v in outs["core2", backend].items():
            if not np.array_equal(bufs[k], v):
                raise AssertionError(
                    f"ABI backend {backend} {k}: the Python-side step is "
                    f"not the demo's bit for bit (max |diff| "
                    f"{float(np.abs(bufs[k] - v).max()):.3e})")
        if backend == 0:
            print(f"ABI backend 0 on core2: the solver and its mesh on "
                  f"cuda, the plain stages (backend 'torch', f64); "
                  f"{ABI_STEPS} steps launched no kernel of the port; "
                  f"a step allocates {mem['step_MB']:.1f} MB of device "
                  f"memory above the {mem['before_step_MB']:.1f} MB held "
                  f"before it (peak {mem['step_peak_MB']:.1f} MB); the "
                  f"buffers bit for bit the demo's", flush=True)
        print(json.dumps(abi_row(mesh, backend, times, mem, card)),
              flush=True)


# --------------------------------------------------------------------------
# phase 13: the ground truth.  Every kernel, the f64 steps and the f32
# production path against the port's numpy oracle (ops/oracle.py) and C++
# golden reference (mesh/native.py), at core2 width
# --------------------------------------------------------------------------

# tests/conftest.py's masked_allclose tolerance: the f64 gate
GT_TOL = 1e-12
# one f32 step against the f64 oracle (ROADMAP.md "In f32"), and each of
# 20 iterative f32 steps against the golden reference (PERF.md §2)
GT_F32_RELERR = 1e-6
GT_LOOP_RELERR = 1e-5
GT_DT = 0.5
GT_SEED = 5
GT_LOOP_KEYS = ("fct_LO", "fct_adf_v", "fct_adf_h")
# (vlimit, iter_yn) of the oracle's whole steps, which feed 13b and 13c:
# vlimit 1 on core2, vlimit 2 and 3 on the cylinder (a core2-size oracle
# step takes about 7 s on the host; H-K1 is held to a1 -> a2 -> a3 at
# vlimit 1/2/3 on both meshes)
GT_CASES = {"core2": [(1, False), (1, True)],
            "cylinder": [(v, it) for v in (2, 3) for it in (False, True)]}
# the oracle's whole steps by (mesh, vlimit, iter_yn): (fields, step, host
# seconds), taken once for phases 12 and 13
GT_ORACLE = {}
# phase 12's C demo host cases: (mesh, backend, device, seed of the fields,
# the variables added to its environment); backend 0 on core2 takes phase
# 13's fields, and so its oracle step
ABI_CASES = (("core2", 1, "cuda", 0, {}),
             ("core2", 0, "cuda", GT_SEED, {}),
             ("core2", 2, "cuda", GT_SEED, {}),
             ("small", 0, "cpu", 0, {"FESOM2_TORCH_DEVICE": "cpu"}))


def gt_oracle_step(key: str, mesh, fields: dict, vlimit: int,
                   iter_yn: bool, mk=None) -> tuple:
    """The oracle's step at GT_DT on ``fields``, taken once a (mesh,
    vlimit, iter_yn) and reused while the fields are the same -> (the
    step, the host seconds it took)."""
    from fesom2_accelerate_tpu_torch.ops import oracle

    hit = GT_ORACLE.get((key, vlimit, iter_yn))
    if hit is None or hit[0].keys() != fields.keys() or not all(
            np.array_equal(hit[0][k], v) for k, v in fields.items()):
        t0 = time.perf_counter()
        ref = oracle.fct_ale_step(mesh, fields, vlimit=vlimit,
                                  iter_yn=iter_yn, dt=GT_DT, mk=mk)
        hit = GT_ORACLE[key, vlimit, iter_yn] = (
            fields, ref, time.perf_counter() - t0)
    return hit[1], hit[2]


def masked_allclose(a, b, rtol=GT_TOL, atol=GT_TOL, msg="") -> float:
    """tests/conftest.py's ``masked_allclose`` on whole arrays (the oracle
    zeroes every output outside the active region), on the card: every
    entry of ``a`` within ``atol + rtol * |b|`` of ``b`` (``np.allclose``'s
    test; a NaN fails), else AssertionError naming the first entries that
    fail.  Returns the largest absolute difference."""
    a, b = gt_tensor(a), gt_tensor(b)
    if a.shape != b.shape:
        raise AssertionError(f"{msg}: shape {tuple(a.shape)} vs "
                             f"{tuple(b.shape)}")
    diff = (a - b).abs()
    bad = ~(diff <= atol + rtol * b.abs())
    if bool(bad.any()):
        idx = torch.nonzero(bad)[:5]
        raise AssertionError(
            f"{msg} mismatch at {int(bad.sum())}/{bad.numel()} entries; "
            f"first idx {idx.tolist()}; a={a[bad][:5].tolist()} "
            f"b={b[bad][:5].tolist()}")
    return float(diff.max()) if diff.numel() else 0.0


def gt_tensor(x) -> torch.Tensor:
    """A numpy array or a tensor -> float64 on the card."""
    return torch.as_tensor(x, dtype=torch.float64, device="cuda")


class GroundErrors:
    """Largest absolute difference from the oracle per kernel (f64)."""

    def __init__(self):
        self.max_abs = {name: 0.0 for name in KERNEL_SOURCES}

    def close(self, kernel, name, got, ref, case, exact=False) -> float:
        """``got`` against the oracle's ``ref``: bit-exact, or within
        GT_TOL -> the largest absolute difference."""
        if ref is None:
            if got is not None:
                raise AssertionError(f"{kernel}.{name} {case}: expected None")
            return 0.0
        what = f"{kernel}.{name} {case} vs oracle"
        if exact:
            d = abserr(got, gt_tensor(ref))
            if not torch.equal(got, gt_tensor(ref)):
                raise AssertionError(f"{what}: not bit-exact (max abs diff "
                                     f"{d:.3e})")
        else:
            d = masked_allclose(got, ref, msg=what)
        self.max_abs[kernel] = max(self.max_abs[kernel], d)
        return d


def cpu_model() -> str:
    """The host CPU as /proc/cpuinfo names it (model name, vendor, family,
    model, stepping of the first CPU) and the cores this process sees."""
    fields = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            if not line.strip():
                break
            key, _, value = line.partition(":")
            fields[key.strip()] = value.strip()
    ident = ", ".join(f"{k} {fields[k]}" for k in ("vendor_id", "cpu family",
                                                   "model", "stepping")
                      if k in fields)
    return (f"{fields.get('model name', '?')} ({ident}), {os.cpu_count()} "
            f"cores")


def gt_incidences(mesh) -> dict:
    """(rows, cols, extra) of the node -> element and node -> edge
    incidences, as ``topology.build_mesh_from_elements`` builds them."""
    E, Ed = mesh.n_elems, mesh.n_edges
    return {"node_elems": (mesh.elem_nodes.ravel(),
                           np.repeat(np.arange(E, dtype=np.int32), 3),
                           np.tile(np.arange(3, dtype=np.int32), E)),
            "node_edges": (mesh.edges.ravel(),
                           np.repeat(np.arange(Ed, dtype=np.int32), 2),
                           np.tile(np.array([1, -1], dtype=np.int8), Ed))}


def gt_mesh_core(meshes: dict, cpu: str) -> dict:
    """13a: the native core's build (g++, from the checkout), then its
    edge derivation and incidences against the numpy topology and the
    mesh's arrays, array for array, on core2, the cylinder and polar_cap
    -> {mesh: (native s, numpy s)} of the builds."""
    from fesom2_accelerate_tpu_torch.mesh import native, topology

    t0 = time.perf_counter()
    lib = native.load()
    print(f"ground truth 13a: native core {pathlib.Path(lib._name).name} "
          f"built and loaded in {time.perf_counter() - t0:.2f} s (g++)",
          flush=True)
    builders = {
        "native": (native.build_edges, native.ragged_to_padded),
        "numpy": (topology._build_edges, topology._ragged_to_padded)}
    times = {}
    for key in ("core2", "cylinder", "polar_cap"):
        mesh = meshes[key]
        want = {"edges": (mesh.edges, mesh.edge_tri),
                "node_elems": (mesh.node_elems, mesh.node_elems_num,
                               mesh.node_elems_pos),
                "node_edges": (mesh.node_edges, mesh.node_edges_num,
                               mesh.node_edges_sign)}
        secs = {}
        for who, (edges_fn, ragged_fn) in builders.items():
            t0 = time.perf_counter()
            got = {"edges": edges_fn(mesh.elem_nodes)}
            for name, (rows, cols, extra) in gt_incidences(mesh).items():
                got[name] = ragged_fn(rows, cols, mesh.n_nodes, extra=extra)
            secs[who] = time.perf_counter() - t0
            for name, arrays in want.items():
                for i, w in enumerate(arrays):
                    g = got[name][i]
                    if g.dtype != w.dtype or not np.array_equal(g, w):
                        raise AssertionError(f"mesh core {key}: {who} "
                                             f"{name}[{i}] differs")
        times[key] = (secs["native"], secs["numpy"])
        print(f"ground truth 13a: mesh core {key} ({mesh.n_nodes} nodes, "
              f"{mesh.n_edges} edges): edges, edge_tri, node_elems (counts, "
              f"positions), node_edges (counts, signs) array-equal between "
              f"the native core and the numpy topology; build native "
              f"{secs['native']:.4f} s, numpy {secs['numpy']:.4f} s (host: "
              f"{cpu})", flush=True)
    return times


def gt_limited(ref: dict, iter_yn: bool) -> tuple:
    """(limited fct_adf_v, its residual, limited fct_adf_h, its residual,
    o1, o2) of an oracle step, in the kernels' output order."""
    if iter_yn:
        return (ref["fct_adf_v_limited"], ref["fct_adf_v"],
                ref["fct_adf_h_limited"], ref["fct_adf_h"], ref["fct_LO"],
                None)
    return (ref["fct_adf_v"], None, ref["fct_adf_h"], None,
            ref["del_ttf_advvert"], ref["del_ttf_advhoriz"])


def gt_kernel_case(md, s: dict, ref: dict, vlimit: int, iter_yn: bool,
                   ge: GroundErrors, case: str) -> float:
    """Every FCT wrapper on f64 tensors against the oracle's stage that
    computes the same thing, each fed the oracle's upstream outputs (the
    stage outputs its ``fct_ale_step`` returns).  Returns H-K3's largest
    difference (its edge outputs are expected bit-exact)."""
    from fesom2_accelerate_tpu_torch.ops.cuda import kernels as K

    eps = 1e-16
    t = gt_tensor
    lim_v, res_v, lim_h, res_h, o1, o2 = gt_limited(ref, iter_yn)
    node = (s["ttf"], s["hnode"], s["hnode_new"], s["fct_LO"],
            s["del_ttf_advvert"], s["del_ttf_advhoriz"], GT_DT, iter_yn)
    bounds = (ref["fct_ttf_max"], ref["fct_ttf_min"])
    limit = (ref["fct_plus"], ref["fct_minus"], lim_v, res_v)
    names = ("fct_plus", "fct_minus", "adf_v_lim", "adf_v_res")
    # H-K2: b1_vertical -> b1_horizontal -> b2 -> b3_vertical
    got = K.limit(md, s["fct_adf_v"], t(bounds[0]), t(bounds[1]),
                  s["fct_adf_h"], GT_DT, eps, iter_yn)
    for name, g, r in zip(names, got, limit):
        ge.close("limit", name, g, r, case)
    # H-K12: the same chain from a1, its bounds bit-exact
    got = K.limit_fused(md, s["fct_LO"], s["ttf"], s["fct_adf_v"],
                        s["fct_adf_h"], vlimit, GT_DT, eps, iter_yn)
    for i, (name, g, r) in enumerate(zip(("fct_ttf_max", "fct_ttf_min")
                                         + names, got, bounds + limit)):
        ge.close("limit_fused", name, g, r, case, exact=i < 2)
    plus, minus, lv = t(ref["fct_plus"]), t(ref["fct_minus"]), t(lim_v)
    # H-K3: b3_horizontal; H-K3fix on every edge, into zeroed outputs
    b3h = 0.0
    for name, g, r in zip(("adf_h_lim", "adf_h_res"),
                          K.b3h(md, plus, minus, s["fct_adf_h"], iter_yn),
                          (lim_h, res_h)):
        b3h = max(b3h, ge.close("b3h", name, g, r, case))
    every = torch.arange(md.n_edges, dtype=torch.int32, device="cuda")
    zero = torch.zeros_like(s["fct_adf_h"])
    got = K.b3h_fixup(md, plus, minus, s["fct_adf_h"], zero.clone(),
                      zero.clone() if iter_yn else None, every, iter_yn)
    for name, g, r in zip(("adf_h_lim", "adf_h_res"), got, (lim_h, res_h)):
        ge.close("b3h_fixup", name, g, r, case)
    # H-K4 and H-K34: c_update_solution / c_update_LO
    for name, g, r in zip(("o1", "o2"), K.update(md, lv, t(lim_h), *node),
                          (o1, o2)):
        ge.close("update", name, g, r, case)
    got = K.update_fused(md, plus, minus, lv, s["fct_adf_h"], *node)
    for name, g, r in zip(("o1", "o2", "adf_h_lim", "adf_h_res"), got,
                          (o1, o2, lim_h, res_h)):
        ge.close("update_fused", name, g, r, case)
    # K4-fix on the whole mesh (every column owned: no edge limited again)
    got = K.update_fixup(md, plus, minus, s["fct_adf_h"], t(lim_h),
                         t(res_h) if iter_yn else None, (0, md.n_nodes), lv,
                         *node)
    for name, g, r in zip(("o1", "o2", "adf_h_lim", "adf_h_res"), got,
                          (o1, o2, lim_h, res_h)):
        ge.close("update_fixup", name, g, r, case)
    return b3h


def gt_kernels(mesh, key: str, ge: GroundErrors, cpu: str) -> tuple:
    """13b on one mesh, f64, inputs from ``random_fields``: H-K1 (vlimit
    1/2/3) and H-A2 against ``a1 -> a2 -> a3_vlimit*``, bit-exact; every
    FCT wrapper against the oracle's step at each (vlimit, iter_yn) of
    GT_CASES; H-S2R against ``oracle.stress2rhs`` and the golden
    reference's ``f2t_stress2rhs``.  Returns (the oracle's steps by case,
    their host seconds, the fields)."""
    from fesom2_accelerate_tpu_torch import (
        FctAleConfig,
        FctAleSolver,
        Stress2RhsSolver,
    )
    from fesom2_accelerate_tpu_torch.mesh import native, random_fields
    from fesom2_accelerate_tpu_torch.ops import oracle
    from fesom2_accelerate_tpu_torch.ops.cuda import kernels as K

    fields = random_fields(mesh, seed=GT_SEED)
    mk = oracle.masks(mesh)
    md = FctAleSolver(mesh, FctAleConfig(dtype=torch.float64),
                      device="cuda").md
    s = {k: gt_tensor(v) for k, v in fields.items()}
    lo = fields["fct_LO"]
    tmax, tmin = oracle.a1(mesh, mk, lo, fields["ttf"])
    uv = oracle.a2(mesh, mk, tmax, tmin)
    for name, g, r in zip(("UV_max", "UV_min"),
                          K.a2(md, gt_tensor(tmax), gt_tensor(tmin), 1e3),
                          uv):
        ge.close("a2", name, g, r, key, exact=True)
    a3 = {1: oracle.a3_vlimit1(mesh, mk, *uv, lo),
          2: oracle.a3_vlimit2(mesh, mk, *uv, tmax, lo),
          3: oracle.a3_vlimit3(mesh, mk, *uv, tmax, lo)}
    for vlimit, want in a3.items():
        for name, g, r in zip(("fct_ttf_max", "fct_ttf_min"),
                              K.bounds(md, s["fct_LO"], s["ttf"], vlimit),
                              want):
            ge.close("bounds", name, g, r, f"{key} vlimit={vlimit}",
                     exact=True)
    refs, secs = {}, {}
    b3h = 0.0
    for vlimit, iter_yn in GT_CASES[key]:
        ref, secs[vlimit, iter_yn] = gt_oracle_step(key, mesh, fields, vlimit,
                                                    iter_yn, mk)
        refs[vlimit, iter_yn] = ref
        b3h = max(b3h, gt_kernel_case(
            md, s, ref, vlimit, iter_yn, ge,
            f"{key} vlimit={vlimit} iter={iter_yn}"))
    # H-S2R against the oracle's gather and the reference's scatter
    host = s2r_inputs(mesh)
    solver = Stress2RhsSolver(mesh, torch.float64, device="cuda")
    got = K.stress2rhs(solver.md, solver.pack_elem_inputs(*host[:7]),
                       *(gt_tensor(a) for a in host[7:]))
    want = oracle.stress2rhs(mesh.elem_nodes, mesh.node_elems,
                             mesh.node_elems_pos, mesh.node_elems_num,
                             *host)
    for name, g, r, n in zip("UV", got, want,
                             native.stress2rhs(mesh.elem_nodes, *host)):
        ge.close("stress2rhs", name, g, r, key)
        d = masked_allclose(g, n, msg=f"stress2rhs.{name} {key} vs "
                            f"f2t_stress2rhs")
        ge.max_abs["stress2rhs"] = max(ge.max_abs["stress2rhs"], d)
    torch.cuda.synchronize()
    print(f"ground truth 13b: {key} ({mesh.n_nodes} nodes, "
          f"{mesh.n_layers} layers), f64: H-K1 (vlimit 1/2/3) and H-A2 "
          f"bit-exact against a1 -> a2 -> a3_vlimit*; at (vlimit, iter_yn) "
          f"{GT_CASES[key]} H-K12's bounds bit-exact, H-K2, H-K12, H-K3, "
          f"H-K3fix, H-K4, H-K34 and K4-fix within {GT_TOL:.0e} of the "
          f"oracle's stages; H-S2R within {GT_TOL:.0e} of the oracle and of "
          f"f2t_stress2rhs; max |H-K3 - b3_horizontal| {b3h:.3e}; an oracle "
          f"step {min(secs.values()):.2f}-{max(secs.values()):.2f} s (numpy, "
          f"host: {cpu})", flush=True)
    return refs, secs, fields


def gt_steps(mesh, key: str, refs: dict, fields: dict, ge: GroundErrors,
             cpu: str, golden: bool) -> tuple:
    """13c: one f64 step of FctAleSolver(device="cuda") in the default
    form (K12 -> K3 -> K4), in K1 -> K2 -> K34 and in K1 -> K2 -> K3 ->
    K4 against the oracle for each case of ``refs``; with ``golden``, also
    against NativeReference.step (vlimit 1), and one f64 4-part split step
    of ShardedFctAleSolver, gathered, against the oracle.  Returns (the default form's first solver and its
    state, the golden reference's host seconds a step by iter_yn)."""
    from fesom2_accelerate_tpu_torch import (
        FctAleConfig,
        FctAleSolver,
        ShardedFctAleSolver,
    )
    from fesom2_accelerate_tpu_torch.mesh import native
    from fesom2_accelerate_tpu_torch.ops.cuda import kernels as K

    nat_secs, worst, kept = {}, {}, None
    reference = native.NativeReference(mesh) if golden else None
    for (vlimit, iter_yn), ref in refs.items():
        cfg = FctAleConfig(vlimit=vlimit, iter_yn=iter_yn, dt=GT_DT,
                           dtype=torch.float64)
        wants = {"the oracle": ref}
        if golden:
            t0 = time.perf_counter()
            wants["NativeReference"] = reference.step(fields, dt=GT_DT,
                                                      iter_yn=iter_yn)
            nat_secs[iter_yn] = time.perf_counter() - t0
        for form, (fuse_k12, fuse_k34) in (
                ("K12 -> K3 -> K4", DEFAULT_FORM),
                ("K1 -> K2 -> K34", (False, True)),
                ("K1 -> K2 -> K3 -> K4", (False, False))):
            solver = FctAleSolver(mesh, cfg, device="cuda",
                                  fuse_k12=fuse_k12, fuse_k34=fuse_k34)
            state = solver.init_state(fields)
            out = solver.step(state)
            kept = kept or (solver, state)
            for what, want in wants.items():
                for k, v in want.items():
                    d = masked_allclose(
                        out[k], v, msg=f"{key} {form} step {k} vlimit="
                        f"{vlimit} iter={iter_yn} vs {what}")
                    worst[form, what] = max(worst.get((form, what), 0.0), d)
    if golden:
        for iter_yn in (False, True):
            cfg = FctAleConfig(vlimit=1, iter_yn=iter_yn, dt=GT_DT,
                               dtype=torch.float64)
            sh = ShardedFctAleSolver(mesh, cfg,
                                     devices=["cuda:0"] * SHARD_PARTS)
            st = sh.init_state(fields)
            K.reset_launch_counts()
            out = sh.step(st)
            check_counts(K.launch_counts(),
                         {n: SHARD_PARTS for n in SHARDED_STEP["split"]},
                         f"ground truth 4-part f64 step iter={iter_yn}")
            gathered = sh.gather_state(out)
            what = ("4-part split step", "the oracle")
            for k, v in refs[1, iter_yn].items():
                d = masked_allclose(gathered[k], v, msg=f"{key} 4-part "
                                    f"split step {k} iter={iter_yn} vs the "
                                    f"oracle")
                worst[what] = max(worst.get(what, 0.0), d)
                if k in ("fct_adf_h", "fct_adf_h_limited", "fct_LO",
                         "del_ttf_advvert", "del_ttf_advhoriz"):
                    # K4-fix's outputs on the parts, gathered
                    ge.max_abs["update_fixup"] = max(
                        ge.max_abs["update_fixup"], d)
            del sh, st, out
    torch.cuda.synchronize()
    for (form, what), d in worst.items():
        print(f"ground truth 13c: {key} f64, one step, {form}, (vlimit, "
              f"iter_yn) {list(refs)}: every output within {GT_TOL:.0e} of "
              f"{what} (max abs diff {d:.3e})", flush=True)
    if golden:
        print(f"ground truth 13c: the 4-part split step launched K1, K2, K3 "
              f"and K4-fix {SHARD_PARTS} times each; NativeReference.step on "
              f"{key} (f64, C++, one thread) {nat_secs[False]:.3f} s, "
              f"iterative {nat_secs[True]:.3f} s (host: {cpu})", flush=True)
    return kept, nat_secs


def gt_golden_run(mesh, f64: dict, paths: dict) -> tuple:
    """13d's reference run: MAIN_STEPS iterative steps of the golden
    reference (f64) from ``f64``, with graphs.loop's carry (as
    ``FctAleSolver.run``); each step also taken in f32 by each solver of
    ``paths`` from the reference's state rounded to f32 -> (the
    reference's final state, its host seconds of each step, each path's
    largest relerr from the reference's next state by field)."""
    from fesom2_accelerate_tpu_torch.mesh import native

    golden = native.NativeReference(mesh)
    cfg = paths["cuda"].cfg
    secs, shadow = [], {b: {k: 0.0 for k in GT_LOOP_KEYS} for b in paths}

    def golden_step(s):
        t0 = time.perf_counter()
        new = {**s, **golden.step(s, dt=cfg.dt, flux_eps=cfg.flux_eps,
                                  iter_yn=True)}
        secs.append(time.perf_counter() - t0)
        for b, sv in paths.items():
            got = sv.step(sv.init_state(s))
            for k in GT_LOOP_KEYS:
                shadow[b][k] = max(shadow[b][k],
                                   relerr(got[k], gt_tensor(new[k])))
        return new

    return graphs.loop(golden_step, f64, MAIN_STEPS), secs, shadow


def gt_f32(mesh, f32: dict, f64: dict, paths: dict,
           golden: tuple) -> tuple:
    """13d: the f32 production path from random_fields(seed=0) rounded to
    f32, the references given those values widened to f64.  One step
    against the oracle.  Then the golden reference's run (``golden``, of
    :func:`gt_golden_run`): each of its steps taken in f32 by the kernels
    within GT_LOOP_RELERR; and MAIN_STEPS steps of ``run`` from the same
    start, free of the reference, their drift from it printed (a few
    entries of an iterative run's f32 state drift further: PERF.md §6,
    PR 13).  Returns the f32 solver and its state."""
    from fesom2_accelerate_tpu_torch import FctAleConfig, FctAleSolver
    from fesom2_accelerate_tpu_torch.ops import oracle
    from fesom2_accelerate_tpu_torch.ops.cuda import kernels as K

    cfg = FctAleConfig(dt=0.5, flux_eps=1e-7, vlimit=1, dtype=torch.float32)
    solver = FctAleSolver(mesh, cfg, device="cuda")
    state = solver.init_state(f32)
    out = solver.step(state)
    ref = oracle.fct_ale_step(mesh, f64, vlimit=1, dt=cfg.dt,
                              flux_eps=cfg.flux_eps)
    errs = {}
    for k, v in ref.items():
        if out[k].dtype != torch.float32:
            raise AssertionError(f"f32 step {k}: {out[k].dtype}")
        errs[k] = relerr(out[k], gt_tensor(v))
        if errs[k] > GT_F32_RELERR:
            raise AssertionError(f"f32 step {k}: relerr {errs[k]:.3e} > "
                                 f"{GT_F32_RELERR:.0e} of the f64 oracle")
    for k in ("fct_ttf_max", "fct_ttf_min"):
        want = torch.as_tensor(ref[k].astype(np.float32), device="cuda")
        print(f"ground truth 13d: f32 step {k}: {int((out[k] != want).sum())}"
              f" entries differ from the f64 oracle's rounded to f32 (max "
              f"abs diff {abserr(out[k], want):.3e})", flush=True)
    print("ground truth 13d: one core2 f32 step (dt 0.5, flux_eps 1e-7, "
          "vlimit 1) against the f64 oracle, relerr: "
          + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
          + f" (bar {GT_F32_RELERR:.0e})", flush=True)
    del ref

    want, _, shadow = golden
    for b, e in shadow.items():
        print(f"ground truth 13d: each of {MAIN_STEPS} iterative core2 steps "
              f"of the golden reference (f64, graphs.loop's carry), taken in "
              f"f32 by backend {b} from the reference's state: largest "
              f"relerr " + ", ".join(f"{k} {v:.3e}" for k, v in e.items())
              + f" (bar {GT_LOOP_RELERR:.0e} on fct_LO)", flush=True)
    if shadow["cuda"]["fct_LO"] > GT_LOOP_RELERR:
        raise AssertionError(f"{MAIN_STEPS} iterative f32 steps: fct_LO "
                             f"relerr {shadow['cuda']['fct_LO']:.3e} > "
                             f"{GT_LOOP_RELERR:.0e} of the golden reference")
    bar = gt_tensor(want["fct_LO"]).abs().max().clamp(min=1.0) * \
        GT_LOOP_RELERR
    for b, sv in paths.items():
        K.reset_launch_counts()
        got = sv.run(sv.init_state(f32), MAIN_STEPS)
        torch.cuda.synchronize()
        counts = K.launch_counts()
        check_counts(counts, {n: MAIN_STEPS for n in FCT_KERNELS}
                     if b == "cuda" else {},
                     f"ground truth {MAIN_STEPS} f32 steps, {b}")
        far = int(((got["fct_LO"].double() - gt_tensor(want["fct_LO"])).abs()
                   > bar).sum())
        print(f"ground truth 13d: {MAIN_STEPS} iterative core2 f32 steps of "
              f"run, backend {b}, free of the reference, drift from "
              f"{MAIN_STEPS} golden-reference steps: relerr " + ", ".join(
                  f"{k} {relerr(got[k], gt_tensor(want[k])):.3e}"
                  for k in GT_LOOP_KEYS)
              + f"; {far} of {got['fct_LO'].numel()} fct_LO entries beyond "
              f"{GT_LOOP_RELERR:.0e} (launches "
              f"{dict((k, v) for k, v in counts.items() if v)})", flush=True)
    return solver, state


def phase_ground_truth(card: str, meshes: dict) -> dict:
    """Phase 13: the port's own ground truth on the card (13a-e).  The
    golden reference's 13d run takes a host thread while the cylinder's
    checks run (no launch is counted meanwhile).  Returns each kernel's
    largest f64 difference from the oracle (13b, with K4-fix's outputs
    of 13c's 4-part step)."""
    from fesom2_accelerate_tpu_torch import FctAleConfig, FctAleSolver
    from fesom2_accelerate_tpu_torch.mesh import random_fields

    cpu = cpu_model()
    ge = GroundErrors()
    topo = gt_mesh_core(meshes, cpu)
    core2 = meshes["core2"]
    refs, secs, fields = gt_kernels(core2, "core2", ge, cpu)
    (s64, st64), nat = gt_steps(core2, "core2", refs, fields, ge, cpu,
                                golden=True)
    del refs, fields
    f32 = random_fields(core2, seed=0, dtype=np.float32)
    f64 = {k: v.astype(np.float64) for k, v in f32.items()}
    cfg_it = FctAleConfig(dt=0.5, flux_eps=1e-7, vlimit=1, iter_yn=True,
                          dtype=torch.float32)
    paths = {b: FctAleSolver(core2, cfg_it, b, device="cuda")
             for b in ("cuda", "torch")}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        run = pool.submit(gt_golden_run, core2, f64, paths)
        cyl = meshes["cylinder"]
        refs, cyl_secs, fields = gt_kernels(cyl, "cylinder", ge, cpu)
        gt_steps(cyl, "cylinder", refs, fields, ge, cpu, golden=False)
        del refs, fields
        golden = run.result()
    s32, st32 = gt_f32(core2, f32, f64, paths, golden)
    best = best_times({"f64": lambda: s64.step(st64),
                       "f32": lambda: s32.step(st32)}, MAIN_STEPS,
                      timer=cuda_time_ms)
    oracle_s = {f"{key} vlimit={v} iter_yn={it}": x
                for key, by in (("core2", secs), ("cylinder", cyl_secs))
                for (v, it), x in by.items()}
    print(json.dumps({
        "ground_truth_times": {
            "native_step_s": nat[False], "native_step_iter_s": nat[True],
            "native_steps_13d_s": golden[1],
            "oracle_step_s": oracle_s,
            "cuda_step_f64_ms": best["f64"], "cuda_step_f32_ms": best["f32"],
            "topology_native_s": {k: v[0] for k, v in topo.items()},
            "topology_numpy_s": {k: v[1] for k, v in topo.items()}},
        "mesh": "core2", "card": card, "host_cpu": cpu}), flush=True)
    print(f"ground truth 13e: one core2 step: C++ golden reference "
          f"{nat[False] * 1e3:.1f} ms (iterative {nat[True] * 1e3:.1f} ms; "
          f"13d's {MAIN_STEPS} on a thread beside the cylinder's checks "
          f"{min(golden[1]) * 1e3:.1f}-{max(golden[1]) * 1e3:.1f} ms), "
          f"numpy oracle {min(secs.values()) * 1e3:.1f} ms (host: {cpu}); "
          f"CUDA f64 {best['f64']:.4f} ms, f32 {best['f32']:.4f} ms (events "
          f"around {MAIN_STEPS} steps, best of {TIMING_RUNS}; card {card})",
          flush=True)
    print("ground truth: each kernel's largest f64 difference from the "
          "oracle: " + ", ".join(f"{k} {v:.3e}"
                                 for k, v in ge.max_abs.items()),
          flush=True)
    return ge.max_abs


def lap(name: str, run, t0: float) -> tuple:
    """Runs ``run()`` and prints the seconds since ``t0`` -> (its result,
    now)."""
    out = run()
    now = time.perf_counter()
    print(f"phase {name} took {now - t0:.1f} s", flush=True)
    return out, now


def main() -> int:
    t_start = time.perf_counter()
    card = phase_env()
    reports = phase_build()
    meshes = build_meshes()
    errs = Errors()
    phase_kernel_checks(errs, meshes)
    phase_s2r_checks(errs, meshes)
    phase_fct_on_rcm(errs, meshes)
    counts, times, md = phase_main_path(card, meshes, reports)
    # each kernel's mesh data (and the inputs its bytes depend on) on the
    # path whose launches it counts, for its bound
    shapes = {name: (md, {}) for name in FCT_KERNELS}
    s2r_counts, times["stress2rhs"], shapes["stress2rhs"] = phase_s2r_path(
        card, meshes)
    counts["stress2rhs"] = s2r_counts["stress2rhs"]
    t0 = time.perf_counter()
    phase_sharded_checks(errs, meshes)
    # H-K3fix, the witness, runs in these checks and no longer on a path
    counts["b3h_fixup"] = phase_fold_checks(errs, meshes)["b3h_fixup"]
    phase_sharded_small()
    split_counts, split_times, split_shapes = phase_sharded_path(
        card, meshes)
    print(f"phase 6 (sharded path) took {time.perf_counter() - t0:.1f} s",
          flush=True)
    # K4-fix and the witness at part 1's shapes, where they run
    for name in ("b3h_fixup", "update_fixup"):
        times[name] = split_times["part 1"][name]
        shapes[name] = split_shapes[name]
    counts["update_fixup"] = split_counts["update_fixup"]
    # H-K1, H-K2 and H-K34 at the whole mesh's, where phase 7b's
    # K1 -> K2 -> K34 form runs them
    for name in ("bounds", "limit", "update_fused"):
        times[name] = split_times["whole"][name]
        shapes[name] = split_shapes[name]
    t0 = time.perf_counter()
    phase_new_kernel_checks(errs, meshes)
    phase_chunk_checks(errs)
    form_counts, a2_times, md = phase_forms(card, meshes)
    for name in ("bounds", "limit", "update_fused"):
        counts[name] = form_counts[form_name(False, True)][name]
    counts["a2"] = phase_tuner(meshes)["a2"]
    times.update(a2_times)
    shapes.update(a2=(md, {}))
    print(f"phase 7 (K12, A2, step forms, tuner) took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    tf = TracerFields(meshes, {"small": 3, "core2": max(TB_SWEEP)})
    _, t1 = lap("8a", lambda: phase_tracer_kernels(errs, tf), t0)
    _, t1 = lap("8b-c", lambda: phase_tracer_runs(tf), t1)
    _, t1 = lap("8d", lambda: phase_tracer_sharded(tf), t1)
    tb8, _ = lap("8e", lambda: phase_tracer_times(card, tf), t1)
    print(f"phase 8 (multi-tracer path) took {time.perf_counter() - t0:.1f} "
          f"s", flush=True)
    t0 = time.perf_counter()
    paths, t1 = lap("9a", lambda: phase_graph_runs(tf, meshes), t0)
    _, t1 = lap("9b", lambda: phase_graph_counts(paths), t1)
    del paths
    _, t1 = lap("9c", lambda: phase_checkpoint(tf), t1)
    print(f"phase 9 (on-device run, checkpoints) took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    lap("10 (bench, scaling, drift)", lambda: phase_bench(card, meshes),
        time.perf_counter())
    lap("11 (2 processes)", lambda: phase_multiprocess(card),
        time.perf_counter())
    lap("12 (host ABI)", lambda: phase_host_abi(card, meshes),
        time.perf_counter())
    oracle_err, _ = lap("13 (ground truth)",
                        lambda: phase_ground_truth(card, meshes),
                        time.perf_counter())
    kernels = []
    for name, src in KERNEL_SOURCES.items():
        kmd, inputs = shapes[name]
        nbytes, ops = profiling.kernel_io(kmd, name, **inputs)
        bound, bound_by = profiling.bound_ms(nbytes, ops, kmd.dtype)
        if counts[name] < 1:
            raise AssertionError(f"{name}: no launch on its path")
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE + src,
            "replaces": ", ".join(PALLAS + r for r in REPLACES[name]),
            "launches": counts[name], "max_abs_err": errs.max_abs[name],
            "ms": times[name]["kernel"], "plain_ms": times[name]["plain"],
            "bound_ms": bound, "bound_by": bound_by,
            # no single PyTorch call computes any of these functions
            "library_ms": None,
            "oracle_max_abs_err_f64": oracle_err[name]})
        if name in tb8:
            # a tracer's share of one launch at 8 tracers, and of its bound
            kernels[-1].update(ms_per_tracer_tb8=tb8[name][0],
                               bound_ms_tb8=tb8[name][1])
        print(f"kernel {name}: {nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} "
              f"G operations, bound {bound:.4f} ms ({bound_by}; H100 SXM "
              f"data sheet), measured {times[name]['kernel']:.4f} ms "
              f"({bound / times[name]['kernel']:.1%} of the bound's rate)")
    print(f"smoke run took {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
