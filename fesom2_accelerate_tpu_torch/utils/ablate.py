"""What each part of the tiled kernels H-K1 ``bounds`` and H-K34
``update_fused`` costs on the card, by ablation.

A variant is ``ops/cuda/csrc/fct_ale.cu`` with parts of one kernel taken
out by textual edits (``ABLATIONS``).  Each edit applies inside the named
kernel's body and must match there exactly once (whitespace aside), so a
source that drifts from the edits fails here; the CPU tests check that
every edit still applies.  The variants are compiled together, one
``nvcc`` each, into ``_build/ablate/``, while the unedited kernels build
as usual (``build.library``); each variant is launched through the wrappers
of ``ops/cuda/kernels.py`` with ``build.library`` pointed at its launchers.

An ablated kernel computes another function: only its time is read.  What
a difference of two times measures:

* ``bounds``: full - ``no_gather`` is the neighbour gathers of the cluster
  bounds; full - ``no_window`` the vlimit window; ``stream`` (neither) is
  what is left, the node's own rows read and both bounds written;
* ``update_fused``: full - ``read_back`` is limiting again the edges that
  start in another tile, over reading one value back per slot as H-K4
  does; full - ``no_stage_c`` is stage c; ``edge_phase`` is the edge phase
  alone, the work H-K3 does, which is timed beside it (with H-K4).

Inputs: ``--preset`` (core2), float32, ``random_fields(seed=0)``, vlimit
1, non-iterative, dt 0.5, flux_eps 1e-7; K34 takes H-K1 -> H-K2's factors.
Times are ``device_time_ms`` over ``--reps`` launches, the best of
``--rounds`` rounds, each round over the unedited kernel and its variants
in turn.  Registers and spills come from each build's ptxas log, blocks an
SM from ``kernels.occupancy``.  Prints one line per kernel and variant and
writes the results, with the card's name and power limit, as JSON.

Usage on a machine with nvcc and a CUDA card::

    python -m fesom2_accelerate_tpu_torch.utils.ablate --preset core2 \\
        --out chiprun_out/ablate_core2.json
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys
import types

import numpy as np
import torch

from fesom2_accelerate_tpu_torch.ops.cuda import build, kernels

SOURCE = "fct_ale.cu"
ABLATE_DIR = build.BUILD_DIR / "ablate"

_NO_GATHER = ("lev[k] = ok ? nd_lev[(size_t)n * KD + k] : 0;",
              "lev[k] = 0;")
_NO_WINDOW = ("bounds_window(pmax, pmin, pa_hi, pa_lo, cur, xmax, xmin, "
              "xa_hi, xa_lo, z, nlev, vlimit, tx, tn);",
              "tx = cur.cmax - cur.lo; tn = cur.cmin - cur.lo;")
_READ_BACK = ("const int o = s_oth[k][lane]; "
              "const T f = adf_h[(size_t)z * Ed + e]; "
              "const T pn = plus[idx], mn = minus[idx]; "
              "const T po = plus[row + o], mo = minus[row + o]; "
              "const T ae = first ? edge_limiter(f, pn, mn, po, mo) "
              ": edge_limiter(f, po, mo, pn, mn); "
              "lim = mul_rn(ae, f);",
              "lim = adf_h[(size_t)z * Ed + e];")
_NO_STAGE_C = ("stage_c(ttf, hnode, hnode_new, lo, dvin, dhin, area_inv, o1, "
               "o2, idx, z < nlev - 1, adf_v_lim[idx], adf_v_lim[idx + N], "
               "acc, dt, iter_yn);",
               "o1[idx] = acc;")
_NO_NODE_PHASE = ("if (n >= N) return;", "return;")

# kernel -> variant -> the (old, new) edits of its body
ABLATIONS = {
    "bounds": {
        "no_gather": (_NO_GATHER,),
        "no_window": (_NO_WINDOW,),
        "stream": (_NO_GATHER, _NO_WINDOW),
    },
    "update_fused": {
        "read_back": (_READ_BACK,),
        "no_stage_c": (_NO_STAGE_C,),
        "edge_phase": (_NO_NODE_PHASE,),
    },
}


def _body(src: str, kernel: str) -> tuple[int, int]:
    """[start, end) of ``<kernel>_kernel``'s definition in ``src``."""
    start = src.index(f"\n{kernel}_kernel(")
    return start, src.index("\n}\n", start) + 3


def edited_source(kernel: str, variant: str, src: str | None = None) -> str:
    """``fct_ale.cu`` (or ``src``) with the edits of ``variant`` applied to
    ``kernel``'s body; raises ValueError unless each matches once."""
    if src is None:
        src = (build.CSRC / SOURCE).read_text()
    start, end = _body(src, kernel)
    body = src[start:end]
    for old, new in ABLATIONS[kernel][variant]:
        pattern = r"\s+".join(map(re.escape, old.split()))
        body, n = re.subn(pattern, lambda _: new, body)
        if n != 1:
            raise ValueError(f"{kernel}/{variant}: {old!r} matches {n} times "
                             f"in {kernel}_kernel")
    return src[:start] + body + src[end:]


def build_variants() -> dict:
    """Compiles every variant, all in parallel, while ``build.library``
    builds the unedited sources -> {(kernel, variant): (launchers as a
    namespace, ptxas log)}."""
    ABLATE_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for kernel, variants in ABLATIONS.items():
        for variant in variants:
            src = ABLATE_DIR / f"fct_ale_{kernel}_{variant}.cu"
            src.write_text(edited_source(kernel, variant))
            out = src.with_suffix(".so")
            cmd = [build.nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src)]
            procs[kernel, variant] = (out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    build.library()
    libs, failed = {}, []
    for key, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{key}: nvcc failed\n{log[-4000:]}")
            continue
        libs[key] = (types.SimpleNamespace(
            **build.load(out, build.SOURCES[SOURCE])), log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


@contextlib.contextmanager
def launching_from(lib):
    """While the block runs, the wrappers launch ``lib``'s launchers."""
    saved = build.library
    build.library = lambda: lib
    try:
        yield
    finally:
        build.library = saved


def _ptxas(log: str, kernel: str, slots: int, threads: int) -> dict:
    for r in build.ptxas_report(log):
        if (r["kernel"] == f"{kernel}_kernel" and r["dtype"] == "float"
                and r["params"] == (slots, threads)):
            return dict(registers=r["registers"],
                        spill_bytes=r["spill_stores"] + r["spill_loads"])
    raise ValueError(f"no ptxas entry for {kernel}<float, {slots}, "
                     f"{threads}>")


def measure(preset: str, threads: int, rounds: int, reps: int) -> dict:
    from fesom2_accelerate_tpu_torch.config import FctAleConfig
    from fesom2_accelerate_tpu_torch.mesh import generate_planar_mesh
    from fesom2_accelerate_tpu_torch.mesh.generate import random_fields
    from fesom2_accelerate_tpu_torch.ops.meshdata import build_mesh_data
    from fesom2_accelerate_tpu_torch.runtime import profiling
    from fesom2_accelerate_tpu_torch.runtime.tracing import (
        card_line,
        device_time_ms,
        require_cuda,
    )

    dev = require_cuda("cuda")
    libs = build_variants()
    mesh = generate_planar_mesh(preset=preset)
    md = build_mesh_data(mesh, torch.float32, dev)
    cfg = FctAleConfig(dt=0.5, flux_eps=1e-7, dtype=torch.float32)
    s = {k: torch.tensor(v, device=dev)
         for k, v in random_fields(mesh, seed=0, dtype=np.float32).items()}
    k = dict(threads=threads)
    lo, ttf, av, ah = s["fct_LO"], s["ttf"], s["fct_adf_v"], s["fct_adf_h"]
    node = (ttf, s["hnode"], s["hnode_new"], lo, s["del_ttf_advvert"],
            s["del_ttf_advhoriz"], cfg.dt, False)
    tmax, tmin = kernels.bounds(md, lo, ttf, cfg.vlimit, **k)
    plus, minus, avl, _ = kernels.limit(md, av, tmax, tmin, ah, cfg.dt,
                                        cfg.flux_eps, False, **k)
    ahl, _ = kernels.b3h(md, plus, minus, ah, False, **k)
    calls = {
        "bounds": lambda: kernels.bounds(md, lo, ttf, cfg.vlimit, **k),
        "update_fused": lambda: kernels.update_fused(md, plus, minus, avl,
                                                     ah, *node, **k),
    }
    beside = {
        "b3h": lambda: kernels.b3h(md, plus, minus, ah, False, **k),
        "update": lambda: kernels.update(md, avl, ahl, *node, **k),
    }
    slots = 8 if md.nd_idx.shape[1] <= 8 else 16
    full_log = build.library_path(SOURCE).with_suffix(".log").read_text()
    res = {}
    for kernel, variants in ABLATIONS.items():
        runs = {"full": (build.library(), full_log)}
        runs.update({v: libs[kernel, v] for v in variants})
        best = {v: float("inf") for v in runs}
        for _ in range(rounds):
            for v, (lib, _log) in runs.items():
                with launching_from(lib):
                    calls[kernel]()
                    best[v] = min(best[v], device_time_ms(calls[kernel],
                                                          reps, dev))
        nbytes, ops = profiling.kernel_io(md, kernel)
        res[kernel] = dict(
            bytes=nbytes, bound_ms=profiling.bound_ms(nbytes, ops)[0],
            variants={})
        for v, (lib, log) in runs.items():
            with launching_from(lib):
                occ = kernels.occupancy(md, kernel, **k)
            res[kernel]["variants"][v] = dict(
                ms=best[v], **_ptxas(log, kernel, slots, threads),
                blocks_per_sm=occ["blocks_per_sm"], waves=occ["waves"])
    for name, fn in beside.items():
        res[name] = dict(ms=min(device_time_ms(fn, reps, dev)
                                for _ in range(rounds)))
    return dict(card=card_line(), preset=preset, threads=threads,
                dtype="float32", rounds=rounds, reps=reps, kernels=res)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="core2")
    ap.add_argument("--threads", type=int, default=kernels.DEFAULT_THREADS)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out", default=None, help="JSON file of the results")
    args = ap.parse_args(argv)
    out = measure(args.preset, args.threads, args.rounds, args.reps)
    for kernel, r in out["kernels"].items():
        if "variants" not in r:
            print(f"ablate {kernel} (beside): {r['ms']:.4f} ms")
            continue
        full = r["variants"]["full"]["ms"]
        for v, m in r["variants"].items():
            print(f"ablate {kernel} {v}: {m['ms']:.4f} ms (full - this "
                  f"{full - m['ms']:+.4f}), {m['registers']} registers, "
                  f"{m['spill_bytes']} spill bytes, {m['blocks_per_sm']} "
                  f"blocks an SM, {m['waves']:.2f} waves; bound "
                  f"{r['bound_ms']:.4f} ms")
    print(f"ablate card: {out['card']}, {out['preset']} float32, "
          f"{out['threads']} threads")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
