"""Tuning sweeps and per-kernel times of the CUDA kernels on one card, with
stored results.

The counterpart of ``scripts/tune.py`` and ``scripts/perf_kernels.py``:
every swept configuration is validated against the float64 gate before it
is timed (``utils/tuning.py``), and each family's results (ms, GB/s against
the byte models, max relerr, ok, the card's name and power limit) are
written to ``<outdir>/tune_h100_<preset>_<family>.json``; the best of each
family is printed as one JSON line.

Usage, on a machine with a CUDA card and nvcc:

    python -m fesom2_accelerate_tpu_torch.utils.tune --preset core2 \\
        --families kernels,a2,step,stress2rhs,perf --outdir perf

Families: ``kernels`` (bounds, limit, limit_fused, b3h, update,
update_fused over threads), ``a2``, ``step`` (fuse_k12 x fuse_k34 x
threads), ``stress2rhs``, ``perf`` (each kernel and each step form at the
default block size).  It exits non-zero if a family fails, if any
configuration fails validation, or if no CUDA device is present.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="core2")
    ap.add_argument("--families", default="kernels,a2,step,stress2rhs,perf",
                    help="comma list: kernels, a2, step, stress2rhs, perf")
    ap.add_argument("--threads", default="64,128,256,512",
                    help="comma list of block sizes to sweep")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--outdir", default="perf")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from fesom2_accelerate_tpu_torch.mesh import generate_planar_mesh
    from fesom2_accelerate_tpu_torch.utils import tuning

    mesh = generate_planar_mesh(preset=args.preset)
    threads = tuple(int(t) for t in args.threads.split(","))
    fams = args.families.split(",")
    unknown = set(fams) - {"kernels", "a2", "step", "stress2rhs", "perf"}
    if unknown:
        ap.error(f"unknown families {sorted(unknown)}")
    os.makedirs(args.outdir, exist_ok=True)
    failed = []

    def path(name):
        return os.path.join(args.outdir,
                            f"tune_h100_{args.preset}_{name}.json")

    def dump(name, results):
        tuning.store(results, path(name))
        b = tuning.best(results)
        print(json.dumps({"family": name, "stored": path(name),
                          "best": dataclasses.asdict(b) if b else None}),
              flush=True)
        failed.extend(f"{name} {r.params}" for r in results if not r.ok)

    kw = dict(preset_name=args.preset, device=args.device)
    if "kernels" in fams:
        per = tuning.tune_kernels(mesh, [dict(threads=t) for t in threads],
                                  iters=args.iters, **kw)
        for fam, results in per.items():
            dump(fam, results)
    if "a2" in fams:
        dump("a2", tuning.tune_a2(mesh, threads, iters=args.iters, **kw))
    if "step" in fams:
        dump("step", tuning.tune_step(mesh, threads, steps=args.iters, **kw))
    if "stress2rhs" in fams:
        dump("stress2rhs", tuning.tune_stress2rhs(mesh, threads,
                                                  iters=args.iters, **kw))
    if "perf" in fams:
        records = tuning.perf_kernels(mesh, iters=max(args.iters, 100), **kw)
        with open(path("perf"), "w") as f:
            json.dump(records, f, indent=2)
        for r in records:
            print(json.dumps(r), flush=True)
    if failed:
        print(f"failed validation: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
