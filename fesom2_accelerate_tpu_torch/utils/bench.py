"""The bench: FCT-ALE step and stress2rhs throughput on one CUDA card.

The counterpart of ``bench.py`` of the JAX package.  Each cell runs a
solver's own entry point (``FctAleSolver.run`` / ``run_tracers``,
``ShardedFctAleSolver.run``, and the EVP substep loop through
``StepGraphs.run`` around ``Stress2RhsSolver.call_packed``) at the full
width of core2 or of the core2-size RCM cylinder, times it at the protocol
of ``runtime/tracing.py:time_run`` and prints one JSON line with the JAX
bench's fields:

* ``metric``: the cell's name (``CELLS``);
* ``value``: grid-points/s for the FCT cells (active node-layers of one
  tracer per second: at ``Tb`` tracers a tracer's share of the step, as
  ``bench.py --tracers`` divides), nodes/s for stress2rhs;
* ``unit``: ``bench.py``'s, "grid-points/s/chip" or "nodes/s/chip" (one
  card);
* ``vs_baseline``: the reference-style modeled bytes
  (``profiling.fct_ale_step_bytes``, ``stress2rhs_bytes``) over the time,
  as a share of the H100 SXM data-sheet 3.35 TB/s;
* ``detail``: the step's time (best of 3, and all 3), device and host time
  a step, what the run chose and a graph run's copy-in, the modeled bytes,
  ``profiling.step_io``'s bytes (the step's kernels' least traffic) and
  their share of the measured triad roof and of 3.35 TB/s, the roof, and
  the card's name and power limit.

Every cell is also a check: after the timed runs one more run, with the
kernels' launch counts set to 0 just before it and read just after, must
launch each of its kernels the step's count times ``steps`` and equal, bit
for bit, ``graphs.loop`` of the same steps from the same state, with
finite values where a result holds a node or an edge; its ``step_io``
share of the measured roof must be at most 1.  A failure raises, so the
command exits non-zero.  There is no CPU fallback: every cell, and the
command without a CUDA device, raises.

All cells are f32, ``dt=0.5``, ``flux_eps=1e-7``, vlimit 1, tracer t from
``random_fields(seed=t)`` (``hnode``/``hnode_new`` of tracer 0 shared, as
``bench.py --tracers`` makes them), stress2rhs inputs as ``bench.py`` makes
them (seed 7), on one card.

Usage, on a machine with a CUDA card and nvcc::

    python -m fesom2_accelerate_tpu_torch.utils.bench [--cell NAME|all] \\
        [--steps 20] [--out perf/bench_h100.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from fesom2_accelerate_tpu_torch.config import FctAleConfig
from fesom2_accelerate_tpu_torch.mesh import (
    generate_cylinder_mesh,
    generate_planar_mesh,
    random_fields,
)
from fesom2_accelerate_tpu_torch.model import FctAleSolver, Stress2RhsSolver
from fesom2_accelerate_tpu_torch.ops.cuda import kernels
from fesom2_accelerate_tpu_torch.ops.cuda.step import BATCH_SHARED
from fesom2_accelerate_tpu_torch.parallel import ShardedFctAleSolver
from fesom2_accelerate_tpu_torch.parallel.step_sharded import EDGE_FIELDS
from fesom2_accelerate_tpu_torch.runtime import graphs, profiling
from fesom2_accelerate_tpu_torch.runtime.tracing import (
    card_line,
    require_cuda,
    time_run,
)

DT, FLUX_EPS = 0.5, 1e-7
# the core2-size RCM cylinder: 126,976 nodes, 252,928 elements
CYLINDER = (512, 248, 48)
PARTS = 4
# stress2rhs calls a run: the EVP substeps of chip_smoke.py's loop
S2R_SUBSTEPS = 120
S2R_SEED = 7
DATASHEET = profiling.PEAKS["h100_sxm"]["bytes_per_s"]
# a measured roof above the data sheet by more than this is a wrong time
ROOF_SLACK = 1.05
ROOF_KERNEL = "triad torch.add(a, b, alpha=0.5, out=c), float32, 512 MiB"


@dataclasses.dataclass(frozen=True)
class Cell:
    """One bench cell: the mesh ("core2" or "cyl512"), the path ("fct":
    ``FctAleSolver``; "sharded": ``ShardedFctAleSolver`` at PARTS parts on
    the one card; "stress2rhs": the EVP loop), and the step's mode."""
    mesh: str
    path: str
    iter_yn: bool = False
    tracers: int = 1
    fused: bool = False


CELLS = {
    "fct_ale_step_core2_f32_cuda": Cell("core2", "fct"),
    "fct_ale_step_core2_f32_cuda_iter": Cell("core2", "fct", iter_yn=True),
    "fct_ale_step_cyl512_f32_cuda": Cell("cyl512", "fct"),
    "fct_ale_sharded_core2_f32_cuda_p4_split": Cell("core2", "sharded"),
    "fct_ale_sharded_core2_f32_cuda_p4_fused": Cell("core2", "sharded",
                                                    fused=True),
    "fct_ale_step_core2_f32_cuda_T8": Cell("core2", "fct", tracers=8),
    "fct_ale_sharded_core2_f32_cuda_p4_split_T8": Cell("core2", "sharded",
                                                       tracers=8),
    "stress2rhs_core2_f32_cuda": Cell("core2", "stress2rhs"),
    "stress2rhs_cyl512_f32_cuda": Cell("cyl512", "stress2rhs"),
}


class Inputs:
    """The cells' meshes and host inputs (numpy), each made once: core2
    (``PRESETS``) and the RCM cylinder; ``meshes`` may hand in meshes
    already built under those keys."""

    def __init__(self, meshes: dict | None = None):
        self.meshes = dict(meshes or {})
        self._fields = {}

    def mesh(self, key: str):
        if key not in self.meshes:
            self.meshes[key] = (generate_cylinder_mesh(*CYLINDER)[0]
                                if key == "cyl512"
                                else generate_planar_mesh(preset=key))
        return self.meshes[key]

    def fields(self, key: str, tracers: int = 1) -> dict:
        """Tracer t's fields from ``random_fields(seed=t)``; at ``tracers``
        > 1 each per-tracer field stacked [Tb, ...], ``hnode`` and
        ``hnode_new`` those of tracer 0, shared."""
        have = self._fields.setdefault(key, [])
        while len(have) < tracers:
            have.append(random_fields(self.mesh(key), seed=len(have),
                                      dtype=np.float64))
        if tracers == 1:
            return have[0]
        return {k: v if k in BATCH_SHARED
                else np.stack([f[k] for f in have[:tracers]])
                for k, v in have[0].items()}

    def s2r(self, key: str) -> tuple:
        """stress2rhs inputs as ``bench.py`` makes them: elem_area,
        ice_strength, sigma11, sigma12, sigma22 [E], gradient_sca [6, E],
        metric_factor [E], inv_areamass, rhs_a, rhs_m [N]."""
        mesh = self.mesh(key)
        rng = np.random.default_rng(S2R_SEED)
        E, N = mesh.n_elems, mesh.n_nodes
        return (np.abs(rng.standard_normal(E)) + 0.1, rng.standard_normal(E),
                *rng.standard_normal((3, E)), rng.standard_normal((6, E)),
                rng.standard_normal(E), rng.standard_normal(N),
                *rng.standard_normal((2, N)))


@dataclasses.dataclass
class Setup:
    """A cell built on the card: ``run(state, n)`` and the ``step`` whose
    loop it must equal, the state, the run's StepGraphs, the kernels'
    launches a step, ``step_io``'s bytes a step, the work a step (grid
    points of one tracer, or nodes), the modeled bytes a tracer's step,
    and ``live``, which maps a flat state's key to the columns that hold
    a node or an edge (None: all)."""
    run: object
    step: object
    state: dict
    graphs: object
    launches: dict
    io_bytes: int
    work: int
    model_bytes: int
    live: object = None


def s2r_substep(solver, packed, inv_areamass, rhs_m):
    """One EVP substep as a step of a carry (rhs_a, u, v): the call, then
    ``rhs_a + 1e-30 * U`` into the next call, so each call depends on the
    one before (the body of ``bench.py``'s stress2rhs scan)."""
    def step(c):
        u, v = solver.call_packed(packed, inv_areamass, c["rhs_a"], rhs_m)
        return {"rhs_a": c["rhs_a"] + 1e-30 * u, "u": u, "v": v}
    return step


def setup(cell: Cell, inputs: Inputs, device) -> Setup:
    """Builds ``cell`` on ``device`` (a CUDA device; else ValueError)."""
    dev = require_cuda(device)
    mesh = inputs.mesh(cell.mesh)
    tb = cell.tracers
    if cell.path == "stress2rhs":
        host = inputs.s2r(cell.mesh)
        solver = Stress2RhsSolver(mesh, torch.float32, device=dev)
        packed = solver.pack_elem_inputs(*host[:7])
        iam, ra, rm = (torch.tensor(a, dtype=torch.float32, device=dev)
                       for a in host[7:])
        step = s2r_substep(solver, packed, iam, rm)
        sg = graphs.StepGraphs(dev)
        io = profiling.kernel_io(solver.md, "stress2rhs", slab=packed,
                                 inv_areamass=iam)[0]
        return Setup(lambda s, n: sg.run(step, s, n), step,
                     dict(rhs_a=ra, u=torch.zeros_like(ra),
                          v=torch.zeros_like(ra)),
                     sg, {"stress2rhs": 1}, io, mesh.n_nodes,
                     profiling.stress2rhs_bytes(mesh, 4))
    cfg = FctAleConfig(dt=DT, flux_eps=FLUX_EPS, vlimit=1,
                       iter_yn=cell.iter_yn, dtype=torch.float32)
    fields = inputs.fields(cell.mesh, tb)
    work = profiling.grid_points(mesh)
    model = profiling.fct_ale_step_bytes(mesh, 4, iter_yn=cell.iter_yn)
    if cell.path == "fct":
        sv = FctAleSolver(mesh, cfg, device=dev)
        form = "K1->K2->K34"
        io = profiling.step_io(sv.md, cfg, form, tracers=tb)[0]
        launches = dict.fromkeys(profiling.STEP_FORMS[form], 1)
        if tb == 1:
            return Setup(sv.run, sv.step, sv.init_state(fields), sv._graphs,
                         launches, io, work, model)
        return Setup(sv.run_tracers, sv.step_tracers,
                     sv.init_state_tracers(fields), sv._graphs, launches,
                     io, work, model)
    sh = ShardedFctAleSolver(mesh, cfg, devices=[dev] * PARTS, tracers=tb,
                             fused=cell.fused)
    form = "K1->K2->K34" if cell.fused else "K1->K2->K3->K4fix"
    io = sum(profiling.step_io(md, cfg, form, tracers=tb, owned=sh.owned)[0]
             for md in sh.mds)
    launches = dict.fromkeys(profiling.STEP_FORMS[form], PARTS)
    pm = sh.pm
    cols = {edge: [torch.from_numpy(g >= 0).to(dev) for g in ids]
            for edge, ids in ((False, pm.local_nodes_global),
                              (True, pm.local_edges_global))}
    return Setup(sh.run, sh.step, sh.init_state(fields), sh._graphs,
                 launches, io, work, model,
                 live=lambda key: cols[key[0] in EDGE_FIELDS][key[1]])


def flat_state(state: dict) -> dict:
    """A state as one dict of tensors (a sharded state's lists keyed
    (field, part))."""
    out = {}
    for k, v in state.items():
        if isinstance(v, list):
            out.update({(k, p): t for p, t in enumerate(v)})
        else:
            out[k] = v
    return out


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal shapes, dtypes and bits (a NaN equals the same NaN: the 0/0
    of a part's pad columns, which hold no node)."""
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.view(ints[a.dtype]), b.view(ints[b.dtype])))


def check_run(name: str, s: Setup, steps: int) -> dict:
    """One more run of ``steps``: its launches (set to 0 just before it,
    read just after) equal ``s.launches`` x steps, its result equals
    ``graphs.loop`` of the same steps bit for bit and is finite where it
    holds a node or an edge.  Returns the launches; raises on a
    mismatch."""
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = s.run(s.state, steps)
    torch.cuda.synchronize()
    counts = {k: n for k, n in kernels.launch_counts().items() if n}
    want = {k: n * steps for k, n in s.launches.items()}
    if counts != want:
        raise AssertionError(f"{name}: launches {counts}, expected {want}")
    got = flat_state(out)
    ref = flat_state(graphs.loop(s.step, s.state, steps))
    if got.keys() != ref.keys() or got.keys() != flat_state(s.state).keys():
        raise AssertionError(f"{name}: the run changed the state's keys")
    for k, v in ref.items():
        if not same_bits(got[k], v):
            raise AssertionError(f"{name} {k}: the run is not bit-identical "
                                 f"to graphs.loop of its steps")
        real = v if s.live is None else v[..., s.live(k)]
        if not bool(torch.isfinite(real).all()):
            raise AssertionError(f"{name} {k}: non-finite values")
    return counts


def bench_line(metric: str, timing: dict, *, work: int, model_bytes: int,
               io_bytes: int, roof: float, card: str,
               tracers: int = 1) -> dict:
    """The JSON line of one cell from its timing (``time_run``'s dict), in
    the JAX bench's fields: ``value`` is the work of one tracer's step
    (grid points, or nodes for stress2rhs) over a tracer's share of the
    best step time, ``vs_baseline`` the modeled bytes a tracer over that
    time against the data-sheet rate; ``detail`` holds the step's times
    (a step of every tracer), what the run chose, ``step_io``'s bytes of
    the whole step (all tracers, all parts) and their shares of the
    measured roof (``roof``, bytes/s) and of the data sheet."""
    s2r = metric.startswith("stress2rhs")
    step_s = timing["step_ms"] * 1e-3
    tracer_s = step_s / tracers
    detail = {
        "steps": timing["steps"],
        "step_ms": timing["step_ms"],
        "step_ms_runs": timing["step_ms_runs"],
        "device_ms": timing["device_ms"],
        "host_ms": timing["host_ms"],
        "choice": timing["choice"],
        "copy_in_ms": timing["copy_in_ms"],
        ("nodes" if s2r else "grid_points"): work,
        "modeled_GB": model_bytes / 1e9,
        "eff_GBps": model_bytes / tracer_s / 1e9,
        "step_io_GB": io_bytes / 1e9,
        "step_io_GBps": io_bytes / step_s / 1e9,
        "frac_measured_roof": io_bytes / step_s / roof,
        "frac_datasheet": io_bytes / step_s / DATASHEET,
        "measured_roof_GBps": roof / 1e9,
        "roof_kernel": ROOF_KERNEL,
        "card": card,
    }
    if s2r:
        detail["step"] = "one EVP substep: call_packed, then rhs_a + 1e-30 U"
    if tracers > 1:
        detail.update(tracers=tracers, tracer_step_ms=timing["step_ms"]
                      / tracers,
                      note="value and vs_baseline a tracer; times a step "
                      "of every tracer")
    return {
        "metric": metric,
        "value": work / tracer_s,
        "unit": "nodes/s/chip" if s2r else "grid-points/s/chip",
        "vs_baseline": model_bytes / tracer_s / DATASHEET,
        "detail": detail,
    }


def check_roof(roof: float) -> None:
    """A measured roof above ROOF_SLACK x the data sheet is a wrong time."""
    if roof > ROOF_SLACK * DATASHEET:
        raise AssertionError(f"measured roof {roof / 1e12:.4f} TB/s above "
                             f"{ROOF_SLACK} x {DATASHEET / 1e12} TB/s")


def run_cell(name: str, inputs: Inputs, steps: int, roof: float, card: str,
             device="cuda") -> dict:
    """Builds, times and checks cell ``name`` -> its JSON line; the
    cell's tensors are freed before it returns.  Raises ValueError
    without a CUDA device, AssertionError where a check fails."""
    dev = require_cuda(device)
    cell = CELLS[name]
    n = S2R_SUBSTEPS if cell.path == "stress2rhs" else steps
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    s = setup(cell, inputs, dev)
    timing = time_run(s.run, s.state, n, graphs=s.graphs, device=dev)
    launches = check_run(name, s, n)
    line = bench_line(name, timing, work=s.work, model_bytes=s.model_bytes,
                      io_bytes=s.io_bytes, roof=roof, card=card,
                      tracers=cell.tracers)
    line["detail"]["launches"] = launches
    share = line["detail"]["frac_measured_roof"]
    if share > 1.0:
        raise AssertionError(f"{name}: step_io share {share:.4f} of the "
                             f"measured roof is above 1")
    del s
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", default="all",
                    help=f"a cell or 'all': {', '.join(CELLS)}")
    ap.add_argument("--steps", type=int, default=20,
                    help="steps of each timed FCT run (stress2rhs: "
                    f"{S2R_SUBSTEPS} substeps)")
    ap.add_argument("--out", default="perf/bench_h100.json")
    args = ap.parse_args(argv)
    names = list(CELLS) if args.cell == "all" else [args.cell]
    if any(n not in CELLS for n in names):
        ap.error(f"unknown cell {args.cell!r}; cells: {', '.join(CELLS)}")
    try:
        dev = require_cuda("cuda")
    except ValueError as e:
        print(f"bench: {e}; nothing measured", file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    roof = profiling.measure_stream_bandwidth(device=dev)
    check_roof(roof)
    inputs = Inputs()
    lines = []
    for name in names:
        lines.append(run_cell(name, inputs, args.steps, roof, card, dev))
        print(json.dumps(lines[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "device": torch.cuda.get_device_name(dev),
                       "measured_roof_Bps": roof, "roof_kernel": ROOF_KERNEL,
                       "steps": args.steps, "lines": lines}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
