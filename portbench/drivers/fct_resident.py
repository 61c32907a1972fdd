"""FCT-ALE with the state resident on the card: what a GPU-resident FESOM2
asks of the library once an ocean timestep.

A model step is ``run_tracers(state, steps_per_call)`` of the program's
``FctAleSolver`` (``run`` at one tracer), or, where the configuration
spreads the mesh over ``ranks`` x ``parts_per_rank`` parts,
``ShardedFctAleSolver.run`` on this rank's parts (``distributed.
global_devices``, the port's default split step and transport).  Each step
is given the seed's tracer fields with a new set of unlimited fluxes and
increments: ``SETS`` sets drawn from the seed (:func:`inputs.fields`),
taken in turn and held on the card, as FESOM2's advection hands the
limiter new fluxes every timestep.  So the limiter limits on every step,
and two steps in a row give different outputs.

Traffic keys: ``tracers``, ``steps_per_call`` (default 1), ``iter_yn``
(default the configuration's), ``limits``.

Checks (float64 reference, :mod:`portbench.reference.fct`):

* ``first_step_relerr``: the program's first call, taken in set-up from
  the first set, against the reference from the same fields;
* ``last_step_relerr``: the window's last call against the reference from
  the set it was given: a step that returns its input, the previous
  step's output or unlimited fluxes reads wrong here.
"""

from __future__ import annotations

import torch

from fesom2_accelerate_tpu_torch.config import FctAleConfig
from fesom2_accelerate_tpu_torch.mesh import build_mesh_from_elements
from fesom2_accelerate_tpu_torch.model import FctAleSolver
from fesom2_accelerate_tpu_torch.parallel import ShardedFctAleSolver
from fesom2_accelerate_tpu_torch.parallel import distributed

from portbench import contract, inputs
from portbench.reference import fct
from portbench.reference.compare import relerr
from portbench.reference.mesh import build_mesh

# calls after the first, before the window
WARM_CALLS = 4
# the sets of fluxes and increments that model steps take in turn
SETS = 2


def compared(iter_yn: bool) -> tuple:
    """The fields a step hands back to the host."""
    if iter_yn:
        return ("fct_LO", "fct_adf_v", "fct_adf_h")
    return ("fct_adf_v", "fct_adf_h", "del_ttf_advvert", "del_ttf_advhoriz")


def reference(mk, state: dict, steps: int, *, dt, flux_eps, iter_yn,
              tracers: int, dtype=torch.float64) -> dict:
    """The reference's ``steps`` steps from ``state`` (tensors or numpy,
    a tracer axis in front of the tracer fields where ``tracers`` > 1),
    in ``dtype``: the compared fields, each with its tracer axis."""
    keys = compared(iter_yn)
    per = []
    for t in range(tracers):
        f = {}
        for k, v in state.items():
            v = torch.as_tensor(v)
            if tracers > 1 and k in inputs.TRACER_FIELDS:
                v = v[t]
            f[k] = v.to(device=mk.node_mask.device, dtype=dtype)
        for _ in range(steps):
            f.update(fct.step(mk, f, dt=dt, flux_eps=flux_eps,
                              iter_yn=iter_yn))
        per.append({k: f[k].to(torch.float64) for k in keys})
    if tracers == 1:
        return per[0]
    return {k: torch.stack([p[k] for p in per]) for k in keys}


class Resident:
    def __init__(self, ctx):
        cfg, traffic, dev = ctx.config, ctx.traffic, ctx.device
        self.ctx = ctx
        self.T = int(traffic["tracers"])
        self.k = int(traffic.get("steps_per_call", 1))
        f = cfg["fct"]
        self.iter_yn = bool(traffic.get("iter_yn", f["iter_yn"]))
        self.dt, self.flux_eps = f["dt"], f["flux_eps"]
        self.limits = traffic["limits"]
        m = cfg["mesh"]
        with ctx.phase("mesh"):
            elem_nodes, nlev_elem, node_xy = inputs.planar_mesh(
                m["nx"], m["ny"], m["nl"])
            self.ref_mesh = build_mesh(elem_nodes, nlev_elem, m["nl"],
                                       node_xy)
            mesh = build_mesh_from_elements(elem_nodes, nlev_elem, m["nl"],
                                            node_xy)
        with ctx.phase("fields"):
            made = inputs.fields(self.ref_mesh, ctx.seed, self.T, dev,
                                 sets=SETS)
            # what the program is served, float32 as the reference starts,
            # kept on the host for the checks
            self.served = [
                {k: (v[0] if self.T == 1 and k in inputs.TRACER_FIELDS
                     else v).float().cpu() for k, v in fs.items()}
                for fs in made]
            del made
        with ctx.phase("solver"):
            pcfg = FctAleConfig(dt=self.dt, flux_eps=self.flux_eps,
                                vlimit=f["vlimit"], iter_yn=self.iter_yn,
                                dtype=torch.float32)
            parts = int(cfg.get("ranks", 1)) * int(cfg.get("parts_per_rank",
                                                           1))
            if parts > 1:
                sv = ShardedFctAleSolver(
                    mesh, pcfg, devices=distributed.global_devices(
                        [dev] * int(cfg.get("parts_per_rank", 1))),
                    tracers=self.T)
                self._run, self.gather = sv.run, sv.gather_state
            else:
                sv = FctAleSolver(mesh, pcfg, device=dev)
                self._run = sv.run if self.T == 1 else sv.run_tracers
                self.gather = None
            self.given = [sv.init_state(s) for s in self.served]
            self.calls = 0
        with ctx.phase("first_call"):
            self.step()
            ctx.sync()
        self.first = self._held(self.state, clone=True)
        with ctx.phase("warm_up"):
            for _ in range(WARM_CALLS):
                self.step()
            ctx.sync()
        self.bytes_per_step = self.k * contract.fct_step_bytes(
            self.ref_mesh, self.T, 4, self.iter_yn)

    def step(self):
        self.state = self._run(self.given[self.calls % SETS], self.k)
        self.calls += 1

    def _held(self, state: dict, clone: bool = False) -> dict | None:
        """``state`` as whole-mesh fields: gathered from every rank (a
        collective; numpy) or, in one process, the tensors themselves;
        None on a rank other than 0."""
        if self.gather is not None:
            out = self.gather(state)
            return out if self.ctx.rank == 0 else None
        return {k: v.clone() if clone else v for k, v in state.items()}

    def checks(self, control: bool = False) -> list:
        """[(name, value, limit)] on rank 0 ([] elsewhere).  ``control``:
        the reference in bfloat16 takes the program's place."""
        after = self._held(self.state)
        last = self.served[(self.calls - 1) % SETS]
        self._run = self.gather = self.state = self.given = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        if self.ctx.rank != 0:
            return []
        mk = fct.Masks(self.ref_mesh, torch.float64, self.ctx.device)
        kw = dict(dt=self.dt, flux_eps=self.flux_eps, iter_yn=self.iter_yn,
                  tracers=self.T)
        out = []
        for name, base, got in (("first_step_relerr", self.served[0],
                                 self.first),
                                ("last_step_relerr", last, after)):
            want = reference(mk, base, self.k, **kw)
            if control:
                low = fct.Masks(self.ref_mesh, torch.bfloat16,
                                self.ctx.device)
                got = reference(low, base, self.k, dtype=torch.bfloat16,
                                **kw)
            out.append((name, relerr(got, want), self.limits[name]))
        return out


def setup(ctx) -> Resident:
    return Resident(ctx)
