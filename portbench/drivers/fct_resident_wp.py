"""FCT-ALE with the state resident on the card at the configuration's
working precision: :mod:`portbench.drivers.fct_resident`'s model step,
inputs and checks, with the program's solver, the fields it is served and
the contract bytes in the configuration's ``fct.dtype`` and ``flux_eps``
(the f32 cell's driver runs float32 whatever the configuration says).

A model step is ``run_tracers(state, steps_per_call)`` of one
``FctAleSolver`` on the whole mesh (``run`` at one tracer), on two seeded
sets of unlimited fluxes and increments taken in turn.  One rank, one part.

Traffic keys: ``tracers``, ``steps_per_call`` (default 1), ``iter_yn``
(default the configuration's), ``limits``.

Checks: ``first_step_relerr`` and ``last_step_relerr`` against the float64
reference, as :class:`~portbench.drivers.fct_resident.Resident` takes
them.
"""

from __future__ import annotations

import torch

from fesom2_accelerate_tpu_torch.config import FctAleConfig
from fesom2_accelerate_tpu_torch.mesh import build_mesh_from_elements

from portbench import contract, inputs
from portbench.drivers import fct_resident
from portbench.reference.mesh import build_mesh


def dtype_of(fct: dict) -> torch.dtype:
    """The configuration's working precision: ``fct.dtype`` by name."""
    dtype = getattr(torch, fct["dtype"], None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"fct.dtype {fct['dtype']!r} names no float dtype")
    return dtype


class ResidentWp(fct_resident.Resident):
    def __init__(self, ctx):
        cfg, traffic, dev = ctx.config, ctx.traffic, ctx.device
        if int(cfg.get("ranks", 1)) * int(cfg.get("parts_per_rank", 1)) > 1:
            raise ValueError("fct_resident_wp runs one rank of one part")
        self.ctx = ctx
        self.T = int(traffic["tracers"])
        self.k = int(traffic.get("steps_per_call", 1))
        f = cfg["fct"]
        dtype = dtype_of(f)
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
                                 sets=fct_resident.SETS)
            # what the program is served, in its working precision, kept
            # on the host for the checks
            self.served = [
                {k: (v[0] if self.T == 1 and k in inputs.TRACER_FIELDS
                     else v).to(dtype).cpu() for k, v in fs.items()}
                for fs in made]
            del made
        with ctx.phase("solver"):
            pcfg = FctAleConfig(dt=self.dt, flux_eps=self.flux_eps,
                                vlimit=f["vlimit"], iter_yn=self.iter_yn,
                                dtype=dtype)
            sv = fct_resident.FctAleSolver(mesh, pcfg, device=dev)
            self._run = sv.run if self.T == 1 else sv.run_tracers
            self.gather = None
            self.given = [sv.init_state(s) for s in self.served]
            self.calls = 0
        with ctx.phase("first_call"):
            self.step()
            ctx.sync()
        self.first = self._held(self.state, clone=True)
        with ctx.phase("warm_up"):
            for _ in range(fct_resident.WARM_CALLS):
                self.step()
            ctx.sync()
        self.bytes_per_step = self.k * contract.fct_step_bytes(
            self.ref_mesh, self.T, dtype.itemsize, self.iter_yn)


def setup(ctx) -> ResidentWp:
    return ResidentWp(ctx)
